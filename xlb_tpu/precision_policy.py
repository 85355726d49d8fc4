"""Precision system: scalar precisions and compute/store precision policies.

Parity surface with reference xlb/precision_policy.py:13-120, with bfloat16
as a first-class storage and compute dtype in addition to the reference's
float16.
"""

from enum import Enum, auto

import jax
import jax.numpy as jnp


class Precision(Enum):
    FP64 = auto()
    FP32 = auto()
    FP16 = auto()
    BF16 = auto()
    UINT8 = auto()
    UINT32 = auto()
    BOOL = auto()

    @property
    def jax_dtype(self):
        return {
            Precision.FP64: jnp.float64,
            Precision.FP32: jnp.float32,
            Precision.FP16: jnp.float16,
            Precision.BF16: jnp.bfloat16,
            Precision.UINT8: jnp.uint8,
            Precision.UINT32: jnp.uint32,
            Precision.BOOL: jnp.bool_,
        }[self]


class PrecisionPolicy(Enum):
    """A (compute, store) dtype pair.

    The distribution functions live in HBM in the *store* precision; every
    operator upcasts to the *compute* precision on entry and downcasts on
    exit (reference nse_stepper.py:243-244, 279).
    """

    FP64FP64 = auto()
    FP64FP32 = auto()
    FP64FP16 = auto()
    FP32FP32 = auto()
    FP32FP16 = auto()
    FP32BF16 = auto()
    BF16BF16 = auto()

    @property
    def compute_precision(self) -> Precision:
        return {
            PrecisionPolicy.FP64FP64: Precision.FP64,
            PrecisionPolicy.FP64FP32: Precision.FP64,
            PrecisionPolicy.FP64FP16: Precision.FP64,
            PrecisionPolicy.FP32FP32: Precision.FP32,
            PrecisionPolicy.FP32FP16: Precision.FP32,
            PrecisionPolicy.FP32BF16: Precision.FP32,
            PrecisionPolicy.BF16BF16: Precision.BF16,
        }[self]

    @property
    def store_precision(self) -> Precision:
        return {
            PrecisionPolicy.FP64FP64: Precision.FP64,
            PrecisionPolicy.FP64FP32: Precision.FP32,
            PrecisionPolicy.FP64FP16: Precision.FP16,
            PrecisionPolicy.FP32FP32: Precision.FP32,
            PrecisionPolicy.FP32FP16: Precision.FP16,
            PrecisionPolicy.FP32BF16: Precision.BF16,
            PrecisionPolicy.BF16BF16: Precision.BF16,
        }[self]

    @property
    def compute_dtype(self):
        return self.compute_precision.jax_dtype

    @property
    def store_dtype(self):
        return self.store_precision.jax_dtype

    def requires_x64(self) -> bool:
        return self.compute_precision == Precision.FP64

    def enable_x64_if_needed(self):
        if self.requires_x64():
            jax.config.update("jax_enable_x64", True)

    # -- casting helpers (names kept for reference-API parity) -----------
    def cast_to_compute_jax(self, array):
        return array.astype(self.compute_dtype)

    def cast_to_store_jax(self, array):
        return array.astype(self.store_dtype)

    # idiomatic aliases
    cast_to_compute = cast_to_compute_jax
    cast_to_store = cast_to_store_jax
