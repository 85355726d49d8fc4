"""Compute-backend enum.

The reference framework (xlb/compute_backend.py:9-18) dispatches between three
engines (JAX, NVIDIA Warp, Autodesk Neon).  This framework has a single array
engine (JAX/XLA) and an optional fused-kernel tier (Pallas, Triton route) that
replaces the reference's fused Warp kernel (nse_stepper.py:335-466).

``WARP`` and ``NEON`` are kept as enum members so that reference scripts importing
them fail with a clear, actionable error instead of an AttributeError.
"""

from enum import Enum, auto


class ComputeBackend(Enum):
    """Available compute backends.

    JAX     -- pure jax.numpy operators (correctness oracle, differentiable).
    PALLAS  -- fused Pallas collide-stream kernel for the hot loop;
               setup-time operators still run through JAX.
    WARP    -- unsupported (reference's CUDA codegen backend).
    NEON    -- unsupported (reference's multi-GPU C++ runtime).
    """

    JAX = auto()
    PALLAS = auto()
    WARP = auto()
    NEON = auto()

    @property
    def is_supported(self) -> bool:
        return self in (ComputeBackend.JAX, ComputeBackend.PALLAS)


def check_backend_supported(backend: "ComputeBackend") -> "ComputeBackend":
    if not isinstance(backend, ComputeBackend):
        raise TypeError(f"expected a ComputeBackend, got {backend!r}")
    if not backend.is_supported:
        raise ValueError(
            f"ComputeBackend.{backend.name} is a backend of the reference framework "
            "and is not available in xlb_tpu. Use ComputeBackend.JAX "
            "(pure-jnp) or ComputeBackend.PALLAS (fused Pallas kernel)."
        )
    return backend
