"""Global configuration singleton and ``init`` entry point.

Parity surface with reference xlb/default_config.py:16-127.  ``xlb_tpu.init``
pins the default velocity set, backend tier, and precision policy that every
subsequently constructed operator reads when not explicitly configured.
"""

import jax

from xlb_tpu.compute_backend import ComputeBackend, check_backend_supported
from xlb_tpu.precision_policy import PrecisionPolicy


class _DefaultConfig:
    velocity_set = None
    default_backend = None
    default_precision_policy = None

    def reset(self):
        self.velocity_set = None
        self.default_backend = None
        self.default_precision_policy = None


DefaultConfig = _DefaultConfig()


def init(velocity_set, default_backend=ComputeBackend.JAX, default_precision_policy=PrecisionPolicy.FP32FP32):
    """One-time global setup (reference xlb/default_config.py:60-100).

    Parameters
    ----------
    velocity_set : VelocitySet
        The lattice stencil (D2Q9 / D3Q19 / D3Q27 instance).
    default_backend : ComputeBackend
        JAX (pure-jnp) or PALLAS (fused Pallas kernel for the hot loop).
    default_precision_policy : PrecisionPolicy
        Compute/store dtype pair.
    """
    check_backend_supported(default_backend)
    default_precision_policy.enable_x64_if_needed()

    DefaultConfig.velocity_set = velocity_set
    DefaultConfig.default_backend = default_backend
    DefaultConfig.default_precision_policy = default_precision_policy
    return DefaultConfig


def check_backend_support():
    """Report the platforms XLA can target (reference default_config.py:108-126)."""
    platforms = {d.platform for d in jax.devices()}
    return {
        "gpu": "gpu" in platforms or "cuda" in platforms,
        "cpu": "cpu" in platforms,
        "devices": jax.devices(),
    }
