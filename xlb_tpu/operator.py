"""Operator base class.

The reference Operator (xlb/operator/operator.py:26-316) is a three-backend
dispatch table with eager kernel construction.  In this framework
an operator is simply a configured callable: ``__call__`` is a pure-jnp
function of its array arguments, closed over static configuration (velocity
set, precision policy).  That makes every operator directly jittable,
shardable under GSPMD, and differentiable, with zero dispatch machinery.
"""

from xlb_tpu.compute_backend import ComputeBackend, check_backend_supported
from xlb_tpu.precision_policy import PrecisionPolicy
from xlb_tpu.default_config import DefaultConfig


class Operator:
    """Base for all operators: holds the static configuration.

    Parameters default to the ``DefaultConfig`` singleton populated by
    ``xlb_tpu.init`` (reference operator.py:48-50).
    """

    def __init__(self, velocity_set=None, precision_policy=None, compute_backend=None):
        self.velocity_set = velocity_set if velocity_set is not None else DefaultConfig.velocity_set
        self.precision_policy = precision_policy if precision_policy is not None else DefaultConfig.default_precision_policy
        backend = compute_backend if compute_backend is not None else DefaultConfig.default_backend
        self.compute_backend = check_backend_supported(backend) if backend is not None else ComputeBackend.JAX

        if self.velocity_set is None or self.precision_policy is None:
            raise RuntimeError(
                f"{type(self).__name__} constructed without a velocity set / precision policy; "
                "call xlb_tpu.init(...) first or pass them explicitly."
            )
        if not isinstance(self.precision_policy, PrecisionPolicy):
            raise TypeError(f"precision_policy must be a PrecisionPolicy, got {self.precision_policy!r}")

    @property
    def compute_dtype(self):
        return self.precision_policy.compute_dtype

    @property
    def store_dtype(self):
        return self.precision_policy.store_dtype

    @property
    def backend(self):
        return self.compute_backend

    def __repr__(self):
        return f"{type(self).__name__}({self.velocity_set}, {self.precision_policy.name})"
