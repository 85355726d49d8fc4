"""xlb_tpu: a differentiable lattice Boltzmann CFD framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the XLB framework
(reference: hsalehipour/XLB): differentiable 2D/3D LBM with a full
boundary-condition zoo, GSPMD multi-device sharding, and a fused Pallas
collide-stream kernel (Triton route, NVIDIA GPUs) for the hot loop.

Quick start::

    import xlb_tpu as xlb
    from xlb_tpu.velocity_set import D2Q9

    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = xlb.grid_factory((256, 256))
    ...
"""

from xlb_tpu.compute_backend import ComputeBackend
from xlb_tpu.precision_policy import Precision, PrecisionPolicy
from xlb_tpu.physics_type import PhysicsType
from xlb_tpu.mres_perf_optimization_type import MresPerfOptimizationType
from xlb_tpu.cell_type import BC_NONE, BC_SFV, BC_SOLID
from xlb_tpu.default_config import DefaultConfig, init, check_backend_support
from xlb_tpu.operator import Operator
from xlb_tpu.grid import Grid, grid_factory
from xlb_tpu import velocity_set
from xlb_tpu import ops, boundary, models, parallel, geometry, utils, helper

__version__ = "0.1.0"

__all__ = [
    "ComputeBackend",
    "Precision",
    "PrecisionPolicy",
    "PhysicsType",
    "MresPerfOptimizationType",
    "BC_NONE",
    "BC_SFV",
    "BC_SOLID",
    "DefaultConfig",
    "init",
    "check_backend_support",
    "Operator",
    "Grid",
    "grid_factory",
    "velocity_set",
    "ops",
    "boundary",
    "models",
    "parallel",
    "geometry",
    "utils",
    "helper",
]
