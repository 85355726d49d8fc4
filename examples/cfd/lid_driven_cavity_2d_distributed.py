"""Distributed 2D lid-driven cavity (reference
examples/cfd/lid_driven_cavity_2d_distributed.py:13-27).

Same scene as lid_driven_cavity_2d but wrapped with distribute(): on a
multi-device mesh the streaming halo exchange is a ppermute between devices.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script


import numpy as np
import jax

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D2Q9
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, HalfwayBounceBackBC
from xlb_tpu.parallel import distribute
from xlb_tpu.ops import Macroscopic
from xlb_tpu.utils import omega_from_reynolds


def run(n=128, re=200.0, u_lid=0.05, num_steps=500):
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = grid_factory((n, n))
    print(f"devices: {grid.nDevices}, mesh: {dict(zip(grid.axis_names, grid.mesh_shape))}")
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)

    bcs = [
        HalfwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(u_lid, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    stepper = distribute(stepper, grid, xlb.DefaultConfig.velocity_set)

    import jax as _jax

    omega = omega_from_reynolds(re, u_lid, n)

    @_jax.jit
    def run_window(f_0, f_1):
        def body(t, carry):
            a, b = carry
            a, b = stepper(a, b, bc_mask, missing_mask, omega, t)
            return (b, a)
        return _jax.lax.fori_loop(0, num_steps, body, (f_0, f_1))

    f_0, f_1 = run_window(f_0, f_1)

    rho, u = Macroscopic()(f_0)
    print(f"distributed cavity done: max|u|={np.abs(np.asarray(u)).max():.4f}")


if __name__ == "__main__":
    run()
