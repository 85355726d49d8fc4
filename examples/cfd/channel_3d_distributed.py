"""Multi-GPU sharded 3D channel (BASELINE config #5).

A periodic force-driven channel sharded over the device mesh along x; each
window dispatch runs ``--steps`` jnp-tier steps that GSPMD partitions, with
the x-rolls of the pull stream lowered to collective-permutes between
cards.  The domain weak-scales with the device count (8 virtual CPU
devices under JAX_PLATFORMS=cpu and
XLA_FLAGS=--xla_force_host_platform_device_count=8, or the GPUs of a host).
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import HalfwayBounceBackBC
from xlb_tpu.ops import Macroscopic


def run(cells_per_device_x=64, ny=64, nz=128, num_steps=200, force=5e-7, omega=1.6, precision="FP32FP32"):
    # FP32FP32 default: a weak body force (5e-7/step) needs 32-bit storage
    # to accumulate -- 16-bit storage quantizes increments this small away
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy[precision])
    n_dev = jax.device_count()
    nx = cells_per_device_x * n_dev
    grid = grid_factory((nx, ny, nz), mesh_shape=(n_dev, 1, 1))
    print(f"{n_dev} device(s), domain {nx}x{ny}x{nz} = {nx * ny * nz / 1e6:.1f}M cells, "
          f"sharded {dict(zip(grid.axis_names, grid.mesh_shape))}, {precision}")

    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    stepper = IncompressibleNavierStokesStepper(
        grid,
        boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())],
        force_vector=np.array([force, 0.0, 0.0]),
    )
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    window = stepper.build_multi_step(num_steps, donate=False)

    f_0, f_1 = jax.block_until_ready(window(f_0, f_1, bc_mask, missing_mask, omega))  # compile + run
    t0 = time.perf_counter()
    f_0, f_1 = jax.block_until_ready(window(f_0, f_1, bc_mask, missing_mask, omega))
    dt = time.perf_counter() - t0

    _, u = Macroscopic()(f_0.astype(jnp.float32))
    profile = np.asarray(u)[0].mean(axis=(0, 1))
    mlups = nx * ny * nz * num_steps / dt / 1e6
    print(f"{mlups:.1f} MLUPS total ({mlups / n_dev:.1f}/device); "
          f"centerline u={profile[nz // 2]:.5f}, wall-adjacent u={profile[1]:.6f}, "
          f"finite={np.isfinite(profile).all()}")
    return mlups


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--cells-per-device-x", type=int, default=64)
    p.add_argument("--precision", default="FP32FP32")
    args = p.parse_args()
    run(cells_per_device_x=args.cells_per_device_x, num_steps=args.steps, precision=args.precision)
