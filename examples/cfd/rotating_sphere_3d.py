"""Flow past a rotating sphere (reference examples/cfd/rotating_sphere_3d.py).

KBC/D3Q27 like the reference (BGK/D3Q19 selectable, but unstable at the
default Re/resolution), halfway bounce-back with a rotational
wall-velocity profile u_wall = omega x r.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import argparse

import numpy as np

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19, D3Q27
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, ExtrapolationOutflowBC, HalfwayBounceBackBC, FullwayBounceBackBC
from xlb_tpu.geometry import sphere_triangles, voxelize, solid_voxel_indices
from xlb_tpu.ops import Macroscopic
from xlb_tpu.utils import omega_from_reynolds


def run(nx=96, nyz=48, re=100.0, u_in=0.03, rot_rate=0.005, num_steps=600, collision="KBC", backend="jax"):
    vset = D3Q27() if collision == "KBC" else D3Q19()
    xlb.init(velocity_set=vset,
             default_backend=xlb.ComputeBackend.PALLAS if backend == "pallas" else xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = grid_factory((nx, nyz, nyz))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    center = np.array([nx / 4, nyz / 2, nyz / 2])
    radius = nyz / 8
    tris = sphere_triangles(center=center, radius=radius, subdivisions=3)
    sphere_idx = solid_voxel_indices(voxelize(tris, grid.shape))

    def rotation_profile(coords):
        # u_wall = omega x (x - c), spinning about the z axis
        r = coords - center[:, None]
        omega_vec = np.array([0.0, 0.0, rot_rate])
        return np.cross(omega_vec[None, :], r.T).T

    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(u_in, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        HalfwayBounceBackBC(indices=sphere_idx.tolist(), profile=rotation_profile),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()

    omega = omega_from_reynolds(re, u_in, 2 * radius)
    import time

    import jax

    # First chunk absorbs compile (warmup); subsequent chunks are timed.
    chunk = min(100, num_steps)
    run_window = stepper.build_multi_step(chunk, donate=False)
    f_0, f_1 = jax.block_until_ready(run_window(f_0, f_1, bc_mask, missing_mask, omega))
    done = chunk
    t0 = time.perf_counter()
    while done + chunk <= num_steps:
        f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)
        done += chunk
    jax.block_until_ready(f_0)
    dt = time.perf_counter() - t0
    if done > chunk:
        mlups = nx * nyz * nyz * (done - chunk) / dt / 1e6
        print(f"rotating sphere [{backend}]: {mlups:.1f} MLUPS ({done} steps, {nx}x{nyz}x{nyz})")

    rho, u = Macroscopic()(f_0)
    u = np.asarray(u)
    # report over fluid voxels only (u is 0/0 inside the solid sphere)
    fluid = np.asarray(bc_mask[0]) != 255
    u_fluid = np.where(fluid[None], u, 0.0)
    # rotation breaks top/bottom symmetry: compare u_x above/below the sphere
    iy_hi, iy_lo = int(center[1] + radius + 2), int(center[1] - radius - 2)
    ix = int(center[0])
    asym = u[0, ix, iy_hi, nyz // 2] - u[0, ix, iy_lo, nyz // 2]
    print(f"rotating sphere [{backend}]: max|u| (fluid)={np.abs(u_fluid).max():.4f}, "
          f"u_x asymmetry (Magnus) = {asym:+.5f}, finite={np.isfinite(u_fluid).all()}")
    return asym


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--nx", type=int, default=96)
    p.add_argument("--nyz", type=int, default=48)
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--collision", default="KBC", choices=["BGK", "KBC"])
    p.add_argument("--backend", default="jax", choices=["jax", "pallas"])
    args = p.parse_args()
    run(nx=args.nx, nyz=args.nyz, num_steps=args.steps, collision=args.collision, backend=args.backend)
