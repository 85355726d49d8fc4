"""Out-of-core lid-driven cavity: the domain lives in host RAM and streams
through the device in ghost-padded x-slabs
(reference examples/out_of_core/lid_driven_cavity.py).

With ``--n 768`` the populations alone are ~34 GB, yet the sweep only
ever holds one padded slab (plus its double-buffered transfer) on
device.  Each sweep advances
``steps_per_sweep`` LBM steps per host<->device round trip; host writeback
overlaps the next slab's compute (see xlb_tpu/experimental/ooc.py).
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # allow running as a script

import argparse
import time

import numpy as np

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.experimental.ooc import OOCNSESolver


def run(n=256, num_tiles=4, steps=40, steps_per_sweep=4, u_lid=0.03, omega=1.7, compression=None):
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = grid_factory((n, n, n))
    gb = 19 * n**3 * 4 / 1e9
    print(f"OOC cavity {n}^3: populations {gb:.1f} GB host-resident, "
          f"{num_tiles} x-slabs ({gb / num_tiles:.1f} GB padded slab on device), "
          f"{steps_per_sweep} steps/sweep")

    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    stepper = IncompressibleNavierStokesStepper(
        grid,
        boundary_conditions=[
            FullwayBounceBackBC(indices=walls.tolist()),
            EquilibriumBC(rho=1.0, u=(u_lid, 0.0, 0.0), indices=box_ne["top"]),
        ],
    )
    solver = OOCNSESolver(stepper, num_tiles=num_tiles, steps_per_sweep=steps_per_sweep,
                          compression=compression).prepare()
    if compression:
        raw = 19 * n**3 * 4 + n**3 + 19 * n**3  # f (f32) + bc_mask (u8) + missing_mask (bool)
        comp = solver.f.compressed_nbytes() + solver.bc_mask.compressed_nbytes() + solver.missing_mask.compressed_nbytes()
        print(f"zstd tiles: {raw / comp:.1f}x compression at rest ({comp / 1e9:.2f} GB host RAM)")

    t0 = time.perf_counter()
    f = solver.run(steps, omega)
    dt = time.perf_counter() - t0
    mlups = n**3 * steps / dt / 1e6
    # diagnose on the mid-z plane only (no second pass over the host array)
    vs = xlb.DefaultConfig.velocity_set
    plane = f[:, :, :, n // 2].astype(np.float64)
    rho = plane.sum(axis=0)
    u = np.einsum("al,lxy->axy", vs._c.astype(np.float64), plane) / rho
    print(f"{steps} steps in {dt:.1f} s ({mlups:.1f} MLUPS through host RAM); "
          f"mid-plane max|u|={np.abs(u).max():.4f}, mean rho={rho.mean():.5f}, finite={np.isfinite(u).all()}")
    return u


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--tiles", type=int, default=4)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--steps-per-sweep", type=int, default=4)
    p.add_argument("--compress", action="store_true", help="hold tiles byte-shuffle+zstd compressed in host RAM")
    args = p.parse_args()
    run(n=args.n, num_tiles=args.tiles, steps=args.steps, steps_per_sweep=args.steps_per_sweep,
        compression="zstd" if args.compress else None)
