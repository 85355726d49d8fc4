"""Multires MLUPS benchmark (reference examples/performance/
mlups_3d_multires.py): per-level weighted lattice updates per second for a
refined cavity."""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import argparse
import time

import numpy as np

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid.multires import MultiresGrid
from xlb_tpu.helper.simulation_manager import MultiresSimulationManager
from xlb_tpu.mres_perf_optimization_type import MresPerfOptimizationType


def run(coarse_edge=64, box_frac=0.5, levels=2, num_coarse_steps=20, reps=5,
        mres_perf="naive_collide_stream", precision="FP32FP32", mesh_shape=None):
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=getattr(xlb.PrecisionPolicy, precision))

    mesh = None
    if mesh_shape is not None and int(np.prod(mesh_shape)) > 1:
        import jax
        from jax.sharding import Mesh

        px, py = mesh_shape
        mesh = Mesh(np.array(jax.devices()[: px * py]).reshape(px, py), ("x", "y"))

    n = coarse_edge
    boxes = []
    shape = (n, n, n)
    parent = shape
    for _ in range(levels - 1):
        extent = tuple(min(p, max(8, int(p * box_frac) // 8 * 8)) for p in parent)
        origin = tuple((s - e) // 2 for s, e in zip(parent, extent))
        boxes.append((origin, extent))
        parent = tuple(2 * e for e in extent)
    grid = MultiresGrid(shape, boxes=boxes)

    strategy = MresPerfOptimizationType.from_string(mres_perf)
    sim = MultiresSimulationManager(grid, omega_finest=1.6, mres_perf_opt=strategy, mesh=mesh)
    sim.run(num_coarse_steps, window=num_coarse_steps)  # compile the window + warm up

    # per-level weighted updates per coarse step: level l runs 2^(L-1-l)
    # sub-steps of its own cell count
    L = grid.num_levels
    updates_per_coarse = 0
    for l, lvl in enumerate(grid.levels):
        cells = int(np.prod(lvl.shape))
        updates_per_coarse += cells * 2 ** (L - 1 - l)

    import jax

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(sim.run(num_coarse_steps, window=num_coarse_steps))  # one dispatch
        times.append(time.perf_counter() - t0)

    mlups = updates_per_coarse * num_coarse_steps / float(np.median(times)) / 1e6
    print(f"multires {L} levels, coarse {n}^3, {strategy.value}, {precision}: {mlups:.1f} MLUPS "
          f"({updates_per_coarse / 1e6:.2f}M updates/coarse step)")
    return mlups


if __name__ == "__main__":
    parser = MresPerfOptimizationType.build_arg_parser(argparse.ArgumentParser())
    parser.add_argument("--coarse-edge", type=int, default=64)
    parser.add_argument("--box-frac", type=float, default=0.5,
                        help="refined-box edge as a fraction of the parent (1.0 = full-domain refinement)")
    parser.add_argument("--levels", type=int, default=2)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--precision", default="FP32FP32", help="PrecisionPolicy name")
    parser.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("PX", "PY"),
                        help="device-mesh shape: shard every level over (x, y); GSPMD partitions the step")
    args = parser.parse_args()
    run(coarse_edge=args.coarse_edge, box_frac=args.box_frac, levels=args.levels,
        num_coarse_steps=args.steps, mres_perf=args.mres_perf_optimization,
        precision=args.precision, mesh_shape=args.mesh)
