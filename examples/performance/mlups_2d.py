"""2D MLUPS benchmark CLI (companion to mlups_3d.py).

2D lid-driven cavity, D2Q9, on the jnp tier or the fused PALLAS window.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import argparse
import time

import numpy as np


def benchmark(n, num_steps, backend_tier, precision, warmup, reps):
    import jax

    import xlb_tpu as xlb
    from xlb_tpu.velocity_set import D2Q9
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC

    xlb.init(
        velocity_set=D2Q9(),
        default_backend=xlb.ComputeBackend.PALLAS if backend_tier == "pallas" else xlb.ComputeBackend.JAX,
        default_precision_policy=xlb.PrecisionPolicy[precision],
    )
    grid = grid_factory((n, n))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bc_mask, missing_mask = stepper.prepare_fields()
    run_window = stepper.build_multi_step(num_steps, donate=False)

    omega = 1.6
    for _ in range(max(1, warmup)):
        jax.block_until_ready(run_window(f0, f1, bc_mask, missing_mask, omega))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run_window(f0, f1, bc_mask, missing_mask, omega))
        times.append(time.perf_counter() - t0)
    secs = float(np.median(times))

    mlups = n * n * num_steps / secs / 1e6
    print(
        f"D2Q9 BGK {precision} tier={stepper.active_tier} {n}^2: "
        f"{mlups:.1f} MLUPS ({secs / num_steps * 1e3:.3f} ms/step, median of {reps} reps) on {jax.devices()[0].device_kind}"
    )
    return mlups


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="2D lid-driven cavity MLUPS benchmark")
    p.add_argument("edge", type=int, nargs="?", default=2048)
    p.add_argument("num_steps", type=int, nargs="?", default=500)
    p.add_argument("--backend", choices=["jax", "pallas"], default="pallas")
    p.add_argument("--precision", default="FP32FP32")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    benchmark(args.edge, args.num_steps, args.backend, args.precision, args.warmup, args.reps)
