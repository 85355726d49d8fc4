"""MLUPS benchmark CLI (reference examples/performance/mlups_3d.py:18-120).

3D lid-driven cavity; sweeps backend tier (jax / pallas), velocity set,
collision model, and cube size; reports MLUPS with warmup + repetitions.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script


import argparse
import time

import numpy as np


def benchmark(cube_edge, num_steps, backend_tier, velocity_set_name, collision, precision, warmup, reps):
    import jax

    import xlb_tpu as xlb
    from xlb_tpu import velocity_set as vsets
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC

    xlb.init(
        velocity_set=getattr(vsets, velocity_set_name)(),
        default_backend=xlb.ComputeBackend.PALLAS if backend_tier == "pallas" else xlb.ComputeBackend.JAX,
        default_precision_policy=xlb.PrecisionPolicy[precision],
    )
    n = cube_edge
    grid = grid_factory((n, n, n))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["top"]),
    ]
    # PowerLawBGK needs a consistency; mildly shear-thinning defaults for benching
    params = {"consistency": 0.05, "power_index": 0.8} if collision == "PowerLawBGK" else None
    stepper = IncompressibleNavierStokesStepper(
        grid, boundary_conditions=bcs, collision_type=collision, collision_params=params
    )
    f0, f1, bc_mask, missing_mask = stepper.prepare_fields()
    # one jitted window per repetition; 16-bit policies keep deviation-form
    # storage inside PALLAS windows
    run_window = stepper.build_multi_step(num_steps, donate=False)

    omega = 1.9
    for _ in range(max(1, warmup)):
        jax.block_until_ready(run_window(f0, f1, bc_mask, missing_mask, omega))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run_window(f0, f1, bc_mask, missing_mask, omega))
        times.append(time.perf_counter() - t0)
    secs = float(np.median(times))

    mlups = n**3 * num_steps / secs / 1e6
    print(
        f"{velocity_set_name} {collision} {precision} tier={stepper.active_tier} {n}^3: "
        f"{mlups:.1f} MLUPS ({secs / num_steps * 1e3:.3f} ms/step, median of {reps} reps) on {jax.devices()[0].device_kind}"
    )
    return mlups


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="3D lid-driven cavity MLUPS benchmark")
    p.add_argument("cube_edge", type=int, nargs="?", default=256)
    p.add_argument("num_steps", type=int, nargs="?", default=50)
    p.add_argument("--backend", choices=["jax", "pallas"], default="pallas")
    p.add_argument("--velocity-set", choices=["D3Q19", "D3Q27"], default="D3Q19")
    p.add_argument("--collision", choices=["BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"], default="BGK")
    p.add_argument("--precision", default="FP32FP32")
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    benchmark(
        args.cube_edge,
        args.num_steps,
        args.backend,
        args.velocity_set,
        args.collision,
        args.precision,
        args.warmup,
        args.reps,
    )
