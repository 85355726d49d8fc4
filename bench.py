#!/usr/bin/env python
"""MLUPS benchmark: 3D lid-driven cavity, D3Q19, BGK, on one NVIDIA GPU.

Protocol parity with the reference harness
(reference examples/performance/mlups_3d.py:200-268): cube domain,
EquilibriumBC lid + FullwayBounceBackBC walls, warmup then timed
repetitions, MLUPS = cells * steps / seconds / 1e6.  Each repetition is one
jitted 200-step window ending in ``block_until_ready``; the median of five
is reported.

Prints ONE JSON line: the headline ``value`` is the PALLAS tier (fused
Triton-route kernel) under FP32BF16 (f32 compute, bf16 deviation-form
storage); the same line carries FP32FP32 and the jnp tier for both
policies, the multires cells (jnp tier), the device and the card's name
and power limit.  Exits non-zero without a GPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _median_seconds(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile + warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _measure(precision, backend, n, iters, reps):
    import xlb_tpu as xlb
    from xlb_tpu.velocity_set import D3Q19
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu.boundary.registry import boundary_condition_registry
    from xlb_tpu.default_config import DefaultConfig

    DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=D3Q19(), default_backend=backend, default_precision_policy=precision)
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
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="BGK")
    f0, f1, bc_mask, missing_mask = stepper.prepare_fields()
    run_window = stepper.build_multi_step(iters, donate=False)
    secs = _median_seconds(lambda: run_window(f0, f1, bc_mask, missing_mask, 1.9), reps)
    return n**3 * iters / secs / 1e6, stepper.active_tier


def main():
    import jax

    dev = jax.devices()
    if dev[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev[0].platform!r}); nothing was measured", file=sys.stderr)
        return 1

    import xlb_tpu as xlb
    from xlb_tpu.utils import tiers

    tiers.enable_compile_cache(HERE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    n, iters, reps = 256, 200, 5
    pp, cb = xlb.PrecisionPolicy, xlb.ComputeBackend
    record = {"metric": f"MLUPS lid-driven cavity {n}^3 D3Q19 BGK FP32BF16 (PALLAS tier)", "unit": "MLUPS"}
    for policy in (pp.FP32BF16, pp.FP32FP32):
        for backend in (cb.PALLAS, cb.JAX):
            mlups, tier = _measure(policy, backend, n, iters, reps)
            record[f"{backend.name.lower()}_{policy.name.lower()}_mlups"] = mlups
            record[f"{backend.name.lower()}_tier"] = tier
    record["value"] = record["pallas_fp32bf16_mlups"]

    # weighted-update MLUPS of the refined cavity (jnp tier): the 2-level
    # fully refined cavity (192^3 fine / 96^3 coarse) and a 3-level
    # half-box pyramid
    sys.path.insert(0, os.path.join(HERE, "examples", "performance"))
    from mlups_3d_multires import run as mres_run

    record["multires_mlups"] = mres_run(coarse_edge=96, box_frac=1.0)
    record["multires3_halfbox_mlups"] = mres_run(coarse_edge=96, box_frac=0.5, levels=3)
    record["device"] = {"platform": dev[0].platform, "kind": dev[0].device_kind, "count": len(dev), "card": card}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
