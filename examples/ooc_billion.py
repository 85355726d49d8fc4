"""Billion-cell lid-driven cavity on ONE chip: 1024^3 = 1.07e9 cells.

The reference's headline scale claim is "billions of cells"
(/root/reference/README.md:116, via its out-of-core tiles,
ooc/ooc_array.py:15-440).  This example runs it end to end on one
accelerator: the domain lives in host RAM as bf16 DEVIATION-form
populations (41 GB -- g = f - w, so 16-bit storage resolves the physics
instead of quantizing against the O(1) weights; see
kernels/fused_step.py io_form) plus ONE pre-packed int32 mask plane
(4.3 GB -- not 1 + q bytes/cell of raw masks), prepared entirely
host-side (experimental/ooc.py::prepare_fields_ooc -- no global device
array is ever created; slab masks rasterize on the in-process CPU
backend), and streams through the chip in ghost-padded x-slabs, 8 LBM
steps per round trip.

Per-sweep traffic at 16 tiles: 51 GB up (1.25x ghost amplification +
packed plane) + 41 GB down, so the sweep is bound by the host link; the
per-slab MB/s printed below measures it.

Run: python examples/ooc_billion.py [--n 1024] [--tiles 16] [--sweeps 1]
     (--n 512 for a quick self-check; n=1024 needs ~50 GB host RAM)
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))  # allow running as a script

import argparse
import json
import time

import numpy as np

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.experimental.ooc import OOCNSESolver


def build_solver(n, num_tiles, steps_per_sweep, u_lid=0.03, compression=None):
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32BF16)
    grid = grid_factory((n, n, n))
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
    return OOCNSESolver(stepper, num_tiles=num_tiles, steps_per_sweep=steps_per_sweep, compression=compression)


def mass_and_sanity(solver, n):
    """Streaming diagnostics (one plain-form f32 tile in memory at a time):
    total mass, max |rho - 1|, max |u|, finiteness."""
    total = 0.0
    max_drho = 0.0
    max_u = 0.0
    finite = True
    vs = xlb.DefaultConfig.velocity_set
    c = np.asarray(vs._c, dtype=np.float64)
    for i, tile in solver.plain_tiles():
        t = tile.astype(np.float64)
        rho = t.sum(axis=0)
        total += float(rho.sum())
        max_drho = max(max_drho, float(np.abs(rho - 1.0).max()))
        # velocity on the tile's mid-x plane only (full-u is another 3 passes)
        mid = t[:, t.shape[1] // 2]
        u = np.einsum("al,lyz->ayz", c, mid) / mid.sum(axis=0)
        max_u = max(max_u, float(np.abs(u).max()))
        finite = finite and bool(np.isfinite(t).all())
        del t
    return {"mean_rho": total / n**3, "max_abs_drho": max_drho,
            "max_abs_u_midplane": max_u, "finite": finite}


def run(n=1024, num_tiles=16, steps_per_sweep=8, sweeps=1, omega=1.6, compression=None, out=None):
    import jax
    import jax.numpy as jnp

    cells = n**3
    solver = build_solver(n, num_tiles, steps_per_sweep, compression=compression)
    gb = 19 * cells * 2 / 1e9
    print(f"OOC cavity {n}^3 = {cells/1e9:.2f}e9 cells: {gb:.1f} GB bf16 deviation-form "
          f"populations + {4 * cells / 1e9:.1f} GB packed masks, {num_tiles} x-slabs, "
          f"{steps_per_sweep} steps/sweep", flush=True)

    t0 = time.perf_counter()
    solver.prepare(host_side=True)
    print(f"host-side prepare: {time.perf_counter() - t0:.1f} s "
          f"(io_shifted={solver._io_shifted}, packed={solver._uses_packed})", flush=True)

    # warm the compile with device-resident zeros (no host transfer)
    g = steps_per_sweep
    slab = (19, n // num_tiles + 2 * g, n, n)
    jfn = solver._tile_fn()
    t0 = time.perf_counter()
    if solver._uses_packed:
        r = jfn(jnp.zeros(slab, jnp.bfloat16), jnp.zeros((1,) + slab[1:], jnp.int32),
                jnp.asarray(omega, jnp.float32))
    else:
        r = jfn(jnp.zeros(slab, jnp.bfloat16), jnp.zeros((1,) + slab[1:], jnp.uint8),
                jnp.zeros(slab, bool), jnp.asarray(omega, jnp.float32))
    jax.block_until_ready(r)
    del r
    print(f"window compile+warm (device-resident, no transfer): {time.perf_counter() - t0:.1f} s", flush=True)

    sweep_times = []
    for s in range(sweeps):
        t0 = time.perf_counter()
        solver.run(steps_per_sweep, omega, return_field=False)
        dt = time.perf_counter() - t0
        sweep_times.append(dt)
        print(f"sweep {s + 1}/{sweeps}: {dt:.1f} s  "
              f"({cells * steps_per_sweep / dt / 1e6:.1f} MLUPS sustained, "
              f"~{(2 * gb + 4 * cells / 1e9) * 1e3 / dt:.0f} MB/s link)", flush=True)

    diag = mass_and_sanity(solver, n)
    steps = sweeps * steps_per_sweep
    best = min(sweep_times)
    result = {
        "cells": cells,
        "steps": steps,
        "mlups_sustained": round(cells * steps_per_sweep / best / 1e6, 2),
        "sweep_seconds": [round(t, 1) for t in sweep_times],
        **{k: (v if isinstance(v, bool) else round(v, 8)) for k, v in diag.items()},
        "mass_conserved": bool(abs(diag["mean_rho"] - 1.0) < 1e-3 and diag["finite"]),
    }
    print(json.dumps(result), flush=True)
    if out:
        _pl.Path(out).write_text(json.dumps(result, indent=2) + "\n")
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--tiles", type=int, default=16)
    p.add_argument("--steps-per-sweep", type=int, default=8)
    p.add_argument("--sweeps", type=int, default=1)
    p.add_argument("--compress", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    run(n=args.n, num_tiles=args.tiles, steps_per_sweep=args.steps_per_sweep,
        sweeps=args.sweeps, compression="zstd" if args.compress else None, out=args.out)
