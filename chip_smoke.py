#!/usr/bin/env python
"""On-card smoke test of the LBM stepper.

Drives the main path -- the 3-D lid-driven cavity, D3Q19 BGK, at 256^3 --
through ``IncompressibleNavierStokesStepper.prepare_fields()`` and
``build_multi_step``, on the jnp tier (plain jax.numpy left to XLA) and the
PALLAS tier (the fused collide-stream kernel compiled through Pallas's
Triton route), under FP32FP32 and FP32BF16, then the other user paths at
small size.  Every check is an assertion: a failing phase ends the script
with a non-zero exit.

    python chip_smoke.py          # one GPU: phases 1-4
    python chip_smoke.py --four   # four GPUs: the sharded jnp-tier cavity only

Run without a GPU, the script exits non-zero before printing any result.
The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

LID = 0.05  # lid speed (lattice units)
OMEGA = 1.6
REPS = 5


def card_name_and_power():
    """The card as ``nvidia-smi`` names it, with its power limit."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script runs on an NVIDIA GPU")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0].strip()


CARD = None


def log(msg):
    print(f"[{CARD}] {msg}", flush=True)


def median_seconds(fn, reps=REPS):
    """Median wall time of ``fn()`` over ``reps`` runs, each ending in
    ``block_until_ready`` (one warm-up run first)."""
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def rate(cells, steps, seconds):
    return f"{seconds / steps * 1e3:.4f} ms/step, {cells * steps / seconds / 1e6:.1f} MLUPS"


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------
def _reset(velocity_set, policy):
    import xlb_tpu as xlb
    from xlb_tpu.boundary.registry import boundary_condition_registry
    from xlb_tpu.default_config import DefaultConfig

    DefaultConfig.reset()
    boundary_condition_registry.reset()
    xlb.init(velocity_set=velocity_set, default_backend=xlb.ComputeBackend.JAX, default_precision_policy=policy)


def cavity(shape, velocity_set, policy, collision="BGK", mesh_shape=None, devices=None):
    """Lid-driven cavity: bounce-back walls, equilibrium lid moving in +x.
    Returns (grid, bcs)."""
    import numpy as np

    from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu.grid import grid_factory

    _reset(velocity_set, policy)
    d = len(shape)
    if mesh_shape is None:
        mesh_shape = (1,) * d
    grid = grid_factory(shape, mesh_shape=mesh_shape, devices=devices)
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    faces = ("bottom", "left", "right", "front", "back") if d == 3 else ("bottom", "left", "right")
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in faces], axis=1), axis=1)
    lid = (LID,) + (0.0,) * (d - 1)
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=lid, indices=box_ne["top"])]
    return grid, bcs


def rotating_sphere(shape, policy):
    """Channel past a sphere spinning about z: halfway bounce-back with the
    per-voxel wall velocity omega x r (an aux-channel BC), equilibrium
    inlet, extrapolation outflow.  D3Q27 KBC, as the reference example."""
    import numpy as np

    from xlb_tpu.boundary import EquilibriumBC, ExtrapolationOutflowBC, FullwayBounceBackBC, HalfwayBounceBackBC
    from xlb_tpu.geometry import solid_voxel_indices, sphere_triangles, voxelize
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.velocity_set import D3Q27

    _reset(D3Q27(), policy)
    nx, ny, nz = shape
    grid = grid_factory(shape, mesh_shape=(1, 1, 1))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    center = np.array([nx / 4, ny / 2, nz / 2])
    radius = ny / 8
    sphere = solid_voxel_indices(voxelize(sphere_triangles(center=center, radius=radius, subdivisions=3), shape))

    def spin(coords):
        return np.cross(np.array([0.0, 0.0, 0.005])[None, :], (coords - center[:, None]).T).T

    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        HalfwayBounceBackBC(indices=sphere.tolist(), profile=spin),
    ]
    return grid, bcs


def steppers(grid, bcs, collision="BGK"):
    """A jnp-tier and a PALLAS-tier stepper over the same grid and BCs."""
    import xlb_tpu as xlb
    from xlb_tpu.models import IncompressibleNavierStokesStepper

    st_j = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    fields = st_j.prepare_fields()
    st_p = IncompressibleNavierStokesStepper(
        grid, boundary_conditions=bcs, collision_type=collision, compute_backend=xlb.ComputeBackend.PALLAS
    )
    st_p.has_solids = st_j.has_solids
    return st_j, st_p, fields


def mass(f):
    """Total mass: the density field summed on the host in float64 (a
    float32 sum over millions of cells would drift by more than the
    bound it checks)."""
    import jax.numpy as jnp
    import numpy as np

    return float(np.sum(np.asarray(jnp.sum(f.astype(jnp.float32), axis=0)), dtype=np.float64))


def max_abs_diff(a, b):
    import jax.numpy as jnp

    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def bf16_ulp(x):
    """One bf16 unit in the last place at magnitude ``x`` (8-bit significand)."""
    import numpy as np

    return float(2.0 ** (np.floor(np.log2(x)) - 7))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_device():
    import jax

    d = jax.devices()
    log(f"phase 1 device: platform {d[0].platform}, kind {d[0].device_kind}, count {len(d)}")


def phase_jnp_full_width():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import xlb_tpu as xlb
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.helper.initializers import initialize_from_macroscopic
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.ops import Macroscopic
    from xlb_tpu.velocity_set import D3Q19

    n, steps = 256, 200
    for policy in (xlb.PrecisionPolicy.FP32FP32, xlb.PrecisionPolicy.FP32BF16):
        grid, bcs = cavity((n, n, n), D3Q19(), policy)
        st, _, (f0, f1, bm, mm) = steppers(grid, bcs)
        run = st.build_multi_step(steps, donate=False)
        out, _ = run(f0, f1, bm, mm, OMEGA)
        assert bool(jnp.all(jnp.isfinite(out))), f"{policy.name}: non-finite populations"
        drift = abs(mass(out) - mass(f0)) / mass(f0)
        _, u = Macroscopic()(out.astype(jnp.float32))
        umax = float(jnp.max(jnp.abs(u)))
        secs = median_seconds(lambda: run(f0, f1, bm, mm, OMEGA))
        # the equilibrium lid imposes rho = 1, so the cavity exchanges mass
        # through it by design: its drift is reported, not bounded
        log(f"phase 2 jnp {n}^3 D3Q19 BGK cavity {policy.name}: {steps} steps, mass change {drift:.3e} "
            f"(open through the rho = 1 lid), max|u| {umax:.5f} (lid {LID}), {rate(n**3, steps, secs)}")
        assert umax <= 1.05 * LID, f"{policy.name}: max|u| {umax} exceeds 1.05 x lid speed"
        del f0, f1, out

        # closed system for the conservation check: the same box, periodic,
        # with a decaying shear wave u_x = LID sin(2 pi y / n)
        _reset(D3Q19(), policy)
        grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1))
        st = IncompressibleNavierStokesStepper(grid)
        _, f1, bm, mm = st.prepare_fields()
        u0 = np.zeros((3, n, n, n), np.float32)
        u0[0] = LID * np.sin(2 * np.pi * (np.arange(n) + 0.5) / n)[None, :, None]
        f0 = initialize_from_macroscopic(grid, st.velocity_set, st.precision_policy, np.ones((1, n, n, n), np.float32), u0)
        out, _ = st.build_multi_step(steps, donate=False)(f0, f1, bm, mm, OMEGA)
        assert bool(jnp.all(jnp.isfinite(out))), f"{policy.name}: non-finite populations (shear wave)"
        drift = abs(mass(out) - mass(f0)) / mass(f0)
        # bounded in f32; FP32BF16 rounds every population to 8 significant
        # bits each step on this tier, so its drift is reported
        f32 = policy == xlb.PrecisionPolicy.FP32FP32
        log(f"phase 2 jnp {n}^3 D3Q19 BGK periodic shear wave {policy.name}: {steps} steps, "
            f"relative mass drift {drift:.3e}" + (" < 1e-05" if f32 else ""))
        assert drift < 1e-5 or not f32, f"f32 relative mass drift {drift} >= 1e-5"
        del f0, f1, out

    # card against the CPU: the same jitted step, committed to each device
    n, steps = 64, 100
    grid, bcs = cavity((n, n, n), D3Q19(), xlb.PrecisionPolicy.FP32FP32)
    st, _, (f0, f1, bm, mm) = steppers(grid, bcs)
    run = st.build_multi_step(steps, donate=False)
    gpu_out, _ = run(f0, f1, bm, mm, OMEGA)
    cpu = jax.devices("cpu")[0]
    cpu_out, _ = run(*(jax.device_put(a, cpu) for a in (f0, f1, bm, mm)), OMEGA)
    assert list(cpu_out.devices())[0].platform == "cpu"
    diff = float(np.max(np.abs(np.asarray(gpu_out) - np.asarray(cpu_out))))
    tol = 1e-5
    log(f"phase 2 card vs CPU {n}^3 f32 after {steps} steps: max|df| {diff:.3e} <= {tol:g} "
        "(reason: sum order and FMA contraction differ; no matrix product is involved)")
    assert diff <= tol


def _jnp_shifted_reference(st_f32, steps):
    """jnp-tier window with the kernel's FP32BF16 storage: populations kept
    as bf16 deviations g = f - w between f32 steps."""
    import jax
    import jax.numpy as jnp

    w = jnp.asarray(st_f32.velocity_set._w, jnp.float32).reshape((-1,) + (1,) * st_f32.velocity_set.d)

    @jax.jit
    def run(f0, bm, mm, omega):
        def body(i, g):
            f = g.astype(jnp.float32) + w
            return (st_f32._step_pull(f, f, bm, mm, omega, i)[1] - w).astype(jnp.bfloat16)

        g = jax.lax.fori_loop(0, steps, body, (f0.astype(jnp.float32) - w).astype(jnp.bfloat16))
        return g.astype(jnp.float32) + w

    return run


def _kernel_vs_jnp(label, scene, collision, policy, steps_list=(10, 100), time_steps=100):
    """PALLAS tier against the jnp tier on the card: max|df| after each of
    ``steps_list`` and ms/step + MLUPS of both tiers.  ``scene(policy)``
    returns (grid, bcs)."""
    import jax.numpy as jnp
    import numpy as np

    import xlb_tpu as xlb
    from xlb_tpu.models import IncompressibleNavierStokesStepper

    bf16 = policy == xlb.PrecisionPolicy.FP32BF16
    if bf16:
        # FP32BF16 reference: f32 steps with BCs built under FP32FP32 (the
        # jnp BCs round their prescribed values to the store dtype), state
        # kept as bf16 deviations like the kernel's
        grid, bcs = scene(xlb.PrecisionPolicy.FP32FP32)
        st_ref = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
        _, _, bm_r, mm_r = st_ref.prepare_fields()
    grid, bcs = scene(policy)
    st_j, st_p, (f0, f1, bm, mm) = steppers(grid, bcs, collision)
    cells = int(np.prod(grid.shape))
    w = np.asarray(st_j.velocity_set._w).reshape((-1,) + (1,) * len(grid.shape))
    for steps in steps_list:
        win = st_p.build_multi_step(steps, donate=False)
        assert "pallas_triton" in st_p.active_tier and not win.interpret, st_p.active_tier
        out_p, _ = win(f0, f1, bm, mm, OMEGA)
        assert bool(jnp.all(jnp.isfinite(out_p))), f"{label}: non-finite kernel populations"
        if bf16:
            out_j = _jnp_shifted_reference(st_ref, steps)(f0, bm_r, mm_r, jnp.float32(OMEGA))
            dev = float(jnp.max(jnp.abs(out_j - w)))
            tol = 2 * bf16_ulp(dev)
            why = f"2 bf16 ulps of max|f - w| = {dev:.3e}; reference keeps the same bf16 deviation storage"
        else:
            out_j, _ = st_j.build_multi_step(steps, donate=False)(f0, f1, bm, mm, OMEGA)
            tol = 1e-5
            why = "f32 sum order and FMA contraction differ between the kernel and XLA"
        diff = max_abs_diff(out_p, out_j)
        log(f"phase 3 {label}: PALLAS vs jnp after {steps} steps: max|df| {diff:.3e} <= {tol:.3e} ({why})")
        assert diff <= tol, f"{label}: kernel differs from the jnp tier by {diff} after {steps} steps"
    win_p = st_p.build_multi_step(time_steps, donate=False)
    win_j = st_j.build_multi_step(time_steps, donate=False)
    t_p = median_seconds(lambda: win_p(f0, f1, bm, mm, OMEGA))
    t_j = median_seconds(lambda: win_j(f0, f1, bm, mm, OMEGA))
    log(f"phase 3 {label}: PALLAS [{st_p.active_tier}] {rate(cells, time_steps, t_p)}; "
        f"jnp {rate(cells, time_steps, t_j)}")


def phase_kernel_vs_jnp():
    from functools import partial

    import xlb_tpu as xlb
    from xlb_tpu.velocity_set import D2Q9, D3Q19, D3Q27

    f32 = xlb.PrecisionPolicy.FP32FP32
    for policy in (f32, xlb.PrecisionPolicy.FP32BF16):
        scene = lambda p: cavity((256, 256, 256), D3Q19(), p)  # noqa: E731
        _kernel_vs_jnp(f"256^3 D3Q19 BGK {policy.name}", scene, "BGK", policy)
    _kernel_vs_jnp("2048^2 D2Q9 BGK FP32FP32", lambda p: cavity((2048, 2048), D2Q9(), p), "BGK", f32)
    _kernel_vs_jnp("128^3 D3Q27 KBC FP32FP32", lambda p: cavity((128, 128, 128), D3Q27(), p), "KBC", f32)
    _kernel_vs_jnp("192x96x96 D3Q27 KBC rotating sphere (aux-channel wall velocity)",
                   partial(rotating_sphere, (192, 96, 96)), "KBC", f32)


def phase_multires():
    import jax.numpy as jnp

    import xlb_tpu as xlb
    from xlb_tpu.grid.multires import MultiresGrid
    from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper
    from xlb_tpu.velocity_set import D3Q19

    _reset(D3Q19(), xlb.PrecisionPolicy.FP32FP32)
    n = 96
    grid = MultiresGrid((n, n, n), boxes=[((0, 0, 0), (n, n, n))])
    st = MultiresIncompressibleNavierStokesStepper(grid)
    fs, _, bms, mms = st.prepare_fields()
    # smooth density wave on both levels
    fs = [f * (1.0 + 0.01 * jnp.sin(2 * jnp.pi * (jnp.arange(f.shape[1]) + 0.5) / f.shape[1]))[None, :, None, None]
          for f in fs]
    steps = 4
    run = st.build_window(steps, donate=False)
    out = run(fs, bms, mms, OMEGA)
    assert all(bool(jnp.all(jnp.isfinite(f))) for f in out), "multires: non-finite populations"
    # the finest box covers the domain, so its cells (1/8 coarse volume
    # each) carry the whole mass
    drift = abs(mass(out[0]) - mass(fs[0])) / mass(fs[0])
    updates = sum(int(jnp.size(f[0])) * 2 ** (grid.num_levels - 1 - l) for l, f in enumerate(fs))
    secs = median_seconds(lambda: run(fs, bms, mms, OMEGA))
    log(f"phase 4 multires 2-level 192^3/96^3 jnp: {steps} coarse steps, mass drift {drift:.3e} < 2e-3 "
        "(bound of tests/models/test_multires.py: the explosion is zeroth order and the ghost ring clamps at "
        f"the box edge), {secs / steps * 1e3:.3f} ms/coarse step, {updates * steps / secs / 1e6:.1f} MLUPS (weighted)")
    assert drift < 2e-3, f"multires relative mass drift {drift} >= 2e-3"


def phase_ibm():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import xlb_tpu as xlb
    from xlb_tpu.geometry import sphere_triangles
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.helper.ibm_helper import marker_window, prepare_immersed_boundary
    from xlb_tpu.helper.initializers import initialize_from_macroscopic
    from xlb_tpu.models.ibm import IBMStepper
    from xlb_tpu.velocity_set import D3Q19

    nx, nyz, steps = 64, 32, 20  # examples/ibm/flow_past_sphere_ibm.py defaults
    outs = {}
    for transfer in ("dense", "scatter"):
        _reset(D3Q19(), xlb.PrecisionPolicy.FP32FP32)
        grid = grid_factory((nx, nyz, nyz), mesh_shape=(1, 1, 1))
        radius = nyz / 6
        tris = sphere_triangles(center=(nx / 3, nyz / 2, nyz / 2), radius=radius, subdivisions=3)
        vertices, areas, velocities = prepare_immersed_boundary(tris, max_lagrangian_spacing=0.8)
        st = IBMStepper(grid, ibm_max_iterations=4, ibm_window=marker_window(vertices), ibm_transfer=transfer)
        _, f1, bm, mm = st.prepare_fields()
        u0 = np.zeros((3, nx, nyz, nyz), np.float32)
        u0[0] = 0.03
        f0 = initialize_from_macroscopic(grid, st.velocity_set, st.precision_policy,
                                         np.ones((1, nx, nyz, nyz), np.float32), u0)
        v, a, uw = jnp.asarray(vertices), jnp.asarray(areas), jnp.asarray(velocities)

        @jax.jit
        def window(f0, f1):
            def body(t, carry):
                f0, f1 = carry
                f0, f1, _ = st(f0, f1, v, a, uw, bm, mm, 0.8, t)
                return (f1, f0)

            return jax.lax.fori_loop(0, steps, body, (f0, f1))

        out, _ = window(f0, f1)
        assert bool(jnp.all(jnp.isfinite(out))), f"IBM {transfer}: non-finite populations"
        drift = abs(mass(out) - mass(f0)) / mass(f0)
        secs = median_seconds(lambda: window(f0, f1))
        outs[transfer] = out
        log(f"phase 4 IBM {nx}x{nyz}x{nyz}, {len(vertices)} markers, transfer {transfer}: "
            f"mass drift {drift:.3e}, {rate(nx * nyz * nyz, steps, secs)}")
        assert drift < 1e-5, f"IBM {transfer}: relative mass drift {drift} >= 1e-5"
    diff = max_abs_diff(outs["dense"], outs["scatter"])
    log(f"phase 4 IBM dense vs scatter after {steps} steps: max|df| {diff:.3e} <= 1e-5 "
        "(reason: the two transfer forms sum the same Peskin weights in different orders)")
    assert diff <= 1e-5


def phase_ooc():
    import numpy as np

    import xlb_tpu as xlb
    from xlb_tpu.experimental.ooc import OOCNSESolver
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.velocity_set import D3Q19

    shape, tiles, g = (512, 256, 256), 2, 2
    grid, bcs = cavity(shape, D3Q19(), xlb.PrecisionPolicy.FP32FP32)
    st = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = st.prepare_fields()
    ref, _ = st.build_multi_step(g, donate=False)(f0, f1, bm, mm, OMEGA)
    ref = np.asarray(ref)
    del f0, f1
    solver = OOCNSESolver(st, num_tiles=tiles, steps_per_sweep=g, tier="fused").prepare()
    slab_gb = 19 * 4 * (shape[0] // tiles + 2 * g) * shape[1] * shape[2] / 1e9
    t0 = time.perf_counter()
    out = solver.run(g, omega=OMEGA)
    secs = time.perf_counter() - t0
    diff = float(np.max(np.abs(out - ref)))
    drift = abs(float(out.sum(dtype=np.float64)) - float(ref.sum(dtype=np.float64))) / float(ref.sum(dtype=np.float64))
    log(f"phase 4 out-of-core {shape} D3Q19 f32, {tiles} slabs of {slab_gb:.2f} GB, fused tier: "
        f"{g} steps in {secs:.3f} s (first sweep, compile included), max|df| vs in-core jnp {diff:.3e} <= 1e-5, "
        f"mass difference {drift:.3e}")
    assert slab_gb > 1.0 and np.isfinite(out).all() and diff <= 1e-5


def phase_grad():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import xlb_tpu as xlb
    from xlb_tpu.velocity_set import D3Q19

    n, steps = 64, 4
    grid, bcs = cavity((n, n, n), D3Q19(), xlb.PrecisionPolicy.FP32FP32)
    st_j, st_p, (f0, f1, bm, mm) = steppers(grid, bcs)
    win_p = st_p.build_multi_step(steps, donate=False)
    win_j = st_j.build_multi_step(steps, donate=False)
    assert "pallas_triton" in st_p.active_tier and not win_p.interpret

    def loss(win):
        return lambda f, om: jnp.sum(win(f, f, bm, mm, om)[0] ** 2)

    gf_p, go_p = jax.grad(loss(win_p), argnums=(0, 1))(f0, jnp.float32(OMEGA))
    gf_j, go_j = jax.grad(loss(win_j), argnums=(0, 1))(f0, jnp.float32(OMEGA))
    rel_f = max_abs_diff(gf_p, gf_j) / float(jnp.max(jnp.abs(gf_j)))
    rel_o = abs(float(go_p) - float(go_j)) / max(abs(float(go_j)), 1e-30)
    log(f"phase 4 jax.grad through a {steps}-step PALLAS window, {n}^3: d/df rel diff {rel_f:.3e} <= 1e-4, "
        f"d/domega {float(go_p):.6e} vs jnp {float(go_j):.6e} (rel {rel_o:.3e} <= 2e-3; "
        "reason: cotangents agree to roundoff, the omega sum over every voxel cancels)")
    assert np.isfinite(float(go_p)) and rel_f <= 1e-4 and rel_o <= 2e-3


def phase_four():
    """GSPMD jnp-tier cavity sharded over a (4, 1, 1) mesh against the same
    domain on one card."""
    import jax
    import jax.numpy as jnp

    import xlb_tpu as xlb
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.velocity_set import D3Q19

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
    shape, steps = (512, 512, 256), 50
    cells = 512 * 512 * 256
    results = {}
    for label, mesh_shape, devs in (("4 cards (4,1,1)", (4, 1, 1), devices[:4]), ("1 card", (1, 1, 1), devices[:1])):
        grid, bcs = cavity(shape, D3Q19(), xlb.PrecisionPolicy.FP32FP32, mesh_shape=mesh_shape, devices=devs)
        st = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
        f0, f1, bm, mm = st.prepare_fields()
        run = st.build_multi_step(steps, donate=False)
        out, _ = run(f0, f1, bm, mm, OMEGA)
        assert bool(jnp.all(jnp.isfinite(out)))
        secs = median_seconds(lambda: run(f0, f1, bm, mm, OMEGA), reps=3)
        log(f"phase 5 {shape} D3Q19 BGK f32 jnp tier on {label}: sharding {out.sharding.spec}, "
            f"{rate(cells, steps, secs)}")
        results[label] = jax.device_put(out, devices[0])
        del f0, f1, bm, mm, out
    diff = max_abs_diff(results["4 cards (4,1,1)"], results["1 card"])
    log(f"phase 5 sharded vs single card after {steps} steps: max|df| {diff:.3e} <= 1e-5 "
        "(reason: the same XLA step partitioned; halo exchange moves values exactly)")
    assert diff <= 1e-5


def main():
    global CARD
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true", help="run only the four-card sharded cavity")
    args = parser.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.devices()[0].platform!r}); nothing was run", file=sys.stderr)
        return 1
    import xlb_tpu

    if os.path.dirname(os.path.dirname(os.path.abspath(xlb_tpu.__file__))) != ROOT:
        print(f"chip_smoke: xlb_tpu imported from {xlb_tpu.__file__}, not this checkout", file=sys.stderr)
        return 1
    from xlb_tpu.utils import tiers

    CARD = card_name_and_power()
    log(f"compile cache: {tiers.enable_compile_cache(ROOT)}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_device()
        phase_jnp_full_width()
        phase_kernel_vs_jnp()
        phase_multires()
        phase_ibm()
        phase_ooc()
        phase_grad()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
