"""Parity tests: fused Pallas collide-stream kernel vs the pure-jnp tier.

The jnp tier is the correctness oracle (SURVEY.md §7 design delta 1); the
fused kernel must match it to float32 roundoff.  Runs in Pallas interpreter
mode on CPU (the Triton route's interpret mode).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.velocity_set import D3Q19, D3Q27
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC, DoNothingBC
from xlb_tpu.kernels.fused_step import build_fused_step, pack_masks


def _cavity(vs_cls, n=16, collision="BGK", halfway=False):
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    wall_cls = HalfwayBounceBackBC if halfway else FullwayBounceBackBC
    bcs = [wall_cls(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"])]
    params = {"consistency": 0.05, "power_index": 0.8} if collision == "PowerLawBGK" else None
    stepper = IncompressibleNavierStokesStepper(
        grid, boundary_conditions=bcs, collision_type=collision, collision_params=params
    )
    return stepper


@pytest.mark.parametrize("block", [None, 256])
@pytest.mark.parametrize("collision", ["BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"])
def test_fused_matches_reference_step(collision, block):
    """``block=None``: one program covers the domain; 256: sixteen
    programs, each gathering across block boundaries."""
    vs = init_env(D3Q27 if collision == "KBC" else D3Q19)
    stepper = _cavity(D3Q27 if collision == "KBC" else D3Q19, collision=collision)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, block=block, interpret=True)

    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"{collision}: fused kernel diverges from jnp tier by {diff}"


@pytest.mark.fast
def test_fused_halfway_and_do_nothing():
    vs = init_env(D3Q19)
    stepper = _cavity(D3Q19, halfway=True)
    # add an outlet face with DoNothing
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.7, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.7, t)
        ga, gb = gb, ga
    assert float(jnp.abs(fa - ga).max()) < 5e-6


def test_fused_forced_channel_matches_reference_step():
    """Exact-difference body force in the fused kernel matches the jnp
    tier's ForcedCollision (reference exact_difference_force.py:14-76)."""
    vs = init_env(D3Q19)
    grid = grid_factory((16, 16, 16), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    stepper = IncompressibleNavierStokesStepper(
        grid,
        boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())],
        force_vector=np.array([1e-4, 0.0, 0.0]),
    )
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    assert float(jnp.abs(fa - ga).max()) < 5e-6
    # the force must actually accelerate the flow
    from xlb_tpu.ops import Macroscopic

    _, u = Macroscopic()(ga.astype(jnp.float32))
    assert float(jnp.mean(u[0][:, :, 1:-1])) > 1e-5


def test_fused_spatial_moving_wall_matches_reference_step():
    """A rotating-sphere-style spatial wall-velocity profile runs in the
    fused kernel via the aux prescribed-velocity field (VERDICT item:
    rotating_sphere_3d under ComputeBackend.PALLAS)."""
    from xlb_tpu.geometry import sphere_triangles, voxelize, solid_voxel_indices

    vs = init_env(D3Q19)
    n = 24
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    center = np.array([n / 2, n / 2, n / 2])
    tris = sphere_triangles(center=center, radius=4.0, subdivisions=2)
    sphere_idx = solid_voxel_indices(voxelize(tris, grid.shape))

    def rotation_profile(coords):
        r = coords - center[:, None]
        return np.cross(np.array([0.0, 0.0, 0.02])[None, :], r.T).T

    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["left"]),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["right"]),
        HalfwayBounceBackBC(indices=sphere_idx.tolist(), profile=rotation_profile),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"spatial moving wall: fused diverges from jnp tier by {diff}"
    # the wall must actually rotate the near-surface fluid (nonzero swirl)
    from xlb_tpu.ops import Macroscopic

    _, u = Macroscopic()(ga)
    assert float(jnp.abs(u[1]).max()) > 1e-4


@pytest.mark.fast
def test_pack_masks_roundtrip():
    """q <= 19: the raw uint8 cell type rides bits 19..26 untouched --
    the full 253-id reference space fits the fused tier."""
    vs = init_env(D3Q19)
    rng = np.random.default_rng(0)
    miss = rng.random((vs.q, 4, 4, 8)) > 0.7
    bc = (rng.integers(0, 254, (1, 4, 4, 8))).astype(np.uint8)  # full id space
    bc[0, 0, 0, 0] = 255  # solid special, stored raw
    bc[0, 1, 0, 0] = 254  # SFV special, stored raw
    packed = np.asarray(pack_masks(jnp.asarray(bc), jnp.asarray(miss)))
    assert (packed >= 0).all(), "q <= 19 packing must keep the sign bit clear"
    bc_ids = (packed >> 19) & 0xFF
    np.testing.assert_array_equal(bc_ids, bc[0].astype(np.int32))
    unpacked = np.stack([(packed >> l) & 1 for l in range(vs.q)]).astype(bool)
    np.testing.assert_array_equal(unpacked, miss)


@pytest.mark.fast
def test_pack_masks_roundtrip_d3q27():
    """D3Q27 keeps the legacy 5-bit id field in bits 27..31 with the
    specials remapped (254 -> 30, 255 -> 31)."""
    from xlb_tpu.velocity_set import D3Q27

    vs = init_env(D3Q27)
    rng = np.random.default_rng(1)
    miss = rng.random((vs.q, 4, 4, 8)) > 0.7
    bc = (rng.integers(0, 4, (1, 4, 4, 8))).astype(np.uint8)
    bc[0, 0, 0, 0] = 255
    bc[0, 1, 0, 0] = 254
    packed = np.asarray(pack_masks(jnp.asarray(bc), jnp.asarray(miss)))
    bc_ids = (packed >> 27) & 31
    expected = bc[0].astype(np.int32)
    expected[expected == 254] = 30
    expected[expected == 255] = 31
    np.testing.assert_array_equal(bc_ids, expected)
    unpacked = np.stack([(packed >> l) & 1 for l in range(vs.q)]).astype(bool)
    np.testing.assert_array_equal(unpacked, miss)


@pytest.mark.fast
def test_fused_rejects_unsupported_bc():
    """A BC class the kernel has no epilogue for raises an actionable
    NotImplementedError from the spec converter."""
    vs = init_env(D3Q19)
    from xlb_tpu.boundary.base import BoundaryCondition, ImplementationStep
    from xlb_tpu.kernels.fused_step import bc_to_spec

    class ExoticBC(BoundaryCondition):
        def __init__(self):
            super().__init__(ImplementationStep.STREAMING, vs, None, None, indices=[[0], [0], [0]])

    with pytest.raises(NotImplementedError, match="ExoticBC"):
        bc_to_spec(ExoticBC(), vs)


def test_fused_extrapolation_outflow():
    """Channel with equilibrium inlet + extrapolation outflow: fused kernel
    (incl. post-collision aux staging) matches the jnp oracle."""
    import jax
    from xlb_tpu.boundary import ExtrapolationOutflowBC, EquilibriumBC, FullwayBounceBackBC

    vs = init_env(D3Q19)
    n = 16
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(5):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"extrapolation outflow fused diverges by {diff}"


@pytest.mark.parametrize("bc_cls_name,bc_type", [("ZouHeBC", "velocity"), ("ZouHeBC", "pressure"), ("RegularizedBC", "velocity")])
def test_fused_zouhe_regularized(bc_cls_name, bc_type):
    """Zou-He / regularized inlets match the jnp oracle inside the fused kernel."""
    import jax
    from xlb_tpu.boundary import ZouHeBC, RegularizedBC, FullwayBounceBackBC, DoNothingBC

    vs = init_env(D3Q19)
    n = 16
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    bc_cls = {"ZouHeBC": ZouHeBC, "RegularizedBC": RegularizedBC}[bc_cls_name]
    value = (0.02, 0.0, 0.0) if bc_type == "velocity" else 1.01
    inlet = bc_cls(bc_type, prescribed_value=value, indices=box_ne["left"])
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), inlet, DoNothingBC(indices=box_ne["right"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(4):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"{bc_cls_name}/{bc_type}: fused diverges by {diff}"


def test_fused_step_is_differentiable():
    """grad through the fused (Pallas) step equals grad through the jnp tier
    via the custom_vjp pairing."""
    import jax

    vs = init_env(D3Q19)
    stepper = _cavity(D3Q19, n=16)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    def loss_fused(f, omega):
        _, out = fused(f, f, bm, mm, omega, 0)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def loss_jnp(f, omega):
        _, out = stepper(f, f, bm, mm, omega, 0)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_fused = jax.grad(loss_fused, argnums=(0, 1))(f0, jnp.float32(1.5))
    g_jnp = jax.grad(loss_jnp, argnums=(0, 1))(f0, jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(g_fused[0]), np.asarray(g_jnp[0]), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(float(g_fused[1]), float(g_jnp[1]), rtol=1e-4)


@pytest.mark.parametrize("collision", ["BGK", "KBC"])
def test_fused_adjoint_sweep_matches_jnp_vjp(collision):
    """The fused step's custom_vjp backward (the jnp tier's VJP) matches
    jax.grad of the jnp tier.  Halfway walls exercise the f_pre term."""
    import jax

    vs_cls = D3Q27 if collision == "KBC" else D3Q19
    init_env(vs_cls)
    shape = (16, 12, 10)
    grid = grid_factory(shape, mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [
        HalfwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.03, 0.01, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type=collision)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    def loss_fused(f, omega):
        _, out = fused(f, f, bm, mm, omega, 0)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def loss_jnp(f, omega):
        _, out = stepper(f, f, bm, mm, omega, 0)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    g_fused = jax.grad(loss_fused, argnums=(0, 1))(f0, jnp.float32(1.5))
    g_jnp = jax.grad(loss_jnp, argnums=(0, 1))(f0, jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(g_fused[0]), np.asarray(g_jnp[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(g_fused[1]), float(g_jnp[1]), rtol=2e-2, atol=1e-5)


def test_fused_adjoint_through_rollout():
    """Reverse-mode through a static fori_loop of fused steps (lowers to
    scan): each step's backward is the custom_vjp's jnp-tier VJP."""
    import jax

    init_env(D3Q19)
    shape = (16, 16, 12)
    grid = grid_factory(shape, mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box_ne = grid.bounding_box_indices(remove_edges=True)
    bcs = [EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    def rollout_loss(step_fn, f, omega, steps=3):
        def body(i, carry):
            a, b = carry
            a, b = step_fn(a, b, bm, mm, omega, i)
            return (b, a)

        a, _ = jax.lax.fori_loop(0, steps, body, (f, f))
        return jnp.sum(a.astype(jnp.float32) ** 2)

    g_fused = jax.grad(lambda f, om: rollout_loss(fused, f, om))(f0, jnp.float32(1.4))
    g_jnp = jax.grad(lambda f, om: rollout_loss(stepper, f, om))(f0, jnp.float32(1.4))
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_jnp), rtol=2e-4, atol=1e-6)


def test_fused_adjoint_extrapolation_outflow():
    """jax.grad through the fused WINDOW of an extrapolation-outflow scene
    (two outflow faces, +x and +y, so the staging gathers tangential
    neighbours along both) matches the jnp rollout."""
    import jax
    from xlb_tpu.boundary import ExtrapolationOutflowBC
    from xlb_tpu.kernels.fused_step import build_fused_window

    init_env(D3Q19)
    shape = (16, 16, 12)
    grid = grid_factory(shape, mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front")], axis=1), axis=1
    )
    bcs = [
        HalfwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.01, 0.0), indices=box_ne["left"]),
        ExtrapolationOutflowBC(indices=box_ne["right"]),
        ExtrapolationOutflowBC(indices=box_ne["back"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    steps = 3
    run = build_fused_window(stepper, steps, interpret=True)

    def loss_window(f, omega):
        out, _ = run(f, f, bm, mm, omega)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def loss_jnp(f, omega):
        a, b = f, f
        for t in range(steps):
            a, b = stepper(a, b, bm, mm, omega, t)
            a, b = b, a
        return jnp.sum(a.astype(jnp.float32) ** 2)

    out_w, _ = run(f0, f0, bm, mm, 1.5)
    out_j = f0
    for t in range(steps):
        out_j = stepper(out_j, out_j, bm, mm, 1.5, t)[1]
    assert float(jnp.abs(out_w - out_j).max()) < 5e-6
    gf_w, go_w = jax.grad(loss_window, argnums=(0, 1))(f0, jnp.float32(1.5))
    gf_j, go_j = jax.grad(loss_jnp, argnums=(0, 1))(f0, jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(gf_w), np.asarray(gf_j), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(float(go_w), float(go_j), rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("bc_cls_name", ["ZouHeBC", "RegularizedBC"])
def test_fused_spatial_velocity_profile_inlet(bc_cls_name):
    """A parabolic (per-voxel) velocity profile on a ZouHe/Regularized inlet
    runs in the fused kernel via the aux field (reference
    flow_past_sphere_3d.py:95-107 uses exactly this inlet)."""
    from xlb_tpu.boundary import ZouHeBC, RegularizedBC, ExtrapolationOutflowBC

    vs = init_env(D3Q19)
    n = 16
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    yz = (np.arange(n) + 0.5) / n - 0.5
    ry, rz = np.meshgrid(2 * yz, 2 * yz, indexing="ij")
    parab = 0.04 * np.maximum(0.0, 1.0 - ry**2 - rz**2)
    prescribed = np.zeros((3, 1, n, n))
    prescribed[0, 0] = parab
    bc_cls = {"ZouHeBC": ZouHeBC, "RegularizedBC": RegularizedBC}[bc_cls_name]
    inlet = bc_cls("velocity", profile=lambda: prescribed, indices=box_ne["left"])
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), inlet, DoNothingBC(indices=box_ne["right"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(4):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"{bc_cls_name} spatial profile: fused diverges by {diff}"
    # the profile must actually drive a centerline-peaked inflow
    from xlb_tpu.ops import Macroscopic

    _, u = Macroscopic()(ga)
    ux = np.asarray(u[0][1])
    assert ux[n // 2, n // 2] > ux[1, 1] + 0.005
