"""Fused-kernel HybridBC parity: the in-kernel hybrid curved-boundary
epilogue (all three methods, with and without mesh distances) matches the
jnp tier to f32 roundoff.  Per-link wall distances ride the aux field's
weight channels (collide_stream.aux_layout)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import HybridBC, EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.geometry import sphere_triangles
from xlb_tpu.kernels.fused_step import build_fused_step


def _sphere_config(method, use_mesh_distance=True, prescribed_value=None):
    nx, nyz = 24, 16
    grid = grid_factory((nx, nyz, nyz), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    tris = sphere_triangles(center=(nx / 2, nyz / 2, nyz / 2), radius=3.2, subdivisions=2)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back", "right")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
        HybridBC(bc_method=method, mesh_vertices=tris, use_mesh_distance=use_mesh_distance,
                 prescribed_value=prescribed_value),
    ]
    return IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)


@pytest.mark.parametrize("method", ["bounceback", "bounceback_regularized", "bounceback_grads", "nonequilibrium_regularized"])
def test_fused_hybrid_matches_jnp_tier(method):
    vs = init_env(D3Q19)
    stepper = _sphere_config(method)
    f0, f1, bm, mm = stepper.prepare_fields()
    hybrid = stepper.boundary_conditions[-1]
    assert hybrid._distances is not None and np.isfinite(hybrid._distances).any()

    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"hybrid {method}: fused diverges from jnp tier by {diff}"


def test_fused_hybrid_no_distance_and_moving_wall():
    """use_mesh_distance=False (halfway fallback, no aux) and a constant
    prescribed wall velocity both run in-kernel."""
    vs = init_env(D3Q19)
    stepper = _sphere_config("bounceback_regularized", use_mesh_distance=False,
                             prescribed_value=(0.01, 0.0, 0.0))
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(2):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    assert float(jnp.abs(fa - ga).max()) < 5e-6


@pytest.mark.parametrize("method", ["bounceback_regularized", "nonequilibrium_regularized"])
def test_fused_hybrid_spatial_moving_wall_matches_jnp_tier(method):
    """HybridBC with a spatial (coordinate-taking) wall-velocity profile —
    a rotating sphere — runs fully in-kernel via the aux velocity channels
    and matches the jnp tier (the round-4 fused hole at fused_step.py:73)."""
    vs = init_env(D3Q19)
    nx, nyz = 24, 16
    grid = grid_factory((nx, nyz, nyz), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    tris = sphere_triangles(center=(nx / 2, nyz / 2, nyz / 2), radius=3.2, subdivisions=2)
    center = np.array([nx / 2, nyz / 2, nyz / 2])

    def rotating(coords):  # omega x r about the z axis through the center
        r = np.asarray(coords, dtype=np.float64) - center[:, None]
        om = 0.02
        return np.stack([-om * r[1], om * r[0], np.zeros_like(r[0])])

    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back", "right")], axis=1), axis=1
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"]),
        HybridBC(bc_method=method, mesh_vertices=tris, profile=rotating),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    hybrid = stepper.boundary_conditions[-1]
    assert hybrid._distances is not None and np.isfinite(hybrid._distances).any()

    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"hybrid spatial mw {method}: fused diverges from jnp tier by {diff}"


def test_fused_hybrid_differentiates_without_solids():
    """Regression: the fused adjoint's f_pre liveness gate must include
    'hybrid' (the epilogue reads f_pre in every branch).  An indices-based
    HybridBC with no solid voxels (has_solids=False) exercises the gate."""
    import jax

    vs = init_env(D3Q19)
    n = 16
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    bcs = [
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["left"]),
        HybridBC(bc_method="bounceback_regularized", use_mesh_distance=False, indices=box["right"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    assert not stepper.has_solids
    fused = build_fused_step(stepper, interpret=True)

    def loss(f):
        _, out = fused(f, f, bm, mm, 1.5, 0)
        return jnp.sum(out**2)

    g_fused = jax.grad(loss)(f0)

    def loss_jnp(f):
        _, out = stepper(f, f, bm, mm, 1.5, 0)
        return jnp.sum(out**2)

    g_jnp = jax.grad(loss_jnp)(f0)
    assert np.isfinite(np.asarray(g_fused)).all()
    np.testing.assert_allclose(np.asarray(g_fused), np.asarray(g_jnp), rtol=1e-4, atol=1e-6)
