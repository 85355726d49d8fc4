"""Multires windows: build_window must match the per-step __call__ path,
solid-tagged voxels must freeze, and the removed fused strategies must
refuse to build."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid.multires import MultiresGrid
from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper
from xlb_tpu.mres_perf_optimization_type import MresPerfOptimizationType


def _scene(bcs_factory=None, grid=None):
    init_env(D3Q19)
    bcs = bcs_factory() if bcs_factory is not None else None
    grid = grid or MultiresGrid((32, 32, 32), boxes=[((8, 8, 8), (16, 16, 16))])
    st = MultiresIncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    fs0, _, bms, mms = st.prepare_fields()
    key = jax.random.PRNGKey(3)
    fs0 = [f + 0.01 * jax.random.uniform(key, f.shape, f.dtype) for f in fs0]
    return st, fs0, bms, mms


def _window_vs_per_step(st, fs0, bms, mms, steps=3):
    fa = [jnp.array(f) for f in fs0]
    for _ in range(steps):
        fa = st(fa, bms, mms, 1.6)
    run = st.build_window(steps, donate=False)
    fw = run([jnp.array(f) for f in fs0], bms, mms, 1.6)
    for a, w in zip(fa, fw):
        # XLA fuses the glue differently inside the fori_loop window than
        # in the eager per-step path -> 1-ulp contraction differences
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=2e-6, atol=1e-7)
    return fa


def test_window_matches_per_step():
    st, fs0, bms, mms = _scene()
    assert st.active_tier == "jnp"
    _window_vs_per_step(st, fs0, bms, mms)


def test_fused_solid_freeze_matches_jnp():
    """An interior solid block on the finest level: solids are 255-tagged
    (shell gets the BC id) and keep their populations (reference Warp
    solid early-out, nse_stepper.py:440-441), in the window too."""
    from xlb_tpu.boundary import HalfwayBounceBackBC

    def bcs_factory():
        ii, jj, kk = np.meshgrid(*[np.arange(6, 10)] * 3, indexing="ij")
        block = np.stack([ii.ravel(), jj.ravel(), kk.ravel()])
        return {0: [HalfwayBounceBackBC(indices=block.tolist())]}

    st, fs0, bms, mms = _scene(bcs_factory=bcs_factory)
    assert (np.asarray(bms[0][0]) == 255).any(), "interior block voxels must be solid-tagged"
    fn = _window_vs_per_step(st, fs0, bms, mms, steps=2)
    solid = np.asarray(bms[0][0]) == 255
    np.testing.assert_array_equal(np.asarray(fn[0])[:, solid], np.asarray(fs0[0])[:, solid])


def test_fully_refined_fast_path_matches_naive():
    """Full-domain refinement (every coarse cell overwritten by the
    coalescence): the window matches the per-step path and stays finite."""
    grid = MultiresGrid((16, 16, 16), boxes=[((0, 0, 0), (16, 16, 16))])
    st, fs0, bms, mms = _scene(grid=grid)
    fa = _window_vs_per_step(st, fs0, bms, mms)
    assert all(np.isfinite(np.asarray(f)).all() for f in fa)


@pytest.mark.parametrize(
    "strategy",
    [
        MresPerfOptimizationType.FUSION_AT_FINEST,
        MresPerfOptimizationType.FUSION_AT_FINEST_SFV,
        MresPerfOptimizationType.FUSION_AT_FINEST_SFV_ALL,
    ],
)
def test_removed_fusion_strategies_raise(strategy):
    """Strategies whose only effect was a removed fused tier fail loudly
    instead of silently running the jnp tier."""
    init_env(D3Q19)
    grid = MultiresGrid((16, 16, 16), boxes=[((4, 4, 4), (8, 8, 8))])
    with pytest.raises(ValueError, match="NAIVE_COLLIDE_STREAM"):
        MultiresIncompressibleNavierStokesStepper(grid, mres_perf_opt=strategy)
