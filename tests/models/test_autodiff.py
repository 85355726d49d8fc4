"""Differentiability tests: gradients flow through the LBM step.

The reference demonstrates adjoint optimization in
examples/out_of_core/autodiff_lbm.py; here differentiability is a
first-class property of the jnp-tier step (every operator is a pure jnp
function), checked against finite differences.
"""

import numpy as np
import jax
import jax.numpy as jnp

from tests.conftest import init_env
from xlb_tpu.velocity_set import D2Q9
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.ops import Macroscopic
from xlb_tpu.ops.equilibrium import quadratic_equilibrium
import pytest


def _loss_after_steps(stepper, bc_mask, missing_mask, n_steps, target_u):
    mac = Macroscopic()

    def loss(u0, omega):
        n = u0.shape[1]
        rho = jnp.ones((1, n, n), dtype=jnp.float32)
        vs = stepper.velocity_set
        f0 = quadratic_equilibrium(rho, u0, vs._c, vs._w, jnp.float32)
        f1 = f0

        def body(i, carry):
            f0, f1 = carry
            f0, f1 = stepper(f0, f1, bc_mask, missing_mask, omega, i)
            return (f1, f0)

        f0, f1 = jax.lax.fori_loop(0, n_steps, body, (f0, f1))
        _, u = mac(f0)
        return jnp.mean((u - target_u) ** 2)

    return loss


def test_gradient_through_steps_matches_finite_difference():
    vs = init_env(D2Q9)
    n = 16
    grid = grid_factory((n, n))
    stepper = IncompressibleNavierStokesStepper(grid)  # periodic, no BCs
    _, _, bc_mask, missing_mask = stepper.prepare_fields()

    rng = np.random.default_rng(0)
    u0 = jnp.asarray(0.01 * rng.standard_normal((2, n, n)).astype(np.float32))
    target = jnp.zeros((2, n, n), dtype=jnp.float32)

    loss = _loss_after_steps(stepper, bc_mask, missing_mask, 5, target)

    # gradient wrt omega vs central finite difference
    g_omega = jax.grad(loss, argnums=1)(u0, 1.2)
    eps = 1e-3
    fd = (loss(u0, 1.2 + eps) - loss(u0, 1.2 - eps)) / (2 * eps)
    assert np.isfinite(float(g_omega))
    np.testing.assert_allclose(float(g_omega), float(fd), rtol=2e-2)

    # gradient wrt initial velocity: check a single component via FD
    g_u = jax.grad(loss, argnums=0)(u0, 1.2)
    du = np.zeros((2, n, n), dtype=np.float32)
    du[0, 5, 7] = 1.0
    fd_u = (loss(u0 + eps * du, 1.2) - loss(u0 - eps * du, 1.2)) / (2 * eps)
    np.testing.assert_allclose(float(g_u[0, 5, 7]), float(fd_u), rtol=5e-2, atol=1e-9)


def test_gradient_with_boundary_conditions():
    """Gradients flow through masked BC selects too."""
    from xlb_tpu.boundary import EquilibriumBC, HalfwayBounceBackBC

    vs = init_env(D2Q9)
    n = 16
    grid = grid_factory((n, n))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [HalfwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.05, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bc_mask, missing_mask = stepper.prepare_fields()

    def loss(omega):
        def body(i, carry):
            a, b = carry
            a, b = stepper(a, b, bc_mask, missing_mask, omega, i)
            return (b, a)

        a, _ = jax.lax.fori_loop(0, 10, body, (f0, f1))
        _, u = Macroscopic()(a)
        return jnp.sum(u**2)

    g = jax.grad(loss)(1.3)
    eps = 1e-3
    fd = (loss(1.3 + eps) - loss(1.3 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)


@pytest.mark.fast
def test_gradient_through_fused_window():
    """The fused WINDOW is differentiable: its custom_vjp backward is the
    jnp tier's VJP, so gradients match the jnp tier to roundoff, including
    through a spatial-profile (aux-BC) configuration."""
    from xlb_tpu.velocity_set import D3Q19
    from xlb_tpu.boundary import DoNothingBC, FullwayBounceBackBC, RegularizedBC
    from xlb_tpu.kernels.fused_step import build_fused_window

    init_env(D3Q19)
    n, nz = 16, 12
    grid = grid_factory((n, n, nz), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    yz = 2 * ((np.arange(n) + 0.5) / n - 0.5)
    rz = 2 * ((np.arange(nz) + 0.5) / nz - 0.5)
    gy, gz = np.meshgrid(yz, rz, indexing="ij")
    prescribed = np.zeros((3, 1, n, nz))
    prescribed[0, 0] = 0.04 * np.maximum(0.0, 1.0 - gy**2 - gz**2)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        RegularizedBC("velocity", profile=lambda: prescribed, indices=box_ne["left"]),
        DoNothingBC(indices=box_ne["right"]),
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

    gf_w, go_w = jax.grad(loss_window, argnums=(0, 1))(f0, jnp.float32(1.5))
    gf_j, go_j = jax.grad(loss_jnp, argnums=(0, 1))(f0, jnp.float32(1.5))
    np.testing.assert_allclose(np.asarray(gf_w), np.asarray(gf_j), rtol=2e-4, atol=1e-6)
    # omega's gradient is a cancellation-prone sum over every voxel and
    # step, accumulated along a replayed trajectory that differs from the
    # jnp tier's at f32 roundoff -- tolerance reflects that, not the
    # per-element f-gradient agreement above
    np.testing.assert_allclose(float(go_w), float(go_j), rtol=2e-3)


def test_gradient_through_multires_step():
    """Multires rollouts differentiate natively on the jnp tier (the
    reference's Neon multires kernels have no backward at all): grad of a
    kinetic-energy loss through two coarse steps wrt omega matches a
    central finite difference."""
    from xlb_tpu.velocity_set import D3Q19
    from xlb_tpu.grid.multires import MultiresGrid
    from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper

    init_env(D3Q19, precision="FP64FP64")  # f64: the central difference is exact enough to pin AD
    grid = MultiresGrid((12, 12, 12), boxes=[((3, 3, 3), (6, 6, 6))])
    st = MultiresIncompressibleNavierStokesStepper(grid)
    fs, _, bms, mms = st.prepare_fields()
    # smooth shear perturbation so omega actually matters
    fs = [
        f * (1.0 + 0.05 * jnp.asarray(np.sin(2 * np.pi * (np.arange(f.shape[1]) + 0.5) / f.shape[1]))[None, :, None, None])
        for f in fs
    ]

    @jax.jit
    def loss(omega):
        out = list(fs)
        for _ in range(2):
            out = st(out, bms, mms, omega)
        return sum(jnp.sum(f ** 2) for f in out)

    g = float(jax.grad(loss)(1.5))
    eps = 1e-5
    fd = float((loss(1.5 + eps) - loss(1.5 - eps)) / (2 * eps))
    assert np.isfinite(g)
    assert abs(g - fd) < 1e-5 * max(1.0, abs(fd)), (g, fd)


def test_differentiable_window_jnp_tier_scan():
    """differentiable=True runs the multires window as a checkpointed scan
    (fori_loop would not reverse-differentiate) and matches the unrolled
    per-call gradient."""
    from xlb_tpu.velocity_set import D3Q19
    from xlb_tpu.grid.multires import MultiresGrid
    from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper

    init_env(D3Q19)
    grid = MultiresGrid((12, 12, 12), boxes=[((3, 3, 3), (6, 6, 6))])
    st = MultiresIncompressibleNavierStokesStepper(grid)
    fs, _, bms, mms = st.prepare_fields()
    fs = [f * (1.0 + 0.03 * jnp.asarray(np.cos(np.arange(f.shape[1]) * 0.7), f.dtype)[None, :, None, None]) for f in fs]
    win = st.build_window(2, differentiable=True)

    g_win = float(jax.grad(lambda om: sum(jnp.sum(f ** 2) for f in win(list(fs), bms, mms, om)))(jnp.float32(1.5)))

    @jax.jit
    def loss(om):
        out = list(fs)
        for _ in range(2):
            out = st(out, bms, mms, om)
        return sum(jnp.sum(f ** 2) for f in out)

    g_ref = float(jax.grad(loss)(jnp.float32(1.5)))
    assert abs(g_win - g_ref) < 1e-4 * max(1.0, abs(g_ref)), (g_win, g_ref)
