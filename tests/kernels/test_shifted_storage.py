"""Deviation-form (shifted) population storage tests.

Storing g = f - w between fused steps keeps the full 16-bit mantissa on the
physically-varying part.  Checks: (a) f32 shifted windows match plain
windows to roundoff, (b) bf16 shifted windows track the analytic
Taylor-Green decay where plain bf16 storage stalls.
"""

import numpy as np
import jax
import jax.numpy as jnp

import xlb_tpu as xlb
from tests.conftest import init_env
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.ops import Macroscopic
from xlb_tpu.ops.equilibrium import quadratic_equilibrium
from xlb_tpu.kernels.fused_step import build_fused_window
from xlb_tpu.utils import viscosity_from_omega


def test_shifted_window_matches_plain_f32():
    vs = init_env(D3Q19)
    n = 16
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
    )
    bcs = [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()

    run_plain = build_fused_window(stepper, 4, interpret=True, shifted=False)
    run_shift = build_fused_window(stepper, 4, interpret=True, shifted=True)
    fa, _ = run_plain(f0, f1, bm, mm, 1.5)
    ga, _ = run_shift(f0, f1, bm, mm, 1.5)
    assert float(jnp.abs(fa - ga).max()) < 1e-5


def _bf16_tgv_ratio(shifted):
    from xlb_tpu.default_config import DefaultConfig
    from xlb_tpu.boundary.registry import boundary_condition_registry

    DefaultConfig.reset()
    boundary_condition_registry.reset()
    vs = init_env(D3Q19, precision="FP32BF16")
    n, u0, omega, steps = 16, 0.01, 1.4, 50
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    x = (np.arange(n) + 0.5) * 2 * np.pi / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    u = np.stack(
        [u0 * np.cos(X) * np.sin(Y) * np.sin(Z), -u0 * np.sin(X) * np.cos(Y) * np.sin(Z), np.zeros_like(X)]
    ).astype(np.float32)
    rho = jnp.ones((1, n, n, n), jnp.float32)
    f0 = quadratic_equilibrium(rho, jnp.asarray(u), vs._c, vs._w, jnp.float32).astype(jnp.bfloat16)
    stepper = IncompressibleNavierStokesStepper(grid)
    _, _, bm, mm = stepper.prepare_fields()
    run = build_fused_window(stepper, steps, interpret=True, shifted=shifted)
    f, _ = run(f0, f0, bm, mm, omega)
    _, ut = Macroscopic()(f.astype(jnp.float32))
    ke0 = float((u**2).sum())
    ke = float(jnp.sum(ut**2))
    nu = viscosity_from_omega(omega)
    k2 = 3 * (2 * np.pi / n) ** 2
    return ke / (ke0 * np.exp(-2 * nu * k2 * steps))


def test_shifted_storage_fixes_bf16_decay():
    r_plain = _bf16_tgv_ratio(shifted=False)
    r_shift = _bf16_tgv_ratio(shifted=True)
    # plain bf16 storage stalls the decay (ratio >> 1); shifted tracks it
    assert r_plain > 2.0
    assert 0.7 < r_shift < 1.3, f"shifted bf16 decay ratio {r_shift}"
