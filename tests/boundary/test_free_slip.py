"""FreeSlipBC (specular reflection) -- beyond-reference wall type.

Anchors: the mirror permutation's algebra, exact tangential-momentum
conservation (the property that distinguishes free-slip from bounce-back),
the analytic half-channel Poiseuille profile (free-slip top = symmetry
plane), and fused-kernel parity.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.velocity_set import D2Q9, D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import FreeSlipBC, FullwayBounceBackBC, HalfwayBounceBackBC
from xlb_tpu.ops import Macroscopic

pytestmark = pytest.mark.fast


def _grid(shape):
    import jax

    return grid_factory(shape, mesh_shape=(1,) * len(shape), devices=jax.devices()[:1])


@pytest.mark.parametrize("vs_cls,normal", [(D2Q9, (0, 1)), (D3Q19, (0, 0, 1)), (D3Q19, (0, 1, 0))])
def test_specular_permutation_algebra(vs_cls, normal):
    vs = init_env(vs_cls)
    bc = FreeSlipBC(indices=[[0], [0], [0]][: vs.d], normal=normal)
    spec = bc.spec_indices
    c = vs._c
    a = bc.axis
    # involution, flips the normal component, keeps tangentials
    assert np.all(spec[spec] == np.arange(vs.q))
    assert np.all(c[a, spec] == -c[a])
    for b in range(vs.d):
        if b != a:
            assert np.all(c[b, spec] == c[b])


def test_free_slip_conserves_tangential_momentum():
    """A sheared periodic-x channel between two free-slip walls keeps its
    total x-momentum EXACTLY (bounce-back walls would drain it)."""
    vs = init_env(D2Q9, precision="FP64FP64")
    nx, ny = 16, 16
    grid = _grid((nx, ny))
    box = grid.bounding_box_indices()
    bcs = [
        FreeSlipBC(indices=box["bottom"], normal=(0, -1)),
        FreeSlipBC(indices=box["top"], normal=(0, 1)),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()

    # non-uniform shear flow
    from xlb_tpu.ops.equilibrium import quadratic_equilibrium

    u = np.zeros((2, nx, ny))
    u[0] = 0.05 * np.sin(2 * np.pi * np.arange(ny) / ny)[None, :]
    f0 = quadratic_equilibrium(jnp.ones((1, nx, ny), jnp.float64), jnp.asarray(u), vs._c, vs._w, jnp.float64)

    rho0, u0 = Macroscopic()(f0)
    mom0 = float(jnp.sum(rho0 * u0[0]))
    run = stepper.build_multi_step(200, donate=False)
    f0, f1 = run(f0, f1, bm, mm, 1.3)
    rho, uT = Macroscopic()(f0)
    mom = float(jnp.sum(rho * uT[0]))
    assert abs(mom - mom0) < 1e-10 * max(1.0, abs(mom0)), f"x-momentum drifted: {mom0} -> {mom}"
    # sanity: the same setup with bounce-back walls DOES lose momentum
    vs = init_env(D2Q9, precision="FP64FP64")
    grid = _grid((nx, ny))
    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box["bottom"]), np.asarray(box["top"])], axis=1), axis=1)
    st2 = IncompressibleNavierStokesStepper(grid, boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())])
    g0, g1, bm2, mm2 = st2.prepare_fields()
    g0 = quadratic_equilibrium(jnp.ones((1, nx, ny), jnp.float64), jnp.asarray(u), vs._c, vs._w, jnp.float64)
    run2 = st2.build_multi_step(200, donate=False)
    g0, g1 = run2(g0, g1, bm2, mm2, 1.3)
    rho_b, u_b = Macroscopic()(g0)
    mom_b = float(jnp.sum(rho_b * u_b[0]))
    assert abs(mom_b - mom0) > 1e-6, "bounce-back control should lose tangential momentum"


def test_half_channel_poiseuille_with_free_slip_symmetry_plane():
    """Force-driven half channel: no-slip bottom (fullway) + free-slip top.
    The free-slip plane is a symmetry plane, so the steady profile is the
    lower half of a full channel of twice the height.  The free-slip row is
    itself fluid, so the slip plane sits half a link beyond it:

        u(s) = (F/nu) (L s - s^2/2),  s = y - 0.5,  L = (ny - 0.5) - 0.5
    """
    vs = init_env(D2Q9, precision="FP64FP64")
    nx, ny = 4, 18
    grid = _grid((nx, ny))
    force, omega = 1e-6, 1.0
    nu = (1.0 / omega - 0.5) / 3.0
    box = grid.bounding_box_indices()
    bcs = [
        FullwayBounceBackBC(indices=box["bottom"]),
        FreeSlipBC(indices=box["top"], normal=(0, 1)),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, force_vector=np.array([force, 0.0]))
    f0, f1, bm, mm = stepper.prepare_fields()
    run = stepper.build_multi_step(60000, donate=False)
    f0, f1 = run(f0, f1, bm, mm, omega)

    _, u = Macroscopic()(f0)
    profile = np.asarray(u)[0, nx // 2, 1:]  # the free-slip top row is fluid
    y = np.arange(1, ny).astype(np.float64)
    s = y - 0.5
    L = ny - 1.0
    analytic = force / nu * (L * s - s**2 / 2.0)
    np.testing.assert_allclose(profile, analytic, rtol=0.02)


def test_free_slip_fused_parity():
    vs = init_env(D3Q19)
    from xlb_tpu.kernels.fused_step import build_fused_step
    from xlb_tpu.boundary import EquilibriumBC

    n = 16
    grid = _grid((n, n, n))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        FreeSlipBC(indices=box_ne["front"], normal=(0, -1, 0)),
        FreeSlipBC(indices=box_ne["back"], normal=(0, 1, 0)),
        EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)

    fa, fb, ga, gb = f0, f1, f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"free-slip fused parity diff {diff}"
