"""2D fused Pallas kernel parity vs the jnp oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests.conftest import init_env
from xlb_tpu.velocity_set import D2Q9
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, HalfwayBounceBackBC
from xlb_tpu.kernels.fused_step import build_fused_step


@pytest.mark.fast
def test_fused_2d_matches_reference_step():
    vs = init_env(D2Q9)
    n = 32
    grid = grid_factory((n, n), mesh_shape=(1, 1), devices=jax.devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [HalfwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.05, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f0, f1, bm, mm = stepper.prepare_fields()

    fused = build_fused_step(stepper, interpret=True)

    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(4):
        fa, fb = stepper(fa, fb, bm, mm, 1.6, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.6, t)
        ga, gb = gb, ga
    assert float(jnp.abs(fa - ga).max()) < 5e-6


def test_fused_2d_kbc_matches_reference_step():
    vs = init_env(D2Q9)
    n = 32
    grid = grid_factory((n, n), mesh_shape=(1, 1), devices=jax.devices()[:1])
    box_ne = grid.bounding_box_indices(remove_edges=True)
    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right")], axis=1), axis=1)
    bcs = [HalfwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.05, 0.0), indices=box_ne["top"])]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs, collision_type="KBC")
    f0, f1, bm, mm = stepper.prepare_fields()
    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(3):
        fa, fb = stepper(fa, fb, bm, mm, 1.6, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.6, t)
        ga, gb = gb, ga
    assert float(jnp.abs(fa - ga).max()) < 5e-6
