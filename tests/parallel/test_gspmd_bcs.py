"""The GSPMD-sharded jnp tier against a single device, for every BC kind.

Several devices run the jnp-tier stepper jitted over sharded inputs: XLA
partitions the step and turns the rolls on sharded axes into
collective-permutes.  Each case builds the same channel scene on a (2, 4, 1)
mesh of the 8 virtual CPU devices and on one device; a few steps must agree
to f32 roundoff.  A 3-D multires scene sharded over (x, y) gets the same
check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import init_env
from xlb_tpu.boundary import (
    DoNothingBC,
    EquilibriumBC,
    ExtrapolationOutflowBC,
    FullwayBounceBackBC,
    HalfwayBounceBackBC,
    HybridBC,
    RegularizedBC,
    ZouHeBC,
)
from xlb_tpu.boundary.registry import boundary_condition_registry
from xlb_tpu.geometry import sphere_triangles
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.velocity_set import D3Q19

SHAPE = (16, 16, 8)
KINDS = [
    "equilibrium",
    "fullway",
    "halfway_moving",
    "halfway_profile",
    "zouhe_velocity",
    "zouhe_pressure",
    "regularized_profile",
    "do_nothing",
    "extrapolation_outflow",
    "free_slip",
    "hybrid",
]


def _bcs(kind, grid):
    from xlb_tpu.boundary.bc_free_slip import FreeSlipBC

    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1)
    inlet = EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["left"])
    outlet = DoNothingBC(indices=box_ne["right"])
    wall = FullwayBounceBackBC(indices=walls.tolist())
    ny, nz = SHAPE[1], SHAPE[2]
    gy, gz = np.meshgrid(2 * ((np.arange(ny) + 0.5) / ny - 0.5), 2 * ((np.arange(nz) + 0.5) / nz - 0.5), indexing="ij")
    profile = np.zeros((3, 1, ny, nz))
    profile[0, 0] = 0.04 * np.maximum(0.0, 1.0 - gy**2 - gz**2)
    block = np.stack([a.ravel() for a in np.meshgrid(np.arange(7, 9), np.arange(7, 9), np.arange(3, 5), indexing="ij")])
    center = np.array([8.0, 8.0, 4.0])
    if kind == "equilibrium":
        return [wall, inlet, EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["right"])]
    if kind == "fullway":
        return [wall, inlet, outlet, FullwayBounceBackBC(indices=block.tolist())]
    if kind == "halfway_moving":
        return [HalfwayBounceBackBC(indices=walls.tolist(), prescribed_value=(0.02, 0.0, 0.0)), inlet, outlet]
    if kind == "halfway_profile":
        spin = lambda x: np.cross(np.array([0.0, 0.0, 0.02])[None, :], (x - center[:, None]).T).T  # noqa: E731
        return [wall, inlet, outlet, HalfwayBounceBackBC(indices=block.tolist(), profile=spin)]
    if kind == "zouhe_velocity":
        return [wall, ZouHeBC("velocity", prescribed_value=(0.02, 0.0, 0.0), indices=box_ne["left"]), outlet]
    if kind == "zouhe_pressure":
        return [wall, inlet, ZouHeBC("pressure", prescribed_value=1.0, indices=box_ne["right"])]
    if kind == "regularized_profile":
        return [wall, RegularizedBC("velocity", profile=lambda: profile, indices=box_ne["left"]), outlet]
    if kind == "do_nothing":
        return [wall, inlet, outlet]
    if kind == "extrapolation_outflow":
        return [wall, inlet, ExtrapolationOutflowBC(indices=box_ne["right"])]
    if kind == "free_slip":
        side = np.unique(np.concatenate([np.asarray(box[k]) for k in ("front", "back")], axis=1), axis=1)
        return [
            FreeSlipBC(indices=box_ne["bottom"], normal=(0, 0, -1)),
            FreeSlipBC(indices=box_ne["top"], normal=(0, 0, 1)),
            FullwayBounceBackBC(indices=side.tolist()),
            inlet,
            outlet,
        ]
    tris = sphere_triangles(center=tuple(center), radius=2.6, subdivisions=2)
    return [wall, inlet, outlet, HybridBC(bc_method="bounceback_regularized", mesh_vertices=tris, use_mesh_distance=True)]


def _run(kind, mesh_shape, devices, steps=4):
    boundary_condition_registry.reset()
    init_env(D3Q19)
    grid = grid_factory(SHAPE, mesh_shape=mesh_shape, devices=devices)
    st = IncompressibleNavierStokesStepper(grid, boundary_conditions=_bcs(kind, grid))
    f0, f1, bm, mm = st.prepare_fields()
    out, _ = st.build_multi_step(steps, donate=False)(f0, f1, bm, mm, 1.5)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_gspmd_sharded_step_matches_single_device(kind):
    ref = np.asarray(_run(kind, (1, 1, 1), jax.devices()[:1]))
    out = _run(kind, (2, 4, 1), jax.devices()[:8])
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-6, atol=1e-7)


def test_gspmd_sharded_multires_3d_matches_single_device():
    """3-D multires with a mesh object on the finest level and cavity BCs
    on the coarsest, every level sharded over a (4, 2) (x, y) mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from xlb_tpu.grid.multires import MultiresGrid
    from xlb_tpu.models.multires import MultiresIncompressibleNavierStokesStepper

    def scene():
        boundary_condition_registry.reset()
        init_env(D3Q19)
        helper = grid_factory((16, 16, 16), mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
        box = helper.bounding_box_indices()
        box_ne = helper.bounding_box_indices(remove_edges=True)
        walls = np.unique(
            np.concatenate([np.asarray(box[k]) for k in ("bottom", "left", "right", "front", "back")], axis=1), axis=1
        )
        bcs = {
            0: [HalfwayBounceBackBC(mesh_vertices=sphere_triangles(center=(8.0, 8.0, 8.0), radius=2.0, subdivisions=2))],
            1: [FullwayBounceBackBC(indices=walls.tolist()), EquilibriumBC(rho=1.0, u=(0.03, 0.0, 0.0), indices=box_ne["top"])],
        }
        st = MultiresIncompressibleNavierStokesStepper(MultiresGrid((16, 16, 16), boxes=[((4, 4, 4), (8, 8, 8))]), boundary_conditions=bcs)
        fs, _, bms, mms = st.prepare_fields()
        return st, fs, bms, mms

    st, fs, bms, mms = scene()
    ref = st.build_window(2, donate=False)(fs, bms, mms, 1.5)
    st2, fs2, bms2, mms2 = scene()
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("x", "y"))
    shard = lambda arrs: [jax.device_put(a, NamedSharding(mesh, P(None, "x", "y", None))) for a in arrs]  # noqa: E731
    out = st2.build_window(2, donate=False)(shard(fs2), shard(bms2), shard(mms2), 1.5)
    for o, r in zip(out, ref):
        assert len(o.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(o), np.asarray(r), rtol=1e-6, atol=1e-7)
    assert all(bool(jnp.all(jnp.isfinite(o))) for o in out)
