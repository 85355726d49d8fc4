"""Distributed multires flow past a sphere on a device mesh.

Multi-device analogue of multires_flow_past_sphere_3d.py -- the reference
can only run multires multi-GPU through the Neon C++ runtime
(nse_multires_stepper.py:540-1110 + mGrid halos); here every level's
fields shard over a (px, py) jax.sharding.Mesh and GSPMD partitions the
jnp-tier multires step, level coupling included.

Run under XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu to exercise the mesh without GPUs.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import numpy as np
import jax

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q19
from xlb_tpu.grid import grid_factory
from xlb_tpu.grid.multires import MultiresGrid
from xlb_tpu.helper.simulation_manager import MultiresSimulationManager
from xlb_tpu.geometry import sphere_triangles
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC, HalfwayBounceBackBC


def run(coarse=(32, 16, 16), num_coarse_steps=40, u_in=0.03, mesh_shape=None):
    xlb.init(velocity_set=D3Q19(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)

    if mesh_shape is None:
        nd = len(jax.devices())
        mesh_shape = (nd // 2, 2) if nd % 2 == 0 and nd > 1 else (nd, 1)
    px, py = mesh_shape
    mesh = None
    if px * py > 1:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[: px * py]).reshape(px, py), ("x", "y"))
    print(f"mesh: {mesh_shape}")

    # refine a box around the sphere, inset from the walls
    extent = (coarse[1] - 4, coarse[1] - 4, coarse[2] - 4)
    ox = max(coarse[0] // 4 - extent[0] // 2, 2)
    origin = (ox, 2, 2)
    grid = MultiresGrid(coarse, boxes=[(origin, extent)])

    helper = grid_factory(coarse, mesh_shape=(1, 1, 1), devices=jax.devices()[:1])
    box = helper.bounding_box_indices()
    box_ne = helper.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back")], axis=1), axis=1
    )
    center = (origin[0] + extent[0] / 2.0, origin[1] + extent[1] / 2.0, origin[2] + extent[2] / 2.0)
    tris = sphere_triangles(
        center=tuple(2 * c for c in center), radius=extent[1] / 3.0, subdivisions=2
    )  # finest-level (2x) coordinates
    bcs = {
        0: [HalfwayBounceBackBC(mesh_vertices=tris)],
        1: [
            FullwayBounceBackBC(indices=walls.tolist()),
            EquilibriumBC(rho=1.0, u=(u_in, 0.0, 0.0), indices=box_ne["left"]),
            EquilibriumBC(rho=1.0, u=(u_in, 0.0, 0.0), indices=box_ne["right"]),
        ],
    }
    sim = MultiresSimulationManager(grid, omega_finest=1.6, boundary_conditions=bcs, mesh=mesh)
    sim.run(num_coarse_steps, window=min(10, num_coarse_steps))

    rho, u = sim.export_macroscopic()[0]  # finest level
    umax = float(np.abs(u).max())
    rmean = float(rho.mean())
    print(f"multires distributed sphere done: max|u|={umax:.4f}, mean rho={rmean:.5f}")
    assert np.isfinite(umax) and abs(rmean - 1.0) < 0.05
    return umax


if __name__ == "__main__":
    run()
