"""Worker process for the multi-host test (see test_multihost.py).

Launched N times with distinct process ids; every process executes the
same program over a global 8-device mesh (2 processes x 4 virtual CPU
devices).  Rank 0 writes the gathered global field to ``<out>`` so the
parent test can compare it against a plain single-process run of the
identical scene.

Usage: python multihost_worker.py <process_id> <num_processes> <port> <out.npy>
"""

import os
import pathlib
import sys

REPO = str(pathlib.Path(__file__).resolve().parents[2])

pid, nproc, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, REPO)

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")

from xlb_tpu.parallel.multihost import hybrid_mesh_devices, init_distributed, is_multiprocess

ok = init_distributed(coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid)
assert ok, "init_distributed returned False despite an explicit coordinator"
assert is_multiprocess() == (nproc > 1)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.local_devices()) == 4
assert len(jax.devices()) == 4 * nproc

import xlb_tpu as xlb
from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.velocity_set import D3Q19

xlb.init(
    velocity_set=D3Q19(),
    default_backend=xlb.ComputeBackend.JAX,
    default_precision_policy=xlb.PrecisionPolicy.FP32FP32,
)

mesh_shape = (4 * nproc, 1, 1)
devices = hybrid_mesh_devices(mesh_shape)  # the host axis = outermost sharded x
grid = grid_factory((32, 16, 16), mesh_shape=mesh_shape, devices=devices)
box = grid.bounding_box_indices()
box_ne = grid.bounding_box_indices(remove_edges=True)
walls = np.unique(
    np.concatenate([np.asarray(box[k]) for k in ("bottom", "top", "front", "back", "right")], axis=1),
    axis=1,
)
bcs = [
    FullwayBounceBackBC(indices=walls.tolist()),
    EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["left"]),
]
stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()

run = stepper.build_multi_step(8, donate=False)
f_0, f_1 = run(f_0, f_1, bc_mask, missing_mask, 1.2)

from jax.experimental import multihost_utils

full = multihost_utils.process_allgather(f_0, tiled=True)
if pid == 0:
    np.save(out, np.asarray(full))
print(f"worker {pid}: done", flush=True)
