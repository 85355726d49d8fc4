"""Multi-host entry point (VERDICT r2 #5): 2 processes x 4 virtual CPU
devices run the jnp distributed stepper over one global 8-device mesh via
``xlb_tpu.parallel.init_distributed`` + ``hybrid_mesh_devices``; the
gathered global field must match a plain single-process run of the same
scene (reference scale claim README.md:116; SURVEY §5).
"""

import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from tests.conftest import init_env

HERE = pathlib.Path(__file__).resolve().parent
WORKER = HERE / "multihost_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _single_process_reference():
    """The worker's scene, run normally in this (8-virtual-device) process."""
    import xlb_tpu as xlb
    from xlb_tpu.boundary import EquilibriumBC, FullwayBounceBackBC
    from xlb_tpu.grid import grid_factory
    from xlb_tpu.models import IncompressibleNavierStokesStepper
    from xlb_tpu.velocity_set import D3Q19

    init_env(D3Q19)
    grid = grid_factory((32, 16, 16), mesh_shape=(8, 1, 1))
    box = grid.bounding_box_indices()
    box_ne = grid.bounding_box_indices(remove_edges=True)
    walls = np.unique(
        np.concatenate(
            [np.asarray(box[k]) for k in ("bottom", "top", "front", "back", "right")], axis=1
        ),
        axis=1,
    )
    bcs = [
        FullwayBounceBackBC(indices=walls.tolist()),
        EquilibriumBC(rho=1.0, u=(0.02, 0.0, 0.0), indices=box_ne["left"]),
    ]
    stepper = IncompressibleNavierStokesStepper(grid, boundary_conditions=bcs)
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()
    run = stepper.build_multi_step(8, donate=False)
    f_0, _ = run(f_0, f_1, bc_mask, missing_mask, 1.2)
    return np.asarray(f_0)


@pytest.mark.slow
def test_two_process_parity():
    expected = _single_process_reference()

    port = _free_port()
    out = pathlib.Path(tempfile.mkdtemp()) / "multihost_f0.npy"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), "2", str(port), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        logs.append(stdout.decode(errors="replace"))
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log}"

    got = np.load(out)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)
