"""Multi-host entry points.

The reference structures for "hundreds of GPUs" via MPI + NCCL
(reference README.md:116, xlb/distribute/distribute.py); the JAX
equivalent is ``jax.distributed`` with one controller process per host,
XLA collectives over NVLink inside a host and the network between hosts
(SURVEY.md §5).  This module is the single entry point:

1. :func:`init_distributed` -- call ONCE at program start on every
   process, before any array lands on a device.  It wraps
   ``jax.distributed.initialize``; pass the coordinator address, process
   count and process id explicitly (or export ``JAX_COORDINATOR_ADDRESS``,
   ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).

2. :func:`hybrid_mesh_devices` -- devices ordered for an inter-host x
   intra-host factorized mesh (``mesh_utils.create_hybrid_device_mesh``),
   ready to hand to ``grid_factory(shape, mesh_shape=..., devices=...)``
   so that the *outermost sharded spatial axis* spans hosts and the
   remaining axes stay inside a host.  LBM halo exchanges are
   nearest-neighbour, so only the two boundary planes of each host's
   block ever cross the network.

After ``init_distributed``, every ``jax.jit`` over a global
``jax.sharding.Mesh`` is automatically multi-process: each host passes
its process-local shards and XLA inserts the collectives.  The GSPMD jnp
tier (parallel/distribute.py) needs no changes for multi-host.

Tested 2-process x 4-virtual-CPU-devices in
tests/parallel/test_multihost.py (jax.distributed supports multiprocess
CPU).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import jax

__all__ = ["init_distributed", "hybrid_mesh_devices", "is_multiprocess", "process_local_fields"]

_initialized = False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> bool:
    """Initialize the JAX distributed runtime (idempotent).

    Call before xlb.init() / any device computation on EVERY process.
    Returns True if a multi-process runtime was initialized (or already
    was), False when running single-process (no coordinator configured)
    -- in which case everything proceeds exactly as before, so library
    code may call this unconditionally.
    """
    global _initialized
    if _initialized:
        return True
    # NOTE: do not touch jax.devices()/process_count() here -- any backend
    # query would initialise XLA and make jax.distributed.initialize illegal.

    import os

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None:
        return False  # single-process run; nothing to do

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    _initialized = True
    return True


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def hybrid_mesh_devices(
    mesh_shape: Tuple[int, ...],
    num_hosts: Optional[int] = None,
) -> list:
    """Devices ordered so ``Grid(mesh_shape=mesh_shape, devices=...)``
    puts the outermost sharded spatial axis across hosts and the rest
    inside each host.

    Parameters
    ----------
    mesh_shape : spatial device-mesh extents, e.g. ``(8, 4, 1)``; their
        product must equal the global device count.
    num_hosts : number of hosts (default: the process count, one process
        per host).  The *first* axis of ``mesh_shape`` whose extent is
        divisible by ``num_hosts`` spans the hosts.

    Returns a flat device list; pass it together with ``mesh_shape`` to
    :func:`xlb_tpu.grid.grid_factory`.
    """
    from jax.experimental import mesh_utils

    devices = jax.devices()
    n = len(devices)
    if int(np.prod(mesh_shape)) != n:
        raise ValueError(f"mesh_shape {mesh_shape} must use all {n} global devices")

    num_hosts = max(1, int(jax.process_count() if num_hosts is None else num_hosts))
    if num_hosts == 1:
        arr = mesh_utils.create_device_mesh(mesh_shape, devices=devices)
        return list(arr.flatten())

    # Factor mesh_shape = host_shape * local_shape: the first axis divisible
    # by num_hosts spans the hosts (outermost spatial axis first -- LBM
    # halos make that axis's exchanges nearest-neighbour planes).
    for axis, extent in enumerate(mesh_shape):
        if extent % num_hosts == 0 and extent >= num_hosts:
            host_shape = tuple(num_hosts if i == axis else 1 for i in range(len(mesh_shape)))
            local_shape = tuple(extent // num_hosts if i == axis else e for i, e in enumerate(mesh_shape))
            break
    else:
        raise ValueError(
            f"no axis of mesh_shape {mesh_shape} is divisible by num_hosts={num_hosts}; "
            "make one spatial mesh extent a multiple of the host count"
        )
    arr = mesh_utils.create_hybrid_device_mesh(local_shape, host_shape, devices=devices, process_is_granule=True)
    return list(arr.flatten())


def process_local_fields(grid, *global_arrays):
    """Host-side (NumPy) global arrays -> process-local on-device global
    jax.Arrays for ``grid``'s sharding.

    In multi-process mode each host only addresses its own devices;
    ``jax.make_array_from_callback`` lets every process supply just its
    local shards while the result behaves as one global array inside jit.
    Single-process it is equivalent to ``jax.device_put``.
    """
    out = []
    for a in global_arrays:
        a = np.asarray(a)
        if a.ndim != grid.dim + 1:
            raise ValueError(f"expected a (cardinality, *spatial) field, got shape {a.shape}")
        out.append(jax.make_array_from_callback(a.shape, grid.sharding, lambda idx, _a=a: _a[idx]))
    return out if len(out) > 1 else out[0]
