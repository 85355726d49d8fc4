"""GSPMD-sharded computational grid.

Replaces the reference's per-backend grids (xlb/grid/jax_grid.py,
warp_grid.py, neon_grid.py) with a single grid that is sharded over an N-D
``jax.sharding.Mesh`` from day one.  The reference only ever shards 1-D over
x (jax_grid.py:24-36); here the device mesh may decompose any subset of the
spatial axes, and fields are allocated directly on-device with
``jit(..., out_shardings=...)`` -- no host round trip.
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from xlb_tpu.default_config import DefaultConfig
from xlb_tpu.precision_policy import Precision

_AXIS_NAMES = ("x", "y", "z")


class Grid:
    """A dense rectangular domain sharded over a device mesh.

    Fields created by :meth:`create_field` have shape
    ``(cardinality, *shape)`` with partition spec ``(None, "x", "y"[, "z"])``;
    the leading cardinality axis (populations / vector components) is always
    replicated -- sharding it would split the lattice directions, which every
    operator needs locally.

    Parameters
    ----------
    shape : tuple of int
        Spatial extents ``(nx, ny[, nz])``.
    mesh_shape : tuple of int, optional
        Device-mesh extents over the spatial axes; defaults to all devices on
        x, matching the reference's decomposition (jax_grid.py:24-26).
    devices : sequence of jax.Device, optional
        Devices to use (defaults to ``jax.devices()``).
    """

    def __init__(self, shape: Tuple[int, ...], mesh_shape: Optional[Tuple[int, ...]] = None, devices: Optional[Sequence] = None):
        self.shape = tuple(int(s) for s in shape)
        self.dim = len(self.shape)
        if self.dim not in (2, 3):
            raise ValueError(f"grid must be 2-D or 3-D, got shape {shape}")

        devices = list(devices) if devices is not None else jax.devices()
        self.nDevices = len(devices)

        if mesh_shape is None:
            mesh_shape = (self.nDevices,) + (1,) * (self.dim - 1)
        mesh_shape = tuple(int(m) for m in mesh_shape)
        if len(mesh_shape) != self.dim:
            raise ValueError(f"mesh_shape must have {self.dim} entries, got {mesh_shape}")
        if int(np.prod(mesh_shape)) != self.nDevices:
            raise ValueError(f"mesh_shape {mesh_shape} does not use all {self.nDevices} devices")
        for extent, parts, name in zip(self.shape, mesh_shape, _AXIS_NAMES):
            if extent % parts != 0:
                raise ValueError(f"axis {name}: extent {extent} not divisible by mesh size {parts}")
        self.mesh_shape = mesh_shape

        self.axis_names = _AXIS_NAMES[: self.dim]
        device_array = np.asarray(devices).reshape((1,) + mesh_shape)
        # keep a leading replicated "cardinality" axis in the mesh for parity
        # with the reference's mesh layout (jax_grid.py:24-36)
        self.global_mesh = Mesh(device_array, axis_names=("cardinality",) + self.axis_names)
        self.field_spec = P(None, *self.axis_names)
        self.sharding = NamedSharding(self.global_mesh, self.field_spec)
        self.scalar_spec = P(*self.axis_names)

    # ------------------------------------------------------------------
    def create_field(self, cardinality: int, dtype: Optional[Precision] = None, fill_value=None):
        """Allocate a ``(cardinality, *shape)`` field directly on the mesh."""
        if dtype is None:
            dtype = DefaultConfig.default_precision_policy.store_precision
        jdtype = dtype.jax_dtype if isinstance(dtype, Precision) else dtype
        full_shape = (int(cardinality),) + self.shape

        def _alloc():
            if fill_value is not None:
                return jnp.full(full_shape, fill_value, dtype=jdtype)
            return jnp.zeros(full_shape, dtype=jdtype)

        return jax.jit(_alloc, out_shardings=self.sharding)()

    def with_sharding(self, array):
        """Reshard/commit an existing array onto this grid's layout."""
        return jax.device_put(array, self.sharding)

    # ------------------------------------------------------------------
    def bounding_box_indices(self, shape=None, remove_edges=False):
        """Per-face voxel index lists of the domain's outer shell.

        Matches the reference helper (grid/grid.py:135-191): returns a dict
        mapping face names to ``(dim, n)`` nested lists, with ``remove_edges``
        trimming the first/last rows of each face so that edge/corner voxels
        are not claimed by two faces.
        """
        shape = tuple(shape) if shape is not None else self.shape
        lo = 1 if remove_edges else 0
        grid = np.indices(shape)
        d = len(shape)

        if d == 2:
            nx, ny = shape
            sx = slice(lo, nx - lo)
            sy = slice(lo, ny - lo)
            faces = {
                "bottom": grid[:, sx, 0],
                "top": grid[:, sx, ny - 1],
                "left": grid[:, 0, sy],
                "right": grid[:, nx - 1, sy],
            }
        else:
            nx, ny, nz = shape
            sx = slice(lo, nx - lo)
            sy = slice(lo, ny - lo)
            sz = slice(lo, nz - lo)
            faces = {
                "bottom": grid[:, sx, sy, 0].reshape(3, -1),
                "top": grid[:, sx, sy, nz - 1].reshape(3, -1),
                "left": grid[:, 0, sy, sz].reshape(3, -1),
                "right": grid[:, nx - 1, sy, sz].reshape(3, -1),
                "front": grid[:, sx, 0, sz].reshape(3, -1),
                "back": grid[:, sx, ny - 1, sz].reshape(3, -1),
            }
        return {k: v.reshape(d, -1).tolist() for k, v in faces.items()}

    def __repr__(self):
        return f"Grid(shape={self.shape}, mesh={dict(zip(self.axis_names, self.mesh_shape))})"


def grid_factory(shape, compute_backend=None, velocity_set=None, mesh_shape=None, devices=None):
    """Create a grid (reference xlb/grid/grid.py:19-58).

    ``compute_backend`` / ``velocity_set`` are accepted for signature parity;
    the single dense grid serves both the JAX and PALLAS tiers.
    """
    return Grid(shape, mesh_shape=mesh_shape, devices=devices)
