"""Multi-device distribution: shard_map wrapping + explicit halo exchange.

Two distribution modes (SURVEY.md §5 "distributed communication backend"):

1. **GSPMD (implicit, default).** Fields created by ``Grid.create_field`` are
   sharded; running the jnp-tier stepper under ``jax.jit`` lets XLA insert
   collective-permutes for the rolls on sharded axes.  Zero wrapper code,
   works for any mesh decomposition.

2. **shard_map + ppermute (explicit, this module).** The reference's scheme
   (distribute.py:10-79): run the operator per-shard with local periodic
   wrap, then patch the shard-edge populations with a ring exchange of
   direction-resolved halo slabs.  Generalized here from the reference's
   1-D x decomposition to every sharded spatial axis.  Useful when manual
   control of communication/compute overlap is needed.

The exchanged quantity is one lattice-deep slabs of the populations whose
direction crosses the shard boundary (c_axis = +-1), identical to the
reference's right_indices/left_indices exchange.
"""

from functools import partial

import numpy as np
import jax
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from xlb_tpu.boundary.base import ImplementationStep


def _halo_patch(result, velocity_set, axis_name, axis_index, n_shards):
    """Patch the wrongly-wrapped shard edges of a locally-streamed field.

    After a per-shard periodic pull-stream along a sharded axis, the first
    slab's downstream-moving populations came from this shard's own last
    slab; they must come from the left neighbor's last slab (and vice
    versa).  Two ppermute rings fix both edges (reference distribute.py:21-46).
    """
    c = velocity_set._c
    d = axis_index  # spatial axis index (0=x, 1=y, 2=z)
    plus = np.nonzero(c[d] == 1)[0]  # directions crossing + boundary
    minus = np.nonzero(c[d] == -1)[0]

    right_perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    left_perm = [((i + 1) % n_shards, i) for i in range(n_shards)]

    spatial_ndim = result.ndim - 1
    first = [slice(None)] * spatial_ndim
    first[d] = slice(0, 1)
    first = tuple(first)
    last = [slice(None)] * spatial_ndim
    last[d] = slice(-1, None)
    last = tuple(last)

    # After the local periodic wrap, this shard's first-slab +d populations
    # equal its own pre-stream last slab -- which is exactly what the RIGHT
    # neighbor's first slab should have pulled.  So each shard forwards its
    # wrongly-wrapped edge values to the neighbor they are correct for
    # (reference distribute.py:27-46).
    from_left = lax.ppermute(result[(plus,) + first], perm=right_perm, axis_name=axis_name)
    from_right = lax.ppermute(result[(minus,) + last], perm=left_perm, axis_name=axis_name)

    result = result.at[(plus,) + first].set(from_left)
    result = result.at[(minus,) + last].set(from_right)
    return result


def distribute_operator(operator, grid, velocity_set, num_results=1, ops="permute", exchange_axes=None):
    """Wrap ``operator`` in shard_map with post-hoc halo patching on every
    sharded spatial axis (reference distribute.py:10-79, generalized N-D)."""
    if ops != "permute":
        raise NotImplementedError(f"operation {ops!r} not implemented")

    sharded_axes = [(i, name) for i, (name, parts) in enumerate(zip(grid.axis_names, grid.mesh_shape)) if parts > 1]

    def _sharded(*args):
        result = operator(*args)
        results = result if isinstance(result, tuple) else (result,)
        patched = []
        for r in results:
            if r.shape[1:] == tuple(s // p for s, p in zip(grid.shape, grid.mesh_shape)) or r.shape[1:] == grid.shape:
                for axis_index, axis_name in exchange_axes if exchange_axes is not None else sharded_axes:
                    r = _halo_patch(r, velocity_set, axis_name, axis_index, grid.mesh_shape[axis_index])
            patched.append(r)
        return patched[0] if not isinstance(result, tuple) else tuple(patched)

    def _wrapped(*args):
        in_specs = tuple(grid.field_spec if (hasattr(a, "shape") and a.shape[1:] == grid.shape) else P() for a in args)
        out_specs = grid.field_spec if num_results == 1 else tuple(grid.field_spec for _ in range(num_results))
        return shard_map(_sharded, mesh=grid.global_mesh, in_specs=in_specs, out_specs=out_specs)(*args)

    return jax.jit(_wrapped)


def distribute(operator, grid, velocity_set, num_results=1, ops="permute"):
    """Distribute a stepper or operator (reference distribute.py:82-105).

    For steppers with post-streaming BCs, only the Stream operator is
    distributed so that BCs observe the globally-correct post-stream state;
    otherwise the whole step is wrapped.
    """
    from xlb_tpu.models.nse import IncompressibleNavierStokesStepper

    if isinstance(operator, IncompressibleNavierStokesStepper):
        has_post_streaming_bc = any(bc.implementation_step == ImplementationStep.STREAMING for bc in operator.boundary_conditions)
        if has_post_streaming_bc:
            operator.stream = distribute_operator(operator.stream, grid, velocity_set)
            return operator
        return distribute_operator(operator, grid, velocity_set, num_results=2, ops=ops)
    return distribute_operator(operator, grid, velocity_set, num_results=num_results, ops=ops)
