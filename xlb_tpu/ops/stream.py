"""Streaming (propagation) operator.

Pull-scheme propagation with periodic wrap, matching the reference
(xlb/operator/stream/stream.py:33-63): population l at voxel x reads from
voxel x - c_l, i.e. ``out[l] = roll(f[l], +c_l)``.  Non-periodic physics is
imposed afterwards by boundary conditions that overwrite shell voxels.

Under GSPMD sharding, ``jnp.roll`` on a sharded axis lowers to an XLA
collective-permute of the one-deep halo between devices -- the same communication
pattern the reference builds by hand with ``lax.ppermute``
(distribute.py:21-46).  An explicit shard_map halo-exchange variant lives in
``xlb_tpu.parallel`` for when manual overlap control is needed.
"""

import jax.numpy as jnp

from xlb_tpu.operator import Operator


def stream_pull(f, c):
    """Pull-stream all q populations: out[l] = roll(f[l], shift=c[:, l])."""
    spatial_axes = tuple(range(f.ndim - 1))
    return jnp.stack([jnp.roll(f[l], shift=tuple(int(s) for s in c[:, l]), axis=spatial_axes) for l in range(c.shape[1])])


def stream_push(f, c):
    """Push-stream all q populations: out[l] = roll(f[l], shift=-c[:, l])."""
    return stream_pull(f, -c)


class Stream(Operator):
    """Pull-scheme streaming operator (periodic by construction)."""

    def __call__(self, f):
        return stream_pull(f, self.velocity_set._c)
