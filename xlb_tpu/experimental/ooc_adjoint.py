"""Differentiable out-of-core runs: host-checkpointed slab-exact adjoint.

Counterpart of the reference's OOC autodiff pipeline
(examples/out_of_core/autodiff_lbm.py + subroutine/{autodiff_stepper_
subroutine.py,rho_loss_subroutine.py}): there, Warp adjoint kernels walk
host-resident checkpoints under manual gradient-tape subroutines.  Here
the same capability is three pieces of plain JAX:

- **Forward** (:meth:`OOCAdjointSolver.forward`): the hardened
  :func:`~xlb_tpu.experimental.ooc.ooc_map` sweep machinery, snapshotting
  the pre-sweep state to host RAM every ``checkpoint_every`` sweeps.
- **Slab-exact adjoint sweep** (:func:`ooc_vjp_sweep`): the adjoint of a
  g-step window is local with the same ghost depth g (each reverse step
  is a push-side gather), so the global cotangent decomposes EXACTLY over
  slabs: every output slab's ``jax.vjp`` produces a cotangent over its
  padded input extent, and the overlapping padded cotangents scatter-add
  (periodic wrap) into the global pre-sweep cotangent.  Each global
  output voxel belongs to exactly one slab interior, so the sum equals
  the in-core VJP to roundoff (tests/models/test_ooc_adjoint.py).
- **Checkpoint/recompute schedule** (:meth:`loss_and_grad`): sweeps not
  at a stored checkpoint are recomputed forward from the nearest one
  (classic two-level checkpointing), bounding peak host RAM at
  ``num_sweeps/checkpoint_every + checkpoint_every`` domain copies.

The per-slab window differentiates through whatever tier runs it: the
jnp tier via native autodiff, the fused Pallas tier via its custom_vjp
(whose backward is the jnp tier's VJP) -- no hand-written tape.

Voxel-local losses only (L2 on density, etc.): the loss is a sum of
per-tile terms, so its cotangent needs no ghost exchange.  Gradients are
w.r.t. the initial populations; omega gradients are not accumulated
across sweeps (use the in-core path for parameter gradients on domains
that fit device memory).
"""

import numpy as np
import jax
import jax.numpy as jnp

from xlb_tpu.experimental.ooc import OOCArray, ooc_map
from xlb_tpu.utils import tiers


def _wrap_accumulate(acc, df_pad, start, ghost, axis=1):
    """Scatter-add a padded-slab cotangent into the global array with
    periodic wrap on the tiled axis (host side)."""
    ext = acc.shape[axis]
    idx = (np.arange(start - ghost, start + df_pad.shape[axis] - ghost)) % ext
    # np.add.at handles the wrap overlap (a slab narrower than 2*ghost
    # can alias itself); for the common non-aliased case use fast slices
    sl = [slice(None)] * acc.ndim

    def _add(rows, chunk):
        if len(rows) == 0:
            return
        if rows[-1] - rows[0] == len(rows) - 1:  # contiguous
            sl[axis] = slice(rows[0], rows[-1] + 1)
            acc[tuple(sl)] += chunk
        else:
            np.add.at(acc, tuple(sl[:axis] + [rows] + sl[axis + 1 :]), chunk)

    # split into [lo ghost | interior | hi ghost] so each piece is contiguous
    take = lambda a, b: np.take(df_pad, np.arange(a, b), axis=axis)
    _add(idx[:ghost], take(0, ghost))
    _add(idx[ghost : len(idx) - ghost], take(ghost, len(idx) - ghost))
    _add(idx[len(idx) - ghost :], take(len(idx) - ghost, len(idx)))


_JIT_CACHE = {}


def _cached_jit(fn, transform=None):
    """jax.jit(fn) (optionally of a transform of fn) cached on identity so
    repeated sweeps/evaluations hit the compile cache."""
    key = (id(fn), transform)
    hit = _JIT_CACHE.get(key)
    if hit is not None and hit[0] is fn:  # guard id() reuse
        return hit[1]
    jitted = jax.jit(fn if transform is None else transform(fn))
    _JIT_CACHE[key] = (fn, jitted)
    return jitted


_TILE_VJP_CACHE = {}


def _tile_vjp_for(window_fn):
    """Jitted per-tile VJP of a padded-slab window, cached so repeated
    sweeps through the same window hit the compile cache."""
    key = id(window_fn)
    hit = _TILE_VJP_CACHE.get(key)
    if hit is not None and hit[0] is window_fn:  # guard id() reuse
        return hit[1]

    @jax.jit
    def tile_vjp(f_pad, bc_pad, miss_pad, cot_pad, om):
        _, vjp = jax.vjp(lambda f: window_fn(f, bc_pad, miss_pad, om), f_pad)
        (df,) = vjp(cot_pad)
        return df

    _TILE_VJP_CACHE[key] = (window_fn, tile_vjp)
    return tile_vjp


def ooc_vjp_sweep(window_fn, f_prev, bc, miss, ghost, cot, omega):
    """Cotangent of one OOC sweep: given the PRE-sweep field ``f_prev``
    (host OOCArray), the masks, and the cotangent ``cot`` (host ndarray)
    of the POST-sweep field, return the cotangent of ``f_prev`` as a host
    ndarray.  ``window_fn(f_pad, bc_pad, miss_pad, omega) -> f_pad_out``
    is the same jittable padded-slab window the forward sweep ran."""
    ax = f_prev.tile_axis
    n, ext = f_prev.num_tiles, f_prev.tile_extent
    tile_vjp = _tile_vjp_for(window_fn)

    acc = np.zeros(f_prev.shape, dtype=np.float32)
    pad_shape = list(cot.shape)
    pad_shape[ax] = ghost
    zeros = np.zeros(pad_shape, dtype=cot.dtype)
    sl = [slice(None)] * cot.ndim
    pending = None
    for i in range(n):
        sl[ax] = slice(i * ext, (i + 1) * ext)
        cot_pad = np.concatenate([zeros, cot[tuple(sl)], zeros], axis=ax)
        df = tile_vjp(
            jnp.asarray(f_prev.padded_tile(i, ghost)),
            jnp.asarray(bc.padded_tile(i, ghost)),
            jnp.asarray(miss.padded_tile(i, ghost)),
            jnp.asarray(cot_pad),
            omega,
        )  # enqueued asynchronously; previous tile's writeback overlaps
        if pending is not None:
            j, dfj = pending
            _wrap_accumulate(acc, np.asarray(dfj, dtype=np.float32), j * ext, ghost, ax)
        pending = (i, df)
    j, dfj = pending
    _wrap_accumulate(acc, np.asarray(dfj, dtype=np.float32), j * ext, ghost, ax)
    return acc


class OOCAdjointSolver:
    """Out-of-core forward + adjoint driver (reference
    examples/out_of_core/autodiff_lbm.py:64-141 capability).

    Parameters mirror :class:`~xlb_tpu.experimental.ooc.OOCNSESolver`;
    ``checkpoint_every`` is in sweeps (one sweep = ``steps_per_sweep``
    LBM steps)."""

    def __init__(self, stepper, num_tiles, steps_per_sweep=2, checkpoint_every=1, tier="auto"):
        self.stepper = stepper
        self.num_tiles = int(num_tiles)
        self.g = int(steps_per_sweep)
        self.checkpoint_every = int(checkpoint_every)
        self.tier = tier
        self._window = None

    def prepare(self, f_init=None):
        f_0, _, bc_mask, missing_mask = self.stepper.prepare_fields()
        f_host = np.asarray(f_0) if f_init is None else np.asarray(f_init, dtype=np.asarray(f_0).dtype)
        self.f = OOCArray.from_array(f_host, num_tiles=self.num_tiles)
        self.bc_mask = OOCArray.from_array(np.asarray(bc_mask), num_tiles=self.num_tiles)
        self.missing_mask = OOCArray.from_array(np.asarray(missing_mask), num_tiles=self.num_tiles)
        del f_0
        return self

    # -- padded-slab window (shared by forward sweep and vjp sweep) ------
    def _window_fn(self):
        if self._window is not None:
            return self._window
        stepper, g = self.stepper, self.g
        want_fused = self.tier == "fused" or (self.tier == "auto" and tiers.fused_by_default())
        window = None
        if want_fused:
            try:
                # build_fused_STEP, not _window: the step carries the
                # custom_vjp that makes the whole window reverse-differentiable
                from xlb_tpu.kernels.fused_step import build_fused_step

                slab_shape = list(stepper.grid.shape)
                slab_shape[0] = self.f.tile_extent + 2 * g
                step = build_fused_step(stepper, shape_override=tuple(slab_shape))

                def window(f, bc, miss, omega):
                    def body(t, carry):
                        a, b = carry
                        a, b = step(a, b, bc, miss, omega, t)
                        return (b, a)

                    a, _ = jax.lax.fori_loop(0, g, body, (f, f))
                    return a.astype(f.dtype)
            except (NotImplementedError, AssertionError):
                if self.tier == "fused":
                    raise
                window = None
        if window is None:

            def window(f, bc, miss, omega):
                def body(t, carry):
                    a, b = carry
                    a, b = stepper(a, b, bc, miss, omega, t)
                    return (b, a)

                a, _ = jax.lax.fori_loop(0, g, body, (f, f))
                return a

        self._window = window
        self._window_jit = jax.jit(window)
        return window

    def forward(self, num_sweeps, omega):
        """Advance ``num_sweeps * steps_per_sweep`` LBM steps in place."""
        self._window_fn()
        om = (jnp.asarray(omega, dtype=jnp.float32),)
        for _ in range(num_sweeps):
            ooc_map(self._window_jit, [self.f, self.bc_mask, self.missing_mask], ghost=self.g, extra_args=om)
        return self.f.to_numpy()

    def loss_only(self, loss_tile_fn, num_sweeps, omega, f_init=None):
        """Forward-only loss evaluation (no checkpoints, no backward) --
        e.g. for line searches around :meth:`loss_and_grad` steps."""
        if f_init is not None:
            self.f.data[...] = np.asarray(f_init, dtype=self.f.data.dtype)
        f0 = self.f.data.copy()
        self.forward(num_sweeps, omega)
        ax, ext, n = self.f.tile_axis, self.f.tile_extent, self.f.num_tiles
        fns = loss_tile_fn if isinstance(loss_tile_fn, (list, tuple)) else [loss_tile_fn] * n
        loss = 0.0
        sl = [slice(None)] * len(self.f.shape)
        for i in range(n):
            sl[ax] = slice(i * ext, (i + 1) * ext)
            loss += float(_cached_jit(fns[i])(jnp.asarray(self.f.data[tuple(sl)])))
        self.f.data[...] = f0
        return loss

    def loss_and_grad(self, loss_tile_fn, num_sweeps, omega, f_init=None):
        """Run ``num_sweeps`` sweeps from ``f_init`` (or the prepared
        state), evaluate ``loss = sum_i loss_tile_fn(f_tile_i)`` on the
        final state, and return ``(loss, dloss/df_initial)`` with the
        gradient as a host float32 ndarray.

        ``loss_tile_fn(f_tile) -> scalar`` must be voxel-local (a sum of
        per-voxel terms) so the per-tile losses partition the global loss.
        Pass a LIST of ``num_tiles`` functions for spatially-varying
        targets (tile i is scored by ``loss_tile_fn[i]``).
        """
        if f_init is not None:
            self.f.data[...] = np.asarray(f_init, dtype=self.f.data.dtype)
        f0 = self.f.data.copy()

        # forward, storing checkpoints at the cadence
        checkpoints = {}
        window = self._window_fn()
        om = (jnp.asarray(omega, dtype=jnp.float32),)
        for s in range(num_sweeps):
            if s % self.checkpoint_every == 0:
                checkpoints[s] = self.f.data.copy()
            ooc_map(self._window_jit, [self.f, self.bc_mask, self.missing_mask], ghost=self.g, extra_args=om)

        # loss + its cotangent, tile by tile (voxel-local: no ghost)
        ax, ext, n = self.f.tile_axis, self.f.tile_extent, self.f.num_tiles
        fns = loss_tile_fn if isinstance(loss_tile_fn, (list, tuple)) else [loss_tile_fn] * n
        if len(fns) != n:
            raise ValueError(f"need one loss fn per tile: got {len(fns)} for {n} tiles")
        graders = [_cached_jit(fn, transform=jax.value_and_grad) for fn in fns]

        loss = 0.0
        cot = np.zeros(self.f.shape, dtype=np.float32)
        sl = [slice(None)] * len(self.f.shape)
        for i in range(n):
            sl[ax] = slice(i * ext, (i + 1) * ext)
            li, gi = graders[i](jnp.asarray(self.f.data[tuple(sl)]))
            loss += float(li)
            cot[tuple(sl)] = np.asarray(gi, dtype=np.float32)

        # backward: recompute each segment forward from its checkpoint,
        # then vjp-sweep back through it
        for seg_start in sorted(checkpoints.keys(), reverse=True):
            seg_end = min(seg_start + self.checkpoint_every, num_sweeps)
            states = [checkpoints[seg_start]]
            if seg_end - seg_start > 1:
                self.f.data[...] = checkpoints[seg_start]
                for s in range(seg_start, seg_end - 1):
                    ooc_map(self._window_jit, [self.f, self.bc_mask, self.missing_mask], ghost=self.g, extra_args=om)
                    states.append(self.f.data.copy())
            for s in range(seg_end - 1, seg_start - 1, -1):
                f_prev = OOCArray.from_array(states[s - seg_start], num_tiles=self.num_tiles)
                cot = ooc_vjp_sweep(window, f_prev, self.bc_mask, self.missing_mask, self.g, cot, omega)

        self.f.data[...] = f0  # restore: loss_and_grad is side-effect free
        return loss, cot
