"""Out-of-core execution: domains bigger than device HBM.

Counterpart of the reference's experimental OOC subsystem
(xlb/experimental/ooc/{out_of_core.py,ooc_array.py}): there, CuPy tile
rings with pinned host buffers and optional MPI stream GPU-sized tiles
through the device.  Here the domain lives in host RAM as a NumPy array
split into x-slabs with ghost layers; :func:`ooc_map` streams each padded
slab through the device function and writes back the valid interior.

A sweep with ghost width ``g`` advances ``g`` LBM steps per host<->device
round trip (the pull stencil consumes one ghost layer per step), amortizing
PCIe transfers -- the same trick as the reference's
``padding``/sub-stepping (ooc_array.py ghost machinery).

Hardened design (vs the reference's cupy ring and our first cut):

- **In-place writeback, O(ghost) extra memory**: tiles are written back
  into the SAME host array while neighbors still see pre-sweep values --
  only the ghost-deep boundary strips each neighbor will read are cached
  before being overwritten (the old version allocated a full-domain copy
  per sweep, doubling host RAM for billion-cell domains).
- **Transfer/compute overlap**: JAX dispatch is asynchronous, so tile
  i+1's upload and compute are enqueued BEFORE tile i's result is fetched;
  the host-side writeback of tile i then runs concurrently with the
  device computing tile i+1 (the reference needs pinned buffers + CUDA
  streams for the same effect, ooc_array.py).
- **Multi-array sweeps**: ``fn`` may return a tuple, written back to
  several OOCArrays in one pass (e.g. populations + a tracked scalar
  field), so aux fields don't pay their own sweep.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from xlb_tpu.utils import tiers


class OOCArray:
    """A host-RAM-resident field logically split into tiles along one
    spatial axis (parity surface with reference ooc_array.py:15-440).

    Parameters
    ----------
    shape : tuple
        Global field shape, e.g. ``(q, X, Y, Z)``.
    dtype : numpy dtype
    tile_axis : int
        Axis to slab (default 1 = x).
    num_tiles : int
    """

    def __init__(self, shape, dtype=np.float32, tile_axis=1, num_tiles=1, fill_value=None):
        self.shape = tuple(shape)
        self.tile_axis = int(tile_axis)
        self.num_tiles = int(num_tiles)
        extent = self.shape[self.tile_axis]
        if extent % self.num_tiles:
            raise ValueError(f"axis extent {extent} not divisible into {num_tiles} tiles")
        self.tile_extent = extent // self.num_tiles
        self.data = (
            np.full(self.shape, fill_value, dtype=dtype) if fill_value is not None else np.zeros(self.shape, dtype=dtype)
        )

    @classmethod
    def from_array(cls, array, tile_axis=1, num_tiles=1):
        array = np.asarray(array)
        out = cls(array.shape, array.dtype, tile_axis, num_tiles)
        out.data[...] = array
        return out

    def _axis_slice(self, start, stop):
        sl = [slice(None)] * len(self.shape)
        sl[self.tile_axis] = slice(start, stop)
        return tuple(sl)

    def padded_tile(self, i, ghost, lo_override=None, hi_override=None):
        """Tile ``i`` with ``ghost`` wrap-around layers on the tiled axis.
        ``lo_override``/``hi_override`` substitute cached pre-sweep ghost
        strips when the neighbor has already been updated in place."""
        ax = self.tile_axis
        ext = self.shape[ax]
        start = i * self.tile_extent
        lo = lo_override if lo_override is not None else np.take(
            self.data, (np.arange(start - ghost, start)) % ext, axis=ax
        )
        hi = hi_override if hi_override is not None else np.take(
            self.data, (np.arange(start + self.tile_extent, start + self.tile_extent + ghost)) % ext, axis=ax
        )
        mid = self.data[self._axis_slice(start, start + self.tile_extent)]
        return np.concatenate([lo, mid, hi], axis=ax)

    def write_tile(self, i, tile_interior):
        self.data[self._axis_slice(i * self.tile_extent, (i + 1) * self.tile_extent)] = np.asarray(tile_interior)

    def head_strip(self, ghost):
        """Copy of the first ``ghost`` layers on the tiled axis (cached by
        ooc_map before a sweep: the wrap ghost of the last tile)."""
        return self.data[self._axis_slice(0, ghost)].copy()

    def apply_tiles(self, fn):
        """In-place per-tile transform ``tile -> tile`` (same shape/dtype),
        e.g. the plain <-> deviation-form conversion of the populations."""
        for i in range(self.num_tiles):
            sl = self._axis_slice(i * self.tile_extent, (i + 1) * self.tile_extent)
            self.data[sl] = fn(self.data[sl])

    def to_numpy(self):
        return self.data


class CompressedOOCArray(OOCArray):
    """An OOCArray whose tiles live byte-shuffle + zstd compressed in host
    RAM (capability parity with the reference's nvComp compressed tiles,
    ooc/tiles/compressed_tile.py:68-248 -- there LZ4 on the GPU, here the
    native host codec in experimental/native/compress.cpp).

    Smooth flow fields compress 10-40x, so a domain whose raw populations
    exceed host RAM can still be swept; each tile decompresses on access
    (~1 GB/s/core) and recompresses on writeback, overlapped with the next
    tile's device compute by ooc_map's deferred-writeback pipeline.

    ``ghost_cache`` layers of each tile's boundary strips are ALSO kept
    uncompressed (O(ghost) memory) so neighbors' ghost reads never
    decompress adjacent tiles; sweeps may use any ghost <= ghost_cache.
    """

    def __init__(self, shape, dtype=np.float32, tile_axis=1, num_tiles=1, fill_value=None, ghost_cache=8, level=1):
        from xlb_tpu.experimental import native as _codec

        self._codec = _codec
        self.shape = tuple(shape)
        self.tile_axis = int(tile_axis)
        self.num_tiles = int(num_tiles)
        extent = self.shape[self.tile_axis]
        if extent % self.num_tiles:
            raise ValueError(f"axis extent {extent} not divisible into {num_tiles} tiles")
        self.tile_extent = extent // self.num_tiles
        if ghost_cache > self.tile_extent:
            raise ValueError(f"ghost_cache {ghost_cache} exceeds tile extent {self.tile_extent}")
        self.dtype = np.dtype(dtype)
        self.ghost_cache = int(ghost_cache)
        self.level = int(level)
        tile_shape = list(self.shape)
        tile_shape[self.tile_axis] = self.tile_extent
        self._tile_shape = tuple(tile_shape)
        self._blobs = [None] * self.num_tiles
        self._lo = [None] * self.num_tiles  # first ghost_cache layers, uncompressed
        self._hi = [None] * self.num_tiles  # last ghost_cache layers, uncompressed
        # all tiles start identical: compress the fill tile ONCE and share
        # the blob/edge strips (write_tile replaces refs, never mutates)
        init = np.full(self._tile_shape, fill_value, dtype=self.dtype) if fill_value is not None else np.zeros(self._tile_shape, self.dtype)
        self._store(0, init)
        for i in range(1, self.num_tiles):
            self._blobs[i] = self._blobs[0]
            self._lo[i] = self._lo[0]
            self._hi[i] = self._hi[0]

    @classmethod
    def from_array(cls, array, tile_axis=1, num_tiles=1, ghost_cache=8, level=1):
        array = np.asarray(array)
        out = cls(array.shape, array.dtype, tile_axis, num_tiles, ghost_cache=ghost_cache, level=level)
        ext = out.tile_extent
        for i in range(num_tiles):
            out._store(i, array[out._axis_slice(i * ext, (i + 1) * ext)])
        return out

    def _store(self, i, tile):
        tile = np.ascontiguousarray(tile, dtype=self.dtype)
        self._blobs[i] = self._codec.compress(tile, level=self.level)
        g = self.ghost_cache
        ax = self.tile_axis
        sl = [slice(None)] * len(self.shape)
        sl[ax] = slice(0, g)
        self._lo[i] = tile[tuple(sl)].copy()
        sl[ax] = slice(self.tile_extent - g, self.tile_extent)
        self._hi[i] = tile[tuple(sl)].copy()

    def _tile(self, i):
        return self._codec.decompress(self._blobs[i], self._tile_shape, self.dtype)

    def padded_tile(self, i, ghost, lo_override=None, hi_override=None):
        if ghost > self.ghost_cache:
            raise ValueError(f"ghost {ghost} exceeds ghost_cache {self.ghost_cache}")
        ax = self.tile_axis
        n = self.num_tiles
        sl = [slice(None)] * len(self.shape)
        if lo_override is None:
            sl[ax] = slice(self.ghost_cache - ghost, self.ghost_cache)
            lo_override = self._hi[(i - 1) % n][tuple(sl)]
        if hi_override is None:
            sl[ax] = slice(0, ghost)
            hi_override = self._lo[(i + 1) % n][tuple(sl)]
        return np.concatenate([lo_override, self._tile(i), hi_override], axis=ax)

    def write_tile(self, i, tile_interior):
        self._store(i, tile_interior)

    def head_strip(self, ghost):
        sl = [slice(None)] * len(self.shape)
        sl[self.tile_axis] = slice(0, ghost)
        return self._lo[0][tuple(sl)].copy()

    def apply_tiles(self, fn):
        for i in range(self.num_tiles):
            self._store(i, fn(self._tile(i)))

    def compressed_nbytes(self):
        return sum(len(b) for b in self._blobs)

    def to_numpy(self):
        return np.concatenate([self._tile(i) for i in range(self.num_tiles)], axis=self.tile_axis)


def ooc_map(fn, ooc_arrays, ghost=1, out_index=0, extra_args=(), sharding=None):
    """Run ``fn`` tile-by-tile over padded tiles of the given OOCArrays
    (parity surface with the reference's OOCmap decorator,
    out_of_core.py:12-110).

    ``fn(*padded_tiles, *extra_args) -> padded_out`` (or a tuple of padded
    outputs) must be jittable; the valid interior of each output (ghost
    layers stripped on the tiled axis) is written back to
    ``ooc_arrays[out_index]`` (``out_index`` may be a sequence for
    multi-output fns).  All tiles read the PRE-sweep state of their
    neighbors; writeback is in place with only the ghost-deep boundary
    strips cached.

    Pass an ALREADY-JITTED ``fn`` (it is detected and not re-wrapped) when
    calling ooc_map repeatedly -- a fresh closure per sweep would re-trace
    and re-lower the whole per-slab window every sweep.  Sweep-varying
    scalars (omega, ...) belong in ``extra_args`` so they ride as traced
    arguments instead of baked constants.

    ``sharding``: an optional ``jax.sharding.Sharding`` (e.g. a
    ``NamedSharding`` over a device mesh on the NON-tiled axes).  Each
    uploaded tile is placed with it, so the per-tile compute runs GSPMD
    across all chips while the domain streams through host RAM -- chips
    AND host memory compose (the reference's OOC is single-GPU per tile
    with optional MPI *between hosts*, out_of_core.py:86-88).  Shard the
    y/z axes and keep the tiled x axis unsharded so the ghost machinery
    stays purely host-side.
    """
    out_indices = [out_index] if isinstance(out_index, int) else list(out_index)
    outs = [ooc_arrays[k] for k in out_indices]
    lead = outs[0]
    n, ax = lead.num_tiles, lead.tile_axis
    jfn = fn if hasattr(fn, "lower") else jax.jit(fn)

    def _interior(result):
        sl = [slice(None)] * result.ndim
        sl[ax] = slice(ghost, result.shape[ax] - ghost)
        return result[tuple(sl)]

    # Writeback lags tile assembly by one iteration, so tile i's lo ghost
    # always reads tile i-1's still-pristine tail directly; the only
    # pre-sweep state a later tile needs after a writeback is the WRAP:
    # the last tile's hi ghost = tile 0's head.  Cache just that.
    head0 = {id(a): a.head_strip(ghost) for a in outs}

    def _put(tile_np):
        return jax.device_put(tile_np, sharding)

    def _tiles(i):
        tiles = []
        for arr in ooc_arrays:
            hi = head0.get(id(arr)) if (i == n - 1 and n > 1) else None
            tiles.append(_put(arr.padded_tile(i, ghost, hi_override=hi)))
        return tiles

    pending = None  # (tile index, device results) awaiting writeback
    for i in range(n):
        results = jfn(*_tiles(i), *extra_args)  # enqueued asynchronously
        if not isinstance(results, (tuple, list)):
            results = (results,)
        if pending is not None:
            _flush(outs, pending, _interior)  # overlaps tile i's device compute
        pending = (i, results)
    _flush(outs, pending, _interior)
    return lead


def _flush(outs, pending, _interior):
    """Fetch a tile's device results (blocking; the NEXT tile's compute is
    already enqueued, so the device stays busy) and write them in place."""
    i, results = pending
    for arr, res in zip(outs, results):
        arr.write_tile(i, _interior(np.asarray(res)))


def _host_slab_masks(stepper, s0, ext):
    """Rasterize ONE x-slab's (bc_mask, missing_mask) on device and return
    them as numpy -- the building block of :func:`prepare_fields_ooc`.

    The slab covers global x in [s0, s0+ext) plus one real neighbor layer
    on each interior side; the masker's own one-voxel pad supplies the
    exterior-solid semantics at true domain edges (maskers.py runs the
    same pad -> tag -> stream -> crop algorithm with ``start_index``
    shifting, reference indices_boundary_masker.py:76-143).  Streaming
    depth is 1, so interior results are exact after cropping the ghost."""
    import copy

    import jax.numpy as jnp

    from xlb_tpu.boundary.maskers import IndicesBoundaryMasker

    vs = stepper.velocity_set
    shape = tuple(stepper.grid.shape)
    X = shape[0]
    lo = 1 if s0 > 0 else 0
    hi = 1 if s0 + ext < X else 0
    sshape = (ext + lo + hi,) + shape[1:]

    clones = []
    for bc in stepper.boundary_conditions:
        idx = np.asarray(bc.indices)
        keep = (idx[0] >= s0 - lo) & (idx[0] < s0 + ext + hi)
        if not keep.any():
            continue
        c = copy.copy(bc)
        c.indices = idx[:, keep]
        clones.append(c)

    masker = IndicesBoundaryMasker(vs, stepper.precision_policy, stepper.compute_backend)
    start = (s0 - lo,) + (0,) * (len(shape) - 1)
    # rasterize on the in-process CPU backend when one is registered: the
    # masks land in host RAM anyway, so a device would only add two
    # transfers per slab for a setup-time op
    import contextlib

    try:
        ctx = jax.default_device(jax.local_devices(backend="cpu")[0])
    except RuntimeError:
        ctx = contextlib.nullcontext()
    with ctx:
        bc_mask = jnp.zeros((1,) + sshape, dtype=jnp.uint8)
        missing = jnp.zeros((vs.q,) + sshape, dtype=bool)
        bc_mask, missing = masker(clones, bc_mask, missing, start_index=start)
        crop = (slice(lo, lo + ext),)
        return (
            np.asarray(bc_mask[(slice(None),) + crop]),
            np.asarray(missing[(slice(None),) + crop]),
        )


def prepare_fields_ooc(stepper, num_tiles, compression=None, ghost_cache=8, shifted=False):
    """Host-side field preparation for domains BEYOND device memory.

    ``stepper.prepare_fields`` materializes the whole domain on device,
    which caps OOC runs at the HBM size even though the sweep itself only
    ever holds one slab.  This builder never creates a global device
    array: masks are rasterized slab-by-slab on device (exact -- see
    :func:`_host_slab_masks`) and the populations start at rest
    equilibrium on the host (f = w per direction, i.e. exactly g = 0 in
    deviation form).  A 1024^3 cavity (1.07e9 cells, 41 GB of bf16
    populations) prepares in host RAM this way; the reference's OOC
    showcase builds its fields on device per tile (ooc_array.py:15-440).

    Restrictions (checked loudly): indices-based boundary-shell BCs only
    -- no interior/solid geometry (its dilated shell could straddle slab
    cuts), no mesh BCs, no spatial aux.  Cavity/channel/duct scenes
    qualify.

    Returns ``(f, bc_mask, missing_mask)`` host OOC arrays; ``shifted``
    selects deviation-form (g = f - w) population storage, the correct
    persistent form for 16-bit policies (see build_fused_window's
    ``io_form``).
    """
    from xlb_tpu.kernels.fused_step import build_aux_field

    shape = tuple(stepper.grid.shape)
    X = shape[0]
    if X % num_tiles:
        raise ValueError(f"x extent {X} not divisible into {num_tiles} tiles")
    ext = X // num_tiles
    d = len(shape)
    for bc in stepper.boundary_conditions:
        if bc.indices is None:
            raise NotImplementedError(
                f"{type(bc).__name__} is mesh-based; host-side OOC prepare supports "
                "indices-based boundary-shell BCs only"
            )
        idx = np.asarray(bc.indices)[:d]
        interior = np.all((idx > 0) & (idx < np.asarray(shape)[:, None] - 1), axis=0)
        if interior.any():
            raise NotImplementedError(
                f"{type(bc).__name__} tags interior geometry; host-side OOC prepare "
                "supports boundary-shell BCs only (use the device prepare path)"
            )
    if build_aux_field(stepper) is not None:
        raise NotImplementedError(
            "spatial-aux BCs (profiles / mesh distances) are not supported by the "
            "host-side OOC prepare path"
        )

    pp = stepper.precision_policy
    store = np.dtype(pp.store_dtype)
    vs = stepper.velocity_set
    q = vs.q

    g = max(int(ghost_cache), 1)
    if compression == "zstd":
        mk = lambda shp, dt, fill: CompressedOOCArray(shp, dt, num_tiles=num_tiles, fill_value=fill, ghost_cache=g)
    elif compression is None:
        mk = lambda shp, dt, fill: OOCArray(shp, dt, num_tiles=num_tiles, fill_value=fill)
    else:
        raise ValueError(f"compression must be None or 'zstd', got {compression!r}")

    f = mk((q,) + shape, store, 0)
    if not shifted:
        w = np.asarray(vs._w, dtype=np.float32).reshape((q,) + (1,) * d)

        def _to_eq(tile):
            return np.broadcast_to(w.astype(store), tile.shape).copy()

        f.apply_tiles(_to_eq)

    bc_mask = mk((1,) + shape, np.uint8, 0)
    missing_mask = mk((q,) + shape, bool, False)
    has_solids = False
    for i in range(num_tiles):
        bm, mm = _host_slab_masks(stepper, i * ext, ext)
        has_solids = has_solids or bool((bm == 255).any())
        bc_mask.write_tile(i, bm)
        missing_mask.write_tile(i, mm)
    # static hint for the fused kernel builder (normally set by
    # prepare_fields): 255-free domains skip the q-channel solid keep-out
    stepper.has_solids = has_solids
    return f, bc_mask, missing_mask


class OOCNSESolver:
    """Out-of-core LBM driver: runs an IncompressibleNavierStokesStepper
    over an OOC-tiled domain, ``ghost`` steps per sweep.

    The per-tile step runs on the padded slab; with ghost width g, g steps
    run on-device per round trip and the interior remains globally exact
    (each pull consumes one ghost layer).  ``tier`` picks the device
    kernel: "jnp" (pure XLA), "fused" (the Pallas fused window bound to the
    padded-slab shape via ``shape_override``), or "auto" (fused on the GPU
    when the config supports it, ``tiers.fused_by_default``).
    """

    def __init__(self, stepper, num_tiles, steps_per_sweep=1, tier="auto", compression=None,
                 sharding=None):
        self.stepper = stepper
        self.num_tiles = int(num_tiles)
        self.steps_per_sweep = int(steps_per_sweep)
        self.tier = tier
        if compression not in (None, "zstd"):
            raise ValueError(f"compression must be None or 'zstd', got {compression!r}")
        self.compression = compression
        self._io_shifted = False  # set by _build_tile_fn (fused + 16-bit storage)
        self._uses_packed = False  # fused tier streams the packed int32 mask
        self._packed = None
        # optional GSPMD sharding of each uploaded slab over a device mesh
        # (shard y/z, never the tiled x axis): chips AND host RAM compose
        self.sharding = sharding

    def prepare(self, host_side=False):
        """Build the host-resident OOC fields.

        ``host_side=True`` prepares without EVER materializing a global
        device array (:func:`prepare_fields_ooc`) -- required for domains
        beyond device memory (the billion-cell tier); the default path
        runs the stepper's ordinary device prepare and downloads it.

        Either way, when the fused tier is active and the storage dtype is
        16-bit, the host copy of the populations is kept in DEVIATION form
        (g = f - w) and the per-slab window runs with ``io_form='shifted'``:
        writing plain-form f back to bf16 after every sweep would quantize
        the deviations against the O(1) lattice weights (~0.4% floor),
        destroying the very conditioning the 16-bit policy relies on.  Use
        :meth:`plain_tiles` / ``run(return_field=True)`` to read physics out.
        """
        if self.compression == "zstd":
            g = max(self.steps_per_sweep, 1)
            mk = lambda a: CompressedOOCArray.from_array(np.asarray(a), num_tiles=self.num_tiles, ghost_cache=g)
        else:
            mk = lambda a: OOCArray.from_array(np.asarray(a), num_tiles=self.num_tiles)

        if host_side:
            # shell-only BCs (enforced by prepare_fields_ooc) never tag
            # BC_SOLID voxels, so the kernel builds without the q-channel
            # solid keep-out; decided BEFORE the window so the compiled
            # HLO matches (prepare_fields_ooc re-derives and asserts it)
            self.stepper.has_solids = False
            self._build_tile_fn()  # decides self._io_shifted before the host fill
            self.f, self.bc_mask, self.missing_mask = prepare_fields_ooc(
                self.stepper, self.num_tiles, compression=self.compression,
                ghost_cache=max(self.steps_per_sweep, 1), shifted=self._io_shifted,
            )
            self.aux = None  # prepare_fields_ooc rejects aux configs
            assert not self.stepper.has_solids, (
                "host-side prepare found BC_SOLID voxels after building a keep-out-free kernel"
            )
            if self._uses_packed:
                # beyond-RAM tier: keep only the packed plane (4 B/cell),
                # freeing the 1 + q B/cell raw masks
                self._pack_masks_host(free_raw=True)
            return self

        f_0, f_1, bc_mask, missing_mask = self.stepper.prepare_fields()
        self._build_tile_fn()  # after prepare_fields: the solid hint is now real
        self.f = mk(f_0)
        self.bc_mask = mk(bc_mask)
        self.missing_mask = mk(missing_mask)
        # spatial-BC aux channels (profile inlets, hybrid wall distances)
        # stream through the device as one more x-tiled read-only operand,
        # sliced with the same ghost wrap as the masks (plain OOCArray: the
        # aux is read-only, so compression would buy one decompress/sweep
        # for no writeback saving)
        from xlb_tpu.kernels.fused_step import build_aux_field

        aux_np = build_aux_field(self.stepper)
        self.aux = None if aux_np is None else OOCArray.from_array(aux_np, num_tiles=self.num_tiles)
        # free the on-device copies: from here the domain is host-resident
        del f_0, f_1
        if self._io_shifted:
            w = self._w_host()

            def _to_dev(tile):
                return (tile.astype(np.float32) - w).astype(tile.dtype)

            self.f.apply_tiles(_to_dev)
        if self._uses_packed:
            self._pack_masks_host()  # raw masks stay user-accessible
        return self

    def _pack_masks_host(self, free_raw=False):
        """One-time host-side pack of the static masks into the int32 plane
        the fused sweep streams (see _build_tile_fn); runs on the in-process
        CPU backend so no device traffic is involved."""
        import contextlib

        from xlb_tpu.kernels.fused_step import pack_masks

        try:
            ctx = jax.default_device(jax.local_devices(backend="cpu")[0])
        except RuntimeError:  # no CPU backend registered: pack on the default device
            ctx = contextlib.nullcontext()
        packed = OOCArray((1,) + tuple(self.bc_mask.shape[1:]), np.int32, num_tiles=self.num_tiles)
        with ctx:
            for i in range(self.num_tiles):
                bm = self.bc_mask.padded_tile(i, 0)
                mm = self.missing_mask.padded_tile(i, 0)
                packed.write_tile(i, np.asarray(pack_masks(bm, mm))[None])
        self._packed = packed
        if free_raw:
            self.bc_mask = None
            self.missing_mask = None

    def _w_host(self):
        vs = self.stepper.velocity_set
        return np.asarray(vs._w, dtype=np.float32).reshape((vs.q,) + (1,) * vs.d)

    def plain_tiles(self):
        """Yield ``(i, tile)`` with the populations in PLAIN f32 form (one
        tile's worth of host memory at a time), whatever the stored form --
        the streaming read-out for beyond-RAM diagnostics."""
        w = self._w_host()
        for i in range(self.f.num_tiles):
            t = self.f.padded_tile(i, 0).astype(np.float32)
            yield i, (t + w if self._io_shifted else t)

    def _check_jnp_slab_broadcast(self):
        """Fail loudly on BC configurations the jnp tile path would silently
        misapply.  It re-runs the stepper's own BC objects on each padded
        x-slab, which is only correct when every spatial prescription
        broadcasts over the slabbed axis: prescribed arrays must have
        extent 1 along it, and coordinate-based scatters (spatial profiles,
        hybrid mesh distances) are full-domain-indexed and never valid on a
        slab.  (Advisor r4: an x-varying profile was applied at wrong slab
        offsets with no error.)"""
        import inspect

        # array axis; fields are (card, X, Y, Z).  The solver always slabs
        # x (axis 1); self.f may not exist yet (the tile fn is built before
        # the host arrays so the storage form is known at fill time)
        ax = getattr(self, "f", None).tile_axis if getattr(self, "f", None) is not None else 1
        dim = self.stepper.grid.dim
        for bc in self.stepper.boundary_conditions:
            name = type(bc).__name__
            profile = getattr(bc, "profile", None)
            if profile is not None and len(inspect.signature(profile).parameters) >= 1:
                raise NotImplementedError(
                    f"{name} has a spatial (coordinate-taking) profile, which the jnp OOC tile path "
                    "would scatter at wrong slab offsets; use tier='fused' (it streams the aux field per slab)"
                )
            if getattr(bc, "_distances", None) is not None:
                raise NotImplementedError(
                    f"{name} carries per-voxel mesh distances, which the jnp OOC tile path would scatter "
                    "at wrong slab offsets; use tier='fused' (it streams the aux field per slab)"
                )
            pv = getattr(bc, "prescribed_values", None)
            if pv is None:
                continue
            arr = np.asarray(pv)
            if arr.ndim == dim + 1 and arr.shape[ax] != 1:
                raise NotImplementedError(
                    f"{name} prescribes values varying along the OOC-slabbed axis "
                    f"(shape {arr.shape}, slab axis {ax}); the jnp tile path would apply them at wrong "
                    "slab offsets -- use tier='fused' or slab a different axis"
                )

    def _tile_fn(self):
        return self._build_tile_fn()

    def _build_tile_fn(self):
        """Jitted padded-slab window (f, bc, miss, omega) -> f, cached on
        the solver so every sweep (and every run) hits the compile cache.
        Also decides ``self._io_shifted``: with a fused window and 16-bit
        storage, slab I/O stays in deviation form end to end (zero
        conversion passes, and no per-sweep plain-bf16 quantization)."""
        if getattr(self, "_tile_jit", None) is not None:
            return self._tile_jit
        from xlb_tpu.kernels.fused_step import build_aux_field

        stepper, g = self.stepper, self.steps_per_sweep
        has_aux = build_aux_field(stepper) is not None
        self._io_shifted = False
        tile_fn = None
        want_fused = self.tier == "fused" or (self.tier == "auto" and tiers.fused_by_default())
        if want_fused:
            try:
                from xlb_tpu.kernels.fused_step import build_fused_window

                slab_shape = list(stepper.grid.shape)
                slab_shape[0] = stepper.grid.shape[0] // self.num_tiles + 2 * g  # padded slab x-extent
                shifted_io = jnp.dtype(stepper.precision_policy.store_dtype).itemsize < 4
                window = build_fused_window(
                    stepper, g, shape_override=tuple(slab_shape),
                    io_form="shifted" if shifted_io else "plain",
                    pre_packed=True,
                )
                self._io_shifted = shifted_io
                # the fused sweep streams ONE pre-packed int32 mask plane
                # ((1, *s), packed once at prepare) instead of uint8 bc +
                # q-channel bool missing: 4 bytes/cell over the host link
                # instead of 1 + q, and no per-slab pack pass on device
                self._uses_packed = True

                if has_aux:

                    def tile_fn(f, packed, aux, omega):
                        a, _ = window(f, f, packed[0], None, omega, aux=aux)
                        return a.astype(f.dtype)
                else:

                    def tile_fn(f, packed, omega):
                        a, _ = window(f, f, packed[0], None, omega)
                        return a.astype(f.dtype)
            except (NotImplementedError, AssertionError):
                if self.tier == "fused":
                    raise
                tile_fn = None  # auto: config unsupported by the fused window
                self._io_shifted = False
                self._uses_packed = False
        if tile_fn is None:
            # jnp tier: the stepper's BC objects broadcast their own
            # prescribed values (size-1 spatial axes survive x-slabbing),
            # so the streamed aux operand is accepted but unused
            self._check_jnp_slab_broadcast()

            def _jnp_tile(f, bc, miss, omega):
                def body(t, carry):
                    a, b = carry
                    a, b = stepper(a, b, bc, miss, omega, t)
                    return (b, a)

                a, _ = jax.lax.fori_loop(0, g, body, (f, f))
                return a

            if has_aux:
                tile_fn = lambda f, bc, miss, aux, omega: _jnp_tile(f, bc, miss, omega)
            else:
                tile_fn = _jnp_tile

        self._tile_jit = jax.jit(tile_fn)
        return self._tile_jit

    def run(self, num_steps, omega, return_field=True):
        """Advance ``num_steps``; returns the populations in PLAIN form
        (f32 when the stored form is deviations), or None with
        ``return_field=False`` -- beyond-RAM domains should stream
        diagnostics through :meth:`plain_tiles` instead of materializing
        a second full-domain copy."""
        g = self.steps_per_sweep
        if num_steps % g:
            raise ValueError(f"num_steps {num_steps} must be a multiple of steps_per_sweep {g}")
        jfn = self._tile_fn()
        om = jnp.asarray(omega, dtype=jnp.float32)
        if self._uses_packed:
            arrays = [self.f, self._packed]
        else:
            arrays = [self.f, self.bc_mask, self.missing_mask]
        if getattr(self, "aux", None) is not None:
            arrays.append(self.aux)
        for _ in range(num_steps // g):
            ooc_map(jfn, arrays, ghost=g, extra_args=(om,), sharding=self.sharding)
        if not return_field:
            return None
        if self._io_shifted:
            ax = self.f.tile_axis
            return np.concatenate([t for _, t in self.plain_tiles()], axis=ax)
        return self.f.to_numpy()
