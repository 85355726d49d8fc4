"""Glue between the NSE stepper and the fused Pallas collide-stream kernel.

Translates BC objects into static kernel epilogue specs, pre-packs the
boolean ``missing_mask`` into an int32 direction bitfield (q <= 27 bits) and
``bc_mask`` into an int32 id field, and builds the fused step and window
callables.

BCs supported in-kernel: EquilibriumBC, DoNothingBC, FullwayBounceBackBC,
HalfwayBounceBackBC (incl. moving walls, constant or per-voxel spatial
profiles), ZouHeBC + RegularizedBC (constant and spatial velocity and
pressure), ExtrapolationOutflowBC (in-kernel staging), FreeSlipBC and
HybridBC (all curved-boundary methods, per-link mesh distances AND spatial
moving-wall profiles via the aux channels) -- the full reference BC
surface.  Unknown BC classes raise and should use the JAX tier.

BC id capacity: D2Q9/D3Q19 scenes carry the full uint8 id space (1..253,
reference parity) in the packed mask's free bits; D3Q27 is limited to 29
distinct ids (see collide_stream.bc_id_shift).

Every callable is differentiable w.r.t. the populations and omega through
a ``custom_vjp`` whose backward is the jnp tier's VJP (the kernel has no
transpose rule of its own).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from xlb_tpu.boundary.base import ImplementationStep
from xlb_tpu.utils import tiers
from xlb_tpu.boundary.bc_equilibrium import EquilibriumBC
from xlb_tpu.boundary.bc_do_nothing import DoNothingBC
from xlb_tpu.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC
from xlb_tpu.boundary.bc_zouhe import ZouHeBC
from xlb_tpu.boundary.bc_regularized import RegularizedBC
from xlb_tpu.boundary.bc_extrapolation_outflow import ExtrapolationOutflowBC
from xlb_tpu.kernels.collide_stream import aux_layout, bc_id_shift, build_fused_collide_stream, kernel_collision_spec


def bc_to_spec(bc, velocity_set):
    """Convert a BC object into a static spec dict for the kernel epilogue."""
    vs = velocity_set
    step = "streaming" if bc.implementation_step == ImplementationStep.STREAMING else "collision"
    if isinstance(bc, EquilibriumBC):
        feq = np.asarray(bc._prescribed_feq(0, jnp.float32)).reshape(-1)
        return {"kind": "equilibrium", "id": bc.id, "step": step, "feq": feq}
    if isinstance(bc, DoNothingBC):
        return {"kind": "do_nothing", "id": bc.id, "step": step}
    if isinstance(bc, FullwayBounceBackBC):
        return {"kind": "fullway", "id": bc.id, "step": step}
    if isinstance(bc, HalfwayBounceBackBC):
        spec = {"kind": "halfway", "id": bc.id, "step": step, "mw": None}
        if bc.needs_moving_wall_treatment:
            if _is_spatial_profile(bc):
                spec["mw"] = "aux"  # per-voxel wall velocity from the aux field
            else:
                u_wall = np.asarray(bc.profile()).reshape(-1)
                cu = vs._c.T.astype(np.float64) @ u_wall
                spec["mw"] = (6.0 * vs._w * cu).astype(np.float64)
        return spec
    if isinstance(bc, ExtrapolationOutflowBC):
        return {"kind": "extrapolation_outflow", "id": bc.id, "step": step, "normal": np.asarray(bc.normal, dtype=np.int64)}
    from xlb_tpu.boundary.bc_free_slip import FreeSlipBC

    if isinstance(bc, FreeSlipBC):
        return {"kind": "free_slip", "id": bc.id, "step": step,
                "spec_indices": bc.spec_indices, "reflect_dirs": bc.reflect_dirs}
    from xlb_tpu.boundary.bc_hybrid import HybridBC

    if isinstance(bc, HybridBC):
        spec = {
            "kind": "hybrid",
            "id": bc.id,
            "step": step,
            "method": bc.bc_method,
            "use_dist": bool(bc.needs_mesh_distance),
            "mw": None,
        }
        if bc.needs_moving_wall_treatment:
            if _is_spatial_profile(bc):
                spec["mw"] = "aux"  # per-voxel wall velocity from the aux field
            else:
                u_wall = np.asarray(bc.profile()).reshape(-1)
                cu = vs._c.T.astype(np.float64) @ u_wall
                spec["mw"] = (6.0 * vs._w * cu).astype(np.float64)
                spec["u_wall"] = u_wall.astype(np.float64)
        return spec
    if isinstance(bc, (ZouHeBC, RegularizedBC)):
        kind = "regularized" if isinstance(bc, RegularizedBC) else "zouhe"
        value = np.asarray(bc.prescribed_values, dtype=np.float64)
        if bc.bc_type == "velocity":
            if value.size == vs.d:
                spec_value = value.reshape(-1)
            else:
                spec_value = "aux"  # spatial profile: per-voxel velocity from the aux field
        else:
            if value.size == 1:
                spec_value = float(value.reshape(-1)[0])
            else:
                spec_value = "aux_rho"  # spatial profile: per-voxel density from the aux field
        return {"kind": kind, "id": bc.id, "step": step, "bc_type": bc.bc_type, "value": spec_value}
    raise NotImplementedError(
        f"{type(bc).__name__} is not yet supported by the fused Pallas kernel; "
        "use ComputeBackend.JAX for this configuration"
    )


def _is_spatial_profile(bc):
    """True when the BC's wall-velocity profile varies per voxel (its
    callable takes the voxel coordinates)."""
    import inspect

    return bc.profile is not None and len(inspect.signature(bc.profile).parameters) >= 1


def build_aux_field(stepper):
    """Assemble the per-voxel aux side array for spatial BCs as a host
    NumPy (nchan, *shape) array, or None when no BC needs it.  The
    counterpart of the reference's f_1 aux-slot encoding
    (helper_functions_bc.py:371-501): spatial prescriptions ride a side
    array read with each block instead of stolen population slots.

    The channel layout is taken from ``collide_stream.aux_layout`` (the
    single source of truth shared with the kernel body): d velocity
    channels (spatial prescribed-velocity BCs), one prescribed-density
    channel (spatial pressure BCs), then q hybrid wall-distance weight
    channels per HybridBC (0.5 default = halfway).  Dynamic base blocks
    (extern force, ADE advecting velocity) are prepended by the caller at
    run time, so the returned array always starts at the BC block.
    Always grid-shaped: shape_override callers (out-of-core slabs) slice
    it per slab and pass the slab through ``run(..., aux=...)``."""
    vs = stepper.velocity_set
    shape = tuple(stepper.grid.shape)
    bc_specs = [bc_to_spec(bc, vs) for bc in stepper.boundary_conditions]
    u_off, rho_off, w_offs, nchan = aux_layout(bc_specs, vs)
    if nchan == 0:
        return None
    aux = np.zeros((nchan,) + shape, np.float32)
    if rho_off is not None:
        aux[rho_off] = 1.0  # inert default: keeps fsum/rho finite off-BC

    def _keep(idx):
        return np.all((idx >= 0) & (idx < np.asarray(shape)[: vs.d, None]), axis=0)

    for bc, spec in zip(stepper.boundary_conditions, bc_specs):
        if spec.get("kind") == "hybrid" and spec.get("use_dist"):
            if bc._distances is None:
                raise NotImplementedError(
                    "HybridBC mesh distances are computed during prepare_fields; build the fused kernel after it"
                )
            w_off = w_offs[bc.id]
            aux[w_off : w_off + vs.q] = 0.5
            vals = np.where(np.isfinite(bc._distances), bc._distances, 0.5).astype(np.float32)
            vals = np.clip(vals, 0.0, 1.0)
            idx = np.asarray(bc._distance_voxels, dtype=np.int64)
            keep = _keep(idx)
            for l in range(vs.q):
                aux[(w_off + l,) + tuple(idx[:, keep])] = vals[l, keep]
        if isinstance(spec.get("mw"), str) and spec["mw"] == "aux":
            if bc.indices is None:
                raise NotImplementedError(
                    "spatial-profile BCs need voxel indices before the fused kernel is built "
                    "(mesh-based BCs: run prepare_fields first)"
                )
            # evaluate at the dilated fluid-side shell, where the BC's missing
            # directions live (matches bc_bounce_back._moving_wall_term)
            idx = np.asarray(bc.pad_indices(), dtype=np.int64)
            vals = np.asarray(bc.profile(idx.astype(np.float64)), dtype=np.float32)
            keep = _keep(idx)
            aux[(slice(u_off, u_off + vs.d),) + tuple(idx[:, keep])] = vals[:, keep]
        elif isinstance(spec.get("value"), str) and spec["value"] in ("aux", "aux_rho"):
            if bc.indices is None:
                raise NotImplementedError("spatial ZouHe/Regularized profiles need voxel indices (run prepare_fields)")
            # spatial profile: prescribed_values broadcasts over the domain
            # (bc_zouhe._broadcast_prescribed semantics); sample at the BC voxels
            from xlb_tpu.boundary.bc_zouhe import _broadcast_prescribed

            values = np.asarray(bc.prescribed_values, dtype=np.float32)
            idx = np.asarray(bc.indices, dtype=np.int64)
            keep = _keep(idx)
            if spec["value"] == "aux":
                full = np.broadcast_to(_broadcast_prescribed(values, (vs.d,) + shape), (vs.d,) + shape)
                aux[(slice(u_off, u_off + vs.d),) + tuple(idx[:, keep])] = full[(slice(None),) + tuple(idx[:, keep])]
            else:
                full = np.broadcast_to(_broadcast_prescribed(values, (1,) + shape), (1,) + shape)
                aux[(rho_off,) + tuple(idx[:, keep])] = full[(0,) + tuple(idx[:, keep])]
    return aux


def stepper_force_vector(stepper):
    """Static (host NumPy) body-force vector of a forced stepper, or None.
    Kept NumPy so it lifts into the kernel as a compile-time constant."""
    fv = getattr(getattr(stepper, "collision", None), "force_vector", None)
    return None if fv is None else np.asarray(fv, dtype=np.float64)


def pack_masks(bc_mask, missing_mask):
    """(bc_mask uint8 (1,*s), missing bool (q,*s)) -> one int32 (*s).

    Bits 0..q-1 hold the missing-direction bitfield (q <= 27); the BC id
    field sits in the free high bits per ``collide_stream.bc_id_shift``:
    the raw uint8 cell type in bits 19..26 for q <= 19 (full 253-id
    reference parity), or a 5-bit id in bits 27..31 for D3Q27 (specials
    254/255 remapped to 30/31, ids capped at 29 -- see kernel_bc_id).
    One array instead of two cuts the kernel's mask traffic from q + 1
    bytes to 4 bytes per cell.
    """
    q = missing_mask.shape[0]
    assert q <= 27, f"missing bitfield needs q <= 27 bits, got {q}"
    weights = jnp.asarray([1 << l for l in range(q)], dtype=jnp.int32).reshape((q,) + (1,) * (missing_mask.ndim - 1))
    miss_i32 = jnp.sum(missing_mask.astype(jnp.int32) * weights, axis=0)
    bc = bc_mask[0].astype(jnp.int32)
    if q > 19:
        bc = jnp.where(bc == 254, 30, jnp.where(bc == 255, 31, bc))
    return miss_i32 | (bc << bc_id_shift(q))




def _build_kernel(stepper, shape, block=None, interpret=None, **flags):
    """The fused collide-stream kernel for ``stepper`` on ``shape``, with
    the platform's interpret mode and launch shape unless given."""
    vs = stepper.velocity_set
    pp = stepper.precision_policy
    if interpret is None:
        interpret = tiers.kernel_interpret()
    default_block, num_warps = tiers.kernel_launch(int(np.prod(shape)), interpret)
    if "collision" not in flags:
        flags["collision"] = kernel_collision_spec(stepper)
    return build_fused_collide_stream(
        vs,
        shape,
        bc_specs=[bc_to_spec(bc, vs) for bc in stepper.boundary_conditions],
        compute_dtype=pp.compute_dtype,
        store_dtype=pp.store_dtype,
        block=block or default_block,
        num_warps=num_warps,
        interpret=interpret,
        has_solids=getattr(stepper, "has_solids", True),
        **flags,
    )


def _stamp(fn, kernel):
    fn.active_tier = kernel.active_tier
    fn.interpret = kernel.interpret
    return fn


def _zero_cotangent(x):
    return np.zeros(np.shape(x), dtype=jax.dtypes.float0)


def build_fused_step(stepper, block=None, interpret=None, shape_override=None):
    """Build the PALLAS-tier step for an IncompressibleNavierStokesStepper.

    ``shape_override`` runs the step on a different (static) domain shape
    than the stepper's grid, e.g. an out-of-core padded slab; the caller
    then passes the slab's aux field at run time (``step(..., aux=...)``).
    Returns a callable with the standard stepper signature
    (f_0, f_1, bc_mask, missing_mask, omega, timestep) -> (f_0, f_1).
    """
    shape = tuple(shape_override) if shape_override is not None else tuple(stepper.grid.shape)
    pp = stepper.precision_policy
    fused = _build_kernel(stepper, shape, block, interpret, force_vector=stepper_force_vector(stepper))
    aux_np = build_aux_field(stepper)
    # grid-shaped aux cannot be pre-sliced for an override shape: the
    # caller passes the matching slab-shaped aux instead
    aux_dev = None if (aux_np is None or shape_override is not None) else jnp.asarray(aux_np)

    def _jnp_step(f_0, bc_mask, missing_mask, omega):
        _, f_1 = stepper._step_pull(f_0, f_0, bc_mask, missing_mask, omega, 0)
        return f_1

    @jax.custom_vjp
    def fused_core(f_0, bc_mask, missing_mask, omega, aux):
        return fused(f_0, pack_masks(bc_mask, missing_mask), omega, aux=aux)

    def _fwd(f_0, bc_mask, missing_mask, omega, aux):
        return fused_core(f_0, bc_mask, missing_mask, omega, aux), (f_0, bc_mask, missing_mask, omega, aux)

    def _bwd(res, g):
        f_0, bc_mask, missing_mask, omega, aux = res
        _, vjp = jax.vjp(lambda f, om: _jnp_step(f, bc_mask, missing_mask, om), f_0, omega)
        df, dom = vjp(g)
        daux = None if aux is None else jnp.zeros_like(aux)
        return df, _zero_cotangent(bc_mask), _zero_cotangent(missing_mask), dom, daux

    fused_core.defvjp(_fwd, _bwd)

    def step(f_0, f_1, bc_mask, missing_mask, omega, timestep=0, aux=None):
        omega = jnp.asarray(omega, dtype=pp.compute_dtype)
        return f_0, fused_core(f_0, bc_mask, missing_mask, omega, aux_dev if aux is None else aux)

    return _stamp(step, fused)


def _build_aux_prefixed_step(stepper, block, interpret, **flags):
    """Shared builder of the ADE and extern-force steps: a per-call field
    rides aux channels [0:d], the static BC channels follow
    (``aux_layout(base=d)``).  Forward-only."""
    shape = tuple(stepper.grid.shape)
    pp = stepper.precision_policy
    fused = _build_kernel(stepper, shape, block, interpret, **flags)
    aux_bc_np = build_aux_field(stepper)
    aux_bc_dev = None if aux_bc_np is None else jnp.asarray(aux_bc_np)

    def step(f_0, f_1, bc_mask, missing_mask, omega, field, timestep=0):
        aux = field.astype(jnp.float32)
        if aux_bc_dev is not None:
            aux = jnp.concatenate([aux, aux_bc_dev], axis=0)
        omega_c = jnp.asarray(omega, dtype=pp.compute_dtype)
        return f_0, fused(f_0, pack_masks(bc_mask, missing_mask), omega_c, aux=aux)

    return _stamp(step, fused)


def build_fused_ade_step(stepper, block=None, interpret=None):
    """PALLAS-tier advection-diffusion step (models/ade.py): one pass of
    stream + voxel-local BCs + linear-equilibrium BGK relaxation, with the
    ADVECTING velocity read per cell as d aux channels (it changes every
    step in coupled flows, so it is a kernel argument).

    Returns ``(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep) ->
    (g_0, g_1)``.  Forward-only (differentiate through the jnp tier).
    """
    return _build_aux_prefixed_step(stepper, block, interpret, collision="BGK", ade=True)


def build_fused_forced_step(stepper, block=None, interpret=None):
    """PALLAS-tier NSE step with a PER-VOXEL exact-difference force field
    (the field generalization of the static ``force_vector``), read per
    cell as d aux channels.  Used by the Boussinesq thermal coupling
    (models/ade.py) and Shan-Chen multiphase, where the force changes
    every step.

    Returns ``(f_0, f_1, bc_mask, missing_mask, omega, force_field,
    timestep) -> (f_0, f_1)``.  Forward-only (differentiate through the
    jnp tier).
    """
    if stepper_force_vector(stepper) is not None:
        raise NotImplementedError("use either a static force_vector or the per-voxel force field, not both")
    return _build_aux_prefixed_step(stepper, block, interpret, extern_force=True)


def build_fused_window(stepper, num_steps, block=None, interpret=None, shifted=None, shape_override=None, donate=False, io_form="plain", pre_packed=False):
    """A jitted ``num_steps``-window of the fused step with optional
    deviation-form (shifted) storage between steps.

    With ``shifted=True`` (default when the storage dtype is 16-bit), the
    populations live in device memory as g = f - w for the duration of the
    window -- 16-bit storage then resolves the physically-varying
    deviations instead of quantizing them against the O(1) lattice weights
    -- and are converted back at the window boundary (two cheap
    elementwise passes per window).

    Returns ``run(f_0, f_1, bc_mask, missing_mask, omega) -> (f_0, f_1)``
    in plain (unshifted) form.  When shifted, the returned field is in the
    COMPUTE dtype: quantizing g + w back to 16 bits at the window boundary
    would silently erase deviations below ~0.4% of the lattice weights
    (the state lives in the deviations).  The next window re-shifts from
    any input dtype, so windows chain losslessly.

    ``io_form="shifted"`` (16-bit policies only) moves that boundary to the
    CALLER: ``run`` consumes AND returns deviation-form populations in the
    store dtype, with no conversion passes.  This is the correct interface
    when the field persists outside the window in 16 bits -- e.g. the
    out-of-core host slabs (experimental/ooc.py), where a plain-form bf16
    writeback would quantize the deviations against the O(1) weights every
    sweep.  Ghost/pad cells use g = 0 (resting equilibrium).

    ``pre_packed=True``: ``run``'s bc_mask operand is the ALREADY-PACKED
    int32 mask (pack_masks) and missing_mask is ignored (pass None).  The
    out-of-core sweep streams one int32 plane instead of uint8 + q bools
    -- 4 bytes/cell over the host link instead of 1 + q.  Such windows are
    forward-only.

    ``shape_override`` runs the window on a different (static) domain
    shape than the stepper's grid -- e.g. an out-of-core padded slab; the
    caller then passes the slab's aux at run time (``run(..., aux=...)``).
    """
    vs = stepper.velocity_set
    pp = stepper.precision_policy
    cdt = pp.compute_dtype
    if shifted is None:
        shifted = jnp.dtype(pp.store_dtype).itemsize < 4
    if io_form not in ("plain", "shifted"):
        raise ValueError(f"io_form must be 'plain' or 'shifted', got {io_form!r}")
    io_shifted = io_form == "shifted"
    if io_shifted and not shifted:
        raise ValueError("io_form='shifted' requires deviation-form (16-bit) storage")
    convert = shifted and not io_shifted  # window-boundary plain <-> deviation passes
    shape = tuple(shape_override) if shape_override is not None else tuple(stepper.grid.shape)
    fused = _build_kernel(
        stepper, shape, block, interpret, shifted=shifted, force_vector=stepper_force_vector(stepper)
    )
    aux_np = build_aux_field(stepper)
    aux_dev = None if (aux_np is None or shape_override is not None) else jnp.asarray(aux_np)
    # the kernel shifts by the compute-dtype weights, so the window
    # boundary must too (16-bit-rounded weights would leave their rounding
    # error in every population)
    w_c = vs._w.reshape((vs.q,) + (1,) * vs.d).astype(np.dtype(cdt))

    def _value(f_0, mask_i32, omega_c, aux):
        g = (f_0.astype(cdt) - w_c).astype(pp.store_dtype) if convert else f_0

        # two steps per iteration over a ping-pong pair: each step writes
        # the buffer the previous one read, so the loop carry needs no copy
        # (one carried buffer costs a full device-to-device copy per step)
        def two_steps(i, carry):
            a, _ = carry
            b = fused(a, mask_i32, omega_c, aux=aux)
            return fused(b, mask_i32, omega_c, aux=aux), b

        g, _ = jax.lax.fori_loop(0, num_steps // 2, two_steps, (g, g))
        if num_steps % 2:
            g = fused(g, mask_i32, omega_c, aux=aux)
        return g.astype(cdt) + w_c if convert else g

    def _jnp_window(f_0, bc_mask, missing_mask, omega_c):
        """The same window on the jnp tier (the backward pass's oracle)."""
        f = (f_0.astype(cdt) + w_c if io_shifted else f_0).astype(pp.store_dtype)

        def body(i, a):
            return stepper._step_pull(a, a, bc_mask, missing_mask, omega_c, i)[1]

        f = jax.lax.fori_loop(0, num_steps, body, f)
        if io_shifted:
            return (f.astype(cdt) - w_c).astype(pp.store_dtype)
        return f.astype(cdt) if convert else f

    @jax.custom_vjp
    def _window(f_0, bc_mask, missing_mask, omega_c, aux):
        mask_i32 = bc_mask if pre_packed else pack_masks(bc_mask, missing_mask)
        return _value(f_0, mask_i32, omega_c, aux)

    def _w_fwd(f_0, bc_mask, missing_mask, omega_c, aux):
        return _window(f_0, bc_mask, missing_mask, omega_c, aux), (f_0, bc_mask, missing_mask, omega_c, aux)

    def _w_bwd(res, gbar):
        f_0, bc_mask, missing_mask, omega_c, aux = res
        if pre_packed:
            raise NotImplementedError("pre-packed (out-of-core) windows are forward-only")
        _, vjp = jax.vjp(lambda f, om: _jnp_window(f, bc_mask, missing_mask, om), f_0, omega_c)
        df, dom = vjp(gbar)
        daux = None if aux is None else jnp.zeros_like(aux)
        return df, _zero_cotangent(bc_mask), _zero_cotangent(missing_mask), dom, daux

    _window.defvjp(_w_fwd, _w_bwd)

    # donate=True frees the caller's population buffers for reuse inside
    # the window -- required headroom for domains near the memory limit
    # (callers must then treat their f_0/f_1 as consumed)
    @partial(jax.jit, donate_argnums=(0, 1) if donate else ())
    def _run(f_0, f_1, bc_mask, missing_mask, omega, aux):
        omega_c = jnp.asarray(omega, dtype=cdt)
        f_out = _window(f_0, bc_mask, missing_mask, omega_c, aux)
        return f_out, f_out

    def run(f_0, f_1, bc_mask, missing_mask, omega, aux=None):
        return _run(f_0, f_1, bc_mask, missing_mask, omega, aux_dev if aux is None else aux)

    return _stamp(run, fused)
