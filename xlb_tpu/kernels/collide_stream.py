"""Fused pull-stream + boundary + collide Pallas kernel (Triton route).

This is the performance tier of the framework -- the analogue of the
reference's fused per-voxel Warp kernel (nse_stepper.py:427-466), which
performs the whole LBM timestep in one pass over device memory:

    read f_0 neighborhood -> pull-stream -> streaming BCs -> moments ->
    equilibrium -> collide -> collision BCs -> write f_1

Design:

- Populations are ``(q, *shape)`` arrays viewed flat as ``(q, N)``.  One
  program updates a power-of-two block of consecutive cells; the tail
  block is masked at the store (its gathers are clamped in bounds).
- The pull is a gathered neighbour load per direction: the cell's
  coordinates come from its flat index, each axis gets its three
  ``(coord - s) mod extent`` variants (s in -1, 0, 1), and direction l
  reads ``f[l, x - c_lx, y - c_ly, z - c_lz]`` -- periodic wrap falls out
  of the modular indices.  Nothing is carried between programs.
- ``bc_mask`` and ``missing_mask`` are pre-packed into ONE int32 voxel field
  (missing-direction bitfield in bits 0..q-1, BC id in the free high bits;
  see ``bc_id_shift``) by the stepper, cutting mask traffic from q+1 bytes
  to 4 bytes per voxel.
- The BC list is unrolled at trace time (the Pallas analogue of the
  reference's ``wp.static`` BC unrolling, nse_stepper.py:366-380); each BC
  becomes a masked select epilogue.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def bc_id_shift(q):
    """Bit position of the BC id field in the packed int32 mask.

    The missing-direction bitfield occupies bits 0..q-1, so the free bits
    depend on the stencil:

    - q <= 19 (D2Q9/D3Q19): bits 19..26 hold the RAW uint8 cell type
      (BC ids 1..253 plus specials 254/255 directly) -- full parity with
      the reference's uint8 id space (boundary_condition_registry.py:6-30)
      at zero extra traffic.  Bits 27..31 stay zero, so packed values are
      always non-negative.
    - q > 19 (D3Q27): only bits 27..31 are free (5 bits); ids 0..29 pack
      directly and the specials remap 254 -> 30, 255 -> 31.
    """
    return 19 if q <= 19 else 27


def bc_id_mask(q):
    """Bitmask of the BC id field width (after shifting)."""
    return 0xFF if q <= 19 else 31


def kernel_bc_id(bc_id, q):
    """Remap a cell-type code to its packed-mask kernel id for a DdQq set."""
    if q <= 19:
        if not 0 <= bc_id <= 255:
            raise ValueError(f"BC id {bc_id} outside the uint8 cell-type space")
        return bc_id
    if bc_id == 254:
        return 30
    if bc_id == 255:
        return 31
    if not 0 <= bc_id < 30:
        raise ValueError(
            f"BC id {bc_id} does not fit the D3Q27 packed-mask 5-bit id space (0..29 + specials); "
            "D2Q9/D3Q19 scenes carry the full uint8 id space"
        )
    return bc_id


def kernel_solid_id(q):
    """Packed id of cell type 255 (solid)."""
    return 255 if q <= 19 else 31


def unpack_bc_id(packed, q):
    """Extract the BC id field from a packed int32 mask (traced)."""
    return jax.lax.bitwise_and(jax.lax.shift_right_logical(packed, bc_id_shift(q)), bc_id_mask(q))


def kernel_collision_spec(stepper):
    """Collision argument for the fused kernel builders.

    Returns the plain collision-type string when the operator runs on class
    defaults, or a ``(string, params)`` tuple carrying the operator's actual
    constructor parameters (TRT magic, MRT projector matrices, custom
    Smagorinsky coefficient) so the kernel matches the jnp tier exactly.
    """
    ct = stepper.collision_type
    coll = stepper.collision
    inner = getattr(coll, "collision_operator", coll)  # unwrap ForcedCollision
    if ct == "TRT":
        return (ct, {"magic": inner.magic})
    if ct == "MRT":
        return (ct, {"fixed": inner.fixed_projectors})
    if ct == "SmagorinskyLESBGK":
        return (ct, {"smagorinsky_coef": inner.smagorinsky_coef})
    if ct == "PowerLawBGK":
        return (ct, {
            "consistency": inner.consistency,
            "power_index": inner.power_index,
            "iterations": inner.iterations,
        })
    return ct


def spec_uses_aux(spec):
    """True when a BC spec needs a per-voxel aux channel (prescribed
    velocity or density, or hybrid directional wall distances)."""
    return (
        (isinstance(spec.get("mw"), str) and spec["mw"] == "aux")
        or (isinstance(spec.get("value"), str) and spec["value"] in ("aux", "aux_rho"))
        or (spec.get("kind") == "hybrid" and spec.get("use_dist"))
    )


def aux_layout(bc_specs, vs, base=0):
    """Static channel layout of the aux side array shared by the kernel
    body and ``fused_step.build_aux_field``: velocity channels first
    (d, for spatial prescribed-velocity BCs), then one prescribed-density
    channel (for spatial pressure BCs), then one q-channel block of
    wall-distance weights PER HybridBC-with-distances (keyed by BC id, so
    overlapping dilated shells of two meshes cannot clobber each other).
    ``base`` shifts the whole layout -- the extern_force mode prepends d
    per-voxel force channels at offset 0 and the ADE mode d advecting-
    velocity channels, each laying the BC channels after them (base=d).
    Returns (u_off, rho_off, w_offs, nchan): ``w_offs`` maps BC id ->
    channel offset; ``u_off``/``rho_off`` are None when no BC needs that
    channel; ``nchan`` includes the ``base`` prefix."""
    has_u = any(
        (isinstance(s.get("mw"), str) and s["mw"] == "aux")
        or (isinstance(s.get("value"), str) and s["value"] == "aux")
        for s in bc_specs
    )
    has_rho = any(isinstance(s.get("value"), str) and s["value"] == "aux_rho" for s in bc_specs)
    u_off = base if has_u else None
    off = base + (vs.d if has_u else 0)
    rho_off = off if has_rho else None
    off += 1 if has_rho else 0
    w_offs = {}
    for s in bc_specs:
        if s.get("kind") == "hybrid" and s.get("use_dist"):
            w_offs[s["id"]] = off
            off += vs.q
    return u_off, rho_off, w_offs, off


def _build_kernel_body(
    vs, collision, bc_specs, compute_dtype, store_dtype,
    smagorinsky_coef=0.17, shifted=False, has_solids=True, force_vector=None,
    ade=False, extern_force=False,
):
    """Returns the per-cell physics of a DdQq fused step (``pointwise_core``
    and the flags the launcher needs).

    ``shifted=True`` stores populations in deviation form g_l = f_l - w_l
    between steps: adding/subtracting the static weight at load/store keeps
    the full mantissa on the physically-varying part, which makes 16-bit
    storage accurate for low-Mach flows (classic well-conditioning trick;
    the reference's Neumaier-compensated sums address the same roundoff).

    ``ade=True`` builds the advection-diffusion variant (models/ade.py):
    the zeroth moment is the transported scalar, the ADVECTING velocity
    arrives as d per-voxel aux channels, and the equilibrium is linear
    (geq_l = w_l phi (1 + 3 c.u)); BGK only, voxel-local BC kinds only.

    ``collision`` is either the collision-type string or a
    ``(string, params)`` tuple from ``kernel_collision_spec`` carrying the
    operator's constructor parameters (TRT magic, MRT projector matrices,
    Smagorinsky coefficient) so custom values reach the kernel instead of
    the class defaults.
    """
    if isinstance(collision, tuple):
        collision, collision_params = collision
    else:
        collision_params = {}
    smagorinsky_coef = collision_params.get("smagorinsky_coef", smagorinsky_coef)
    if ade:
        assert collision == "BGK", "fused ADE supports BGK relaxation only"
        # zouhe/regularized with a CONSTANT prescribed value give Dirichlet
        # scalar walls (rho closure = the transported scalar): the jnp ADE
        # tier applies the same NSE BC operators on g (models/ade.py:117-120),
        # so the NSE epilogue closures match bit-for-bit
        allowed = {"equilibrium", "do_nothing", "halfway", "fullway", "zouhe", "regularized"}
        bad = [s["kind"] for s in bc_specs if s["kind"] not in allowed]
        if bad:
            raise NotImplementedError(f"fused ADE supports BC kinds {sorted(allowed)}; got {bad}")
        # the ADVECTING velocity always rides channels [0:d]; spatial-BC
        # channels (profile walls, spatial Dirichlet values) follow at
        # offset d, exactly like the extern_force layout
        use_aux = True
        aux_u_off, aux_rho_off, aux_w_offs, aux_nchan = aux_layout(bc_specs, vs, base=vs.d)
    elif extern_force:
        # per-voxel exact-difference force field rides aux channels [0:d]
        # (a kernel ARGUMENT -- it changes every step in coupled flows);
        # spatial-BC channels, when present, follow at offset d
        assert force_vector is None, "extern_force replaces the static force_vector"
        use_aux = True
        aux_u_off, aux_rho_off, aux_w_offs, aux_nchan = aux_layout(bc_specs, vs, base=vs.d)
    else:
        use_aux = any(spec_uses_aux(s) for s in bc_specs)
        aux_u_off, aux_rho_off, aux_w_offs, aux_nchan = aux_layout(bc_specs, vs)
    q, d = vs.q, vs.d
    c = vs._c  # (3, q) static
    w = vs._w
    opp = vs._opp_indices
    cdt = compute_dtype

    def moments(f_s):
        rho = f_s[0]
        for l in range(1, q):
            rho = rho + f_s[l]
        inv_rho = 1.0 / rho
        mom = []
        for a in range(d):
            acc = None
            for l in range(q):
                ca = c[a, l]
                if ca == 0:
                    continue
                t = f_s[l] if ca == 1 else -f_s[l]
                acc = t if acc is None else acc + t
            mom.append(acc * inv_rho)
        return rho, mom

    def equilibrium(rho, u):
        # pair-shared Hermite form: for a direction l and its opposite o,
        # w_l == w_o and c_o = -c_l, so with cu3 = 3 c_l.u the quadratic
        # feq = rho w (1 + cu3 (1 + cu3/2) - 1.5 u^2) splits into a shared
        # even part t = (1 - 1.5u^2) + cu3^2/2 and the odd +-cu3 term:
        #   feq_l = rho w (t + cu3),  feq_o = rho w (t - cu3)
        # -- one cu dot product, one square, and one rho*w per PAIR instead
        # of per direction (~45% fewer VPU flops in this, the hottest,
        # closure; parity with the per-direction jnp tier is reassociation
        # only, covered by the 1e-6-rtol fused-vs-jnp tests)
        usqr = u[0] * u[0]
        for a in range(1, d):
            usqr = usqr + u[a] * u[a]
        base = 1.0 - 1.5 * usqr
        feq = [None] * q
        for l in range(q):
            if feq[l] is not None:
                continue
            cu = None
            for a in range(d):
                ca = c[a, l]
                if ca == 0:
                    continue
                t = u[a] if ca == 1 else -u[a]
                cu = t if cu is None else cu + t
            rw = rho * cdt(w[l])
            if cu is None:
                feq[l] = rw * base
                continue
            cu3 = 3.0 * cu
            even = base + 0.5 * (cu3 * cu3)
            feq[l] = rw * (even + cu3)
            o = int(opp[l])
            if feq[o] is None:
                feq[o] = rw * (even - cu3)
        return feq

    def second_moment(fneq):
        """Packed upper-triangular Pi = sum cc_l fneq_l as a list."""
        cc = vs._cc  # (q, nt)
        nt = cc.shape[1]
        pis = []
        for t in range(nt):
            acc = None
            for l in range(q):
                coef = cc[l, t]
                if coef == 0:
                    continue
                term = fneq[l] if coef == 1 else (-fneq[l] if coef == -1 else fneq[l] * cdt(coef))
                acc = term if acc is None else acc + term
            pis.append(acc if acc is not None else jnp.zeros_like(fneq[0]))
        return pis

    def collide(f_s, feq, omega):
        if collision == "BGK":
            return [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]
        if collision == "TRT":
            # two-relaxation-time (ops/collision.py::trt_collide): even part
            # relaxes at omega (viscosity), odd at omega_minus from the magic
            # parameter; computed per opposite PAIR like the equilibrium
            lam = cdt(collision_params.get("magic", 0.25))
            tau_p_half = 1.0 / omega - 0.5
            om_m = 1.0 / (lam / tau_p_half + 0.5)
            out = [None] * q
            for l in range(q):
                if out[l] is not None:
                    continue
                o = int(opp[l])
                if o == l:  # rest direction: purely even
                    out[l] = f_s[l] - omega * (f_s[l] - feq[l])
                    continue
                h_even = omega * (0.5 * (f_s[l] + f_s[o]) - 0.5 * (feq[l] + feq[o]))
                h_odd = om_m * (0.5 * (f_s[l] - f_s[o]) - 0.5 * (feq[l] - feq[o]))
                out[l] = f_s[l] - h_even - h_odd
                out[o] = f_s[o] - h_even + h_odd
            return out
        if collision == "MRT":
            # BGK plus one static-projector correction per fixed-rate moment
            # group (ops/collision.py::mrt_collide); unrolled adds keep the
            # contraction on the VPU at full precision, zero entries skipped
            fixed = collision_params["fixed"]

            def mat_apply(mat, vecs):
                outs = []
                for i in range(q):
                    acc = None
                    for j in range(q):
                        m = float(mat[i, j])
                        if abs(m) < 1e-14:
                            continue
                        t = vecs[j] if m == 1.0 else (-vecs[j] if m == -1.0 else vecs[j] * cdt(m))
                        acc = t if acc is None else acc + t
                    outs.append(acc if acc is not None else jnp.zeros_like(vecs[0]))
                return outs

            fneq = [f_s[l] - feq[l] for l in range(q)]
            out = [f_s[l] - omega * fneq[l] for l in range(q)]
            for s, P in fixed:
                r = mat_apply(P, fneq)
                coef = omega - cdt(s)
                out = [out[l] + coef * r[l] for l in range(q)]
            return out
        if collision == "SmagorinskyLESBGK":
            fneq = [f_s[l] - feq[l] for l in range(q)]
            pi = second_moment(fneq)
            if d == 3:
                diag, offd = (0, 3, 5), (1, 2, 4)
            else:
                diag, offd = (0, 2), (1,)
            strain = sum(pi[t] * pi[t] for t in diag) + 2.0 * sum(pi[t] * pi[t] for t in offd)
            tau0 = 1.0 / omega
            cs = cdt(smagorinsky_coef)
            tau = 0.5 * (tau0 + jnp.sqrt(tau0 * tau0 + 36.0 * cs * cs * jnp.sqrt(strain)))
            om = 1.0 / tau
            return [f_s[l] - om * fneq[l] for l in range(q)]
        if collision == "PowerLawBGK":
            # generalized-Newtonian power-law viscosity
            # (ops/collision.py::power_law_collide): local omega from a
            # damped fixed point of 1/om = 3K (A om)^(n-1) + 1/2
            fneq = [f_s[l] - feq[l] for l in range(q)]
            pi = second_moment(fneq)
            if d == 3:
                diag, offd = (0, 3, 5), (1, 2, 4)
            else:
                diag, offd = (0, 2), (1,)
            pi_sq = sum(pi[t] * pi[t] for t in diag) + 2.0 * sum(pi[t] * pi[t] for t in offd)
            rho_loc = None
            for l in range(q):
                rho_loc = f_s[l] if rho_loc is None else rho_loc + f_s[l]
            a_sh = 1.5 * jnp.sqrt(2.0 * pi_sq) / rho_loc
            k3 = 3.0 * cdt(collision_params["consistency"])
            nm1 = cdt(collision_params["power_index"] - 1.0)
            eps = cdt(1e-12)
            tau = jnp.broadcast_to(1.0 / omega, a_sh.shape).astype(a_sh.dtype)
            for _ in range(int(collision_params.get("iterations", 5))):
                tau = k3 * (a_sh / tau + eps) ** nm1 + 0.5
            om = jnp.clip(1.0 / tau, 0.05, 1.99)
            return [f_s[l] - om * fneq[l] for l in range(q)]
        if collision == "KBC":
            fneq = [f_s[l] - feq[l] for l in range(q)]
            pi = second_moment(fneq)
            zeros = jnp.zeros_like(fneq[0])
            ds = [zeros] * q
            if d == 3:  # D3Q27 shear decomposition (reference kbc.py:96-145)
                nxz = pi[0] - pi[5]
                nyz = pi[3] - pi[5]
                ds[9] = ds[18] = (2.0 * nxz - nyz) / 6.0
                ds[3] = ds[6] = (-nxz + 2.0 * nyz) / 6.0
                ds[1] = ds[2] = (-nxz - nyz) / 6.0
                ds[12] = ds[24] = pi[1] / 4.0
                ds[21] = ds[15] = -pi[1] / 4.0
                ds[10] = ds[20] = pi[2] / 4.0
                ds[19] = ds[11] = -pi[2] / 4.0
                ds[8] = ds[4] = pi[4] / 4.0
                ds[7] = ds[5] = -pi[4] / 4.0
            else:  # D2Q9 (reference kbc.py:147-174), delta_s = shear / 4
                n = pi[0] - pi[2]
                ds[3] = ds[6] = n / 4.0
                ds[2] = ds[1] = -n / 4.0
                ds[8] = ds[7] = pi[1] / 4.0
                ds[4] = ds[5] = -pi[1] / 4.0
            beta = 0.5 * omega
            inv_beta = 1.0 / beta
            dh = [fneq[l] if ds[l] is zeros else fneq[l] - ds[l] for l in range(q)]

            # entropic products <ds, dh>_{1/feq} and <dh, dh>_{1/feq},
            # pair-shared: ds is even in c (ds_l == ds_opp), and with
            # inv = 1/(feq_l feq_o) the two per-direction divisions of a
            # pair collapse into ONE (dh_l/feq_l = dh_l feq_o inv) --
            # 14 divides instead of 27 at q=27; pure reassociation, so
            # jnp-tier parity holds to the usual f32 roundoff.  Directions with ds == 0 (statically
            # known) skip the <ds, dh> term entirely.
            sp1 = None
            sp2 = None
            for l in range(q):
                o = int(opp[l])
                if o < l:
                    continue  # pair handled at its lower index
                if o == l:  # rest direction
                    tmp = dh[l] / feq[l]
                    t1 = None if ds[l] is zeros else tmp * ds[l]
                    t2 = tmp * dh[l]
                else:
                    inv = 1.0 / (feq[l] * feq[o])
                    a = dh[l] * feq[o]
                    b = dh[o] * feq[l]
                    t1 = None if ds[l] is zeros else ds[l] * ((a + b) * inv)
                    t2 = (dh[l] * a + dh[o] * b) * inv
                if t1 is not None:
                    sp1 = t1 if sp1 is None else sp1 + t1
                sp2 = t2 if sp2 is None else sp2 + t2
            gamma = inv_beta - (2.0 - inv_beta) * sp1 / (cdt(1e-32) + sp2)
            return [
                f_s[l] - beta * (gamma * dh[l]) if ds[l] is zeros
                else f_s[l] - beta * (2.0 * ds[l] + gamma * dh[l])
                for l in range(q)
            ]
        raise ValueError(f"unsupported collision {collision!r} in fused kernel")

    def _zouhe_epilogue(spec, on, missing, f_s, aux=None):
        """Zou-He / regularized closure (local math only; mirrors
        boundary/bc_zouhe.py + bc_regularized.py).  ``spec`` carries the
        static prescribed velocity vector or density, or ``"aux"`` to read
        a per-voxel prescribed velocity from the aux field."""
        miss_f = [missing(l).astype(cdt) for l in range(q)]
        known_f = [miss_f[opp[l]] for l in range(q)]
        middle_f = [1.0 - jnp.maximum(miss_f[l], known_f[l]) for l in range(q)]

        fsum = None
        for l in range(q):
            term = f_s[l] * middle_f[l] + 2.0 * f_s[l] * known_f[l]
            fsum = term if fsum is None else fsum + term

        # inward normal from missing main directions
        normals = []
        for a in range(d):
            acc = None
            for l in vs.main_indices:
                ca = c[a, l]
                if ca == 0:
                    continue
                t = miss_f[l] if ca == 1 else -miss_f[l]
                acc = t if acc is None else acc + t
            normals.append(-acc if acc is not None else jnp.zeros_like(fsum))

        if spec["bc_type"] == "velocity":
            if isinstance(spec["value"], str) and spec["value"] == "aux":  # per-voxel prescribed velocity
                u = [aux[aux_u_off + a] for a in range(d)]
                unormal = None
                for a in range(d):
                    t = normals[a] * u[a]
                    unormal = t if unormal is None else unormal + t
                rho = fsum / (1.0 + unormal)
            else:
                vel_const = spec["value"]  # static (d,) numpy
                unormal = None
                for a in range(d):
                    if vel_const[a] == 0.0:
                        continue
                    t = normals[a] * cdt(vel_const[a])
                    unormal = t if unormal is None else unormal + t
                if unormal is None:
                    unormal = jnp.zeros_like(fsum)
                rho = fsum / (1.0 + unormal)
                u = [jnp.full_like(fsum, cdt(vel_const[a])) for a in range(d)]
        else:  # pressure
            if isinstance(spec["value"], str) and spec["value"] == "aux_rho":
                # per-voxel prescribed density from the aux rho channel
                rho = aux[aux_rho_off].astype(cdt)
            else:
                rho = jnp.full_like(fsum, cdt(spec["value"]))
            unormal = -1.0 + fsum / rho
            u = [unormal * normals[a] for a in range(d)]

        feq = equilibrium(rho, u)
        f_bd = [jnp.where(missing(l), f_s[opp[l]] + feq[l] - feq[opp[l]], f_s[l]) for l in range(q)]

        if spec["kind"] == "regularized":
            fneq = [f_bd[l] - feq[l] for l in range(q)]
            pi = second_moment(fneq)
            qi = vs._qi  # (q, nt) static
            out_bd = []
            for l in range(q):
                qipi = None
                for t in range(qi.shape[1]):
                    coef = qi[l, t]
                    if coef == 0:
                        continue
                    term = pi[t] * cdt(coef)
                    qipi = term if qipi is None else qipi + term
                out_bd.append(feq[l] + cdt(4.5 * w[l]) * (qipi if qipi is not None else 0.0))
            f_bd = out_bd

        return [jnp.where(on, f_bd[l], f_s[l]) for l in range(q)]

    def _qi_contract(pi):
        """Per-direction Q_l : Pi contraction (list of q slabs)."""
        qi = vs._qi  # (q, nt) static
        out = []
        for l in range(q):
            acc = None
            for t in range(qi.shape[1]):
                coef = qi[l, t]
                if coef == 0:
                    continue
                term = pi[t] * cdt(coef)
                acc = term if acc is None else acc + term
            out.append(acc)
        return out

    def _regularize_list(f_bd, feq):
        """Latt-Chopard: feq + 4.5 w_l Q_l : Pi_neq (bc_hybrid.py:121-126)."""
        pi = second_moment([f_bd[l] - feq[l] for l in range(q)])
        qipi = _qi_contract(pi)
        return [feq[l] + cdt(4.5 * w[l]) * qipi[l] if qipi[l] is not None else feq[l] for l in range(q)]

    def _hybrid_epilogue(spec, on, missing, f_s, f_pre, aux):
        """Hybrid curved-boundary closure (mirrors boundary/bc_hybrid.py,
        reference bc_hybrid.py:39-391): interpolated bounce-back or Tao
        one-point closure + regularization/Grad reconstruction.  Per-link
        wall distances ride the aux field's weight channels when the BC
        has mesh distances; otherwise the halfway value applies."""
        method = spec["method"]
        use_dist = spec["use_dist"]
        mw = spec.get("mw")  # static per-l 6 w_l (c_l . u_wall), "aux", or None
        miss = [missing(l) for l in range(q)]
        if isinstance(mw, str) and mw == "aux":
            # spatial moving wall: per-voxel wall velocity from the aux
            # velocity channels (same channels as halfway's mw="aux")
            u_aux = [aux[aux_u_off + a] for a in range(d)]

        def mw_term(l):
            """Moving-wall correction 6 w_l (c_l . u_wall) for direction l:
            a static constant, a per-voxel slab (spatial profile), or None."""
            if mw is None:
                return None
            if isinstance(mw, str):  # spatial: assemble from aux velocity
                cu = None
                for a in range(d):
                    ca = c[a, l]
                    if ca == 0:
                        continue
                    t = u_aux[a] if ca == 1 else -u_aux[a]
                    cu = t if cu is None else cu + t
                return None if cu is None else cdt(6.0 * w[l]) * cu
            return cdt(mw[l])
        if use_dist:
            w_off = aux_w_offs[spec["id"]]
            t_w = [aux[w_off + l] for l in range(q)]
        else:
            t_w = [cdt(0.5)] * q  # only the Tao closure reads these

        if method in ("bounceback", "bounceback_regularized", "bounceback_grads"):
            # Yu-Mei-Shyy single-node interpolated bounce-back
            f_bd = []
            for l in range(q):
                if use_dist:
                    interp = ((1.0 - t_w[l]) * f_s[opp[l]] + t_w[l] * (f_pre(l) + f_pre(opp[l]))) / (1.0 + t_w[l])
                    # sandwich (both directions missing): plain bounce-back
                    interp = jnp.where(jnp.logical_and(miss[l], miss[opp[l]]), f_pre(opp[l]), interp)
                else:
                    interp = f_pre(opp[l])
                mwl = mw_term(l)
                if mwl is not None:
                    interp = interp + mwl
                f_bd.append(jnp.where(miss[l], interp, f_s[l]))
            if method == "bounceback":
                return [jnp.where(on, f_bd[l], f_s[l]) for l in range(q)]
            rho, u = moments(f_bd)
            if method == "bounceback_regularized":
                f_bd = _regularize_list(f_bd, equilibrium(rho, u))
            else:  # Grad's approximation for the missing populations
                pi = second_moment(f_bd)
                diag = vs.diagonal_moment_indices
                pi_dev = [pi[t] - rho / 3.0 if t in diag else pi[t] for t in range(len(pi))]
                qipi = _qi_contract(pi_dev)
                for l in range(q):
                    cu = None
                    for a in range(d):
                        ca = c[a, l]
                        if ca == 0:
                            continue
                        term = u[a] if ca == 1 else -u[a]
                        cu = term if cu is None else cu + term
                    grads = rho * cdt(w[l]) * (1.0 if cu is None else 1.0 + 3.0 * cu)
                    if qipi[l] is not None:
                        grads = grads + cdt(4.5 * w[l]) * qipi[l]
                    f_bd[l] = jnp.where(miss[l], grads, f_bd[l])
        else:  # nonequilibrium_regularized: Tao et al. one-point closure
            fp = [f_pre(l) for l in range(q)]
            rho_p, u_p = moments(fp)
            feq_p = equilibrium(rho_p, u_p)
            if isinstance(mw, str) and mw == "aux":  # spatial wall velocity
                feq_w = equilibrium(rho_p, [u_aux[a].astype(rho_p.dtype) for a in range(d)])
            elif mw is not None:
                uw = spec["u_wall"]  # static (d,)
                feq_w = equilibrium(rho_p, [jnp.full_like(rho_p, cdt(uw[a])) for a in range(d)])
            else:
                feq_w = [cdt(w[l]) * rho_p for l in range(q)]
            f_bd = []
            for l in range(q):
                f_wall = feq_w[l] + (fp[opp[l]] - feq_p[opp[l]])
                closed = (f_wall + t_w[l] * fp[l]) / (1.0 + t_w[l])
                f_bd.append(jnp.where(miss[l], closed, f_s[l]))
            rho2, u2 = moments(f_bd)
            f_bd = _regularize_list(f_bd, equilibrium(rho2, u2))

        return [jnp.where(on, f_bd[l], f_s[l]) for l in range(q)]

    def pointwise_core(fs_raw, fp_raw, packed, omega, aux=None, staging_read=None):
        """Per-voxel physics given already-gathered populations.

        ``fs_raw[l]`` is the raw (store-form) pulled block of direction l;
        ``fp_raw(l)`` lazily returns the raw centered (pre-streaming) block;
        ``aux[k]`` is aux channel k.  Everything here is voxel-local except
        the extrapolation-outflow staging epilogue, which needs
        ``staging_read(m, t)`` -- raw direction m at the cell minus the
        d-vector offset t -- for its tangential-neighbor pulls.  Returns
        the list of post-collision compute-dtype blocks (unshifted,
        uncast)."""
        bc = unpack_bc_id(packed, q)
        f_s = [fs_raw[l] + cdt(w[l]) if shifted else fs_raw[l] for l in range(q)]

        # pre-streaming populations, read lazily: only the channels a BC
        # epilogue (or the solid keep-out) actually touches cost a slab read
        fpre_cache = {}

        def f_pre(l):
            if l not in fpre_cache:
                v = fp_raw(l)
                fpre_cache[l] = v + cdt(w[l]) if shifted else v
            return fpre_cache[l]

        def missing(l):
            return jax.lax.bitwise_and(jax.lax.shift_right_logical(packed, l), 1) == 1

        # ---- streaming-step BCs (trace-time unrolled) ---------------------
        for spec in bc_specs:
            if spec["step"] != "streaming":
                continue
            on = bc == kernel_bc_id(spec["id"], q)
            kind = spec["kind"]
            if kind == "equilibrium":
                feq_p = spec["feq"]  # static (q,) numpy
                f_s = [jnp.where(on, cdt(feq_p[l]), f_s[l]) for l in range(q)]
            elif kind == "do_nothing":
                f_s = [jnp.where(on, f_pre(l), f_s[l]) for l in range(q)]
            elif kind == "halfway":
                mw = spec.get("mw")
                for l in range(q):
                    if isinstance(mw, str) and mw == "aux":
                        # spatial moving wall: 6 w_l (c_l . u_wall(x))
                        cu = None
                        for a in range(d):
                            ca = c[a, l]
                            if ca == 0:
                                continue
                            av = aux[aux_u_off + a]
                            t = av if ca == 1 else -av
                            cu = t if cu is None else cu + t
                        refl = f_pre(opp[l]) if cu is None else f_pre(opp[l]) + cdt(6.0 * w[l]) * cu
                    elif mw is None:
                        refl = f_pre(opp[l])
                    else:
                        refl = f_pre(opp[l]) + cdt(mw[l])
                    f_s[l] = jnp.where(jnp.logical_and(on, missing(l)), refl, f_s[l])
            elif kind == "free_slip":
                # specular reflection (bc_free_slip.py): wall-crossing
                # missing dirs take the pre-streaming population of the
                # normal-flipped mirror; other tagged dirs (periodic corner
                # wraps) keep their streamed values
                perm = spec["spec_indices"]
                refl = spec["reflect_dirs"]
                for l in range(q):
                    if not refl[l]:
                        continue
                    f_s[l] = jnp.where(jnp.logical_and(on, missing(l)), f_pre(int(perm[l])), f_s[l])
            elif kind in ("zouhe", "regularized"):
                f_s = _zouhe_epilogue(spec, on, missing, f_s, aux)
            elif kind == "hybrid":
                f_s = _hybrid_epilogue(spec, on, missing, f_s, f_pre, aux)
            elif kind == "extrapolation_outflow":
                # missing dirs take the staged values from the previous
                # step's outgoing slots (bc_extrapolation_outflow.py:137-147)
                for l in range(q):
                    f_s[l] = jnp.where(jnp.logical_and(on, missing(l)), f_pre(opp[l]), f_s[l])
            else:
                raise ValueError(f"BC kind {kind!r} not supported in fused kernel")

        # ---- moments + equilibrium + collision ----------------------------
        if ade:
            # scalar transport: phi = sum g; u is the externally-prescribed
            # advecting velocity from the aux channels; linear equilibrium
            rho = f_s[0]
            for l in range(1, q):
                rho = rho + f_s[l]
            # advecting velocity: always channels [0:d] (BC aux channels,
            # if any, start at offset d -- aux_layout(base=d))
            u = [aux[a] for a in range(d)]
            feq = [None] * q
            for l in range(q):
                if feq[l] is not None:
                    continue
                cu = None
                for a in range(d):
                    ca = c[a, l]
                    if ca == 0:
                        continue
                    t = u[a] if ca == 1 else -u[a]
                    cu = t if cu is None else cu + t
                rw = rho * cdt(w[l])
                if cu is None:
                    feq[l] = rw
                    continue
                # pair-shared linear form: geq_{l,o} = rho w (1 +- 3 c.u)
                cu3 = 3.0 * cu
                feq[l] = rw * (1.0 + cu3)
                o = int(opp[l])
                if feq[o] is None:
                    feq[o] = rw * (1.0 - cu3)
            f_out = [f_s[l] - omega * (f_s[l] - feq[l]) for l in range(q)]
        else:
            rho, u = moments(f_s)
            feq = equilibrium(rho, u)
            f_out = collide(f_s, feq, omega)

        # exact-difference body force (Kupershtokh; ops/force.py:28-45,
        # reference exact_difference_force.py:14-76): f += feq(rho, u+F) - feq
        if force_vector is not None:
            u_f = [u[a] + cdt(force_vector[a]) for a in range(d)]
            feq_f = equilibrium(rho, u_f)
            f_out = [f_out[l] + (feq_f[l] - feq[l]) for l in range(q)]
        elif extern_force and not ade:
            # the per-voxel force always sits in channels [0:d] (BC aux
            # channels, if any, start at offset d -- aux_layout(base=d))
            u_f = [u[a] + aux[a] for a in range(d)]
            feq_f = equilibrium(rho, u_f)
            f_out = [f_out[l] + (feq_f[l] - feq[l]) for l in range(q)]

        # ---- collision-step BCs -------------------------------------------
        for spec in bc_specs:
            if spec["step"] != "collision":
                continue
            on = bc == kernel_bc_id(spec["id"], q)
            if spec["kind"] == "fullway":
                f_out = [jnp.where(on, f_s[opp[l]], f_out[l]) for l in range(q)]
            else:
                raise ValueError(f"BC kind {spec['kind']!r} not supported in fused kernel")

        # ---- aux staging epilogues (post-collision) ------------------------
        # extrapolation outflow stages cs*f_s(neighbor) + (1-cs)*f_s(self)
        # into the outgoing slots for the next step's streaming phase
        # (bc_extrapolation_outflow.py:107-133).  The neighbor term
        # f_s[m](v - n) equals raw[m](v - t) with t = n + c_m; wherever the
        # staging mask is true, c_m . n = -1, so t is purely tangential and
        # the read is an ordinary gathered pull.
        for spec in bc_specs:
            if spec["kind"] != "extrapolation_outflow":
                continue
            assert staging_read is not None, (
                "extrapolation_outflow staging needs neighbour reads; this caller requires voxel-local physics"
            )
            on = bc == kernel_bc_id(spec["id"], q)
            n = spec["normal"]  # static d-vector (outward)
            cs_speed = cdt(1.0 / np.sqrt(3.0))

            for l in range(q):
                m = opp[l]
                t = tuple(int(n[a] + c[a, m]) for a in range(d))
                if any(abs(tc) > 1 for tc in t):
                    # c_m . n >= +1: such a direction is never a staged slot
                    # at this face (its pull source is interior fluid)
                    continue
                neighbor = staging_read(m, t)
                if shifted:
                    neighbor = neighbor + cdt(w[m])
                extrap_opp = cs_speed * neighbor + (1.0 - cs_speed) * f_s[m]
                f_out[l] = jnp.where(jnp.logical_and(on, missing(m)), extrap_opp, f_out[l])

        # solid voxels keep their previous populations (reference solid
        # early-out, nse_stepper.py:440-441); also kills NaNs from rho=0.
        # Skipped entirely when the stepper knows no voxel carries the
        # solid tag (bounding-box-only setups) -- saves q slab reads.
        if has_solids:
            solid = bc == kernel_solid_id(q)  # packed id of cell-type 255
            f_out = [jnp.where(solid, f_pre(l), f_out[l]) for l in range(q)]
        return f_out


    return pointwise_core, use_aux, aux_nchan


def build_fused_collide_stream(
    velocity_set,
    shape,
    collision="BGK",
    bc_specs=(),
    compute_dtype=jnp.float32,
    store_dtype=jnp.float32,
    block=256,
    num_warps=4,
    interpret=False,
    shifted=False,
    has_solids=True,
    force_vector=None,
    ade=False,
    extern_force=False,
):
    """Build the fused step ``(f, mask_i32, omega, aux=None) -> f_new`` for
    a 2-D or 3-D ``shape``.

    ``block`` (a power of two) is the number of consecutive cells one
    program updates and ``num_warps`` the warps it runs with; the last
    block is masked when it overhangs the domain.  ``aux`` is the
    ``(nchan, *shape)`` per-voxel side array the BC specs, the ADE
    velocity or the extern force read (``aux_layout``).
    """
    d, q = velocity_set.d, velocity_set.q
    shape = tuple(int(s) for s in shape)
    if len(shape) != d:
        raise ValueError(f"shape {shape} does not match the D{d}Q{q} velocity set")
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    n_cells = int(np.prod(shape))
    strides = [int(np.prod(shape[a + 1 :])) for a in range(d)]
    c = velocity_set._c
    w = velocity_set._w
    cdt = compute_dtype
    pointwise_core, use_aux, nchan = _build_kernel_body(
        velocity_set, collision, list(bc_specs), compute_dtype, store_dtype,
        shifted=shifted, has_solids=has_solids, force_vector=force_vector,
        ade=ade, extern_force=extern_force,
    )

    def kernel(omega_ref, f_ref, mask_ref, *rest):
        out_ref = rest[-1]
        start = pl.program_id(0) * block
        cell = start + jnp.arange(block, dtype=jnp.int32)
        valid = cell < n_cells
        cell = jnp.minimum(cell, n_cells - 1)  # tail lanes gather in bounds

        # offs[a][s]: flat offset along axis a of the cell's coordinate
        # minus s (periodic), s in (-1, 0, 1)
        offs = []
        for a in range(d):
            coord = jax.lax.rem(jax.lax.div(cell, np.int32(strides[a])), np.int32(shape[a]))
            lo = jnp.where(coord == 0, shape[a] - 1, coord - 1)
            hi = jnp.where(coord == shape[a] - 1, 0, coord + 1)
            offs.append({0: coord * strides[a], 1: lo * strides[a], -1: hi * strides[a]})

        block_slice = pl.ds(start, block)

        def load_block(ref, k):
            return plgpu.load(ref.at[k, block_slice], mask=valid, other=0)

        def gather(l, t):
            """Raw population l at the cell minus the d-vector offset t."""
            if not any(t):
                return load_block(f_ref, l).astype(cdt)
            idx = offs[0][t[0]]
            for a in range(1, d):
                idx = idx + offs[a][t[a]]
            return plgpu.load(f_ref.at[l, idx]).astype(cdt)

        zero = (0,) * d
        fs_raw = [gather(l, tuple(int(c[a, l]) for a in range(d))) for l in range(q)]
        packed = plgpu.load(mask_ref.at[block_slice], mask=valid, other=0)
        aux = [load_block(rest[0], k).astype(cdt) for k in range(nchan)] if use_aux else None
        omega = omega_ref[0].astype(cdt)
        f_out = pointwise_core(fs_raw, lambda l: gather(l, zero), packed, omega, aux, staging_read=gather)
        for l in range(q):
            res = f_out[l] - cdt(w[l]) if shifted else f_out[l]
            plgpu.store(out_ref.at[l, block_slice], res.astype(store_dtype), mask=valid)

    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((q, n_cells), store_dtype),
        grid=(pl.cdiv(n_cells, block),),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        name="lbm_collide_stream",
    )

    def step(f, mask_i32, omega, aux=None):
        args = [jnp.asarray(omega, compute_dtype).reshape(1), f.reshape(q, n_cells), mask_i32.reshape(n_cells)]
        if use_aux:
            if aux is None:
                raise ValueError("this BC set needs the per-voxel aux field")
            args.append(aux.astype(jnp.float32).reshape(aux.shape[0], n_cells))
        return call(*args).reshape((q,) + shape)

    step.active_tier = f"pallas_triton block {block} warps {num_warps}" + (" interpret" if interpret else "")
    step.interpret = interpret
    step.aux_nchan = nchan if use_aux else 0
    return step
