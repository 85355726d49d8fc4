"""Shan-Chen pseudopotential multiphase flow (single component).

BEYOND-REFERENCE capability: the reference's only physics families are
NSE and a placeholder ADE (xlb/physics_type.py:6-8; this framework also
implements ADE + thermal coupling, models/ade.py).  The Shan-Chen model
(Shan & Chen 1993) adds liquid/vapor phase separation, droplets/bubbles
with surface tension, and solid wettability -- all from one inter-particle
pseudopotential force, riding the SAME per-voxel exact-difference forcing
machinery the thermal coupling uses (models/nse.py::_step_pull
``force_field``; kernels/fused_step.build_fused_forced_step on the PALLAS
tier), so both compute tiers and GSPMD distribution come for free.

Model:

    psi(rho)  = rho0 * (1 - exp(-rho / rho0))          # bounded potential
    F_a(x)    = -G psi(x) * sum_l w_l psi(x + c_l) c_{a,l}
    delta u   = F / rho                                 # exact-difference shift
    EOS:  p   = cs^2 rho + (cs^2 G / 2) psi^2

``G < 0`` is attractive; below the critical point (G < -4 for rho0 = 1)
the fluid separates into coexisting liquid/vapor phases.  The force uses
the step's INPUT state (rho(t), the zeroth moment of f_0 -- collision
conserves mass, so this is the time-t density): the same one-step-explicit
coupling as the Boussinesq thermal stepper, identical on both tiers.

Wettability: ``psi_wall`` assigns solid voxels (cell-type 255) a virtual
potential, giving contact angles from ~0 (psi_wall -> psi(rho_liquid),
wetting) to ~180 degrees (psi_wall -> psi(rho_vapor), non-wetting).

True fluid velocity at force half-step: u_true = u_raw + delta_u / 2
(``macroscopic``).
"""

import numpy as np
import jax
import jax.numpy as jnp

from xlb_tpu.compute_backend import ComputeBackend


class ShanChenMultiphaseStepper:
    """Single-component multiphase NSE stepper.

    Parameters
    ----------
    nse : IncompressibleNavierStokesStepper
        Configured stepper (its BC list handles walls; pull scheme).
    G : float
        Interaction strength (negative = attractive; |G| > 4 separates
        phases for rho0 = 1).
    rho0 : float
        Potential saturation density.
    psi_wall : float or None
        Virtual potential of solid voxels (wettability); None leaves
        solids force-neutral (psi read from the frozen solid state).

    Call: ``(f_0, f_1, bc_mask, missing_mask, omega, timestep) ->
    (f_0, f_1)`` -- the standard stepper signature.
    """

    def __init__(self, nse, G=-5.0, rho0=1.0, psi_wall=None):
        if nse.streaming_scheme != "pull":
            raise NotImplementedError("ShanChenMultiphaseStepper needs the pull streaming scheme")
        self._fused_nse = None
        if nse.compute_backend == ComputeBackend.PALLAS:
            from xlb_tpu.kernels.fused_step import build_fused_forced_step
            from xlb_tpu.utils.tiers import notify_fallback

            try:
                # per-voxel interaction force in-kernel, streamed as aux
                # channels (same path as the Boussinesq buoyancy)
                self._fused_nse = build_fused_forced_step(nse)
            except NotImplementedError as e:
                notify_fallback(f"Shan-Chen runs on the jnp tier: {e}")
        self.nse = nse
        self.G = float(G)
        self.rho0 = float(rho0)
        self.psi_wall = None if psi_wall is None else float(psi_wall)
        # wettability anchors: interior solids (255) plus any bounce-back
        # wall BC voxels (the masker tags them with their BC ids, not 255)
        from xlb_tpu.boundary.bc_bounce_back import FullwayBounceBackBC, HalfwayBounceBackBC

        self._wall_ids = [255] + [
            bc.id for bc in nse.boundary_conditions if isinstance(bc, (FullwayBounceBackBC, HalfwayBounceBackBC))
        ]

    # ------------------------------------------------------------------
    def psi(self, rho):
        """Bounded Shan-Chen potential psi = rho0 (1 - exp(-rho/rho0))."""
        r0 = jnp.asarray(self.rho0, rho.dtype)
        return r0 * (1.0 - jnp.exp(-rho / r0))

    def pressure(self, rho):
        """Equation of state p = cs^2 rho + (cs^2 G / 2) psi^2."""
        cs2 = jnp.asarray(self.nse.velocity_set.cs2, rho.dtype)
        return cs2 * rho + cs2 * jnp.asarray(0.5 * self.G, rho.dtype) * self.psi(rho) ** 2

    def interaction_du(self, rho, bc_mask=None):
        """Exact-difference velocity shift delta_u = F / rho, with
        F_a = -G psi sum_l w_l psi(x + c_l) c_{a,l}.  Neighbor sums are
        per-direction ``jnp.roll`` gathers (periodic wrap; walls override
        via ``psi_wall``) -- a handful of fused elementwise XLA passes."""
        vs = self.nse.velocity_set
        d, q = vs.d, vs.q
        c = np.asarray(vs._c)
        w = np.asarray(vs._w)
        psi0 = self.psi(rho)[0]
        if self.psi_wall is not None and bc_mask is not None:
            on_wall = bc_mask[0] == self._wall_ids[0]
            for wid in self._wall_ids[1:]:
                on_wall = jnp.logical_or(on_wall, bc_mask[0] == wid)
            psi0 = jnp.where(on_wall, jnp.asarray(self.psi_wall, psi0.dtype), psi0)
        S = [None] * d
        for l in range(q):
            cl = c[:, l]
            if not cl.any():
                continue
            nb = jnp.roll(psi0, shift=tuple(-int(cl[a]) for a in range(d)), axis=tuple(range(d)))
            for a in range(d):
                if cl[a]:
                    term = float(w[l] * cl[a]) * nb
                    S[a] = term if S[a] is None else S[a] + term
        G = jnp.asarray(self.G, psi0.dtype)
        rho_safe = jnp.maximum(rho[0], jnp.asarray(1e-8, psi0.dtype))
        return jnp.stack([-G * psi0 * S[a] / rho_safe for a in range(d)])

    # ------------------------------------------------------------------
    def __call__(self, f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        pp = self.nse.precision_policy
        f0c = pp.cast_to_compute(f_0)
        rho = jnp.sum(f0c, axis=0, keepdims=True)
        du = self.interaction_du(rho, bc_mask)
        if self._fused_nse is not None:
            return self._fused_nse(f_0, f_1, bc_mask, missing_mask, omega, du, timestep)
        return self.nse._step_pull(f_0, f_1, bc_mask, missing_mask, omega, timestep, force_field=du)

    def macroscopic(self, f, bc_mask=None):
        """(rho, u_true) from a stepper OUTPUT state.

        The stepper returns POST-collision populations whose bare momentum
        already carries the full exact-difference kick rho*delta_u; the
        physical (half-step-centered) velocity therefore subtracts half of
        it back: u_true = u_raw - delta_u / 2.  (Measured on a stationary
        G=-5 droplet: |u_raw| ~ 0.13 at the interface, |u_true| ~ 0.005 --
        the actual spurious-current level.)"""
        pp = self.nse.precision_policy
        rho, u = self.nse.macroscopic(pp.cast_to_compute(f))
        du = self.interaction_du(rho, bc_mask)
        return rho, u - 0.5 * du

    def build_multi_step(self, num_steps):
        """Jitted fori_loop window (one dispatch per window)."""

        @jax.jit
        def run(f_0, f_1, bc_mask, missing_mask, omega, start=0):
            def body(t, carry):
                a, b = carry
                a, b = self(a, b, bc_mask, missing_mask, omega, start + t)
                return (b, a)

            f_0, f_1 = jax.lax.fori_loop(0, num_steps, body, (f_0, f_1))
            return f_0, f_1

        return run
