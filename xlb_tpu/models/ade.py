"""Advection-diffusion (ADE) stepper and Boussinesq-coupled thermal flow.

The reference declares ``PhysicsType.ADE`` but ships no solver
(xlb/physics_type.py:6-8); this module supplies one: a
scalar field phi carried by a second distribution set g on the SAME
velocity set, advected by a prescribed (or NSE-coupled) velocity field
with the standard linear equilibrium geq_l = w_l phi (1 + 3 c_l . u).
Diffusivity maps to the scalar relaxation rate as D = (1/omega_phi -
1/2)/3 (same Chapman-Enskog form as the NSE viscosity).

Boundary conditions reuse the NSE machinery unchanged:

- Dirichlet phi = const  ->  ``EquilibriumBC(rho=phi_wall, u=(0, ...))``
  (at zero velocity the quadratic feq reduces exactly to w_l phi_wall);
- zero-flux (adiabatic)  ->  ``HalfwayBounceBackBC`` / fullway (pure
  reflection conserves the scalar).

``ThermalNSEStepper`` couples an NSE stepper to the scalar via the
Boussinesq approximation: per-voxel buoyancy F = -beta (phi - phi_ref) g
applied by exact-difference forcing inside the NSE collide, with u from
the NSE macroscopics advecting phi.  Everything is pure jnp -- it jits,
shards under GSPMD, and differentiates like the rest of the jnp tier.
"""

import jax
import jax.numpy as jnp
import numpy as np

from xlb_tpu.boundary.base import ImplementationStep
from xlb_tpu.models.stepper import Stepper
from xlb_tpu.ops.stream import Stream
from xlb_tpu.ops.equilibrium import LinearEquilibrium
from xlb_tpu.ops.macroscopic import density


def omega_from_diffusivity(diffusivity):
    """omega_phi for a target lattice diffusivity D = (1/omega - 1/2)/3."""
    return 1.0 / (3.0 * float(diffusivity) + 0.5)


def diffusivity_from_omega(omega):
    return (1.0 / float(omega) - 0.5) / 3.0


class AdvectionDiffusionStepper(Stepper):
    """Scalar-transport LBM step: stream -> BCs -> phi moment -> linear
    equilibrium -> BGK relax -> BCs.

    Call signature: ``(g_0, g_1, bc_mask, missing_mask, omega_phi, u,
    timestep=0) -> (g_0, g_1)`` -- the caller swaps buffers, exactly like
    the NSE stepper, with the advecting velocity ``u`` (d, *spatial) as an
    extra argument.
    """

    def __init__(self, grid, boundary_conditions=(), velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(grid, boundary_conditions, velocity_set, precision_policy, compute_backend)
        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy, compute_backend=self.compute_backend)
        self.stream = Stream(**common)
        self.equilibrium = LinearEquilibrium(**common)

        self._pallas_step = None
        from xlb_tpu.compute_backend import ComputeBackend

        if self.compute_backend == ComputeBackend.PALLAS:
            from xlb_tpu.kernels.fused_step import build_fused_ade_step

            self._pallas_step = build_fused_ade_step(self)

    def prepare_fields(self, phi_init=None):
        """Allocate (g_0, g_1, bc_mask, missing_mask); ``phi_init`` is an
        optional (1, *shape) or (*shape) initial scalar field (default 0)."""
        from xlb_tpu.helper.nse_fields import create_nse_fields

        _, g_0, g_1, missing_mask, bc_mask = create_nse_fields(
            grid=self.grid, velocity_set=self.velocity_set, precision_policy=self.precision_policy
        )
        bc_mask, missing_mask = self._process_boundary_conditions(self.boundary_conditions, bc_mask, missing_mask)

        vs = self.velocity_set
        shape = tuple(self.grid.shape)
        if phi_init is None:
            phi = jnp.zeros((1,) + shape, dtype=self.precision_policy.compute_dtype)
        else:
            phi = jnp.asarray(phi_init, dtype=self.precision_policy.compute_dtype).reshape((1,) + shape)
        w = np.asarray(vs._w, dtype=np.dtype(self.precision_policy.store_dtype)).reshape((-1,) + (1,) * len(shape))
        g_0 = (phi * w).astype(self.precision_policy.store_dtype)
        g_1 = g_1 + g_0
        return g_0, g_1, bc_mask, missing_mask

    def _process_boundary_conditions(self, boundary_conditions, bc_mask, missing_mask):
        from xlb_tpu.boundary.maskers import IndicesBoundaryMasker
        from xlb_tpu.helper.check_boundary_overlaps import check_bc_overlaps

        check_bc_overlaps(boundary_conditions, self.velocity_set.d)
        bcs = [bc for bc in boundary_conditions if bc.indices is not None]
        if bcs:
            masker = IndicesBoundaryMasker(
                velocity_set=self.velocity_set,
                precision_policy=self.precision_policy,
                compute_backend=self.compute_backend,
                grid=self.grid,
            )
            bc_mask, missing_mask = masker(bcs, bc_mask, missing_mask)
        return bc_mask, missing_mask

    def phi(self, g):
        """Zeroth moment: the transported scalar (1, *spatial)."""
        return density(self.precision_policy.cast_to_compute(g))

    def __call__(self, g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep=0):
        if self._pallas_step is not None:
            return self._pallas_step(g_0, g_1, bc_mask, missing_mask, omega_phi, u, timestep)
        pp = self.precision_policy
        g_0c = pp.cast_to_compute(g_0)

        g_post_stream = self.stream(g_0c)
        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.STREAMING:
                g_post_stream = bc(g_0c, g_post_stream, bc_mask, missing_mask)

        phi = density(g_post_stream)
        geq = self.equilibrium(phi, u.astype(g_post_stream.dtype))
        g_post = g_post_stream - omega_phi * (g_post_stream - geq)

        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.COLLISION:
                g_post = bc(g_post_stream, g_post, bc_mask, missing_mask)

        # solid early-out: 255-tagged voxels (deep interior of a curved
        # obstacle) neither stream nor relax -- matches the NSE jnp tier
        # and the fused kernels' keep-out
        if self.boundary_conditions:
            g_post = jnp.where(bc_mask == 255, g_0c, g_post)

        return g_0, pp.cast_to_store(g_post)


class ThermalNSEStepper:
    """Boussinesq-coupled NSE + ADE: buoyancy F = -beta (phi - phi_ref) g_vec
    drives the flow; the flow advects the scalar.

    ``nse`` and ``ade`` are independently configured steppers on the same
    grid/velocity set (their BC lists may differ: no-slip walls for f,
    Dirichlet/adiabatic walls for g).  One coupled step:

        rho, u   <- f                  (NSE macroscopics)
        f        <- NSE step with exact-difference buoyancy(phi)
        g        <- ADE step advected by u

    Call: ``(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega,
    omega_phi, timestep) -> (f_0, f_1, g_0, g_1)``.
    """

    def __init__(self, nse, ade, beta=1e-3, gravity=None, phi_ref=0.0):
        from xlb_tpu.compute_backend import ComputeBackend

        if nse.streaming_scheme != "pull":
            raise NotImplementedError("ThermalNSEStepper needs the pull streaming scheme")
        self._fused_nse = None
        if nse.compute_backend == ComputeBackend.PALLAS:
            # per-voxel buoyancy in-kernel: the force field streams in as
            # aux channels (kernels/fused_step.build_fused_forced_step)
            from xlb_tpu.kernels.fused_step import build_fused_forced_step

            self._fused_nse = build_fused_forced_step(nse)
        self.nse = nse
        self.ade = ade
        self.beta = float(beta)
        d = nse.velocity_set.d
        self.gravity = np.asarray(gravity if gravity is not None else (0.0,) * (d - 1) + (-1.0,), dtype=np.float64)
        assert self.gravity.shape == (d,)
        self.phi_ref = float(phi_ref)

    def __call__(self, f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, timestep=0):
        nse, ade = self.nse, self.ade

        # scalar field BEFORE the step drives this step's buoyancy
        phi = ade.phi(g_0)
        grav = jnp.asarray(self.gravity, dtype=phi.dtype).reshape((-1,) + (1,) * (phi.ndim - 1))
        force = -self.beta * (phi - self.phi_ref) * grav

        # NSE step via the stepper's own pull path + force_field hook
        if self._fused_nse is not None:
            f_0, f_1 = self._fused_nse(f_0, f_1, bc_f, miss_f, omega, force, timestep)
        else:
            f_0, f_1 = nse._step_pull(f_0, f_1, bc_f, miss_f, omega, timestep, force_field=force)

        # ADE step advected by the post-stream velocity of the UPDATED f
        _, u = nse.macroscopic(nse.precision_policy.cast_to_compute(f_1))
        g_0, g_1 = ade(g_0, g_1, bc_g, miss_g, omega_phi, u, timestep)
        return f_0, f_1, g_0, g_1

    def build_multi_step(self, num_steps):
        """Jitted fori_loop window over coupled steps (one dispatch)."""

        @jax.jit
        def run(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, start=0):
            def body(t, carry):
                f_0, f_1, g_0, g_1 = carry
                f_0, f_1, g_0, g_1 = self(f_0, f_1, g_0, g_1, bc_f, miss_f, bc_g, miss_g, omega, omega_phi, start + t)
                return (f_1, f_0, g_1, g_0)

            f_0, f_1, g_0, g_1 = jax.lax.fori_loop(0, num_steps, body, (f_0, f_1, g_0, g_1))
            return f_0, f_1, g_0, g_1

        return run
