"""Single-resolution incompressible Navier-Stokes stepper.

Parity surface with reference xlb/operator/stepper/nse_stepper.py:41-333:
``prepare_fields()`` builds (f_0, f_1, bc_mask, missing_mask) and the call
``stepper(f_0, f_1, bc_mask, missing_mask, omega, timestep) -> (f_0, f_1)``
advances one LBM step with the caller swapping buffers.

Two implementation tiers:

- JAX (default): the pure-jnp pull/push step below, left to XLA; under
  GSPMD sharding the rolls on sharded axes lower to collective-permutes.
- PALLAS: a fused collide-stream kernel (xlb_tpu/kernels, Pallas's Triton
  route) that makes one pass over device memory per step -- the analogue
  of the reference's fused Warp kernel (nse_stepper.py:427-466).

``stepper.active_tier`` names the tier that runs the hot loop: ``"jnp"`` or
the kernel's launch description (``interpret`` marks interpret mode).
"""

from functools import partial

import jax
import jax.numpy as jnp

from xlb_tpu.compute_backend import ComputeBackend
from xlb_tpu.default_config import DefaultConfig
from xlb_tpu.models.stepper import Stepper
from xlb_tpu.operator import Operator  # noqa: F401  (re-exported for parity)
from xlb_tpu.ops.stream import Stream
from xlb_tpu.ops.equilibrium import QuadraticEquilibrium
from xlb_tpu.ops.macroscopic import Macroscopic
from xlb_tpu.ops.collision import BGK, KBC, SmagorinskyLESBGK, TRT, MRT, PowerLawBGK, ForcedCollision
from xlb_tpu.boundary.base import ImplementationStep
from xlb_tpu.boundary.maskers import IndicesBoundaryMasker
from xlb_tpu.helper.check_boundary_overlaps import check_bc_overlaps
from xlb_tpu.helper.nse_fields import create_nse_fields
from xlb_tpu.helper.initializers import initialize_eq

_COLLISIONS = {"BGK": BGK, "KBC": KBC, "SmagorinskyLESBGK": SmagorinskyLESBGK, "TRT": TRT, "MRT": MRT, "PowerLawBGK": PowerLawBGK}


class IncompressibleNavierStokesStepper(Stepper):
    """Full LBM timestep: stream -> BCs -> macroscopic -> equilibrium ->
    collide -> BCs.

    Parameters
    ----------
    grid : Grid
    boundary_conditions : list of BoundaryCondition
    collision_type : {"BGK", "KBC", "SmagorinskyLESBGK", "TRT", "MRT", "PowerLawBGK"}
    streaming_scheme : {"pull", "push"}
    forcing_scheme : str
        Only "exact_difference" (used when ``force_vector`` is given).
    force_vector : array-like, optional
    """

    def __init__(
        self,
        grid,
        boundary_conditions=(),
        collision_type="BGK",
        streaming_scheme="pull",
        forcing_scheme="exact_difference",
        force_vector=None,
        backend_config=None,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
        collision_params=None,
    ):
        super().__init__(grid, boundary_conditions, velocity_set, precision_policy, compute_backend)
        self.backend_config = backend_config or {}
        self.collision_type = collision_type

        if collision_type not in _COLLISIONS:
            raise ValueError(f"unknown collision_type {collision_type!r}; choose from {sorted(_COLLISIONS)}")
        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy, compute_backend=self.compute_backend)
        # collision_params: extra ctor kwargs for the collision operator
        # (TRT magic, MRT bulk_rate/ghost_rate, Smagorinsky smagorinsky_coef);
        # threaded into the fused kernels via kernel_collision_spec
        self.collision = _COLLISIONS[collision_type](**common, **(collision_params or {}))
        if force_vector is not None:
            self.collision = ForcedCollision(self.collision, forcing_scheme=forcing_scheme, force_vector=force_vector)

        if streaming_scheme not in ("pull", "push"):
            raise ValueError(f"unknown streaming scheme {streaming_scheme!r}")
        self.streaming_scheme = streaming_scheme

        self.stream = Stream(**common)
        self.equilibrium = QuadraticEquilibrium(**common)
        self.macroscopic = Macroscopic(**common)

        self._pallas_step = None
        self.active_tier = "jnp"
        if self.compute_backend == ComputeBackend.PALLAS:
            from xlb_tpu.kernels.fused_step import build_fused_step

            self._pallas_step = build_fused_step(self)
            self.active_tier = self._pallas_step.active_tier

    # ------------------------------------------------------------------
    # Setup path (reference nse_stepper.py:99-225)
    # ------------------------------------------------------------------
    def prepare_fields(self, initializer=None):
        """Allocate fields, rasterize BCs into the masks, and initialize f.

        Returns (f_0, f_1, bc_mask, missing_mask)."""
        _, f_0, f_1, missing_mask, bc_mask = create_nse_fields(
            grid=self.grid, velocity_set=self.velocity_set, precision_policy=self.precision_policy
        )

        bc_mask, missing_mask = self._process_boundary_conditions(self.boundary_conditions, bc_mask, missing_mask)

        # static hint for the fused kernels: a domain with no solid-tagged
        # voxels skips the q-channel f_pre keep-out entirely (one scalar
        # device fetch at setup time)
        import jax.numpy as _jnp

        self.has_solids = bool(_jnp.any(bc_mask == 255))

        if initializer is not None:
            f_0 = initializer(bc_mask, f_0)
        else:
            f_0 = initialize_eq(f_0, self.grid, self.velocity_set, self.precision_policy)
        f_1 = f_1 + f_0  # f_1 starts as a copy of f_0 (zeros + f_0 keeps sharding)
        return f_0, f_1, bc_mask, missing_mask

    def _process_boundary_conditions(self, boundary_conditions, bc_mask, missing_mask):
        check_bc_overlaps(boundary_conditions, self.velocity_set.d)

        bc_with_indices = [bc for bc in boundary_conditions if bc.indices is not None]
        bc_with_mesh = [bc for bc in boundary_conditions if bc.mesh_vertices is not None and bc.indices is None]

        for bc in bc_with_mesh:
            # voxelize mesh-based BCs on the host, then feed the resulting
            # voxel indices through the shared indices path
            from xlb_tpu.geometry.mesh_masker import assign_mesh_indices

            assign_mesh_indices(bc, self.grid)
            if bc.needs_mesh_distance:
                bc.compute_mesh_distances()
            bc_with_indices.append(bc)

        if bc_with_indices:
            masker = IndicesBoundaryMasker(
                velocity_set=self.velocity_set,
                precision_policy=self.precision_policy,
                compute_backend=self.compute_backend,
                grid=self.grid,
            )
            bc_mask, missing_mask = masker(bc_with_indices, bc_mask, missing_mask)
        return bc_mask, missing_mask

    # ------------------------------------------------------------------
    # Hot loop (reference nse_stepper.py:237-333)
    # ------------------------------------------------------------------
    def __call__(self, f_0, f_1, bc_mask, missing_mask, omega, timestep=0):
        if self._pallas_step is not None:
            return self._pallas_step(f_0, f_1, bc_mask, missing_mask, omega, timestep)
        if self.streaming_scheme == "pull":
            return self._step_pull(f_0, f_1, bc_mask, missing_mask, omega, timestep)
        return self._step_push(f_0, f_1, bc_mask, missing_mask, omega, timestep)

    def _step_pull(self, f_0, f_1, bc_mask, missing_mask, omega, timestep, force_field=None):
        pp = self.precision_policy
        f_0c = pp.cast_to_compute(f_0)

        f_post_stream = self.stream(f_0c)
        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.STREAMING:
                f_post_stream = bc(f_0c, f_post_stream, bc_mask, missing_mask)

        rho, u = self.macroscopic(f_post_stream)
        feq = self.equilibrium(rho, u)
        f_post_collision = self.collision(f_post_stream, feq, omega)

        if force_field is not None:
            # per-voxel exact-difference forcing (the field generalization
            # of ops/force.py ExactDifference, same rho_0 = 1 convention):
            # used by the Boussinesq thermal coupling (models/ade.py)
            from xlb_tpu.ops.equilibrium import quadratic_equilibrium

            vs = self.velocity_set
            feq_shift = quadratic_equilibrium(rho, u + force_field.astype(u.dtype), vs._c, vs._w, u.dtype)
            f_post_collision = f_post_collision + (feq_shift - feq)

        for bc in self.boundary_conditions:
            f_post_collision = bc.assemble_auxiliary_data(f_post_stream, f_post_collision, bc_mask, missing_mask)
            if bc.implementation_step == ImplementationStep.COLLISION:
                f_post_collision = bc(f_post_stream, f_post_collision, bc_mask, missing_mask)

        # solid voxels (cell type 255, e.g. the interior of halfway-BB
        # geometry) keep their previous populations -- the reference Warp
        # early-out (nse_stepper.py:440-441); matches the fused kernels'
        # keep-out and prevents KBC NaNs at nearly-enclosed voxels
        f_post_collision = jnp.where(bc_mask == 255, f_0c, f_post_collision)

        return f_0, pp.cast_to_store(f_post_collision)

    def _step_push(self, f_0, f_1, bc_mask, missing_mask, omega, timestep):
        pp = self.precision_policy
        f_post_stream_prev = pp.cast_to_compute(f_0)

        rho, u = self.macroscopic(f_post_stream_prev)
        feq = self.equilibrium(rho, u)
        f_post_collision = self.collision(f_post_stream_prev, feq, omega)

        for bc in self.boundary_conditions:
            f_post_collision = bc.update_bc_auxiliary_data(f_post_stream_prev, f_post_collision, bc_mask, missing_mask)
            if bc.implementation_step == ImplementationStep.COLLISION:
                f_post_collision = bc(f_post_stream_prev, f_post_collision, bc_mask, missing_mask)

        # solid early-out (see _step_pull): solids neither collide nor move
        f_post_collision = jnp.where(bc_mask == 255, f_post_stream_prev, f_post_collision)

        from xlb_tpu.ops.stream import stream_push

        f_post_stream = stream_push(f_post_collision, self.velocity_set._c)
        for bc in self.boundary_conditions:
            if bc.implementation_step == ImplementationStep.STREAMING:
                f_post_stream = bc(f_post_collision, f_post_stream, bc_mask, missing_mask)

        return pp.cast_to_store(f_post_collision), pp.cast_to_store(f_post_stream)

    # ------------------------------------------------------------------
    def build_jitted_step(self, donate=True):
        """A jitted single step with buffer donation: the returned callable
        has signature (f_0, f_1, bc_mask, missing_mask, omega, timestep)."""

        def _step(f_0, f_1, bc_mask, missing_mask, omega, timestep):
            new_f0, new_f1 = self(f_0, f_1, bc_mask, missing_mask, omega, timestep)
            return new_f1, new_f0  # swapped: next step's (f_0, f_1)

        donate_argnums = (0, 1) if donate else ()
        return jax.jit(_step, donate_argnums=donate_argnums)

    def build_multi_step(self, num_steps, donate=True):
        """A jitted ``num_steps``-step advance using ``lax.fori_loop`` --
        ONE dispatch for the whole window.

        Always prefer this over per-step Python dispatch for the hot loop:
        a single device round trip per window instead of per step.  The
        returned callable has signature
        ``(f_0, f_1, bc_mask, missing_mask, omega, start_step=0)`` and
        returns the post-window ``(f_0, f_1)`` in standard orientation
        (f_0 = current state).
        """

        if self.compute_backend == ComputeBackend.PALLAS:
            # fused-kernel window; 16-bit storage policies automatically use
            # deviation-form (shifted) populations between steps
            from xlb_tpu.kernels.fused_step import build_fused_window

            window = build_fused_window(self, num_steps)
            self.active_tier = window.active_tier

            def _run_fused(f_0, f_1, bc_mask, missing_mask, omega, start_step=0):
                return window(f_0, f_1, bc_mask, missing_mask, omega)

            _run_fused.active_tier = window.active_tier
            _run_fused.interpret = window.interpret
            return _run_fused

        @partial(jax.jit, static_argnames=(), donate_argnums=(0, 1) if donate else ())
        def _run(f_0, f_1, bc_mask, missing_mask, omega, start_step=0):
            def body(i, carry):
                f_0, f_1 = carry
                f_0, f_1 = self(f_0, f_1, bc_mask, missing_mask, omega, start_step + i)
                return (f_1, f_0)

            f_0, f_1 = jax.lax.fori_loop(0, num_steps, body, (f_0, f_1))
            return f_0, f_1

        return _run
