"""Multi-resolution incompressible Navier-Stokes stepper.

Dense counterpart of the reference's Neon-only
MultiresIncompressibleNavierStokesStepper (nse_multires_stepper.py:102-1193)
and MultiresSimulationManager (helper/simulation_manager.py:16-245).

Algorithm (collide-then-stream with acoustic scaling; reference
simulation_manager.py:137-170):

    advance(level L):                       # L counts from finest=0
        collide(L)
        explode ghosts of level L-1 from level L post-collision state
        advance(L-1); advance(L-1)          # two fine sub-steps per coarse
        coalesce level L-1 -> refined cells of L (2^d child average)
        stream(L) + BCs

Level coupling on dense arrays:

- *Explosion* (coarse -> fine ghost ring): piecewise-constant upsampling of
  the coarse post-collision populations into a one-cell ghost ring around
  the fine box, realized as a precomputed static gather.  Matches the
  reference's direct coarser-neighbor reads (wp.neon_lbm_read_coarser_ngh,
  nse_multires_stepper.py:540-582) which are also zeroth-order in space and
  piecewise-constant in time.
- *Coalescence* (fine -> coarse): the refined coarse cells take the
  2^d-child average of the fine populations -- a reshape-mean, the dense
  equivalent of the reference's accumulate-and-normalize with precomputed
  per-direction counts (simulation_manager.py:74).

Per-level relaxation follows the reference's acoustic scaling exactly
(simulation_manager.py:86-105)::

    omega_L = 2^(L+1) * omega_0 / ((2^L - 1) * omega_0 + 2)
"""

import numpy as np
import jax
import jax.numpy as jnp

from xlb_tpu.operator import Operator
from xlb_tpu.ops.stream import stream_pull
from xlb_tpu.ops.equilibrium import QuadraticEquilibrium
from xlb_tpu.ops.macroscopic import Macroscopic
from xlb_tpu.ops.collision import BGK, KBC, SmagorinskyLESBGK
from xlb_tpu.boundary.base import ImplementationStep
from xlb_tpu.boundary.maskers import IndicesBoundaryMasker
from xlb_tpu.helper.initializers import initialize_eq

_COLLISIONS = {"BGK": BGK, "KBC": KBC, "SmagorinskyLESBGK": SmagorinskyLESBGK}


def compute_omega(omega_finest, level):
    """Relaxation rate at ``level`` from the finest-level omega (acoustic
    scaling; reference simulation_manager.py:86-105)."""
    w0 = omega_finest
    return 2.0 ** (level + 1) * w0 / ((2.0**level - 1.0) * w0 + 2.0)


class MultiresIncompressibleNavierStokesStepper(Operator):
    """Dense multi-level LBM stepper on the jnp tier.

    Parameters
    ----------
    grid : MultiresGrid
    boundary_conditions : dict level -> list of BCs (or list, applied to the
        coarsest level only -- where domain walls live).
    collision_type : str
    mres_perf_opt : MresPerfOptimizationType, optional
        Only ``NAIVE_COLLIDE_STREAM`` (the default): every level runs the
        jnp tier, left to XLA.  Under a device mesh, shard the per-level
        fields' x/y axes and GSPMD partitions the step.
    """

    def __init__(
        self,
        grid,
        boundary_conditions=None,
        collision_type="BGK",
        mres_perf_opt=None,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
    ):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.grid = grid
        self.collision_type = collision_type
        common = dict(velocity_set=self.velocity_set, precision_policy=self.precision_policy, compute_backend=self.compute_backend)
        self.collision = _COLLISIONS[collision_type](**common)
        self.equilibrium = QuadraticEquilibrium(**common)
        self.macroscopic = Macroscopic(**common)

        if boundary_conditions is None:
            boundary_conditions = {}
        if isinstance(boundary_conditions, (list, tuple)):
            boundary_conditions = {grid.num_levels - 1: list(boundary_conditions)}
        self.boundary_conditions = {int(k): list(v) for k, v in boundary_conditions.items()}

        self._ghost_gather = [None] * grid.num_levels  # per fine level: indices into parent
        for l, lvl in enumerate(grid.levels):
            if lvl.origin_in_parent is not None:
                self._ghost_gather[l] = self._build_ghost_gather(l)

        from xlb_tpu.mres_perf_optimization_type import MresPerfOptimizationType

        if mres_perf_opt is None:
            mres_perf_opt = MresPerfOptimizationType.NAIVE_COLLIDE_STREAM
        if mres_perf_opt != MresPerfOptimizationType.NAIVE_COLLIDE_STREAM:
            raise ValueError(
                f"{mres_perf_opt} selected the fused multires Pallas kernels, which were removed; "
                "multires runs its jnp tier on every level: use "
                "MresPerfOptimizationType.NAIVE_COLLIDE_STREAM (the default)"
            )
        self.mres_perf_opt = mres_perf_opt
        self.active_tier = "jnp"

    # ------------------------------------------------------------------
    def _build_ghost_gather(self, level):
        """Static index maps: every cell of the fine level's one-cell
        ring-extended box -> the parent-level cell containing it."""
        lvl = self.grid.levels[level]
        parent_shape = self.grid.levels[level + 1].shape
        maps = []
        for d in range(self.grid.dim):
            fine_coords = np.arange(-1, lvl.shape[d] + 1)  # extended fine indices
            parent_idx = lvl.origin_in_parent[d] + np.floor((fine_coords + 0.5) / 2.0).astype(np.int64)
            parent_idx = np.clip(parent_idx, 0, parent_shape[d] - 1)
            maps.append(parent_idx)
        return maps

    # ------------------------------------------------------------------
    def prepare_fields(self):
        """Per-level (f_0, f_1, bc_mask, missing_mask) lists, finest first."""
        fs0, fs1, bms, mms = [], [], [], []
        vs = self.velocity_set
        for l, lvl in enumerate(self.grid.levels):
            f0 = lvl.create_field(vs.q, dtype=self.precision_policy.store_precision)
            bc_mask = lvl.create_field(1, dtype=jnp.uint8)
            missing = lvl.create_field(vs.q, dtype=jnp.bool_)
            bcs = self.boundary_conditions.get(l, [])
            for bc in bcs:
                # per-level mesh attachment: voxelize in the level's own
                # cell coordinates (reference multires maskers run the
                # same queries per level, multires_aabb.py etc.)
                if bc.mesh_vertices is not None and bc.indices is None:
                    from xlb_tpu.geometry.mesh_masker import assign_mesh_indices

                    origin, spacing = self.grid.level_origin_spacing(l)
                    assign_mesh_indices(bc, lvl, spacing=spacing, origin=tuple(origin))
                    if bc.needs_mesh_distance:
                        bc.compute_mesh_distances()
            if bcs:
                masker = IndicesBoundaryMasker(vs, self.precision_policy, self.compute_backend)
                bc_mask, missing = masker(bcs, bc_mask, missing)
            feq0 = self.equilibrium(
                jnp.ones((1,) + lvl.shape, dtype=self.precision_policy.compute_dtype),
                jnp.zeros((vs.d,) + lvl.shape, dtype=self.precision_policy.compute_dtype),
            ).astype(self.precision_policy.store_dtype)
            fs0.append(feq0)
            fs1.append(feq0)
            bms.append(bc_mask)
            mms.append(missing)
        return fs0, fs1, bms, mms

    # ------------------------------------------------------------------
    def _collide(self, f, omega):
        rho, u = self.macroscopic(f)
        feq = self.equilibrium(rho, u)
        return self.collision(f, feq, omega)

    def _collide_with_bcs(self, level, f, bm, mm, omega):
        """Collision phase of one sub-step, collision-step BCs included."""
        f_pc = self._collide(f, omega)
        return self._apply_bcs(ImplementationStep.COLLISION, level, f, f_pc, bm, mm)

    def _stream_with_ghosts(self, f_post_collision, ghost_ext, level):
        """Pull-stream a fine level using a ghost-extended array."""
        interior = (slice(None),) + (slice(1, -1),) * self.grid.dim
        ext = ghost_ext.at[interior].set(f_post_collision)
        streamed = stream_pull(ext, self.velocity_set._c)
        return streamed[interior]

    def _explode(self, f_coarse, level):
        """Gather the parent's populations onto the fine level's extended box
        (piecewise-constant upsampling) as a separable per-axis take."""
        out = f_coarse
        for axis, g in enumerate(self._ghost_gather[level]):
            out = jnp.take(out, jnp.asarray(g), axis=axis + 1)
        return out

    def _coalesce_avg(self, f_fine, level_fine):
        """The 2^d-child average of a fine level's populations: pairwise
        strided adds on the leading spatial axes, then a reshape-sum on the
        last one."""
        d = self.grid.dim
        shape = self.grid.levels[level_fine].shape
        avg = f_fine
        for a in range(d - 1):
            s0 = [slice(None)] * (d + 1)
            s1 = [slice(None)] * (d + 1)
            s0[a + 1] = slice(0, None, 2)
            s1[a + 1] = slice(1, None, 2)
            avg = avg[tuple(s0)] + avg[tuple(s1)]
        new_shape = avg.shape[:-1] + (shape[d - 1] // 2, 2)
        return avg.reshape(new_shape).sum(axis=-1) * self.precision_policy.compute_dtype(0.5**d)

    def _coalesce(self, f_coarse, f_fine, level_fine):
        """Average 2^d fine children into the refined coarse cells."""
        lvl = self.grid.levels[level_fine]
        avg = self._coalesce_avg(f_fine, level_fine)
        box = (slice(None),) + tuple(slice(o, o + e) for o, e in zip(lvl.origin_in_parent, avg.shape[1:]))
        return f_coarse.at[box].set(avg.astype(f_coarse.dtype))

    def _apply_bcs(self, step, level, f_pre, f_post, bc_mask, missing_mask):
        for bc in self.boundary_conditions.get(level, []):
            if step == ImplementationStep.COLLISION:
                # post-collision aux staging (e.g. ExtrapolationOutflowBC
                # writes extrapolated populations into outgoing slots);
                # f_pre here is the pre-collision = previous post-stream
                # state, matching the NSE stepper's call (models/nse.py)
                f_post = bc.assemble_auxiliary_data(f_pre, f_post, bc_mask, missing_mask)
            if bc.implementation_step == step:
                f_post = bc(f_pre, f_post, bc_mask, missing_mask)
        return f_post

    # ------------------------------------------------------------------
    def _freeze_solids(self, level, f_before, f_after, bms):
        """Solid early-out (reference Warp nse_stepper.py:440-441; matches
        the fused kernels): voxels tagged 255 end the sub-step unchanged."""
        bcs = self.boundary_conditions.get(level, [])
        if not bcs:
            return f_after
        return jnp.where(bms[level] == 255, f_before, f_after)


    def _substep(self, level, fs, bms, mms, omega_finest, ghost_ext, probe):
        """One timestep of ``level``: collide, run the finer level's two
        sub-steps against this post-collision state and coalesce them back,
        then stream (through the parent's ghost ring when ``ghost_ext`` is
        given, periodically otherwise) and apply the streaming BCs."""
        pp = self.precision_policy
        omega = pp.compute_dtype(compute_omega(omega_finest, level))
        f = pp.cast_to_compute(fs[level])
        f_pc = self._collide_with_bcs(level, f, bms[level], mms[level], omega)
        f_pc = self._freeze_solids(level, f, f_pc, bms)
        if level > 0:
            child = level - 1
            ghost_child = self._explode(f_pc, child)
            for _ in range(2):
                fs = self._substep(child, fs, bms, mms, omega_finest, ghost_child, probe)
            f_pc = self._coalesce(f_pc, pp.cast_to_compute(fs[child]), child)
        if ghost_ext is None:
            f_ps = stream_pull(f_pc, self.velocity_set._c)
        else:
            f_ps = self._stream_with_ghosts(f_pc, ghost_ext, level)
        f_ps = self._apply_bcs(ImplementationStep.STREAMING, level, f_pc, f_ps, bms[level], mms[level])
        f_ps = self._freeze_solids(level, f, f_ps, bms)
        if probe is not None:
            probe(level, f_ps, f_pc)
        fs = list(fs)
        fs[level] = pp.cast_to_store(f_ps)
        return fs

    def _advance(self, level, fs, bms, mms, omega_finest, probe=None):
        """Advance ``level`` by one of its own timesteps (recursively running
        2 sub-steps of each finer level).  ``fs`` is the per-level state list
        (current populations).  ``probe``, if given, is called as
        ``probe(level, f_post_stream, f_post_collision)`` after each
        sub-step (used by step_with_force)."""
        return self._substep(level, fs, bms, mms, omega_finest, None, probe)

    def __call__(self, fs, bms, mms, omega_finest):
        """One coarsest-level timestep (= 2^(L-1) finest steps).  Returns the
        updated per-level population list."""
        return self._advance(self.grid.num_levels - 1, list(fs), bms, mms, omega_finest)

    def build_window(self, num_coarse_steps, donate=True, differentiable=False):
        """A jitted ``num_coarse_steps``-coarse-step advance -- ONE dispatch.
        Signature: ``run(fs, bms, mms, omega_finest) -> fs``.

        ``differentiable=True`` runs the steps as a per-coarse-step
        checkpointed ``lax.scan`` (a ``fori_loop`` would not
        reverse-differentiate)."""
        L = self.grid.num_levels
        if differentiable:

            def run_scan(fs, bms, mms, omega):
                body = jax.checkpoint(lambda s, _: (tuple(self._advance(L - 1, list(s), bms, mms, omega)), None))
                out, _ = jax.lax.scan(body, tuple(fs), None, length=num_coarse_steps)
                return list(out)

            return jax.jit(run_scan)

        def run_plain(fs, bms, mms, omega_finest):
            return jax.lax.fori_loop(
                0,
                num_coarse_steps,
                lambda i, s: self._advance(L - 1, list(s), bms, mms, omega_finest),
                list(fs),
            )

        return jax.jit(run_plain, donate_argnums=(0,) if donate else ())

    def step_with_force(self, fs, bms, mms, omega_finest, momentum_transfer):
        """One coarsest-level timestep that also integrates the momentum-
        exchange force at ``momentum_transfer.level`` (the reference's
        MultiresMomentumTransfer capability, multires_momentum_transfer.py:
        17-139).  Returns ``(fs, force)`` with the force sampled at that
        level's final sub-step of this coarse step, in the level's lattice
        units."""
        lvl = momentum_transfer.level
        out = {}

        def probe(level, f_ps, f_pc):
            if level == lvl:
                out["force"] = momentum_transfer.from_states(f_ps, f_pc, bms[level], mms[level])

        fs = self._advance(self.grid.num_levels - 1, list(fs), bms, mms, omega_finest, probe)
        if "force" not in out:
            raise ValueError(f"momentum_transfer.level={lvl} outside this grid's {self.grid.num_levels} levels")
        return fs, out["force"]
