"""Body forcing and boundary-force readout operators.

- :class:`ExactDifference`: Kupershtokh exact-difference body force
  (reference xlb/operator/force/exact_difference_force.py).
- :class:`MomentumTransfer`: momentum-exchange drag/lift integration on a
  no-slip boundary (reference xlb/operator/force/momentum_transfer.py),
  implemented as a masked tensordot + global reduction -- no atomics.
"""

from enum import Enum, auto

import jax.numpy as jnp

from xlb_tpu.operator import Operator
from xlb_tpu.ops.equilibrium import quadratic_equilibrium
from xlb_tpu.ops.stream import stream_pull


class LBMOperationSequence(Enum):
    """Order of stream/collide in the producing stepper (reference
    momentum_transfer.py:16-25)."""

    STREAM_THEN_COLLIDE = auto()
    COLLIDE_THEN_STREAM = auto()


class ExactDifference(Operator):
    """Kupershtokh (2004) exact-difference forcing:

        f_out += feq(rho, u + F/rho_0) - feq(rho, u)

    applied post-collision (reference exact_difference_force.py:14-76).
    """

    def __init__(self, force_vector, velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.force_vector = jnp.asarray(force_vector)
        assert self.force_vector.shape == (self.velocity_set.d,), "force vector must have one entry per spatial dim"

    def __call__(self, f_postcollision, feq, rho, u):
        delta_u = self.force_vector.astype(u.dtype).reshape((-1,) + (1,) * (u.ndim - 1))
        vs = self.velocity_set
        feq_force = quadratic_equilibrium(rho, u + delta_u, vs._c, vs._w, self.compute_dtype)
        return f_postcollision + (feq_force - feq)


class FetchPopulations(Operator):
    """Recover (post-collision, post-stream) population pairs from the stored
    state (reference momentum_transfer.py:28-119).

    With the standard stream-then-collide stepper, f_0 holds post-collision
    values; the post-stream state is reconstructed by streaming once and
    re-applying the no-slip BC.
    """

    def __init__(
        self,
        no_slip_bc_instance,
        operation_sequence=LBMOperationSequence.STREAM_THEN_COLLIDE,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
    ):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.no_slip_bc_instance = no_slip_bc_instance
        self.operation_sequence = operation_sequence

    def __call__(self, f_0, f_1, bc_mask, missing_mask):
        if self.operation_sequence == LBMOperationSequence.STREAM_THEN_COLLIDE:
            f_post_collision = f_0
            f_post_stream = stream_pull(f_0, self.velocity_set._c)
            f_post_stream = self.no_slip_bc_instance(f_post_collision, f_post_stream, bc_mask, missing_mask)
            return f_post_collision, f_post_stream
        # collide-then-stream steppers already hold both states
        return f_1, f_0


class MomentumTransfer(Operator):
    """Drag/lift via the momentum-exchange method (Ladd 1994; Mei et al 2002;
    Caiazzo & Junk 2008), parity with reference momentum_transfer.py:180-212.

    Sums c_opp * (f_postcollision[opp] + f_poststream) over the missing
    directions of fluid-side boundary voxels; returns the net force vector.
    """

    def __init__(
        self,
        no_slip_bc_instance,
        operation_sequence=LBMOperationSequence.STREAM_THEN_COLLIDE,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
    ):
        super().__init__(velocity_set, precision_policy, compute_backend)
        self.no_slip_bc_instance = no_slip_bc_instance
        self.operation_sequence = operation_sequence
        self.fetcher = FetchPopulations(
            no_slip_bc_instance,
            operation_sequence,
            velocity_set=self.velocity_set,
            precision_policy=self.precision_policy,
            compute_backend=self.compute_backend,
        )

    def __call__(self, f_0, f_1, bc_mask, missing_mask):
        vs = self.velocity_set
        f_post_collision, f_post_stream = self.fetcher(f_0, f_1, bc_mask, missing_mask)

        boundary = (bc_mask == self.no_slip_bc_instance.id)[0]
        # fluid-side edge voxels: tagged, but their rest direction is present
        is_edge = jnp.logical_and(boundary[None, ...], ~missing_mask[0][None, ...])

        opp = vs._opp_indices
        phi = f_post_collision[opp] + f_post_stream
        phi = jnp.where(jnp.logical_and(missing_mask, is_edge), phi, 0.0)
        from xlb_tpu.ops.stencil_math import stencil_contract

        force = stencil_contract(vs._c[:, opp], phi)
        return jnp.sum(force, axis=tuple(range(1, force.ndim)))


class MultiresMomentumTransfer(MomentumTransfer):
    """Momentum-exchange force on a multi-resolution grid (reference
    force/multires_momentum_transfer.py:17-139).

    The no-slip boundary voxels must all live at a single level and away
    from level-transition regions (the reference asserts the same); the
    force is integrated on that level's post-collision / post-stream pair,
    which the multires stepper retains when stepping via
    ``step_with_force``.  The returned force is in the BC level's lattice
    units (acoustic scaling keeps velocities level-invariant, so drag
    coefficients normalize with that level's cell size).
    """

    def __init__(self, no_slip_bc_instance, level=0, velocity_set=None, precision_policy=None, compute_backend=None):
        super().__init__(
            no_slip_bc_instance,
            LBMOperationSequence.COLLIDE_THEN_STREAM,
            velocity_set=velocity_set,
            precision_policy=precision_policy,
            compute_backend=compute_backend,
        )
        self.level = int(level)

    def from_states(self, f_post_stream, f_post_collision, bc_mask, missing_mask):
        """Force from explicitly supplied level states (the COLLIDE_THEN_
        STREAM fetcher maps (f_0, f_1) -> (f_1, f_0), hence the order)."""
        return super().__call__(f_post_stream, f_post_collision, bc_mask, missing_mask)
