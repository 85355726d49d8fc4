"""Boundary-condition base class.

Parity surface with reference xlb/operator/boundary_condition/
boundary_condition.py:33-180.  A BC is applied inside the step as a masked
select: voxels whose ``bc_mask`` equals the BC's id get the BC-specific
populations, all others pass through.  This maps directly onto the VPU
(vectorized ``jnp.where``), which is why the same scheme also works inside
the fused Pallas kernel.

Design difference vs the reference: prescribed values (density, velocity,
profiles) are kept as explicit arrays/closures on the BC object instead of
being encoded into unused slots of the ``f_1`` buffer
(helper_functions_bc.py:371-501).  Here the fused kernel reads a separate
aux side array instead, so BCs stay decoupled from the buffer layout.
"""

from enum import Enum, auto

import numpy as np
import jax.numpy as jnp

from xlb_tpu.operator import Operator
from xlb_tpu.boundary.registry import boundary_condition_registry


class ImplementationStep(Enum):
    """Algorithmic stage at which a BC executes (reference
    boundary_condition.py:26-30)."""

    COLLISION = auto()
    STREAMING = auto()


class BoundaryCondition(Operator):
    """Abstract base for all LBM boundary conditions.

    Parameters
    ----------
    implementation_step : ImplementationStep
    indices : array-like (d, n), optional
        Explicit voxel indices this BC claims.
    mesh_vertices : array-like (n, 3), optional
        Triangle soup for geometry-based BCs (voxelized at setup).
    voxelization_method : optional
        Strategy used by the mesh masker when ``mesh_vertices`` is given.
    """

    def __init__(
        self,
        implementation_step: ImplementationStep,
        velocity_set=None,
        precision_policy=None,
        compute_backend=None,
        indices=None,
        mesh_vertices=None,
        voxelization_method=None,
    ):
        self.id = boundary_condition_registry.register_boundary_condition(f"{type(self).__name__}_{id(self)}")
        super().__init__(velocity_set, precision_policy, compute_backend)

        self.indices = indices
        self.mesh_vertices = mesh_vertices
        self.voxelization_method = voxelization_method
        self.implementation_step = implementation_step

        # capability flags (reference boundary_condition.py:82-99)
        self.needs_padding = False          # dilate indices to find missing dirs for interior geometry
        self.needs_mesh_distance = False    # fractional wall distance from voxelizer
        self.needs_aux_init = False         # kept for parity; aux data lives on the BC object here
        self.is_initialized_with_aux_data = False
        self.num_of_aux_data = 0
        self.needs_aux_recovery = False

    # ------------------------------------------------------------------
    def boundary_map(self, bc_mask):
        """(1, *spatial) boolean: voxels claimed by this BC."""
        return bc_mask == self.id

    def boundary_map_q(self, bc_mask):
        """(q, *spatial) boolean: claimed voxels broadcast over directions."""
        return jnp.broadcast_to(bc_mask == self.id, (self.velocity_set.q,) + bc_mask.shape[1:])

    def pad_indices(self):
        """Dilate this BC's indices by one stencil hop in every direction
        (reference boundary_condition.py:123-136), used by the masker to
        discover missing directions of interior geometry."""
        bc_indices = np.asarray(self.indices)
        if not self.needs_padding:
            return bc_indices
        c = self.velocity_set._c  # (d, q)
        dilated = bc_indices[:, :, None] + c[:, None, :]
        return np.unique(dilated.reshape(self.velocity_set.d, -1), axis=1)

    # ------------------------------------------------------------------
    def assemble_auxiliary_data(self, f_pre, f_post, bc_mask, missing_mask):
        """Post-collision hook for BCs that stage data for the next step
        (reference boundary_condition.py:109-121); identity by default."""
        return f_post

    def update_bc_auxiliary_data(self, f_pre, f_post, bc_mask, missing_mask):
        """Push-scheme variant of the aux hook; identity by default."""
        return f_post

    def __call__(self, f_pre, f_post, bc_mask, missing_mask):
        raise NotImplementedError
