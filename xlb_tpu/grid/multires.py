"""Multi-resolution grid: nested dense cuboid levels with factor-2 refinement.

Dense replacement for the reference's Neon mGrid
(xlb/grid/multires_grid.py:41-224).  Neon stores sparse per-level voxel sets
with explode/coalesce intrinsics; here each level is a dense rectangular
array (the reference's levels are nested cuboids anyway -- utils/mesher.py
``make_cuboid_mesh``), and inter-level transfers are precomputed gathers /
reshape-averages (see xlb_tpu/models/multires.py).

Level convention follows the reference: level 0 is the FINEST; each level
l+1 is coarser by a factor of 2.  Every finer level occupies a box of the
next-coarser level, specified as (origin, extent) in coarser-level cells;
its own shape is 2 * extent.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np

from xlb_tpu.grid.grid import Grid
from xlb_tpu.default_config import DefaultConfig
from xlb_tpu.precision_policy import Precision


class MultiresLevel:
    """One resolution level: a dense grid plus its placement in the parent."""

    def __init__(self, shape, origin_in_parent=None, extent_in_parent=None):
        self.shape = tuple(int(s) for s in shape)
        self.dim = len(self.shape)
        # placement of THIS level's box inside the next-coarser level
        self.origin_in_parent = tuple(int(o) for o in origin_in_parent) if origin_in_parent is not None else None
        self.extent_in_parent = tuple(int(e) for e in extent_in_parent) if extent_in_parent is not None else None

    def create_field(self, cardinality, dtype=None, fill_value=None):
        import jax.numpy as jnp

        if dtype is None:
            dtype = DefaultConfig.default_precision_policy.store_precision
        jdtype = dtype.jax_dtype if isinstance(dtype, Precision) else dtype
        full = (int(cardinality),) + self.shape
        if fill_value is not None:
            return jnp.full(full, fill_value, dtype=jdtype)
        return jnp.zeros(full, dtype=jdtype)


class MultiresGrid:
    """Nested levels, finest first.

    Parameters
    ----------
    coarsest_shape : tuple
        Cell extents of the coarsest (outermost) level, which spans the
        whole domain.
    boxes : list of (origin, extent)
        One entry per finer level, outermost-first: the box the next-finer
        level occupies, in the cells of the level it refines.  ``len(boxes)
        + 1`` is the total number of levels.
    """

    def __init__(self, coarsest_shape: Tuple[int, ...], boxes: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]] = ()):
        dim = len(coarsest_shape)
        levels_coarse_first: List[MultiresLevel] = [MultiresLevel(coarsest_shape)]
        for origin, extent in boxes:
            origin = tuple(int(o) for o in origin)
            extent = tuple(int(e) for e in extent)
            parent = levels_coarse_first[-1]
            for o, e, s in zip(origin, extent, parent.shape):
                if o < 0 or o + e > s:
                    raise ValueError(f"refinement box ({origin}, {extent}) exceeds parent shape {parent.shape}")
            fine_shape = tuple(2 * e for e in extent)
            levels_coarse_first.append(MultiresLevel(fine_shape, origin, extent))
        # reference convention: level 0 = finest
        self.levels = list(reversed(levels_coarse_first))
        self.num_levels = len(self.levels)
        self.dim = dim

    @property
    def count_levels(self):
        return self.num_levels

    def level_to_shape(self, level):
        """Shape of a level (parity with reference multires_grid.py:142-149)."""
        return self.levels[level].shape

    def level_origin_spacing(self, level):
        """(origin, spacing) of a level's voxel grid in coarsest-level
        (global) units: global = origin + index * spacing."""
        idx = self.num_levels - 1
        origin = np.zeros(self.dim, dtype=np.float64)
        spacing = 1.0
        while idx > level:
            child = self.levels[idx - 1]
            origin = origin + np.asarray(child.origin_in_parent, dtype=np.float64) * spacing
            spacing = spacing / 2.0
            idx -= 1
        return origin, spacing

    def finest_equivalent_cells(self):
        """Total cell count if the whole domain were at finest resolution."""
        coarsest = self.levels[-1]
        return int(np.prod(coarsest.shape)) * (2 ** self.dim) ** (self.num_levels - 1)

    def active_cells(self):
        """Cells actually simulated: each level's cells minus refined boxes."""
        total = 0
        for i, lvl in enumerate(self.levels):
            n = int(np.prod(lvl.shape))
            if i > 0:
                child = self.levels[i - 1]
                n -= int(np.prod(child.extent_in_parent))
            total += n
        return total
