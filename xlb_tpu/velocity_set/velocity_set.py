"""Lattice velocity sets (DdQq stencils) and their derived constants.

Parity surface with reference xlb/velocity_set/velocity_set.py:20-265: every
derived quantity is computed once in NumPy with vectorized
code and exposed both as NumPy (for setup-time/masker code) and as jnp arrays
(traced into XLA computations as constants).
"""

import math

import numpy as np
import jax.numpy as jnp


class VelocitySet:
    """A DdQq lattice stencil.

    Parameters
    ----------
    d : int
        Spatial dimension (2 or 3).
    q : int
        Number of lattice directions.
    c : array-like, shape (d, q), int
        Direction vectors (columns).
    w : array-like, shape (q,), float
        Quadrature weights.

    Derived constants (reference velocity_set.py:63-128, 139-253):

    - ``opp_indices``: index of the opposite direction for each direction.
    - ``cc``: second-moment basis, shape (q, d*(d+1)//2), the upper-triangular
      entries of c_a c_b per direction.
    - ``qi``: cc - cs^2 I with off-diagonal entries doubled (used by the
      Latt-Chopard regularized BC).
    - ``main/right/left`` index sets and the rest-velocity ``center_index``.
    """

    def __init__(self, d, q, c, w, precision_policy=None, compute_backend=None):
        # precision_policy / compute_backend are accepted for API parity with
        # the reference ctor signature; constants are stored dtype-neutral and
        # cast at trace time by the operators.
        self.d = int(d)
        self.q = int(q)
        self.precision_policy = precision_policy
        self.compute_backend = compute_backend

        c = np.asarray(c, dtype=np.int32)
        assert c.shape == (self.d, self.q), f"c must have shape (d, q), got {c.shape}"
        w = np.asarray(w, dtype=np.float64)
        assert w.shape == (self.q,)
        assert abs(w.sum() - 1.0) < 1e-12, "weights must sum to 1"

        # -- NumPy-side constants ------------------------------------------
        self._c = c
        self._w = w
        self._c_float = c.astype(np.float64)
        self._opp_indices = self._derive_opposites(c)
        self._cc = self._derive_second_moment_basis(c)
        self._qi = self._derive_qi(self._cc)

        self.cs = math.sqrt(3.0) / 3.0
        self.cs2 = 1.0 / 3.0
        self.inv_cs2 = 3.0

        abs_sum = np.abs(c).sum(axis=0)
        self.main_indices = np.nonzero(abs_sum == 1)[0]
        self.right_indices = np.nonzero(c[0] == 1)[0]
        self.left_indices = np.nonzero(c[0] == -1)[0]
        self.center_index = int(np.nonzero(abs_sum == 0)[0][0])

        # -- jnp-side constants (weak dtype; cast happens in operators) -----
        self.c = jnp.asarray(self._c, dtype=jnp.int32)
        self.w = jnp.asarray(self._w, dtype=jnp.float32)
        self.opp_indices = jnp.asarray(self._opp_indices, dtype=jnp.int32)
        self.cc = jnp.asarray(self._cc, dtype=jnp.float32)
        self.c_float = jnp.asarray(self._c_float, dtype=jnp.float32)
        self.qi = jnp.asarray(self._qi, dtype=jnp.float32)

    @staticmethod
    def _derive_opposites(c):
        # direction i's opposite is the unique j with c[:, j] == -c[:, i]
        eq = (c[:, :, None] == -c[:, None, :]).all(axis=0)  # (q, q)
        opp = np.argmax(eq, axis=1)
        assert (eq[np.arange(c.shape[1]), opp]).all(), "stencil is not symmetric"
        return opp.astype(np.int32)

    def _derive_second_moment_basis(self, c):
        pairs = [(a, b) for a in range(self.d) for b in range(a, self.d)]
        cc = np.stack([c[a].astype(np.float64) * c[b] for a, b in pairs], axis=1)
        return cc  # (q, d*(d+1)//2)

    def _derive_qi(self, cc):
        qi = cc.copy()
        if self.d == 3:
            diagonal, offdiagonal = (0, 3, 5), (1, 2, 4)
        elif self.d == 2:
            diagonal, offdiagonal = (0, 2), (1,)
        else:
            raise ValueError(f"unsupported dimension {self.d}")
        qi[:, diagonal] -= 1.0 / 3.0
        # off-diagonal entries counted twice in the symmetric contraction
        qi[:, offdiagonal] *= 2.0
        return qi

    # ---------------------------------------------------------------------
    @property
    def diagonal_moment_indices(self):
        return (0, 3, 5) if self.d == 3 else (0, 2)

    @property
    def offdiagonal_moment_indices(self):
        return (1, 2, 4) if self.d == 3 else (1,)

    def __repr__(self):
        return f"D{self.d}Q{self.q}"

    __str__ = __repr__
