"""Moment operators: density, momentum, and momentum flux.

Parity with reference xlb/operator/macroscopic/{zero,first,second}_moment.py
and macroscopic.py.  The reference's Warp kernels use Neumaier-compensated
summation for f16 storage (zero_moment.py:22-40); here all reductions happen
in the compute dtype (f32 by default) after the stepper upcasts, which meets
the same accuracy bar without scalar loops.
"""

import numpy as np
import jax.numpy as jnp

from xlb_tpu.operator import Operator
from xlb_tpu.ops.stencil_math import stencil_contract


def density(f):
    """Zeroth moment: rho = sum_l f_l, shape (1, *spatial)."""
    return jnp.sum(f, axis=0, keepdims=True)


def velocity(f, rho, c, compute_dtype=None):
    """First moment: u = (sum_l c_l f_l) / rho, shape (d, *spatial)."""
    return stencil_contract(np.asarray(c), f) / rho


def momentum_flux(fneq, cc, compute_dtype=None):
    """Second moment Pi = sum_l cc_l fneq_l.

    ``cc`` is the (q, d*(d+1)//2) upper-triangular second-moment basis; the
    result packs the symmetric tensor as (xx, xy, [xz,] yy, [yz, zz]).
    """
    return stencil_contract(np.asarray(cc).T, fneq)


class ZeroMoment(Operator):
    def __call__(self, f):
        return density(f)


class FirstMoment(Operator):
    def __call__(self, f, rho):
        return velocity(f, rho, self.velocity_set._c, self.compute_dtype)


class SecondMoment(Operator):
    def __call__(self, fneq):
        return momentum_flux(fneq, self.velocity_set._cc, self.compute_dtype)


class Macroscopic(Operator):
    """Fused (rho, u) readout (reference macroscopic.py:21-26)."""

    def __call__(self, f, rho=None, u=None):
        rho = density(f)
        u = velocity(f, rho, self.velocity_set._c, self.compute_dtype)
        return rho, u
