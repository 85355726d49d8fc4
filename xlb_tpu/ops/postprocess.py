"""Post-processing operators: Q-criterion, vorticity, grid->point sampling.

Parity surface with reference xlb/operator/postprocess/{q_criterion,
vorticity,grid_to_point}.py -- which are Warp-only there (q_criterion.py:
139-143 raises on JAX).  Here they are pure-jnp, so they run anywhere, compose
under jit, shard under GSPMD, and differentiate.

Derivatives use 2nd-order central differences with periodic wrap (matching
the roll-based streaming convention); boundary values are one-sided only in
the sense that callers typically ignore the outermost shell.
"""

import jax.numpy as jnp

from xlb_tpu.operator import Operator


def _central_diff(field, axis):
    """d(field)/dx_axis by central differences with periodic wrap."""
    return 0.5 * (jnp.roll(field, -1, axis=axis) - jnp.roll(field, 1, axis=axis))


def velocity_gradient(u):
    """grad[i][j] = du_i/dx_j for u of shape (d, *spatial)."""
    d = u.shape[0]
    return [[_central_diff(u[i], axis=j) for j in range(d)] for i in range(d)]


def vorticity(u):
    """curl(u): (1, *s) scalar in 2D, (3, *s) vector in 3D."""
    g = velocity_gradient(u)
    d = u.shape[0]
    if d == 2:
        return (g[1][0] - g[0][1])[None, ...]
    wx = g[2][1] - g[1][2]
    wy = g[0][2] - g[2][0]
    wz = g[1][0] - g[0][1]
    return jnp.stack([wx, wy, wz])


def vorticity_magnitude(u):
    w = vorticity(u)
    return jnp.sqrt(jnp.sum(w * w, axis=0, keepdims=True))


def q_criterion(u):
    """Q = (||Omega||^2 - ||S||^2) / 2 from the velocity-gradient tensor."""
    g = velocity_gradient(u)
    d = u.shape[0]
    norm_sym = 0.0
    norm_asym = 0.0
    for i in range(d):
        for j in range(d):
            s = 0.5 * (g[i][j] + g[j][i])
            o = 0.5 * (g[i][j] - g[j][i])
            norm_sym = norm_sym + s * s
            norm_asym = norm_asym + o * o
    return (0.5 * (norm_asym - norm_sym))[None, ...]


def grid_to_point(field, points):
    """Sample a (c, *spatial) grid field at continuous ``points`` (n, d)
    with multilinear interpolation (reference grid_to_point.py, Warp-only
    there).  Out-of-range points clamp to the domain."""
    c = field.shape[0]
    spatial = field.shape[1:]
    d = len(spatial)
    pts = jnp.asarray(points, dtype=field.dtype)
    assert pts.shape[1] == d

    lo = jnp.floor(pts).astype(jnp.int32)
    frac = pts - lo.astype(pts.dtype)

    out = 0.0
    for corner in range(2**d):
        offs = [(corner >> a) & 1 for a in range(d)]
        idx = [jnp.clip(lo[:, a] + offs[a], 0, spatial[a] - 1) for a in range(d)]
        weight = 1.0
        for a in range(d):
            weight = weight * (frac[:, a] if offs[a] else (1.0 - frac[:, a]))
        vals = field[(slice(None),) + tuple(idx)]  # (c, n)
        out = out + vals * weight[None, :]
    return out


class QCriterion(Operator):
    """Returns (norm_mu = |grad u| magnitude proxy omitted; q) per reference API."""

    def __call__(self, u):
        return q_criterion(u)


class Vorticity(Operator):
    def __call__(self, u):
        return vorticity(u), vorticity_magnitude(u)


class GridToPoint(Operator):
    def __call__(self, field, points):
        return grid_to_point(field, points)
