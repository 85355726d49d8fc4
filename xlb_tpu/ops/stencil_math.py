"""Exact small-stencil contractions.

LBM moment/projection contractions have tiny static coefficient matrices
whose entries are mostly -1/0/+1 (lattice directions and their products).
Lowering them to ``jnp.tensordot`` would (a) route a 19-wide contraction
through a matrix unit at its default reduced precision (TF32 on NVIDIA
GPUs) and (b) block fusion with the surrounding elementwise math.
Unrolling them into adds/subtracts keeps full compute precision and lets
XLA fuse them with the collide step.
"""

import numpy as np
import jax.numpy as jnp


def stencil_contract(coeffs, f):
    """Contract ``coeffs (k, q)`` (static NumPy) with ``f (q, *spatial)``.

    Returns ``(k, *spatial)`` = sum_l coeffs[k, l] * f[l], with +-1 entries
    turned into adds/subtracts and zeros skipped.
    """
    coeffs = np.asarray(coeffs)
    k, q = coeffs.shape
    assert f.shape[0] == q, f"stencil mismatch: coeffs q={q}, field q={f.shape[0]}"
    outs = []
    for row in coeffs:
        acc = None
        for l in range(q):
            cl = row[l]
            if cl == 0:
                continue
            if cl == 1:
                term = f[l]
            elif cl == -1:
                term = -f[l]
            else:
                term = f[l] * f.dtype.type(cl)
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else jnp.zeros_like(f[0]))
    return jnp.stack(outs)
