"""Adjoint optimization through the LBM solver
(reference examples/out_of_core/autodiff_lbm.py, which needed hand-rolled
checkpointed adjoints over OOC tiles).

Here the whole rollout is differentiable by construction: optimize the
initial velocity field so the flow after N steps matches a target vortex,
using jax.grad + optax, with jax.checkpoint rematerializing the rollout to
bound memory (the analogue of the reference's checkpoint_frequency
re-simulation).
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script

import argparse

import numpy as np
import jax
import jax.numpy as jnp

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D2Q9
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.ops import Macroscopic
from xlb_tpu.ops.equilibrium import quadratic_equilibrium


def run(n=32, num_steps=20, iters=30, lr=0.3, segment=5):
    xlb.init(velocity_set=D2Q9(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    grid = grid_factory((n, n))
    vs = xlb.DefaultConfig.velocity_set
    stepper = IncompressibleNavierStokesStepper(grid)  # periodic box
    _, _, bc_mask, missing_mask = stepper.prepare_fields()
    mac = Macroscopic()
    omega = 1.3

    # target: a Taylor-Green vortex observed after num_steps
    x = (np.arange(n) + 0.5) / n * 2 * np.pi
    X, Y = np.meshgrid(x, x, indexing="ij")
    u_target0 = 0.01 * np.stack([np.cos(X) * np.sin(Y), -np.sin(X) * np.cos(Y)]).astype(np.float32)

    def rollout(u0):
        rho = jnp.ones((1, n, n), dtype=jnp.float32)
        f = quadratic_equilibrium(rho, u0, vs._c, vs._w, jnp.float32)

        @jax.checkpoint  # segment-wise rematerialization bounds adjoint memory
        def segment_steps(f):
            def body(i, carry):
                a, b = carry
                a, b = stepper(a, b, bc_mask, missing_mask, omega, i)
                return (b, a)

            a, _ = jax.lax.fori_loop(0, segment, body, (f, f))
            return a

        for _ in range(num_steps // segment):
            f = segment_steps(f)
        _, u = mac(f)
        return u

    u_target = rollout(jnp.asarray(u_target0))

    @jax.jit
    def loss_fn(u0):
        u = rollout(u0)
        return jnp.mean((u - u_target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn))

    import optax

    opt = optax.adam(lr * 1e-2)
    u0 = jnp.zeros((2, n, n), dtype=jnp.float32)
    state = opt.init(u0)
    l0 = float(loss_fn(u0))
    for it in range(iters):
        g = grad_fn(u0)
        updates, state = opt.update(g, state)
        u0 = optax.apply_updates(u0, updates)
    l1 = float(loss_fn(u0))
    err = float(jnp.abs(u0 - jnp.asarray(u_target0)).max())
    print(f"adjoint optimization: loss {l0:.3e} -> {l1:.3e} ({l0 / max(l1, 1e-30):.0f}x), "
          f"max |u0 - truth| = {err:.2e}")
    return l0, l1


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args()
    run(iters=args.iters)
