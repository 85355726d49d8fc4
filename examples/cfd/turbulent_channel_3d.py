"""3D turbulent channel flow driven by a body force
(reference examples/cfd/turbulent_channel_3d.py).

D3Q27 KBC + exact-difference forcing; halfway bounce-back walls in z,
periodic in x/y.  ``run()`` is the quick demo; ``run_validation()`` runs a
Re_tau = 180 channel to statistical steadiness, accumulates the mean
streamwise profile in-jit (sampled every few steps inside the fused
window), and compares u+(y+) against the MKM DNS dataset
(examples/cfd/data/turbulent_channel_dns_data.json, Moser-Kim-Mansour
1999) exactly as the reference does (turbulent_channel_3d.py:21-36).

The full run (domain (192, 96, 64), dz+ = 5.6, 240k steps; see
tests/test_channel_dns.py) has not been measured on the GPU yet.
"""

import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[2]))  # allow running as a script


import argparse
import json
import pathlib

import numpy as np
import jax
import jax.numpy as jnp

import xlb_tpu as xlb
from xlb_tpu.velocity_set import D3Q27
from xlb_tpu.grid import grid_factory
from xlb_tpu.models import IncompressibleNavierStokesStepper
from xlb_tpu.boundary import HalfwayBounceBackBC
from xlb_tpu.ops import Macroscopic
from xlb_tpu.helper.initializers import initialize_from_macroscopic

DATA = pathlib.Path(__file__).resolve().parent / "data" / "turbulent_channel_dns_data.json"


def get_dns_data():
    """MKM Re_tau=180 DNS means (reference turbulent_channel_3d.py:27-36)."""
    with open(DATA) as fh:
        return json.load(fh)


def vonkarman_loglaw(yplus):
    return np.log(np.maximum(yplus, 1e-12)) / 0.41 + 5.5


def compare_to_dns(mean_profile, u_tau, visc, lo_yplus=10.0, hi_yplus=180.0):
    """Mean relative deviation of the computed u+(y+) from the DNS profile
    over [lo_yplus, hi_yplus] (profile symmetrized over both channel
    halves; DNS u+ interpolated to the simulation's y+ stations)."""
    dns = get_dns_data()
    nz = len(mean_profile)
    half = 0.5 * (mean_profile[: nz // 2] + mean_profile[::-1][: nz // 2])
    z = np.arange(nz // 2) + 0.5  # wall-normal cell centers (halfway wall at z=-0.5... z=0 face)
    yplus = z * u_tau / visc
    uplus = half / u_tau
    dns_uplus = np.interp(yplus, np.asarray(dns["y+"]), np.asarray(dns["Umean"]))
    sel = (yplus >= lo_yplus) & (yplus <= hi_yplus)
    if not sel.any():
        raise ValueError(f"no resolved stations in y+ range [{lo_yplus}, {hi_yplus}]")
    rel = np.abs(uplus[sel] - dns_uplus[sel]) / np.maximum(dns_uplus[sel], 1e-12)
    return float(rel.mean()), yplus, uplus, dns_uplus


def _build_channel(nx, ny, nz, re_tau, u_tau, seed):
    grid = grid_factory((nx, ny, nz))
    vs = xlb.DefaultConfig.velocity_set
    h = nz / 2.0
    visc = u_tau * h / re_tau
    omega = 1.0 / (3.0 * visc + 0.5)
    force_x = u_tau**2 / h

    box = grid.bounding_box_indices()
    walls = np.unique(np.concatenate([np.asarray(box[k]) for k in ("bottom", "top")], axis=1), axis=1)
    stepper = IncompressibleNavierStokesStepper(
        grid,
        boundary_conditions=[HalfwayBounceBackBC(indices=walls.tolist())],
        collision_type="KBC",
        force_vector=np.array([force_x, 0.0, 0.0]),
    )
    f_0, f_1, bc_mask, missing_mask = stepper.prepare_fields()

    rng = np.random.default_rng(seed)
    z = (np.arange(nz) + 0.5) / nz
    u_profile = 10 * u_tau * (1 - (2 * z - 1) ** 2)
    u0 = np.zeros((3, nx, ny, nz), dtype=np.float32)
    u0[0] = u_profile[None, None, :]
    u0 += (0.05 * 10 * u_tau * rng.standard_normal(u0.shape)).astype(np.float32)
    # coherent finite-amplitude trigger: white noise alone decays before it
    # can trip transition (observed: the flow stays laminar, accelerates
    # toward u_max = u_tau*Re_tau/2 under the fixed forcing, and blows up).
    # Streamwise-varying spanwise/wall-normal rolls at ~10% of the profile
    # amplitude are the standard bypass-transition seed.
    X = (np.arange(nx) + 0.5) / nx
    Y = (np.arange(ny) + 0.5) / ny
    amp = 0.1 * 10 * u_tau
    envelope = np.sin(np.pi * z)[None, None, :]  # vanishes at both walls
    u0[1] += amp * np.sin(4 * np.pi * X)[:, None, None] * envelope
    u0[2] += amp * np.sin(2 * np.pi * X)[:, None, None] * np.cos(6 * np.pi * Y)[None, :, None] * envelope
    rho0 = np.ones((1, nx, ny, nz), dtype=np.float32)
    f_0 = initialize_from_macroscopic(grid, vs, xlb.DefaultConfig.default_precision_policy, rho0, u0)
    return stepper, (f_0, f_1, bc_mask, missing_mask), omega, visc


def run(nx=64, ny=32, nz=32, re_tau=60.0, u_tau=0.002, num_steps=1000, seed=0):
    xlb.init(velocity_set=D3Q27(), default_backend=xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    stepper, (f_0, f_1, bc_mask, missing_mask), omega, visc = _build_channel(nx, ny, nz, re_tau, u_tau, seed)
    run_window = stepper.build_multi_step(num_steps, donate=False)
    f_0, f_1 = run_window(f_0, f_1, bc_mask, missing_mask, omega)

    rho, u = Macroscopic()(f_0)
    u = np.asarray(u)
    mean_profile = u[0].mean(axis=(0, 1))
    print(f"channel Re_tau={re_tau}: bulk u={u[0].mean():.5f}, centerline={mean_profile[nz // 2]:.5f}, "
          f"wall-adjacent={mean_profile[0]:.5f}, finite={np.isfinite(u).all()}")
    return mean_profile


def run_validation(nx=192, ny=96, nz=64, re_tau=180.0, u_tau=0.009, dev_steps=160000,
                   avg_steps=80000, sample_every=8, seed=0, backend="pallas"):
    # u_tau sets omega = 1/(3 u_tau h / Re_tau + 0.5) AND the Mach number
    # (u_max ~ 18 u_tau).  0.009 gives omega 1.9809 / Ma ~ 0.16: measured
    # stability floor for KBC at dz+ = 5.6 through transition -- 0.004
    # (omega 1.9967) and 0.006 (1.9873) both went NaN when the coherent
    # trigger tripped turbulence; the entropic stabilizer needs the extra
    # dissipation at this wall resolution.
    """Full DNS validation: develop the turbulence, then time-average the
    streamwise profile in-jit and compare u+(y+) to MKM.  Returns the mean
    relative deviation over y+ in [10, 180]."""
    xlb.init(velocity_set=D3Q27(),
             default_backend=xlb.ComputeBackend.PALLAS if backend == "pallas" else xlb.ComputeBackend.JAX,
             default_precision_policy=xlb.PrecisionPolicy.FP32FP32)
    stepper, (f_0, f_1, bc_mask, missing_mask), omega, visc = _build_channel(nx, ny, nz, re_tau, u_tau, seed)
    mac = Macroscopic()
    print(f"validation channel: ({nx},{ny},{nz}) Re_tau={re_tau}, omega={omega:.5f}, "
          f"dz+={re_tau / (nz / 2):.2f}, {dev_steps}+{avg_steps} steps")

    # development phase: plain fused windows
    window = stepper.build_multi_step(20000, donate=False)
    for s in range(0, dev_steps, 20000):
        f_0, f_1 = window(f_0, f_1, bc_mask, missing_mask, omega)
        rho, u = mac(f_0)
        bulk = float(u[0].mean())
        print(f"  dev {s + 20000}: bulk u={bulk:.5f} finite={bool(jnp.isfinite(u).all())}", flush=True)
        if not np.isfinite(bulk):
            raise FloatingPointError(f"channel blew up during development at step {s + 20000}")

    # averaging phase: sample the x/y-averaged profile every few steps
    step1 = stepper.build_multi_step(sample_every, donate=False)

    @jax.jit
    def sample_window(f_0, f_1, acc, n):
        def body(_, carry):
            f_0, f_1, acc = carry
            f_0, f_1 = step1(f_0, f_1, bc_mask, missing_mask, omega)
            _, u = mac(f_0)
            return f_0, f_1, acc + u[0].mean(axis=(0, 1))

        f_0, f_1, acc = jax.lax.fori_loop(0, n, body, (f_0, f_1, acc))
        return f_0, f_1, acc

    # one dispatch per <=2000 samples (16000 steps), with a finiteness
    # check between chunks
    n_samples = avg_steps // sample_every
    chunk = min(n_samples, 2000)
    acc = jnp.zeros((nz,), jnp.float32)
    done = 0
    while done < n_samples:
        k = min(chunk, n_samples - done)
        f_0, f_1, acc = sample_window(f_0, f_1, acc, k)
        probe = float(acc[nz // 2])
        if not np.isfinite(probe):
            raise FloatingPointError(f"channel blew up during averaging at sample {done + k}")
        done += k
    mean_profile = np.asarray(acc) / n_samples

    dev, yplus, uplus, dns_uplus = compare_to_dns(mean_profile, u_tau, visc)
    print(f"u+(y+) vs MKM DNS: mean relative deviation {dev:.1%} over y+ in [10, 180]")
    for i in range(0, len(yplus), max(1, len(yplus) // 10)):
        print(f"  y+={yplus[i]:7.1f}  u+={uplus[i]:6.2f}  DNS={dns_uplus[i]:6.2f}")
    return dev


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--validate", action="store_true")
    args = p.parse_args()
    if args.validate:
        run_validation()
    else:
        run(num_steps=args.steps)
