"""Smoke matrix: every example runs tiny on the CPU mesh and reports
physical output (the counterpart of reference tests/install/
flow_past_sphere_3d_test.py:1-60)."""

import numpy as np
import pytest

import importlib.util
import pathlib
import sys

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(relpath):
    path = EXAMPLES / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[path.stem] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _reset():
    from xlb_tpu.default_config import DefaultConfig
    from xlb_tpu.boundary.registry import boundary_condition_registry

    DefaultConfig.reset()
    boundary_condition_registry.reset()


def test_lid_driven_cavity_2d():
    u = _load("cfd/lid_driven_cavity_2d.py").run(n=32, num_steps=100)
    assert np.isfinite(u).all() and np.abs(u).max() <= 0.06


def test_flow_past_sphere_3d():
    u = _load("cfd/flow_past_sphere_3d.py").run(nx=32, nyz=16, num_steps=60)
    assert np.isfinite(u).all()


def test_insitu_render_3d(tmp_path):
    surf, vol = _load("cfd/insitu_render_3d.py").run(
        nx=32, nyz=16, num_steps=60, frames=1, image=48, outdir=str(tmp_path)
    )
    assert surf.shape == (48, 48, 3) and np.isfinite(surf).all()
    assert np.isfinite(vol).all() and vol.max() > 0.0
    assert (tmp_path / "qcrit_000.png").exists()


def test_windtunnel_3d():
    drags = _load("cfd/windtunnel_3d.py").run(nx=32, nyz=16, num_steps=60, print_every=30)
    assert len(drags) == 2 and all(np.isfinite(d) for d in drags)


def test_windtunnel_3d_hybrid_object():
    drags = _load("cfd/windtunnel_3d.py").run(nx=32, nyz=16, num_steps=60, print_every=30, object_bc="hybrid")
    assert len(drags) == 2 and all(np.isfinite(d) for d in drags)


def test_turbulent_channel_3d():
    profile = _load("cfd/turbulent_channel_3d.py").run(nx=16, ny=8, nz=16, num_steps=60)
    assert np.isfinite(profile).all()
    # wall-adjacent slower than centerline
    assert profile[len(profile) // 2] > profile[0]


def test_taylor_green_vortex_3d():
    ke, expected = _load("cfd/taylor_green_vortex_3d.py").run(n=16, num_steps=50)
    assert 0.5 < ke / expected < 2.0


def test_rotating_sphere_3d():
    asym = _load("cfd/rotating_sphere_3d.py").run(nx=32, nyz=16, num_steps=60)
    assert np.isfinite(asym)


def test_rotating_sphere_3d_pallas():
    """Spatial moving-wall profile through the fused (PALLAS) tier."""
    asym = _load("cfd/rotating_sphere_3d.py").run(nx=32, nyz=16, num_steps=60, backend="pallas")
    assert np.isfinite(asym)


def test_flow_past_cylinder_2d_pallas():
    """Regularized in/out BCs through the fused 2D (PALLAS) tier."""
    drags, uy = _load("cfd/flow_past_cylinder_2d.py").run(
        nx=96, ny=32, re=50.0, num_steps=400, probe_every=200, backend="pallas"
    )
    assert all(np.isfinite(d) for d in drags)


def test_flow_past_cylinder_2d():
    drags, uy = _load("cfd/flow_past_cylinder_2d.py").run(nx=96, ny=32, re=50.0, num_steps=400, probe_every=200)
    assert np.isfinite(drags).all() and np.isfinite(uy).all()


def test_airfoil_ibm():
    # needs ~a third of a convective time for the starting vortex to shed
    # and lift to turn positive
    cd, cl = _load("ibm/airfoil_ibm.py").run(nx=40, ny=16, nz=24, num_steps=120)
    assert np.isfinite(cd) and np.isfinite(cl)
    # positive angle of attack must produce positive lift and positive drag
    assert cl > 0 and cd > 0


def test_wind_turbine_ibm():
    torque, thrust = _load("ibm/wind_turbine_ibm.py").run(nx=40, nyz=24, num_steps=40, window=20)
    assert all(np.isfinite(t) for t in torque) and all(np.isfinite(t) for t in thrust)
    # the incoming flow must push on the rotor (positive axial thrust)
    assert thrust[-1] > 0


def test_ooc_cavity():
    u = _load("ooc_cavity.py").run(n=32, num_tiles=4, steps=8, steps_per_sweep=2)
    assert np.isfinite(u).all() and np.abs(u).max() <= 0.05


def test_windtunnel_ibm():
    # the impulsive-start transient needs ~150 steps before drag turns positive
    cd = _load("ibm/windtunnel_ibm.py").run(nx=40, nyz=20, num_steps=150)
    assert np.isfinite(cd) and cd > 0


def test_multires_windtunnel_3d():
    drags = _load("cfd/multires_windtunnel_3d.py").run(nx=24, nyz=16, coarse_steps=20, print_every=0)
    assert len(drags) == 20 and np.isfinite(drags).all()
    # momentum exchange must register positive drag once the flow arrives
    assert drags[-1] > 0


def test_channel_3d_distributed():
    mlups = _load("cfd/channel_3d_distributed.py").run(cells_per_device_x=8, ny=16, nz=16, num_steps=30)
    assert mlups > 0


def test_autodiff_lbm():
    l0, l1 = _load("cfd/autodiff_lbm.py").run(n=16, num_steps=10, iters=10, segment=5)
    assert l1 < l0


def test_multiphase_droplet_laplace():
    """Shan-Chen droplet sweep: Laplace law dp = sigma/R holds across
    radii (beyond-reference capability)."""
    sigma, resid, results = _load("cfd/multiphase_droplet_2d.py").run(
        n=64, radii=(9.0, 13.0), num_steps=600
    )
    assert sigma > 0.0 and resid < 0.1
    for _, dp, umax, rmin, rmax in results:
        assert dp > 0.0 and umax < 0.05 and rmax > 1.5 and rmin < 0.35


def test_multires_flow_past_sphere_distributed():
    """Multires on the (4,2) virtual mesh through the example surface:
    every level sharded over (x, y), GSPMD partitions the jnp tier."""
    umax = _load("cfd/multires_flow_past_sphere_3d_distributed.py").run(
        coarse=(32, 16, 16), num_coarse_steps=10, mesh_shape=(4, 2)
    )
    assert np.isfinite(umax)


def test_multires_flow_past_sphere():
    u_f, u_c = _load("cfd/multires_flow_past_sphere_3d.py").run(coarse_n=(32, 16, 16), coarse_steps=15)
    assert np.isfinite(u_f).all() and np.isfinite(u_c).all()


def test_ibm_flow_past_sphere():
    residual = _load("ibm/flow_past_sphere_ibm.py").run(nx=32, nyz=16, num_steps=30)
    assert residual < 0.01


def test_taylor_green_vortex_3d_low_precision_storage():
    """BASELINE config #3: f16 storage (11 mantissa bits) tracks the analytic
    decay; bf16 storage (8 bits) quantizes the tiny low-Mach increments of
    this configuration away, so it is held to stability + bounded energy
    (deviation-from-weight storage would recover the lost bits; backlog)."""
    from xlb_tpu.default_config import DefaultConfig
    from xlb_tpu.boundary.registry import boundary_condition_registry

    ke, expected = _load("cfd/taylor_green_vortex_3d.py").run(n=16, num_steps=50, precision="FP32FP16")
    assert 0.5 < ke / expected < 2.0, f"FP32FP16: KE {ke} vs analytic {expected}"

    DefaultConfig.reset()
    boundary_condition_registry.reset()
    ke_bf16, _ = _load("cfd/taylor_green_vortex_3d.py").run(n=16, num_steps=50, precision="FP32BF16")
    assert np.isfinite(ke_bf16) and 0 < ke_bf16 <= 0.028  # bounded by initial KE


def test_ooc_autodiff():
    losses = _load("ooc_autodiff.py").run(n=32, num_tiles=2, num_sweeps=2, iters=3)
    assert losses[-1] < losses[0]


def test_rayleigh_benard_2d():
    nus = _load("cfd/rayleigh_benard_2d.py").run(nx=48, ny=24, num_steps=1500, window=500)
    assert np.isfinite(nus).all()
    # convection onset: heat transport beats pure conduction
    assert nus[-1] > 1.05


def test_mlups_3d_cli():
    m = _load("performance/mlups_3d.py").benchmark(
        16, 4, "pallas", "D3Q19", "BGK", "FP32FP32", warmup=1, reps=1
    )
    assert m > 0


def test_mlups_2d_cli():
    m = _load("performance/mlups_2d.py").benchmark(64, 8, "pallas", "FP32FP32", warmup=1, reps=1)
    assert m > 0


def test_rayleigh_benard_2d_pallas():
    nus = _load("cfd/rayleigh_benard_2d.py").run(nx=48, ny=24, num_steps=1000, window=500, backend="pallas")
    assert np.isfinite(nus).all()


def test_cylinder_benchmark_schafer_turek():
    # tiny-diameter smoke: geometry/profile plumbing + an established
    # periodic lift signal; quantitative agreement needs d >= 40 (the
    # measured d=40 run is recorded in the script header)
    cd_max, cl_max, st = _load("cfd/cylinder_benchmark_schafer_turek.py").run(
        d=12, transient_periods=25, measure_periods=8, verbose=False
    )
    assert np.isfinite([cd_max, cl_max, st]).all()
    assert 0.15 < st < 0.5 and cd_max > 1.0
