"""Turbulent-channel DNS validation (reference
examples/cfd/turbulent_channel_3d.py:21-36 + data/).

The full validation needs ~240k steps of a 1.2M-cell channel (hours on the
CPU test mesh), so CI checks the dataset and the comparison machinery; the
long run is gated behind XLB_LONG_TESTS=1.
"""

import os

import numpy as np
import pytest

import importlib.util
import pathlib

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _channel_module():
    path = EXAMPLES / "cfd" / "turbulent_channel_3d.py"
    spec = importlib.util.spec_from_file_location("turb_channel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dns_dataset_ships_and_is_sane():
    mod = _channel_module()
    dns = mod.get_dns_data()
    yp = np.asarray(dns["y+"])
    up = np.asarray(dns["Umean"])
    assert yp.shape == up.shape and len(yp) == 65
    assert (np.diff(yp) > 0).all() and yp[-1] > 170  # reaches the centerline at Re_tau 180
    # the DNS profile itself obeys the log law in the log region to ~5%
    sel = (yp > 30) & (yp < 150)
    rel = np.abs(up[sel] - mod.vonkarman_loglaw(yp[sel])) / up[sel]
    assert rel.max() < 0.06


def test_compare_to_dns_machinery():
    """Feeding the DNS profile itself through the comparison returns ~zero
    deviation (round-trip sanity for the y+ mapping and interpolation)."""
    mod = _channel_module()
    dns = mod.get_dns_data()
    u_tau, re_tau, nz = 0.004, 180.0, 64
    visc = u_tau * (nz / 2.0) / re_tau
    z = np.arange(nz // 2) + 0.5
    yplus = z * u_tau / visc
    half = np.interp(yplus, np.asarray(dns["y+"]), np.asarray(dns["Umean"])) * u_tau
    profile = np.concatenate([half, half[::-1]])
    dev, *_ = mod.compare_to_dns(profile, u_tau, visc)
    assert dev < 1e-6


@pytest.mark.skipif(not os.environ.get("XLB_LONG_TESTS"), reason="long-running DNS validation (set XLB_LONG_TESTS=1)")
def test_channel_validates_against_dns():
    # band matches validation.py's resolution-qualified note: coarse DNS at
    # dz+ = 5.62 carries a systematic drag excess (measured 15.2% uniform
    # u+ deficit with the correct log-layer shape, 2026-08-21); the 5%-class
    # needs nz >= 96
    mod = _channel_module()
    dev = mod.run_validation()
    assert dev < 0.20, f"mean u+(y+) deviation from MKM DNS is {dev:.1%} (resolution-qualified tolerance 20%)"
