"""Quantitative 3D sphere drag validation (round-3 VERDICT #3/#4).

Runs the wind tunnel of examples/cfd/sphere_drag_validation.py over the
checked-in NON-WATERTIGHT sphere STL (voxelized with WINDING -- the exact
pathology the reference built winding.py:20 for), HybridBC curved wall,
and asserts the momentum-exchange drag coefficient against the published
steady value at Re=100 (Johnson & Patel 1999 JFM: Cd ~ 1.087).

Expected systematic biases at the test resolution (D=24, 2% blockage,
FreeSlip tunnel walls): blockage ~ +2%, first-order staircase remnants at
the open-hole fallback links ~ few %.  The assertion band is therefore
published +/- 8%: Cd in [1.00, 1.18].

This is a ~30k-step run on a 288 x 144 x 144 lattice (hours on the CPU
test mesh), so it is marked ``gpu`` and runs only on the card.

The reference exercises this path qualitatively only
(examples/cfd/windtunnel_3d.py:120-285 reports Cd time series without a
published-value assertion).
"""

import importlib.util
import pathlib

import pytest

pytestmark = [
    pytest.mark.validation,
    pytest.mark.gpu,
]


def _load_example():
    path = pathlib.Path(__file__).resolve().parents[2] / "examples" / "cfd" / "sphere_drag_validation.py"
    spec = importlib.util.spec_from_file_location("sphere_drag_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sphere_drag_re100_hybrid_vs_published():
    mod = _load_example()
    cd = mod.run(d=24, re=100.0, verbose=True)
    assert 1.00 <= cd <= 1.18, f"Cd {cd:.4f} outside [1.00, 1.18] (published ~1.087)"
