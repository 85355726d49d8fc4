"""Quantitative Schafer-Turek 2D-2 validation (round-3 VERDICT #1).

Runs the full unsteady benchmark (examples/cfd/
cylinder_benchmark_schafer_turek.py) with the HybridBC curved cylinder
wall and asserts Cd_max / Cl_max / Strouhal INSIDE the published
lower/upper bounds of the benchmark compilation (Schafer & Turek 1996):

    Cd_max in [3.2200, 3.2400]
    Cl_max in [0.9900, 1.0100]
    St     in [0.2950, 0.3050]

This is a ~430k-step run on a 1321 x 247 lattice (hours on the CPU test
mesh), so it is marked ``gpu`` and runs only on the card; its time there is
not measured yet.

The reference has no counterpart: its curved-BC machinery is Warp/3D-only
(bc_hybrid.py:110-116) and its examples report qualitative vortex streets
only.
"""

import importlib.util
import pathlib

import pytest

pytestmark = [
    pytest.mark.validation,
    pytest.mark.gpu,
]


def _load_example():
    path = pathlib.Path(__file__).resolve().parents[2] / "examples" / "cfd" / "cylinder_benchmark_schafer_turek.py"
    spec = importlib.util.spec_from_file_location("schafer_turek_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_schafer_turek_2d2_hybrid_in_published_intervals():
    mod = _load_example()
    cd_max, cl_max, st = mod.run(
        d=60, u_mean=0.035, cylinder_bc="hybrid", hybrid_method="bounceback", verbose=True
    )
    assert 3.2200 <= cd_max <= 3.2400, f"Cd_max {cd_max:.4f} outside [3.2200, 3.2400]"
    assert 0.9900 <= cl_max <= 1.0100, f"Cl_max {cl_max:.4f} outside [0.9900, 1.0100]"
    assert 0.2950 <= st <= 0.3050, f"St {st:.4f} outside [0.2950, 0.3050]"
