"""Sphere-drag resolution ladder (round-4 VERDICT next #5).

Re=100 sphere at D = 24 / 36 / 48 lattice diameters over the checked-in
non-watertight STL: the HybridBC momentum-exchange Cd must converge
toward Johnson & Patel's 1.087 as the resolution doubles, landing within
+/-3% at D=48 -- a band tight enough that the curved-wall correction is
load-bearing (the 2D Schafer-Turek study measured plain staircase ~3%
off on Cd, so a staircase sphere would not reliably pass it).

None of the rungs has been measured on the GPU yet.  Each D doubles the
step count AND the cell count (~47.8M at D=48), so the ladder runs on the
card only (``gpu`` marker).  Reference force path: momentum_transfer.py:121-212.
"""

import importlib.util
import pathlib

import pytest

pytestmark = [
    pytest.mark.validation,
    pytest.mark.gpu,
]

CD_PUBLISHED = 1.087  # Johnson & Patel 1999, steady axisymmetric Re=100


def _example():
    path = pathlib.Path(__file__).resolve().parents[2] / "examples" / "cfd" / "sphere_drag_validation.py"
    spec = importlib.util.spec_from_file_location("sphere_drag_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sphere_drag_converges_with_resolution():
    from xlb_tpu.default_config import DefaultConfig
    from xlb_tpu.boundary.registry import boundary_condition_registry

    mod = _example()
    errs = {}
    for d in (24, 36, 48):
        DefaultConfig.reset()
        boundary_condition_registry.reset()
        cd = mod.run(d=d, re=100.0, verbose=True)
        errs[d] = abs(cd / CD_PUBLISHED - 1.0)
    # finest lands inside the +/-3% band the staircase wall cannot hold
    assert errs[48] < 0.03, errs
    # and the error shrinks with resolution (0.5% slack: the acoustic
    # standing wave leaves ~0.01 absolute spread on each sample mean)
    assert errs[36] < errs[24] + 0.005, errs
    assert errs[48] < errs[36] + 0.005, errs
