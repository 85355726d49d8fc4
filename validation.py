"""Per-round quantitative physics validation gate.

Runs the flagship validation benchmarks on the REAL accelerator and emits
one machine-readable artifact so every round re-measures instead of quoting
stale trophy numbers from test skip strings (round-4 VERDICT weak #3).  The
counterpart of the reference's examples-as-acceptance-suite role
(examples/cfd/windtunnel_3d.py:120-285, turbulent_channel_3d.py:21-36).

Usage (on a machine with an NVIDIA GPU; exits non-zero without one):

    python validation.py                      # all benchmarks -> VALIDATION.json
    python validation.py --only sphere tgv    # subset
    python validation.py --skip channel       # skip the long DNS run
    python validation.py --out VALIDATION_gpu.json

The same physics is assert-gated in the test suite via
``python -m pytest -m gpu`` on the card; this runner is the
artifact-producing form of those tests (same example entry points, same
published bands).
"""

import argparse
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
EXAMPLES = HERE / "examples" / "cfd"


def _load(name):
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"validation_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_schafer_turek():
    """Schafer & Turek (1996) 2D-2 unsteady cylinder: Cd_max / Cl_max / St
    inside the published compilation intervals."""
    mod = _load("cylinder_benchmark_schafer_turek")
    cd_max, cl_max, st = mod.run(d=60, u_mean=0.035, cylinder_bc="hybrid", hybrid_method="bounceback", verbose=True)
    return {
        "cd_max": {"value": cd_max, "band": [3.2200, 3.2400]},
        "cl_max": {"value": cl_max, "band": [0.9900, 1.0100]},
        "strouhal": {"value": st, "band": [0.2950, 0.3050]},
    }


def bench_sphere_drag():
    """Johnson & Patel (1999) Re=100 sphere: momentum-exchange Cd at D=24
    over the non-watertight STL (WINDING voxelization + HybridBC)."""
    mod = _load("sphere_drag_validation")
    cd = mod.run(d=24, re=100.0, verbose=True)
    return {"cd": {"value": cd, "band": [1.00, 1.18], "published": 1.087}}


def bench_tgv():
    """3D Taylor-Green kinetic-energy decay vs the exp(-2 nu k^2 t)
    envelope in the linear regime."""
    mod = _load("taylor_green_vortex_3d")
    ke, expected = mod.run(n=64, u0=0.01, omega=1.4, num_steps=400)
    ratio = ke / expected
    return {"ke_ratio_vs_analytic": {"value": ratio, "band": [0.97, 1.03]}}


def bench_channel():
    """Turbulent channel Re_tau=180 vs the MKM DNS dataset: mean relative
    u+(y+) deviation over y+ in [10, 180].

    Band note: at the suite's wall resolution (dz+ = 5.62, 192x96x64,
    halfway bounce-back walls) coarse DNS carries a systematic drag
    excess; the band reflects that resolution (not yet measured on the
    GPU).  Tightening to the 5%-class requires nz >= 96 (dz+ <= 3.75),
    which triples the run cost."""
    mod = _load("turbulent_channel_3d")
    dev = mod.run_validation()
    return {"mean_uplus_deviation": {"value": dev, "band": [0.0, 0.20]}}


BENCHMARKS = {
    "schafer_turek": bench_schafer_turek,
    "sphere": bench_sphere_drag,
    "tgv": bench_tgv,
    "channel": bench_channel,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", nargs="*", choices=sorted(BENCHMARKS), help="run only these benchmarks")
    ap.add_argument("--skip", nargs="*", default=[], choices=sorted(BENCHMARKS), help="skip these benchmarks")
    ap.add_argument("--out", default="VALIDATION.json")
    args = ap.parse_args(argv)

    names = list(args.only) if args.only else list(BENCHMARKS)
    names = [n for n in names if n not in args.skip]

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"validation: no GPU (JAX platform {jax.devices()[0].platform!r}); nothing was run", file=sys.stderr)
        return 1
    from xlb_tpu.utils import tiers

    tiers.enable_compile_cache(HERE)
    report = {
        "device": jax.devices()[0].device_kind,
        "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        "benchmarks": {},
        "all_pass": True,
    }
    for name in names:
        print(f"=== validation: {name} ===", flush=True)
        t0 = time.time()
        entry = {"status": "ok", "metrics": {}, "seconds": None}
        try:
            metrics = BENCHMARKS[name]()
            for k, m in metrics.items():
                lo, hi = m["band"]
                m["pass"] = bool(lo <= m["value"] <= hi)
                if not m["pass"]:
                    report["all_pass"] = False
            entry["metrics"] = metrics
        except Exception as exc:  # noqa: BLE001 - record, don't abort the artifact
            entry["status"] = f"error: {type(exc).__name__}: {exc}"
            report["all_pass"] = False
        entry["seconds"] = round(time.time() - t0, 1)
        report["benchmarks"][name] = entry
        print(json.dumps({name: entry}, indent=2), flush=True)

    out = HERE / args.out
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(f"wrote {out} (all_pass={report['all_pass']})")
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
