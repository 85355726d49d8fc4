"""Multires strategy enum + CLI helper.

API parity with reference xlb/mres_perf_optimization_type.py:12-83.  Only
NAIVE_COLLIDE_STREAM -- the jnp tier on every level -- is available.  The
FUSION_AT_FINEST* members are kept so that reference scripts naming them
fail with an actionable ValueError at stepper construction (their only
effect was to select fused multires Pallas kernels, which were removed).
"""

import argparse
from enum import Enum


class MresPerfOptimizationType(Enum):
    NAIVE_COLLIDE_STREAM = "naive_collide_stream"
    FUSION_AT_FINEST = "fusion_at_finest"
    FUSION_AT_FINEST_SFV = "fusion_at_finest_sfv"
    FUSION_AT_FINEST_SFV_ALL = "fusion_at_finest_sfv_all"

    @classmethod
    def from_string(cls, name: str) -> "MresPerfOptimizationType":
        try:
            return cls(name.lower())
        except ValueError:
            valid = ", ".join(m.value for m in cls)
            raise ValueError(f"unknown multires optimization {name!r}; choose from: {valid}") from None

    @staticmethod
    def build_arg_parser(parser: argparse.ArgumentParser = None) -> argparse.ArgumentParser:
        parser = parser or argparse.ArgumentParser()
        parser.add_argument(
            "--mres-perf-optimization",
            type=str,
            default=MresPerfOptimizationType.NAIVE_COLLIDE_STREAM.value,
            choices=[m.value for m in MresPerfOptimizationType],
            help="multires strategy (only naive_collide_stream is available; kept for CLI parity)",
        )
        return parser
