"""Platform decisions, in one place.

The program runs on two platforms: the CPU, where the test-suite runs the
Pallas kernels in interpret mode, and an NVIDIA GPU, where they compile
through Pallas's Triton route.  Every choice that depends on the platform
-- interpret mode, kernel launch shape, the default tier of the out-of-core
sweep and of the examples -- is made by a function of this module; any
other platform raises.

Builders that replace a requested tier by a slower one report it through
:func:`notify_fallback`, and stamp an ``active_tier`` attribute on the
callables they return (steppers mirror it as ``stepper.active_tier``).
"""

import logging
import os
import warnings

import jax

logger = logging.getLogger("xlb_tpu")

_PLATFORMS = ("cpu", "gpu")

# Triton-route launch shape on the GPU: cells per program and warps per
# program (one cell per thread).
GPU_BLOCK = 512
GPU_NUM_WARPS = 8

# Interpret mode runs one XLA loop iteration per program, so the CPU takes
# the whole domain in one block up to this many cells.
_INTERPRET_MAX_BLOCK = 1 << 15


def platform():
    """The default JAX backend, checked against the supported platforms."""
    p = jax.default_backend()
    if p not in _PLATFORMS:
        raise RuntimeError(
            f"xlb_tpu runs on the CPU (tests, interpret-mode kernels) or an NVIDIA GPU; "
            f"JAX's default backend is {p!r}"
        )
    return p


def kernel_interpret():
    """Pallas kernels run in interpret mode on the CPU and compiled on the GPU."""
    return platform() == "cpu"


def kernel_launch(n_cells, interpret):
    """``(block, num_warps)`` of the fused collide-stream kernel for a
    domain of ``n_cells`` cells: the tuned GPU shape, or in interpret mode
    the smallest power of two covering the domain (capped), which keeps
    the interpreter's per-program loop short."""
    if not interpret:
        return GPU_BLOCK, GPU_NUM_WARPS
    block = 1
    while block < min(n_cells, _INTERPRET_MAX_BLOCK):
        block *= 2
    return block, 4


def fused_by_default():
    """Whether ``tier="auto"`` paths (out-of-core sweeps, examples) pick the
    fused kernel: on the GPU yes, in CPU interpret mode no."""
    return platform() == "gpu"


def enable_compile_cache(checkout_root):
    """Persist JAX's compile cache across processes.  ``JAX_COMPILATION_CACHE_DIR``,
    when set, is left to JAX; otherwise the cache lives in the fixed
    ``<checkout_root>/.jax_cache``.  Called by the scripts at the repo root,
    never on import of the library.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(os.path.abspath(checkout_root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def notify_fallback(message):
    """One-line notice that a faster kernel tier was replaced by a slower
    one, emitted through both ``warnings`` (deduplicated per call site by
    the default filter) and the ``xlb_tpu`` logger."""
    warnings.warn(message, RuntimeWarning, stacklevel=3)
    logger.warning(message)
