"""Profiling and timing utilities.

The JAX equivalents of the reference's tracing hooks (SURVEY.md §5: NVTX
ranges, wp.ScopedTimer): jax.profiler traces viewable in XProf/TensorBoard,
named trace annotations, and a wall-clock timer that waits for the device
with ``block_until_ready``.
"""

import contextlib
import time

import jax


def sync(*arrays):
    """Wait for pending work on the given arrays."""
    jax.block_until_ready(arrays)
    return arrays[0] if len(arrays) == 1 else arrays


@contextlib.contextmanager
def trace(name):
    """Named profiler annotation (NVTX-range equivalent)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir):
    """Capture a device trace into ``log_dir`` for XProf/TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ScopedTimer:
    """Wall-clock scope timer with device sync (wp.ScopedTimer analogue).

    Usage::

        with ScopedTimer("window", sync_arrays=lambda: [f_0]) as t:
            f_0, f_1 = run_window(...)
        print(t.elapsed)
    """

    def __init__(self, name="scope", sync_arrays=None, verbose=True):
        self.name = name
        self._sync = sync_arrays
        self.verbose = verbose
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            sync(*self._sync())
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.name}] {self.elapsed * 1e3:.3f} ms")
        return False


def mlups(cells, steps, seconds):
    """Million lattice updates per second (reference mlups_3d.py:265-268)."""
    return cells * steps / seconds / 1e6
