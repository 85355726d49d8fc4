"""Device-memory bandwidth microbenchmark: a plain XLA copy of the LBM
population array (256^3 x 19 channels, f32), the roofline the fused step
is measured against.

Prints ms per pass and GB/s (read + write) with the card's name and power
limit; each repetition is a jitted 200-pass window ending in
``block_until_ready``, the median of five is reported.

    python examples/performance/memory_bandwidth.py
"""

import subprocess
import time

import numpy as np
import jax
import jax.numpy as jnp

N, q, iters = 256, 19, 200


def main():
    f = jnp.ones((q, N, N, N), jnp.float32)
    gb = q * N**3 * 4 / 1e9

    # scale by 1.0000001 so XLA cannot elide the pass
    @jax.jit
    def copy_window(x):
        return jax.lax.fori_loop(0, iters, lambda i, v: v * jnp.float32(1.0000001), x)

    x = jax.block_until_ready(copy_window(f))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        x = jax.block_until_ready(copy_window(x))
        times.append(time.perf_counter() - t0)
    per_pass = float(np.median(times)) / iters
    card = jax.devices()[0].device_kind
    if jax.devices()[0].platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    print(f"[{card}] XLA scale-copy of {gb:.2f} GB: {per_pass * 1e3:.3f} ms/pass -> {2 * gb / per_pass:.0f} GB/s")


if __name__ == "__main__":
    main()
