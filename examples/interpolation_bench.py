"""Interpolation benchmark (basic/interpolation.py __main__ equivalent).

Upscales lenna 1024^2 -> 2048^2 (the reference protocol,
basic/interpolation.py:121-124), times cv2 vs the JAX resize over 20
iterations, and reports PSNR against the align-corners NumPy oracle
(the reference used scipy interp2d as ground truth; interp2d is removed
from modern scipy, and our oracle computes the same align-corners math).

  python examples/interpolation_bench.py
"""

import os
import time
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import cv2
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    enable_compile_cache()

    from oclcomputervision_jax.oracle.interpolation import resize_uint8 as oracle_resize
    from oclcomputervision_jax.ops.interpolation import resize_uint8
    from oclcomputervision_jax.utils import load_image, psnr
    from oclcomputervision_jax.utils.profiling import bench_op

    rgb = load_image("lenna.png")
    src = cv2.resize(rgb, (1024, 1024))
    hn = wn = 2048
    loop = 20

    for method, cv2_mode in (("bilinear", cv2.INTER_LINEAR), ("bicubic", cv2.INTER_CUBIC)):
        truth = oracle_resize(src, (hn, wn), method)

        ms = bench_op(lambda: cv2.resize(src, (wn, hn), interpolation=cv2_mode), iters=loop)
        out_cv = cv2.resize(src, (wn, hn), interpolation=cv2_mode)
        print(
            f"{method}: cv2 took {ms:.3f} ms, PSNR vs oracle: {psnr(out_cv, truth):.3f}"
        )

        dev = jnp.asarray(src)
        fn = jax.jit(lambda x: resize_uint8(x, (hn, wn), method))
        out_jax = np.asarray(fn(dev))  # compile + correctness sample

        # throughput over fresh buffers, chained through a carried
        # scalar and closed by one host readback
        keys = jax.random.split(jax.random.PRNGKey(0), loop)
        gen = jax.jit(
            lambda k: jax.random.randint(k, src.shape, 0, 256, jnp.int32).astype(
                jnp.uint8
            )
        )
        bufs = [gen(k) for k in keys]
        jax.block_until_ready(bufs)
        chained = jax.jit(
            lambda x, acc: acc + jnp.sum(fn(x), dtype=jnp.float32)
        )
        acc = jnp.float32(0)
        for b in bufs[:4]:
            acc = chained(b, acc)
        float(acc)
        acc = jnp.float32(0)
        t0 = time.perf_counter()
        for b in bufs[4:]:
            acc = chained(b, acc)
        float(acc)
        ms = (time.perf_counter() - t0) / (loop - 4) * 1000.0
        mps = hn * wn / 1e6 / ms * 1000.0
        print(
            f"{method}: JAX took {ms:.3f} ms ({mps:.0f} MP out/s) on "
            f"{jax.devices()[0].platform}, PSNR vs oracle: {psnr(out_jax, truth):.3f}"
        )


if __name__ == "__main__":
    main()
