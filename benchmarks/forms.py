"""Time the alternative forms that the GPU dispatch chooses between.

    python3 benchmarks/forms.py

- RAISR x2/x3/x4 end to end (uint8 in, uint8 out; 16 images of ~4 MP
  output, bench.py's geometry) with the Pallas apply kernel and with
  the plain gather form (ops.raisr.apply_filters_batched);
- the fast search's two warp forms (warp_bound 'gather' and the
  masked-shift residual warp) on 16 VGA frame pairs, unseeded and seeded.

Each form is compiled, run once, then timed as the median of 7 calls
that end in block_until_ready. Prints the card (nvidia-smi name and
power limit) and one line per form. Needs a GPU.
"""

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(name, fn, *args, iters=7):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    print(f"{name}: median_ms={np.median(ts) * 1e3:.3f} min_ms={min(ts) * 1e3:.3f} "
          f"first_call_s={first:.1f}", flush=True)


def raisr_forms():
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.models.raisr import RaisrModel
    from oclcomputervision_jax.ops import raisr as R
    from oclcomputervision_jax.ops.interpolation import _resize_plane
    from oclcomputervision_jax.utils import asset_path, load_gray

    for scale in (2, 3, 4):
        m = RaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"), fidelity="full")
        cfg, filters = m.cfg, jnp.asarray(m.filters, jnp.float32)
        h = w = 2048 // scale
        tile = np.tile(load_gray("lenna.png"), (-(-h // 512), -(-w // 512)))[:h, :w]
        imgs = jnp.asarray(np.stack([np.roll(tile, 37 * i, (0, 1)) for i in range(16)]))
        kernel = jax.jit(lambda x: R.raisr_upsample(x, filters, cfg))

        @jax.jit
        def plain(x):
            # ops.raisr._raisr_batched for gray input, plain apply form
            up = jax.vmap(lambda im: _resize_plane(
                im[..., None], (h * scale, w * scale), "bilinear"))(x.astype(jnp.float32) / 255.0)
            bucket = jax.vmap(lambda y: R.hash_image(y, cfg))(up[..., 0])
            out = R.apply_filters_batched(up, bucket, filters, cfg)[..., 0]
            return jnp.clip(jnp.round(out * 255.0), 0, 255).astype(jnp.uint8)

        _time(f"raisr_x{scale}_e2e_kernel", kernel, imgs)
        _time(f"raisr_x{scale}_e2e_gather", plain, imgs)
        same = np.mean(np.asarray(kernel(imgs)) == np.asarray(plain(imgs)))
        print(f"raisr_x{scale}: kernel and gather outputs equal on {same:.6f} of pixels", flush=True)


def warp_forms():
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.ops import motion as M
    from oclcomputervision_jax.utils import load_gray

    g0, g1 = load_gray("frame10.png"), load_gray("frame11.png")
    rng = np.random.default_rng(0)
    a = jnp.asarray(np.clip(g0[None] + rng.integers(-4, 5, (16,) + g0.shape), 0, 255).astype(np.uint8))
    b = jnp.asarray(np.clip(g1[None] + rng.integers(-4, 5, (16,) + g1.shape), 0, 255).astype(np.uint8))
    yy, xx = np.mgrid[0:480, 0:640]
    seed = np.stack([20 * np.sin(xx / 90.0) + 6, 18 * np.cos(yy / 70.0) - 5], -1).astype(np.float32)
    seeds = jnp.asarray(np.broadcast_to(seed, (16,) + seed.shape).copy())
    for seeded in (False, True):
        for wb, label in ((None, "gather"), (-1, "shift")):
            f = jax.jit(jax.vmap(lambda x, y, s: M._estimate_2d_fast(
                x, y, s, 15, 5, "fixed", seeded, "sad", warp_bound=wb)))
            _time(f"me_fast_16xVGA_{'seeded' if seeded else 'unseeded'}_warp_{label}",
                  f, a, b, seeds)


if __name__ == "__main__":
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("benchmarks/forms.py times GPU forms; JAX found no GPU")
    from oclcomputervision_jax.utils.cache import enable_compile_cache

    enable_compile_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    raisr_forms()
    warp_forms()
