"""Benchmark harness for the five workloads on one GPU.

Measures, on device-resident uint8 batches in steady state, global and
local-block histogram equalization, resize, pyr_down, dense motion
estimation (fast, exact, the exact 3-level pyramid, EPE on Middlebury),
a video pipeline, and RAISR x2/x3/x4 super-resolution.

Prints the device (platform, kind, count) first, then one JSON line per
metric: {"metric": ..., "value": N, "unit": ...}; quality metrics add
"vs_baseline" (zero-flow EPE / EPE). The RAISR value counts OUTPUT
megapixels. Exits non-zero when JAX finds no GPU: a CPU number is not
a device metric.

Each timed call is one jitted lax.scan over a stack of batches, closed
by a host readback of a scan-carried scalar, so one dispatch covers the
whole measured workload.
"""

import json
import sys
import time


def _measure(fn, make_buf, n_scan, rounds, jax, jnp):
    """Median per-batch seconds: each timed call is one dispatch of a
    jitted scan over ``n_scan`` stacked batches. ``make_buf(r)`` builds
    round r's [n_scan, ...] stack of fresh content; stacks are created
    and dropped per round so rounds x n_scan batches are never resident
    at once."""

    def chain(xs, acc):
        return jax.lax.scan(lambda a, x: (fn(x, a), None), acc, xs)[0]

    chain = jax.jit(chain)
    buf = make_buf(0)
    jax.block_until_ready(buf)
    _ = int(chain(buf, jnp.int32(0)))  # compile + warmup
    times = []
    for r in range(rounds):
        del buf
        buf = make_buf(r + 1)
        jax.block_until_ready(buf)
        t0 = time.perf_counter()
        # forced host readback of the scan-carried scalar: completion
        # of the whole chain
        _ = int(chain(buf, jnp.int32(0)))
        times.append((time.perf_counter() - t0) / n_scan)
    times.sort()
    return times[len(times) // 2]


def _emit(metric, value, unit="megapixels/sec/chip", vs=None):
    """One JSON line; quality metrics pass a ``vs`` ratio."""
    line = {"metric": metric, "value": value, "unit": unit}
    if vs is not None:
        line["vs_baseline"] = vs
    print(json.dumps(line), flush=True)


def bench_histeq(jax, jnp):
    from oclcomputervision_jax.ops import histeq_global

    # Batched serving geometry: 256 resident 768x1280 frames per batch,
    # 16 batches per scan dispatch (4 GB uint8 resident, one round live
    # at a time; dispatch overhead < 3% of the chain).
    batch, h, w = 256, 768, 1280
    n_scan, rounds = 16, 3
    keys = jax.random.split(jax.random.PRNGKey(0), rounds + 1)
    gen = jax.jit(
        lambda k: jax.random.randint(
            k, (n_scan, batch, h, w), 0, 256, jnp.int32
        ).astype(jnp.uint8)
    )

    fn = lambda x, acc: acc + jnp.sum(histeq_global(x), dtype=jnp.int32)
    median_s = _measure(fn, lambda r: gen(keys[r]), n_scan, rounds, jax, jnp)
    print("histeq warmup+measure done", file=sys.stderr, flush=True)
    _emit("fused_histeq_global_throughput", batch * h * w / 1e6 / median_s)


def bench_raisr(jax, jnp, scale=2):
    import numpy as np

    from oclcomputervision_jax.models.raisr import RaisrModel
    from oclcomputervision_jax.ops.raisr import raisr_upsample
    from oclcomputervision_jax.utils.assets import asset_path

    model = RaisrModel.load(
        asset_path(f"raisr_filters_x{scale}.npz"), fidelity="full"
    )
    filters = jnp.asarray(model.filters, jnp.float32)
    cfg = model.cfg

    # 4MP-class output geometry per scale (x2: 1024^2 LR -> 2048^2 HR),
    # batch 16 per scan step, 16 steps per dispatch; natural-image
    # content so the hash buckets are realistic.
    batch, h, w = 16, 2048 // scale, 2048 // scale
    n_scan, rounds = 16, 3
    from oclcomputervision_jax.utils import load_gray

    base = load_gray("lenna.png")
    tile = np.tile(base, (-(-h // base.shape[0]), -(-w // base.shape[1])))[:h, :w]
    rng = np.random.default_rng(0)

    def make_buf(r):
        stack = []
        for j in range(n_scan):
            # unique content per batch: random roll + additive noise
            sh = rng.integers(0, 512, 2)
            noisy = tile.astype(np.int16) + rng.integers(-8, 9, tile.shape)
            img = np.clip(np.roll(noisy, sh, (0, 1)), 0, 255).astype(np.uint8)
            stack.append(np.stack([img] * batch))
        return jnp.asarray(np.stack(stack))

    # the sum runs over the FULL output (a strided subsample would let
    # XLA dead-code-eliminate part of the re-interleave glue)
    fn = lambda x, acc: acc + jnp.sum(raisr_upsample(x, filters, cfg), dtype=jnp.int32)
    median_s = _measure(fn, make_buf, n_scan, rounds, jax, jnp)
    print(f"raisr x{scale} warmup+measure done", file=sys.stderr, flush=True)
    _emit(
        f"raisr_x{scale}_throughput",
        batch * h * w * cfg.scale**2 / 1e6 / median_s,
    )


def bench_pyr_down(jax, jnp):
    """Gaussian pyramid primitive (pyramid/pyramid.py:12's cv2.pyrDown
    twin): one 2x blur+decimate level on batched 768x1280 luma."""
    from oclcomputervision_jax.ops.pyramid import pyr_down

    batch, h, w = 256, 768, 1280
    n_scan, rounds = 16, 3
    keys = jax.random.split(jax.random.PRNGKey(3), rounds + 1)
    gen = jax.jit(
        lambda k: jax.random.randint(
            k, (n_scan, batch, h, w), 0, 256, jnp.int32
        ).astype(jnp.uint8)
    )
    fn = lambda x, acc: acc + jnp.sum(
        pyr_down(x, 2, batched=True), dtype=jnp.int32
    )
    median_s = _measure(fn, lambda r: gen(keys[r]), n_scan, rounds, jax, jnp)
    print("pyr_down done", file=sys.stderr, flush=True)
    _emit("pyr_down_2x_throughput", batch * h * w / 1e6 / median_s)


def bench_me_pyramid_time(jax, jnp):
    """Wall + device time of the full seeded-EXACT 3-level VGA pyramid
    (me_test.py:76-90's coarse-to-fine flow, bit-identical search).

    The pyramid is jitted end to end (one program). The headline wall
    reads the flow back as int8: the exact pyramid's flow is
    integer-valued and bounded by motion.exact_flow_bound, so the cast
    is lossless - and ASSERTED bit-equal to the f32 program's output
    before anything is timed. The int16 and f32 readback walls and the
    eager driver's wall are emitted alongside; the device time comes
    from a profiler trace (utils.profiling.profile_device)."""
    import numpy as np

    from oclcomputervision_jax.ops.motion import estimate_motion_pyramid
    from oclcomputervision_jax.utils.profiling import profile_device

    g0, g1 = _me_frames(jnp)
    rng = np.random.default_rng(7)

    def _pyr(a, b):
        return estimate_motion_pyramid(a, b, 3, method="exact", smooth=9)[-1]

    run_jit = jax.jit(_pyr)
    run_jit_i16 = jax.jit(lambda a, b: _pyr(a, b).astype(jnp.int16))
    run_jit_i8 = jax.jit(lambda a, b: _pyr(a, b).astype(jnp.int8))

    def run_eager(a, b):
        return _pyr(a, b)

    def fresh(r):
        a = jnp.asarray(
            np.clip(np.asarray(g0, np.int16) + rng.integers(-4, 5, g0.shape), 0, 255
                    ).astype(np.uint8))
        b = jnp.asarray(
            np.clip(np.asarray(g1, np.int16) + rng.integers(-4, 5, g1.shape), 0, 255
                    ).astype(np.uint8))
        jax.block_until_ready((a, b))
        return a, b

    def med_wall(run, rounds=3):
        times = []
        for _r in range(rounds):
            a, b = fresh(_r)
            t0 = time.perf_counter()
            _ = np.asarray(run(a, b))  # full host readback completes the flow
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2] * 1e3

    # warmups: compile every level's kernels + all three jit programs,
    # and assert both integer readbacks are lossless flow encodings
    from oclcomputervision_jax.ops.motion import exact_flow_bound

    assert exact_flow_bound(3, 15) <= 127  # int8 holds by construction
    f32 = np.asarray(run_jit(g0, g1))
    i16 = np.asarray(run_jit_i16(g0, g1))
    i8 = np.asarray(run_jit_i8(g0, g1))
    assert i16.dtype == np.int16 and np.array_equal(f32, i16.astype(np.float32)), \
        "int16 flow readback must be bit-equal to the f32 program"
    assert i8.dtype == np.int8 and np.array_equal(f32, i8.astype(np.float32)), \
        "int8 flow readback must be bit-equal to the f32 program"
    _ = np.asarray(run_eager(*fresh(100)))  # compile the eager driver
    wall_ms = med_wall(run_jit_i8)
    i16_wall_ms = med_wall(run_jit_i16)
    f32_wall_ms = med_wall(run_jit)
    eager_wall_ms = med_wall(run_eager, rounds=5)
    a, b = fresh(99)
    dev_ms = profile_device(run_jit, a, b).pop("__total__")
    print("me exact pyramid time done", file=sys.stderr, flush=True)
    _emit("me_exact_pyramid_wall_ms", wall_ms, unit="ms (lower is better)")
    _emit("me_exact_pyramid_wall_i16_ms", i16_wall_ms, unit="ms (lower is better)")
    _emit("me_exact_pyramid_wall_f32_ms", f32_wall_ms, unit="ms (lower is better)")
    _emit("me_exact_pyramid_eager_wall_ms", eager_wall_ms, unit="ms (lower is better)")
    _emit("me_exact_pyramid_device_ms", dev_ms, unit="ms (lower is better)")


def bench_me_pyramid_batched(jax, jnp):
    """Serving-shape throughput: the jitted exact 3-level pyramid over
    [B, H, W] VGA stacks (batch 4), scan-dispatch protocol. Unit is
    finest-level megapixels per second."""
    import numpy as np

    from oclcomputervision_jax.ops.motion import estimate_motion_pyramid

    g0, g1 = _me_frames(jnp)
    h, w = g0.shape
    bsz, n_scan, rounds = 4, 4, 3
    key = jax.random.PRNGKey(11)

    def make_buf(r):
        k0, k1 = jax.random.split(jax.random.fold_in(key, r))
        j0 = (jax.random.uniform(k0, (n_scan, bsz, h, w)) * 9 - 4).astype(jnp.int16)
        j1 = (jax.random.uniform(k1, (n_scan, bsz, h, w)) * 9 - 4).astype(jnp.int16)
        a = jnp.clip(g0.astype(jnp.int16)[None, None] + j0, 0, 255).astype(jnp.uint8)
        b = jnp.clip(g1.astype(jnp.int16)[None, None] + j1, 0, 255).astype(jnp.uint8)
        return a, b

    def fn(ab, acc):
        a, b = ab
        flow = estimate_motion_pyramid(a, b, 3, method="exact", smooth=9)[-1]
        return acc + jnp.sum(flow, dtype=jnp.float32).astype(jnp.int32)

    median_s = _measure(fn, make_buf, n_scan, rounds, jax, jnp)
    mps = bsz * h * w / median_s / 1e6
    print("me exact pyramid batched done", file=sys.stderr, flush=True)
    _emit("me_exact_pyramid_batched_throughput", mps)


def bench_video(jax, jnp):
    """Serving-style video pipeline fps (fused histeq + fast dense flow
    per 768x1280 frame), measured with the SCAN discipline: one
    dispatch covers the whole frame chain, so the number is sustained
    device throughput, not async-enqueue wall time."""
    from oclcomputervision_jax.ops.histeq import histeq_global
    from oclcomputervision_jax.ops.motion import estimate_motion_vector

    h, w = 768, 1280
    n_scan, rounds = 64, 3
    key = jax.random.PRNGKey(5)
    base = (jax.random.uniform(key, (h + 384, w + 384)) * 255).astype(jnp.uint8)

    def make_buf(r):
        # panning synthetic scene; never-seen content per round via the
        # round-dependent offset
        fs = jnp.stack(
            [
                jax.lax.dynamic_slice(base, (2 * i + 3 * r, 3 * i), (h, w))
                for i in range(n_scan + 1)
            ]
        )
        return fs[:-1], fs[1:]

    def fn(pc, acc):
        prev, cur = pc
        eq = histeq_global(cur)
        mv = estimate_motion_vector(prev, cur, 15, 5, method="fast")
        return acc + (
            jnp.sum(eq, dtype=jnp.int32)
            + jnp.sum(mv, dtype=jnp.float32).astype(jnp.int32)
        )

    median_s = _measure(fn, make_buf, n_scan, rounds, jax, jnp)
    print("video pipeline done", file=sys.stderr, flush=True)
    _emit("video_pipeline_fps", 1.0 / median_s, unit="frames/sec")


def bench_localeq(jax, jnp):
    """Local-block (CLAHE-style) histeq, 768x1280 @ 256x256 blocks."""
    from oclcomputervision_jax.ops.histeq import histeq_local_block

    batch, h, w = 64, 768, 1280
    n_scan, rounds = 8, 3
    keys = jax.random.split(jax.random.PRNGKey(1), rounds + 1)
    gen = jax.jit(
        lambda k: jax.random.randint(
            k, (n_scan, batch, h, w), 0, 256, jnp.int32
        ).astype(jnp.uint8)
    )
    fn = lambda x, acc: acc + jnp.sum(
        histeq_local_block(x, 0.5, 0.05, 3.0, (256, 256)), dtype=jnp.int32
    )
    median_s = _measure(fn, lambda r: gen(keys[r]), n_scan, rounds, jax, jnp)
    print("localeq done", file=sys.stderr, flush=True)
    _emit("histeq_local_block_throughput", batch * h * w / 1e6 / median_s)


def bench_resize(jax, jnp):
    """Bilinear/bicubic 1024^2 -> 2048^2 (output MP)."""
    from oclcomputervision_jax.ops.interpolation import resize_uint8

    batch, h, w = 16, 1024, 1024
    n_scan, rounds = 16, 3
    keys = jax.random.split(jax.random.PRNGKey(2), 2 * (rounds + 1))
    gen = jax.jit(
        lambda k: jax.random.randint(
            k, (n_scan, batch, h, w, 1), 0, 256, jnp.int32
        ).astype(jnp.uint8)
    )
    for mi, method in enumerate(("bilinear", "bicubic")):
        fn = lambda x, acc: acc + jnp.sum(
            resize_uint8(x, (2 * h, 2 * w), method), dtype=jnp.int32
        )
        median_s = _measure(
            fn, lambda r: gen(keys[mi * (rounds + 1) + r]), n_scan, rounds, jax, jnp
        )
        print(f"resize {method} done", file=sys.stderr, flush=True)
        _emit(f"resize_{method}_2x_throughput", batch * h * w * 4 / 1e6 / median_s)


def _me_frames(jnp):
    import numpy as np

    from oclcomputervision_jax.utils import load_gray

    g0 = load_gray("frame10.png")
    g1 = load_gray("frame11.png")
    return g0, g1


def bench_me(jax, jnp):
    """Dense block-matching ME at VGA (input MP/s of frame pairs), fast
    and exact modes."""
    import numpy as np

    from oclcomputervision_jax.ops.motion import estimate_motion_vector

    g0, g1 = _me_frames(jnp)
    h, w = g0.shape
    rng = np.random.default_rng(0)

    for mode, batch, n_scan in (("fast", 16, 16), ("exact", 8, 4)):
        def make_buf(r):
            # unique content: additive noise over the Middlebury pair
            stack0, stack1 = [], []
            for j in range(n_scan):
                n0 = rng.integers(-4, 5, (batch, h, w))
                n1 = rng.integers(-4, 5, (batch, h, w))
                stack0.append(np.clip(g0.astype(np.int16) + n0, 0, 255).astype(np.uint8))
                stack1.append(np.clip(g1.astype(np.int16) + n1, 0, 255).astype(np.uint8))
            return jnp.asarray(np.stack(stack0)), jnp.asarray(np.stack(stack1))

        def fn(x, acc):
            f0, f1 = x
            mv = estimate_motion_vector(f0, f1, 15, 5, method=mode)
            return acc + jnp.sum(mv, dtype=jnp.float32).astype(jnp.int32)

        median_s = _measure(fn, make_buf, n_scan, 3, jax, jnp)
        print(f"me {mode} done", file=sys.stderr, flush=True)
        _emit(f"me_{mode}_throughput", batch * h * w / 1e6 / median_s)


def bench_me_epe(jax, jnp):
    """ME quality: endpoint error vs flow10.flo for the 3-level pyramid
    (exact and fast modes, smooth=9). vs_baseline = zero-flow EPE / EPE
    (improvement factor over predicting no motion)."""
    import numpy as np

    from oclcomputervision_jax.ops.motion import estimate_motion_pyramid
    from oclcomputervision_jax.utils import read_flo
    from oclcomputervision_jax.utils.assets import asset_path
    from oclcomputervision_jax.utils.metrics import epe

    g0, g1 = _me_frames(jnp)
    gt = read_flo(asset_path("flow10.flo"))
    zero = float(epe(np.zeros_like(gt), gt))
    for mode in ("exact", "fast"):
        flows = estimate_motion_pyramid(g0, g1, 3, method=mode, smooth=9)
        e = float(epe(np.asarray(flows[-1]), gt))
        _emit(f"me_{mode}_pyramid_epe", e, unit="px (lower is better)", vs=zero / e)
    # quality extension: 12 rounds of median-regularized equiangular
    # subpixel refinement per level (refine_flow_subpixel), for both the
    # reference-faithful exact pyramid and the hybrid (fast+refine)
    # schedule
    for mode in ("exact", "fast"):
        flows = estimate_motion_pyramid(
            g0, g1, 3, method=mode, smooth=9, subpixel=12
        )
        e = float(epe(np.asarray(flows[-1]), gt))
        _emit(
            f"me_{mode.replace('fast', 'hybrid')}_subpixel_pyramid_epe",
            e, unit="px (lower is better)", vs=zero / e,
        )


def main():
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"device": device}), flush=True)
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {device}")
    enable_compile_cache()

    # supporting metrics first; the two north-star lines stay at the
    # tail (the driver parses from the end)
    bench_localeq(jax, jnp)
    bench_resize(jax, jnp)
    bench_pyr_down(jax, jnp)
    bench_me(jax, jnp)
    bench_me_epe(jax, jnp)
    bench_me_pyramid_time(jax, jnp)
    bench_me_pyramid_batched(jax, jnp)
    bench_video(jax, jnp)
    bench_raisr(jax, jnp, scale=3)
    bench_raisr(jax, jnp, scale=4)
    bench_histeq(jax, jnp)
    bench_raisr(jax, jnp, scale=2)


if __name__ == "__main__":
    sys.path.insert(0, ".")
    main()
