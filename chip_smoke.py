"""Smoke test of the library's public entry points on a GPU.

    python3 chip_smoke.py            # one card: every workload
    python3 chip_smoke.py --multi    # four cards: the parallel/ paths only

Every phase runs a public entry point at a real width on seeded data or
the PNG assets, and checks the result against oracle/ (the NumPy
reference), against the same op run on the CPU, or - for the GPU
kernel - against the plain JAX form at the same width on the card. Each
phase prints one line with its setup seconds (compilation, or the first
call where a phase has no single program), run milliseconds and the
process's peak device bytes after it, after a line with the device bytes
each compiled program plans for. Any failed phase exits non-zero.
The last line of a passing run is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

The script exits non-zero, without that line, when JAX finds no GPU.
The persistent compile cache is $JAX_COMPILATION_CACHE_DIR when set,
else .jax_cache/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# the CPU backend serves the CPU-side comparisons (train_filters)
_plats = os.environ.get("JAX_PLATFORMS")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Geometries: REAL is what the script runs on the card; TINY is the same
# code at toy sizes, for rehearsing the script on the CPU (tests/).
REAL = {
    "histeq": (16, 768, 1280),
    "local": (4, 768, 1280),
    "block": (256, 256),
    "resize": (4, 1024, 1024),
    "pyramid": (768, 1280),
    "frames": None,  # full Middlebury frame10/11
    "epe_max": 3.6,
    "raisr": {2: (4, 1024, 1024), 3: (4, 683, 683), 4: (4, 512, 512)},
    "raisr_rgb": (1024, 1024),
    "oracle_crop": 64,
    "train_crop": None,  # full lenna
    "multi_frame": (2048, 3840),
    "multi_1080p": (1080, 1920),
    "multi_dp_raisr": (1024, 1024),
}
TINY = {
    "histeq": (2, 64, 256),
    "local": (2, 64, 128),
    "block": (32, 32),
    "resize": (2, 32, 32),
    "pyramid": (64, 96),
    "frames": (96, 128),
    "epe_max": None,
    "raisr": {2: (2, 16, 32), 3: (2, 16, 24), 4: (2, 8, 16)},
    "raisr_rgb": (16, 32),
    "oracle_crop": 16,
    "train_crop": 48,
    "multi_frame": (256, 128),
    "multi_1080p": (256, 96),
    "multi_dp_raisr": (16, 24),
}


def _peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _compiled(fn, *args):
    """jit + lower + compile fn at args; returns (compiled, seconds) and
    prints the program's device footprint as the compiler plans it."""
    import jax

    t0 = time.perf_counter()
    c = jax.jit(fn).lower(*args).compile()
    secs = time.perf_counter() - t0
    m = c.memory_analysis()
    if m is not None:
        total = (m.argument_size_in_bytes + m.output_size_in_bytes
                 + m.temp_size_in_bytes - m.alias_size_in_bytes)
        print(f"  program bytes {total} (arguments + outputs + temporaries)", flush=True)
    return c, secs


def _run(compiled, *args):
    """Call a compiled fn, wait for it; returns (host result, ms)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    ms = (time.perf_counter() - t0) * 1e3
    return jax.tree_util.tree_map(np.asarray, out), ms


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


def _max_diff(a, b):
    return int(np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64)).max())


def _frames(geom):
    from oclcomputervision_jax.utils import asset_path, load_gray, read_flo

    g0, g1 = load_gray("frame10.png"), load_gray("frame11.png")
    gt = read_flo(asset_path("flow10.flo"))
    if geom["frames"] is not None:
        h, w = geom["frames"]
        g0, g1, gt = g0[:h, :w], g1[:h, :w], gt[:h, :w]
    return g0, g1, gt


def _natural(rng, b, h, w, rgb=False):
    """Seeded natural-looking uint8 stack: tiled lenna, rolled per image,
    plus +-8 noise."""
    from oclcomputervision_jax.utils import load_gray, load_image

    base = load_image("lenna.png") if rgb else load_gray("lenna.png")
    reps = (-(-h // base.shape[0]), -(-w // base.shape[1])) + ((1,) if rgb else ())
    tile = np.tile(base, reps)[:h, :w]
    out = []
    for _ in range(b):
        sh = tuple(int(v) for v in rng.integers(0, 512, 2))
        noisy = np.roll(tile, sh, (0, 1)).astype(np.int16) + rng.integers(-8, 9, tile.shape)
        out.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return np.stack(out)


# ---------------------------------------------------------------- one card


def phase_histeq_global(geom, rng):
    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops import histeq_global

    x = rng.integers(0, 256, geom["histeq"], np.uint8)
    c, cs = _compiled(histeq_global, x)
    out, ms = _run(c, x)
    d = max(_max_diff(out[i], oracle.histeq_global(x[i])) for i in range(len(x)))
    _check(d <= 1, f"histeq_global vs oracle: max diff {d} > 1")
    return cs, ms, f"{x.shape} max|d| vs oracle {d} (<= 1)"


def phase_histeq_local(geom, rng):
    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops import histeq_local_block

    x = _natural(rng, *geom["local"])
    bs = geom["block"]
    c, cs = _compiled(lambda a: histeq_local_block(a, 0.5, 0.05, 3.0, bs), x)
    out, ms = _run(c, x)
    worst, frac = 0, 0.0
    for i in range(len(x)):
        d = np.abs(out[i].astype(int) - oracle.histeq_local_block(x[i].copy(), 0.5, 0.05, 3.0, bs).astype(int))
        worst, frac = max(worst, int(d.max())), max(frac, float((d > 0).mean()))
    _check(worst <= 1 and frac < 1e-3, f"histeq_local_block vs oracle: max {worst}, share {frac}")
    return cs, ms, f"{x.shape} blocks {bs} max|d| {worst} (<= 1), share off {frac:.2e} (< 1e-3)"


def phase_resize(geom, rng):
    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops import resize_uint8

    b, h, w = geom["resize"]
    x = _natural(rng, b, h, w)[..., None]
    notes = []
    total_cs = total_ms = 0.0
    for method in ("bilinear", "bicubic"):
        c, cs = _compiled(lambda a: resize_uint8(a, (2 * h, 2 * w), method), x)
        out, ms = _run(c, x)
        want = oracle.interpolation.resize_uint8(x[0, ..., 0], (2 * h, 2 * w), method)
        d = _max_diff(out[0, ..., 0], want)
        _check(d <= 1, f"resize {method} vs oracle: max diff {d}")
        total_cs, total_ms = total_cs + cs, total_ms + ms
        notes.append(f"{method} max|d| {d}")
    return total_cs, total_ms, f"{x.shape} -> {2 * h}x{2 * w}: " + ", ".join(notes) + " (<= 1)"


def phase_pyramid(geom, rng):
    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops import gaussian_pyramid

    x = _natural(rng, 1, *geom["pyramid"])[0]
    c, cs = _compiled(lambda a: gaussian_pyramid(a, 2, 3), x)
    out, ms = _run(c, x)
    want = oracle.gaussian_pyramid(x, 2, 3)
    d = max(_max_diff(o, wv) for o, wv in zip(out, want))
    _check(d <= 1, f"gaussian_pyramid vs oracle: max diff {d}")
    return cs, ms, f"{x.shape} 3 levels max|d| {d} (<= 1)"


def phase_motion(geom, rng):
    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops import estimate_motion_vector

    g0, g1, _ = _frames(geom)
    notes = []
    total_cs = total_ms = 0.0
    for method, ref in (("exact", oracle.estimate_motion_vector), ("fast", oracle.estimate_motion_fast)):
        c, cs = _compiled(lambda a, b: estimate_motion_vector(a, b, 15, 5, method=method), g0, g1)
        out, ms = _run(c, g0, g1)
        _check(np.array_equal(out, ref(g0, g1, 15, 5)), f"motion {method} != oracle")
        total_cs, total_ms = total_cs + cs, total_ms + ms
        notes.append(f"{method} bit-exact")
    return total_cs, total_ms, f"{g0.shape}: " + ", ".join(notes)


def phase_pyramid_flow(geom, rng):
    import jax

    from oclcomputervision_jax import oracle
    from oclcomputervision_jax.ops.motion import estimate_motion_pyramid, upscale_mv
    from oclcomputervision_jax.utils import epe

    g0, g1, gt = _frames(geom)

    def pyr(a, b):
        return estimate_motion_pyramid(a, b, 3, method="exact", smooth=9)

    c, cs = _compiled(pyr, g0, g1)
    jitted, ms = _run(c, g0, g1)
    t0 = time.perf_counter()
    eager = [np.asarray(f) for f in pyr(g0, g1)]
    eager_s = time.perf_counter() - t0
    for lv, (e, j) in enumerate(zip(eager, jitted)):
        _check(np.array_equal(e, j), f"pyramid level {lv}: jitted != eager")
    # the finest level's raw search around the eager seed == the oracle
    from oclcomputervision_jax.ops import estimate_motion_vector, gaussian_pyramid

    p0 = [np.asarray(v) for v in gaussian_pyramid(g0, 2, 3)]
    p1 = [np.asarray(v) for v in gaussian_pyramid(g1, 2, 3)]
    seed = np.asarray(upscale_mv(eager[1], 2, mode="fixed"))
    raw = np.asarray(jax.jit(lambda a, b, s: estimate_motion_vector(a, b, 15, 5, seed=s, seed_mode="fixed"))(p0[2], p1[2], seed))
    _check(
        np.array_equal(raw, oracle.estimate_motion_vector(p0[2], p1[2], 15, 5, seed=seed, seed_mode="fixed")),
        "seeded finest-level search != oracle",
    )
    e = float(epe(eager[-1], gt))
    zero = float(epe(np.zeros_like(gt), gt))
    seed_max = float(np.abs(np.trunc(seed)).max())
    _check(e < zero, f"EPE {e} not below zero-flow {zero}")
    if geom["epe_max"] is not None:
        _check(e < geom["epe_max"], f"EPE {e} >= {geom['epe_max']}")
    return cs, ms, (
        f"{g0.shape} jitted == eager (eager {eager_s * 1e3:.1f} ms incl. dispatch), "
        f"finest seeds to {seed_max:.0f} px == oracle, EPE {e:.4f} (zero flow {zero:.4f})"
    )


def _raisr_model(scale):
    import jax.numpy as jnp

    from oclcomputervision_jax.models.raisr import RaisrModel
    from oclcomputervision_jax.utils import asset_path

    m = RaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"), fidelity="full")
    return m.cfg, jnp.asarray(m.filters, jnp.float32)


def _kernel_vs_plain(imgs, filters, cfg):
    """The apply stage alone at this width: GPU kernel vs plain form."""
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.ops import raisr as R
    from oclcomputervision_jax.ops.interpolation import resize
    from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

    interpret = jax.default_backend() != "gpu"
    b, h, w = imgs.shape[:3]
    up = resize(imgs, (h * cfg.scale, w * cfg.scale), "bilinear", batched=imgs.ndim == 3) / 255.0
    up = up[..., None] if imgs.ndim == 3 else up
    bucket = jax.jit(jax.vmap(lambda y: R.hash_image(y, cfg)))(up[..., 0])
    kern = jax.jit(lambda u, k, f: apply_filters_pallas(u, k, f, cfg, interpret=interpret))
    got = np.asarray(kern(up, bucket, filters))
    want = np.asarray(jax.jit(lambda u, k, f: R.apply_filters_batched(u, k, f, cfg))(up, bucket, filters))
    return float(np.abs(got - want).max()), got.shape


def _raisr_phase(imgs, scale, geom):
    import jax

    from oclcomputervision_jax.oracle import raisr as oracle_raisr
    from oclcomputervision_jax.ops.raisr import raisr_upsample
    from oclcomputervision_jax.utils import psnr

    cfg, filters = _raisr_model(scale)
    fn = lambda x: raisr_upsample(x, filters, cfg)  # noqa: E731
    kernel_ran = 'name = "raisr_apply"' in jax.jit(fn).lower(imgs).as_text()
    _check(kernel_ran == (jax.default_backend() == "gpu"), "apply form does not follow the platform")
    c, cs = _compiled(fn, imgs)
    out, ms = _run(c, imgs)
    _check(out.shape[1:3] == (imgs.shape[1] * scale, imgs.shape[2] * scale), f"bad shape {out.shape}")
    kdiff, kshape = _kernel_vs_plain(imgs, filters, cfg)
    _check(kdiff < 1e-4, f"apply kernel vs plain form: max |d| {kdiff}")
    k = geom["oracle_crop"]
    crop = imgs[0, :k, :k]
    got = np.asarray(raisr_upsample(crop, filters, cfg))
    want = oracle_raisr.raisr_upsample(crop, np.asarray(filters), cfg)
    p = psnr(got, want)
    far = float((np.abs(got.astype(int) - want.astype(int)) > 2).mean())
    _check(p > 35 and far < 0.02, f"crop vs oracle: PSNR {p:.2f}, share > 2 levels {far}")
    mp = out.shape[0] * out.shape[1] * out.shape[2] / 1e6
    form = "pallas-triton kernel raisr_apply" if kernel_ran else "plain gather form"
    return cs, ms, (
        f"{imgs.shape} -> {out.shape} ({mp:.1f} MP out) apply: {form}; kernel vs plain "
        f"at {kshape} max|d| {kdiff:.2e} (< 1e-4); {k}px crop vs oracle PSNR {p:.1f} dB (> 35)"
    )


def phase_raisr(scale):
    def phase(geom, rng):
        return _raisr_phase(_natural(rng, *geom["raisr"][scale]), scale, geom)

    phase.__name__ = f"phase_raisr_x{scale}"
    return phase


def phase_raisr_rgb(geom, rng):
    return _raisr_phase(_natural(rng, 1, *geom["raisr_rgb"], rgb=True), 2, geom)


def phase_train(geom, rng):
    """One train_filters pass (hash, normal equations, ridge solve) on
    lenna, on the default device and on the CPU."""
    import jax

    from oclcomputervision_jax.models import raisr as mr
    from oclcomputervision_jax.utils import load_gray
    from oclcomputervision_jax.utils.config import RaisrConfig

    cfg = RaisrConfig()
    y = load_gray("lenna.png").astype(np.float32) / 255.0
    if geom["train_crop"] is not None:
        y = y[: geom["train_crop"], : geom["train_crop"]]

    def one_pass(y01):
        p, t, f = mr._training_arrays(y01, cfg)
        g, r, cnt = mr.accumulate_normal_eq(p, t, f, cfg.num_filters, 1024)
        return f, cnt, mr.solve_filters(g, r, cnt, cfg.filter_len, mr.RIDGE_BY_SCALE[2])

    t0 = time.perf_counter()
    f_dev, cnt_dev, filt_dev = jax.tree_util.tree_map(np.asarray, one_pass(y))
    cs = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        f_cpu, cnt_cpu, filt_cpu = jax.tree_util.tree_map(np.asarray, one_pass(jax.device_put(y, cpu)))
    agree = float((f_dev == f_cpu).mean())
    rel = float(np.linalg.norm(filt_dev - filt_cpu) / np.linalg.norm(filt_cpu))
    _check(agree > 0.999, f"hash buckets agree on {agree:.5f} of pixels (<= 0.999)")
    _check(rel < 2e-2, f"filters differ from the CPU pass by {rel:.2e} (relative)")
    return cs, float("nan"), (
        f"lenna {y.shape}: buckets agree with CPU on {agree:.5f}, filter bank relative diff {rel:.2e} (< 2e-2)"
    )


SINGLE = [
    phase_histeq_global,
    phase_histeq_local,
    phase_resize,
    phase_pyramid,
    phase_motion,
    phase_pyramid_flow,
    phase_raisr(2),
    phase_raisr(3),
    phase_raisr(4),
    phase_raisr_rgb,
    phase_train,
]


# -------------------------------------------------------------- four cards


def _spread(out, ndev):
    devs = {s.device for s in out.addressable_shards}
    _check(len(devs) == ndev, f"result lives on {len(devs)} of {ndev} devices")


def phase_multi_dp(geom, rng):
    import jax

    from oclcomputervision_jax import parallel
    from oclcomputervision_jax.ops import estimate_motion_vector
    from oclcomputervision_jax.ops.raisr import raisr_upsample

    n = len(jax.devices())
    mesh = parallel.make_mesh((n,), ("data",))
    cfg, filters = _raisr_model(2)
    imgs = _natural(rng, n, *geom["multi_dp_raisr"])
    dp = jax.jit(parallel.data_parallel(lambda b: raisr_upsample(b, filters, cfg), mesh, "data"))
    t0 = time.perf_counter()
    out = jax.block_until_ready(dp(imgs))
    cs = time.perf_counter() - t0
    _spread(out, n)
    single = np.asarray(jax.jit(lambda b: raisr_upsample(b, filters, cfg))(imgs))
    d = np.abs(np.asarray(out).astype(int) - single.astype(int))
    # float sums may group differently per shard; where that moves a
    # pixel across a hash quantizer edge it takes another filter, so the
    # bound is on the share of pixels that differ
    _check((d > 0).mean() < 1e-3, f"dp RAISR x2 vs single card: share {(d > 0).mean()}")
    g0, g1, _ = _frames(geom)
    b0 = np.stack([np.roll(g0, k, 1) for k in range(n)])
    b1 = np.stack([np.roll(g1, k, 1) for k in range(n)])
    me = jax.jit(parallel.data_parallel(lambda a, b: estimate_motion_vector(a, b, 15, 5), mesh, "data"))
    flow = jax.block_until_ready(me(b0, b1))
    _spread(flow, n)
    want = np.asarray(jax.jit(lambda a, b: estimate_motion_vector(a, b, 15, 5))(b0, b1))
    _check(np.array_equal(np.asarray(flow), want), "dp exact ME != single card")
    return cs, float("nan"), (
        f"RAISR x2 {imgs.shape} over {n} cards vs single card max|d| {d.max()}, "
        f"share {(d > 0).mean():.1e} (< 1e-3); "
        f"exact ME {b0.shape} == single card"
    )


def phase_multi_histeq(geom, rng):
    import jax

    from oclcomputervision_jax import parallel
    from oclcomputervision_jax.ops import histeq_global, histeq_local_block

    n = len(jax.devices())
    mesh = parallel.make_mesh((n,), ("data",))
    x = _natural(rng, 1, *geom["multi_frame"])[0]
    bs = geom["block"]
    t0 = time.perf_counter()
    g = jax.block_until_ready(jax.jit(lambda a: parallel.histeq_global_sharded(a, mesh))(x))
    cs = time.perf_counter() - t0
    _spread(g, n)
    _check(np.array_equal(np.asarray(g), np.asarray(histeq_global(x))), "sharded histeq_global != single card")
    loc = jax.block_until_ready(jax.jit(lambda a: parallel.histeq_local_sharded(a, mesh, blockshape=bs))(x))
    _spread(loc, n)
    d = np.abs(np.asarray(loc).astype(int) - np.asarray(histeq_local_block(x, blockshape=bs)).astype(int))
    # the blend contracts at shard-local shapes: a +-1 flip exactly on a
    # truncation boundary is the documented bound
    _check(d.max() <= 1 and (d > 0).mean() < 1e-3, f"sharded local histeq: max {d.max()}")
    return cs, float("nan"), f"{x.shape}: global == single card, local max|d| {d.max()} share {(d > 0).mean():.1e}"


def phase_multi_1080p(geom, rng):
    import jax

    from oclcomputervision_jax import parallel
    from oclcomputervision_jax.ops import estimate_motion_vector
    from oclcomputervision_jax.ops.raisr import raisr_upsample

    n = len(jax.devices())
    mesh = parallel.make_mesh((n,), ("data",))
    h, w = geom["multi_1080p"]
    cfg, filters = _raisr_model(2)
    lr = _natural(rng, 1, h, w)[0]
    t0 = time.perf_counter()
    hr = jax.block_until_ready(jax.jit(lambda a: parallel.raisr_upsample_sharded(a, filters, cfg, mesh))(lr))
    cs = time.perf_counter() - t0
    _spread(hr, n)
    d = np.abs(np.asarray(hr).astype(int) - np.asarray(raisr_upsample(lr, filters, cfg)).astype(int))
    # the sharded upscale is a tap matmul, the single-card one a gather:
    # a last-bit difference can move a pixel across a hash quantizer edge
    # (another filter), so the bound is on the share of pixels that differ
    _check((d > 0).mean() < 1e-3, f"sharded RAISR vs single card: share {(d > 0).mean()}")
    f0 = _natural(rng, 1, h, w)[0]
    f1 = np.roll(f0, (3, -5), (0, 1))
    notes = [f"RAISR x2 {lr.shape} -> {hr.shape} vs single card max|d| {d.max()} share {(d > 0).mean():.1e} (< 1e-3)"]
    for name, fn, method in (
        ("fast", parallel.motion_fast_sharded, "fast"),
        ("exact", parallel.motion_exact_sharded, "exact"),
    ):
        got = jax.block_until_ready(jax.jit(lambda a, b: fn(a, b, mesh))(f0, f1))
        _spread(got, n)
        want = np.asarray(estimate_motion_vector(f0, f1, 15, 5, method=method))
        _check(np.array_equal(np.asarray(got), want), f"sharded {name} ME != single card")
        notes.append(f"{name} ME == single card")
    return cs, float("nan"), f"{h}x{w}: " + ", ".join(notes)


def phase_multi_train(geom, rng):
    import jax

    from oclcomputervision_jax import parallel
    from oclcomputervision_jax.models import raisr as mr
    from oclcomputervision_jax.utils import load_gray
    from oclcomputervision_jax.utils.config import RaisrConfig

    cfg = RaisrConfig()
    y = load_gray("lenna.png").astype(np.float32) / 255.0
    if geom["train_crop"] is not None:
        y = y[: geom["train_crop"], : geom["train_crop"]]
    p, t, f = mr._training_arrays(y, cfg)
    mesh = parallel.make_mesh((2, 2), ("dp", "tp"))
    ridge = 0.03
    t0 = time.perf_counter()
    got = jax.block_until_ready(
        parallel.raisr_train_step(p, t, f, cfg.num_filters, cfg.filter_len, mesh, chunk=256, ridge=ridge)
    )
    cs = time.perf_counter() - t0
    g, r, cnt = mr.accumulate_normal_eq(p, t, f, cfg.num_filters, 256)
    want = np.asarray(mr.solve_filters(g, r, cnt, cfg.filter_len, ridge))
    rel = float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))
    _check(rel < 2e-2, f"dp=2 tp=2 train step vs single card: relative diff {rel:.2e}")
    return cs, float("nan"), f"{p.shape[0]} pixels, dp=2 tp=2 filters vs single card relative diff {rel:.2e} (< 2e-2)"


MULTI = [phase_multi_dp, phase_multi_histeq, phase_multi_1080p, phase_multi_train]


# ---------------------------------------------------------------- driver


def run_phases(phases, geom, dev) -> bool:
    """Run each phase, print its line; True when all passed."""
    ok = True
    for phase in phases:
        rng = np.random.default_rng(0)
        name = phase.__name__.removeprefix("phase_")
        t0 = time.perf_counter()
        try:
            cs, ms, note = phase(geom, rng)
        except Exception:  # a failed phase is reported and the run goes on
            ok = False
            print(f"PHASE {name} FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
            traceback.print_exc(file=sys.stdout)
            continue
        print(
            f"PHASE {name} ok: setup_s={cs:.2f} run_ms={ms:.3f} "
            f"peak_bytes={_peak_bytes(dev)} wall_s={time.perf_counter() - t0:.1f} | {note}",
            flush=True,
        )
    return ok


def _gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true", help="run the four-card parallel/ paths only")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (default device {dev}); nothing to check", file=sys.stderr)
        return 1
    ndev = len(jax.devices())
    if args.multi and ndev != 4:
        print(f"chip_smoke --multi needs 4 GPUs, found {ndev}", file=sys.stderr)
        return 1

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"jax {jax.__version__}, devices: {jax.devices()}", flush=True)
    print(_gpu_line(), flush=True)
    t0 = time.perf_counter()
    ok = run_phases(MULTI if args.multi else SINGLE, REAL, dev)
    print(f"total wall {time.perf_counter() - t0:.1f} s", flush=True)
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {"platform": dev.platform, "kind": dev.device_kind, "count": ndev}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
