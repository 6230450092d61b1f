"""Pyramidal dense block-matching motion estimation.

The reference runs a per-pixel Python loop with a shrinking-step SAD
search (motion_estimation/me_pyramid.py:130-205) - the slowest path in
the toolkit (SURVEY.md §3.4). Here every pixel searches simultaneously:
each of the 3 shrinking-step rounds gathers one (patch+2*step)^2 window
per pixel around its current center, evaluates the 3x3 candidate offsets
{-step,0,+step}^2 with integer SAD, and recenters via argmin.
The sequential structure that remains (3 rounds) is the algorithm's own
data dependence; each round is one fused device pass over the image
instead of ~300k Python iterations.

Semantics (incl. zero-padded out-of-bounds windows, first-minimum
tie-breaking in row-major (dy, dx) order, and the 'shipped' seed
double-count quirk) match oracle/motion.py exactly - see its docstring.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from oclcomputervision_jax.oracle.motion import MEDIAN9_EXCHANGES, gaussian2d, me_steps


def _cost(patches, cand, costfn: str, patch_size: int):
    """Candidate cost over the trailing [ps, ps] axes (me_pyramid.py:29-48).

    SAD/SSD stay in int32 (exact); the WSAD variants use
    float32 with the reference's 5x5 sigma=2 Gaussian - 'wsad_shipped'
    keeps the np.dot-as-matmul quirk (fidelity note 9), 'wsad' is the
    intended elementwise weighting.
    """
    if costfn == "sad":
        return jnp.sum(jnp.abs(patches - cand), axis=(2, 3))
    if costfn == "ssd":
        d = patches - cand
        return jnp.sum(d * d, axis=(2, 3))
    w = jnp.asarray(
        gaussian2d((patch_size, patch_size), 2.0), jnp.float32
    )
    p0 = patches.astype(jnp.float32)
    p1 = cand.astype(jnp.float32)
    if costfn == "wsad_shipped":
        # full f32 products: the oracle's np.dot is float64, and a TF32
        # product would move costs by ~1e-3 relative and flip argmins
        hi = jax.lax.Precision.HIGHEST
        return jnp.sum(
            jnp.abs(jnp.matmul(p0, w, precision=hi) - jnp.matmul(p1, w, precision=hi)),
            axis=(2, 3),
        )
    if costfn == "wsad":
        return jnp.sum(jnp.abs(p0 - p1) * w, axis=(2, 3))
    raise ValueError(f"unknown costfn {costfn!r}")


def _gather_padded_u8(img: jnp.ndarray, yy: jnp.ndarray, xx: jnp.ndarray) -> jnp.ndarray:
    """img[yy, xx] with zeros outside (me_pyramid.py:89-127 semantics)."""
    h, w = img.shape
    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat = jnp.clip(yy, 0, h - 1) * w + jnp.clip(xx, 0, w - 1)
    vals = jnp.take(img.reshape(-1), flat)
    return jnp.where(valid, vals, jnp.uint8(0))


@functools.partial(
    jax.jit,
    static_argnames=("search_size", "patch_size", "seed_mode", "has_seed", "costfn"),
)
def _estimate_2d(
    gray0, gray1, seed, search_size, patch_size, seed_mode, has_seed, costfn="sad"
):
    """The exact search: each round gathers every pixel's candidate
    window (patch + 2 * step, zero outside the frame) around its own
    center and takes the first minimum of the 9 candidate costs, as
    oracle/motion.py does - bit-identical to it for any seed."""
    h, w = gray0.shape
    pm = patch_size // 2
    ys, xs = jnp.mgrid[0:h, 0:w]
    ys = ys.astype(jnp.int32)
    xs = xs.astype(jnp.int32)

    if has_seed:
        seed_u = seed[..., 0].astype(jnp.float32)
        seed_v = seed[..., 1].astype(jnp.float32)
    else:
        seed_u = jnp.zeros((h, w), jnp.float32)
        seed_v = jnp.zeros((h, w), jnp.float32)

    cy = ys + jnp.trunc(seed_v).astype(jnp.int32)
    cx = xs + jnp.trunc(seed_u).astype(jnp.int32)

    offs = jnp.arange(patch_size, dtype=jnp.int32) - pm
    patches = _gather_padded_u8(
        gray0,
        ys[:, :, None, None] + offs[None, None, :, None],
        xs[:, :, None, None] + offs[None, None, None, :],
    ).astype(jnp.int32)

    for step in me_steps(search_size, patch_size):
        k = patch_size + 2 * step  # candidate window extent
        woffs = jnp.arange(k, dtype=jnp.int32) - (pm + step)
        window = _gather_padded_u8(
            gray1,
            cy[:, :, None, None] + woffs[None, None, :, None],
            cx[:, :, None, None] + woffs[None, None, None, :],
        ).astype(jnp.int32)

        sads = []
        for iy in range(3):
            for ix in range(3):
                cand = jax.lax.slice(
                    window,
                    (0, 0, iy * step, ix * step),
                    (h, w, iy * step + patch_size, ix * step + patch_size),
                )
                sads.append(_cost(patches, cand, costfn, patch_size))
        best = jnp.argmin(jnp.stack(sads), axis=0).astype(jnp.int32)
        cy = cy + (best // 3 - 1) * step
        cx = cx + (best % 3 - 1) * step

    du = (cx - xs).astype(jnp.float32)
    dv = (cy - ys).astype(jnp.float32)
    if seed_mode == "shipped":
        u, v = seed_u + du, seed_v + dv
    else:  # 'fixed'
        u, v = du, dv
    return jnp.stack([u, v], axis=-1)


def _reachable_sets(steps):
    """Per-axis displacement sets entering each search round."""
    cur = {0}
    sets = []
    for st in steps:
        sets.append(sorted(cur))
        cur = {v + o * st for v in cur for o in (-1, 0, 1)}
    return sets


def _me_boxsum(img, S, w, patch_size):
    """Separable (2*pm+1)-tap zero-padded patch sum (the fast mode's
    cost aggregation; shared by the full-image loop and its band twin)."""
    pm = patch_size // 2
    p = jnp.pad(img, ((pm, pm), (0, 0)))
    v = jnp.zeros_like(img)
    for k in range(patch_size):
        v = v + jax.lax.slice(p, (k, 0), (k + S, w))
    p = jnp.pad(v, ((0, 0), (pm, pm)))
    o = jnp.zeros_like(img)
    for k in range(patch_size):
        o = o + jax.lax.slice(p, (0, k), (S, k + w))
    return o


def _residual_shift_warp(f1pad, rb, S, w, dy, dx, vals):
    """Masked-shift residual warp: the residual state provably stays in
    this round's reachable set ``vals`` (it starts at 0; each update
    adds -step/0/step and the median-of-9 SELECTS one of its inputs),
    so the select only needs |vals|^2 terms, not the full (2 rb + 1)^2
    square: 0 + 9 + 81 selects across the 15/5 rounds instead of
    3 x 289 (dropped terms have all-false masks and add exactly 0 -
    bit-identical)."""
    if vals == [0]:
        return jax.lax.slice(f1pad, (rb, rb), (rb + S, rb + w))
    mx = {v: dx == v for v in vals}
    w1 = jnp.zeros((S, w), jnp.int32)
    for vy in vals:
        inner = jnp.zeros((S, w), jnp.int32)
        for vx in vals:
            sl = jax.lax.slice(
                f1pad, (rb + vy, rb + vx), (rb + vy + S, rb + vx + w)
            )
            inner = inner + jnp.where(mx[vx], sl, 0)
        w1 = w1 + jnp.where(dy == vy, inner, 0)
    return w1


def _fast_rounds(
    f0, steps, patch_size, costfn, warp_fn, S, w,
    init_dy=None, init_dx=None, in_img=None, grow=None, h_img=None,
):
    """The fast mode's round loop, shared VERBATIM by _estimate_2d_fast
    and _fast_residual_band (their bit-identity is the sharding
    correctness contract - one implementation, not two copies): warp ->
    9 statically-shifted boxsum costs -> argmin update -> median-of-9
    regularization, once per shrinking step.

    ``in_img``/``grow`` carry the band twin's true-image-edge masks
    ([S, 1] global-row predicates); None means full image - every mask
    branch disappears at trace time, so the full-image path pays
    nothing for the sharing. ``init_dy/dx`` seed the state for the
    legacy full-field gather mode (residual modes start at 0).

    The 3x3 state median uses Paeth's 19-exchange median-of-9 network
    (far cheaper than jnp.sort of the 9-stack); column
    neighbors edge-replicate at the true (full-width) image columns,
    row neighbors at the true image rows (a band edge is not an image
    edge)."""

    def median3x3(a):
        pd = jnp.pad(a, ((1, 1), (1, 1)), mode="edge")
        ctr = pd[1:-1, 1:-1]
        if grow is None:
            up, dn = pd[:-2, 1:-1], pd[2:, 1:-1]
        else:
            up = jnp.where(grow >= 1, pd[:-2, 1:-1], ctr)
            dn = jnp.where(grow <= h_img - 2, pd[2:, 1:-1], ctr)
        v = []
        for row in (up, ctr, dn):
            rp = jnp.pad(row, ((0, 0), (1, 1)), mode="edge")
            v.extend([rp[:, :-2], row, rp[:, 2:]])

        def cx(i, j):
            lo = jnp.minimum(v[i], v[j])
            v[j] = jnp.maximum(v[i], v[j])
            v[i] = lo

        for i, j in MEDIAN9_EXCHANGES:
            cx(i, j)
        return v[4]

    dy = jnp.zeros((S, w), jnp.int32) if init_dy is None else init_dy
    dx = jnp.zeros((S, w), jnp.int32) if init_dx is None else init_dx
    for step, vals in zip(steps, _reachable_sets(steps)):
        w1 = warp_fn(dy, dx, vals)
        if in_img is not None:
            # a band row outside the global image could otherwise warp
            # real frame rows into view (the full-image w1 only exists
            # on [h, w])
            w1 = jnp.where(in_img, w1, 0)
        w1p = jnp.pad(w1, ((step, step), (step, step)))
        sads = []
        for oy in (-step, 0, step):
            for ox in (-step, 0, step):
                shifted = jax.lax.slice(
                    w1p, (step + oy, step + ox), (step + oy + S, step + ox + w)
                )
                if costfn == "sad":
                    diff = jnp.abs(f0 - shifted)
                elif costfn == "ssd":
                    diff = (f0 - shifted) * (f0 - shifted)
                else:
                    # the WSAD matmul cost has no shifted-boxsum form;
                    # it exists only on the exact path
                    raise ValueError(f"costfn {costfn!r} requires method='exact'")
                if in_img is not None:
                    # a +-step candidate shift can carry in-image w1
                    # data into an out-of-image diff row, which the
                    # full-image box sum zero-pads
                    diff = jnp.where(in_img, diff, 0)
                sads.append(_me_boxsum(diff, S, w, patch_size))
        best = jnp.argmin(jnp.stack(sads), axis=0).astype(jnp.int32)
        dy = median3x3(dy + (best // 3 - 1) * step)
        dx = median3x3(dx + (best % 3 - 1) * step)
    return dy, dx


@functools.partial(
    jax.jit,
    static_argnames=(
        "search_size", "patch_size", "seed_mode", "has_seed", "costfn", "warp_bound",
    ),
)
def _estimate_2d_fast(
    gray0, gray1, seed, search_size, patch_size, seed_mode, has_seed, costfn="sad",
    warp_bound=None,
):
    """Warp-based approximate search: one warp per round.

    Instead of gathering a per-pixel candidate window (exact path),
    each round warps frame1 by the current displacement field ONCE,
    then evaluates the 3x3 candidate offsets with statically-shifted
    absolute differences box-filtered to patch sums (separable adds).
    The candidate cost uses the neighbor's displacement at the window
    edge (w1[p+o+q] carries d(p+o+q), not d(p)), so results are not
    bit-identical to the exact search, but quality on smooth fields
    matches (EPE parity on the Middlebury pair).

    ``warp_bound`` != None replaces the per-round per-pixel warp GATHER
    with masked static shifts. The field decomposes as d = trunc(seed) + r: frame1 is
    warped by the seed base ONCE (a single gather - or not at all when
    unseeded), and each round's warp handles only the search residual
    r, which is bounded by sum(steps) BY CONSTRUCTION (each round moves
    the center by at most its step; the median is order-preserving), so
    the (2*sum(steps)+1)^2 shift set is exact - no re-clamp cycles, no
    silent saturation. The residual warp samples the seed at p + r instead
    of p (seed fields are smooth upscaled flows; EPE on the Middlebury
    pair is unchanged - see tests). A non-negative int ``warp_bound``
    additionally clamps the seed BASE to [-B, B] once on entry (the
    public wrapper warns when a concrete seed actually saturates). None
    keeps the per-round gather of the full field.
    """
    h, w = gray0.shape
    ys, xs = jnp.mgrid[0:h, 0:w]
    ys = ys.astype(jnp.int32)
    xs = xs.astype(jnp.int32)

    if has_seed:
        seed_u = seed[..., 0].astype(jnp.float32)
        seed_v = seed[..., 1].astype(jnp.float32)
    else:
        seed_u = jnp.zeros((h, w), jnp.float32)
        seed_v = jnp.zeros((h, w), jnp.float32)

    dy = jnp.trunc(seed_v).astype(jnp.int32)
    dx = jnp.trunc(seed_u).astype(jnp.int32)
    pix_dt = jnp.int32
    f0 = gray0.astype(pix_dt)

    steps = me_steps(search_size, patch_size)
    if warp_bound is not None:
        if warp_bound >= 0:
            # saturation contract: clamp the seed base ONCE
            dy = jnp.clip(dy, -warp_bound, warp_bound)
            dx = jnp.clip(dx, -warp_bound, warp_bound)
        base_y, base_x = dy, dx
        if has_seed:
            base1 = _gather_padded_u8(gray1, ys + base_y, xs + base_x)
        else:
            base1 = gray1
        rb = sum(steps)  # exact residual bound (see docstring)
        f1pad = jnp.pad(base1.astype(pix_dt), rb)
        rdy, rdx = _fast_rounds(
            f0, steps, patch_size, costfn,
            lambda a, b, vals: _residual_shift_warp(f1pad, rb, h, w, a, b, vals),
            h, w,
        )
        dy = base_y + rdy
        dx = base_x + rdx
    else:
        # per-round gather of the FULL field (warp_bound 'auto'/'gather')
        def warp_gather(ry, rx, vals):
            return _gather_padded_u8(gray1, ys + ry, xs + rx).astype(pix_dt)

        dy, dx = _fast_rounds(
            f0, steps, patch_size, costfn, warp_gather, h, w,
            init_dy=dy, init_dx=dx,
        )
    du = dx.astype(jnp.float32)
    dv = dy.astype(jnp.float32)
    if seed_mode == "shipped":
        u, v = seed_u + du, seed_v + dv
    else:
        u, v = du, dv
    return jnp.stack([u, v], axis=-1)


def exact_halo_rows(search_size: int = 15, patch_size: int = 5) -> int:
    """Per-side row halo that makes a band-local EXACT search exact:
    every output pixel of _estimate_2d reads frame rows within
    pm (patch) + sum(steps) (max reachable displacement) of itself and
    nothing else (the search is purely per-pixel - unlike the fast
    iteration there is no cross-pixel state flow), so a band holding
    that many true rows beyond its kept region reproduces the
    full-image result bit-exactly (10 rows at the 15/5 geometry).
    The spatial-parallel building block of parallel.mesh
    motion_exact_sharded."""
    return patch_size // 2 + sum(me_steps(search_size, patch_size))


def fast_halo_rows(search_size: int = 15, patch_size: int = 5) -> int:
    """Per-side row halo that makes a band-local fast iteration exact:
    each round spreads state influence by 1 (median) + step (candidate
    shift) + pm (patch sum) rows, so garbage creeps inward from a band
    edge by sum(1 + step + pm) rows total."""
    pm = patch_size // 2
    return sum(1 + st + pm for st in me_steps(search_size, patch_size))


@functools.partial(
    jax.jit,
    static_argnames=("h", "w", "search_size", "patch_size", "costfn"),
)
def _fast_residual_band(
    f0_ext, f1_ext, r0, h, w,
    search_size=15, patch_size=5, costfn="sad",
):
    """The fast residual iteration computed on a row band with
    true-image-edge masks.

    ``f0_ext``/``f1_ext`` are [S, w] integer row bands covering global
    rows [r0, r0 + S) of frame0 / the (seed-base-warped) frame1, ZERO
    outside the global image; ``r0`` may be negative and is a traced
    scalar (shard-dependent under shard_map). Returns [S, w, 2] int
    residual flow whose rows at distance >= fast_halo_rows() from both
    band edges are BIT-IDENTICAL to the full-image _estimate_2d_fast
    residual loop - masks reproduce its exact edge semantics:

    - w1 is zeroed outside the global image (the full-image w1 only
      exists on [h, w]; a band row outside the image could otherwise
      warp real frame rows into view),
    - the DIFF is also masked to true image rows: a +-step candidate
      shift can carry in-image w1 data into an out-of-image diff row,
      which the full-image box sum zero-pads,
    - the 3x3 state medians edge-REPLICATE at the true image rows via
      global-row masks (columns are full-width, so plain edge pad).

    This is the spatial-parallel building block (parallel.mesh
    motion_fast_sharded): shards exchange fast_halo_rows() true rows
    via ppermute, run this band locally, and crop the halo.
    """
    S = f0_ext.shape[0]
    steps = me_steps(search_size, patch_size)
    f0 = f0_ext.astype(jnp.int32)
    rb = sum(steps)
    grow = r0 + jnp.arange(S, dtype=jnp.int32)[:, None]  # global row ids
    in_img = (grow >= 0) & (grow < h)  # [S, 1], broadcasts over w
    f1pad = jnp.pad(f1_ext.astype(jnp.int32), rb)
    dy, dx = _fast_rounds(
        f0, steps, patch_size, costfn,
        lambda a, b, vals: _residual_shift_warp(f1pad, rb, S, w, a, b, vals),
        S, w, in_img=in_img, grow=grow, h_img=h,
    )
    return jnp.stack([dx, dy], axis=-1)


# the hybrid schedule's refine pass clips its seed to this many px
_REFINE_CLIP = 32.0


def _warn_seed_saturation(seed, bound, what):
    """Host-side guard: warn when a CONCRETE seed's base exceeds an
    explicit clamp (tracers skip - the check is advisory, not semantic)."""
    if seed is None or isinstance(seed, jax.core.Tracer):
        return
    base_max = float(jnp.max(jnp.abs(jnp.trunc(jnp.asarray(seed)))))
    if base_max > bound:
        import warnings

        warnings.warn(
            f"seed displacements reach {base_max:.0f} px but {what}={bound} "
            f"clamps the seed base to [-{bound}, {bound}]; the flow "
            "saturates there. Raise the bound (or use warp_bound='gather') "
            "for larger motion.",
            RuntimeWarning,
            stacklevel=3,
        )


def estimate_motion_vector(
    gray0: jnp.ndarray,
    gray1: jnp.ndarray,
    search_size: int = 15,
    patch_size: int = 5,
    seed: Optional[jnp.ndarray] = None,
    seed_mode: str = "shipped",
    method: str = "exact",
    costfn: str = "sad",
    warp_bound="auto",
) -> jnp.ndarray:
    """Dense integer block-matching flow [H, W, 2] (u=x, v=y) float32.

    Defaults match me_pyramid.py:130. Accepts [H, W] or batched [B, H, W]
    frames (seed batched alike). ``method='exact'`` is bit-identical to
    the reference search; ``method='fast'`` uses the warp-based
    approximation (EPE parity on Middlebury). ``costfn`` in {'sad',
    'ssd', 'wsad_shipped', 'wsad'} selects the match cost
    (me_pyramid.py:29-48; the reference search only ever uses SAD at
    :70; the WSAD variants are exact-mode only).

    ``method='exact'`` is the windowed search: every round gathers each
    pixel's candidate windows around its own center, so any seed, of
    any extent, is searched exactly (eagerly and under jax.jit alike).

    ``warp_bound`` (fast mode only): 'auto' and 'gather' warp frame1 by
    the whole field every round (of the two warp forms, the one measured
    faster on an H100; PERF.md).
    An int B >= 0 selects the masked-shift residual warp: the seed base
    is clamped to [-B, B] once on entry and gather-warped once, and only
    the bounded search residual uses masked shifts (a warning is emitted
    when a concrete seed actually saturates).
    """
    gray0 = jnp.asarray(gray0)
    gray1 = jnp.asarray(gray1)
    if gray0.ndim == 3:
        from oclcomputervision_jax.ops._layout import guard_batch_first

        guard_batch_first(gray0.shape, "estimate_motion_vector")
    has_seed = seed is not None
    if warp_bound in ("auto", "gather"):
        wb = None
    else:
        wb = int(warp_bound)
        if wb < 0:
            raise ValueError(
                "warp_bound must be 'auto', 'gather', or an int >= 0"
            )
    if method == "fast" and wb is not None and has_seed:
        _warn_seed_saturation(seed, wb, "warp_bound")
    if method == "fast":
        impl = functools.partial(_estimate_2d_fast, warp_bound=wb)
    else:
        impl = _estimate_2d
    s = jnp.asarray(seed) if has_seed else jnp.zeros((1,), jnp.float32)
    if gray0.ndim == 3:
        return jax.vmap(
            lambda g0, g1, sd: impl(
                g0, g1, sd, search_size, patch_size, seed_mode, has_seed, costfn
            )
        )(gray0, gray1, s if has_seed else jnp.zeros((gray0.shape[0], 1), jnp.float32))
    return impl(gray0, gray1, s, search_size, patch_size, seed_mode, has_seed, costfn)


def _halfpixel_taps(n_out: int, n_in: int):
    """cv2.INTER_LINEAR tap indices/weights (constants under jit)."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    u = x - x0
    i0 = x0.astype(np.int64)
    u = np.where(i0 < 0, 0.0, u)
    u = np.where(i0 >= n_in - 1, 1.0, u)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, u.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("out_hw",))
def resize_bilinear_halfpixel(img: jnp.ndarray, out_hw: Tuple[int, int]) -> jnp.ndarray:
    """cv2.INTER_LINEAR-style float resize (half-pixel centers) of [H, W]."""
    h_out, w_out = out_hw
    y0, y1, vy = _halfpixel_taps(h_out, img.shape[0])
    x0, x1, ux = _halfpixel_taps(w_out, img.shape[1])
    a = img.astype(jnp.float32)
    rows = a[jnp.asarray(y0)] * (1 - vy)[:, None] + a[jnp.asarray(y1)] * vy[:, None]
    out = rows[:, jnp.asarray(x0)] * (1 - ux)[None, :] + rows[:, jnp.asarray(x1)] * ux[None, :]
    return out


def upscale_mv(mv: jnp.ndarray, scale: int, mode: str = "shipped") -> jnp.ndarray:
    """Coarse-to-fine flow seeding (me_test.py:51-63 semantics).

    'shipped' reproduces the reference's max-normalized resize (wrong for
    all-negative components, div-by-zero if max==0 - fidelity note 8);
    'fixed' resizes and scales directly. Accepts [H, W, 2] or batched
    [B, H, W, 2] (per-frame max-normalization, matching the reference's
    single-frame semantics).
    """
    mv = jnp.asarray(mv)
    if mv.ndim == 4:
        return jax.vmap(lambda m: upscale_mv(m, scale, mode))(mv)
    h, w = mv.shape[:2]
    out_hw = (h * scale, w * scale)
    u = mv[..., 0].astype(jnp.float32)
    v = mv[..., 1].astype(jnp.float32)
    if mode == "shipped":
        u_max = jnp.max(u)
        v_max = jnp.max(v)
        u = resize_bilinear_halfpixel(u / u_max, out_hw) * (u_max * scale)
        v = resize_bilinear_halfpixel(v / v_max, out_hw) * (v_max * scale)
    elif mode == "fixed":
        u = resize_bilinear_halfpixel(u, out_hw) * scale
        v = resize_bilinear_halfpixel(v, out_hw) * scale
    else:
        raise ValueError(mode)
    return jnp.stack([u, v], axis=-1)


def exact_flow_bound(levels: int, search_size: int = 15) -> int:
    """Analytic sup bound on |flow| for the exact pyramid (per axis, px).

    Each level's integer full search moves at most d = search_size // 2
    px from its seed, and coarse-to-fine seeding doubles the previous
    level's flow (upscale_mv x2; bilinear resize is a convex combination
    so it cannot exceed the per-axis extrema, in either seed_mode), so
    |f_L| <= 2 |f_{L-1}| + d and the finest level is bounded by
    (2**levels - 1) * d. The median filter selects one of its inputs and
    subpixel refinement is off on the exact path, so the bound holds for
    every returned level. At the me_test.py:76-90 defaults (3 levels,
    search 15) the bound is 49 - the integer-valued flow (pinned by
    test_exact_pyramid_flow_is_integer_valued) is losslessly servable as
    int8.
    """
    return (2 ** levels - 1) * (search_size // 2)


@functools.lru_cache(maxsize=None)
def _median_network(n: int):
    """Comparator program selecting the median (index n//2) of n wires.

    Batcher odd-even mergesort on the next power of two; the +inf pad
    wires are constant-folded away (a compare against a known-inf wire
    is a value move, not an op), then the program is backward-pruned to
    the comparators that can reach the median output. Returns
    (ops, out_wire) where ops is a tuple of ('cmp'|'mov', a, b):
    cmp -> a, b = min(a, b), max(a, b); mov -> a = b.

    A sort along a length-81 axis is far more work than this network's
    few hundred fused min/max ops, which select the exact same median
    value.
    """
    n2 = 1 << (n - 1).bit_length()
    pairs = []

    def merge(lo, hi, r):  # hi inclusive; classic odd-even merge
        step = r * 2
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + r, hi, step)
            for i in range(lo + r, hi - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort_range(lo, hi):
        if hi - lo >= 1:
            mid = lo + (hi - lo) // 2
            sort_range(lo, mid)
            sort_range(mid + 1, hi)
            merge(lo, hi, 1)

    sort_range(0, n2 - 1)

    # constant-fold the pad wires (indices >= n start as +inf)
    inf = [w >= n for w in range(n2)]
    prog = []
    for a, b in pairs:  # a < b: a takes min, b takes max
        if inf[a] and inf[b]:
            continue
        if inf[b]:  # min lands on a (already there), b stays inf
            continue
        if inf[a]:  # real value at b moves down to a; b becomes inf
            prog.append(("mov", a, b))
            inf[a], inf[b] = False, True
        else:
            prog.append(("cmp", a, b))

    # backward prune to the median output wire
    needed = {n // 2}
    kept = []
    for op, a, b in reversed(prog):
        if op == "cmp":
            if a in needed or b in needed:
                needed.add(a)
                needed.add(b)
                kept.append((op, a, b))
        else:  # mov: post-op a = pre-op b
            if a in needed:
                needed.discard(a)
                needed.add(b)
                kept.append((op, a, b))
    return tuple(reversed(kept)), n // 2


def _median_select(planes):
    """Exact median of a list of same-shape arrays, elementwise."""
    ops, out = _median_network(len(planes))
    vals = {i: p for i, p in enumerate(planes)}
    for op, a, b in ops:
        if op == "cmp":
            va, vb = vals[a], vals[b]
            vals[a] = jnp.minimum(va, vb)
            vals[b] = jnp.maximum(va, vb)
        else:
            vals[a] = vals[b]
    return vals[out]


@functools.partial(jax.jit, static_argnames=("k",))
def median_filter_flow(mv: jnp.ndarray, k: int = 5) -> jnp.ndarray:
    """k x k per-component median filter of a [H, W, 2] (or batched
    [B, H, W, 2]) flow field.

    Per-pixel integer SAD matching is noisy (the reference never
    regularized it); a median between pyramid levels roughly HALVES the
    endpoint error on the Middlebury pair (7.6 -> 3.4 EPE at k=9).
    Selection runs on a pruned Batcher min/max network (_median_network)
    instead of jnp.sort - same median value, far less work.

    Inputs are assumed FINITE: the min/max comparator network propagates
    NaNs non-deterministically (jnp.minimum/maximum return NaN when
    either operand is NaN), unlike a sort, which places NaNs last and
    leaves the median of mostly-finite windows unaffected. Every
    in-package caller satisfies this (integer search outputs; the
    subpixel fit guards its denominators) - sanitize external flows
    (jnp.nan_to_num) before filtering.
    """
    mv = jnp.asarray(mv)
    if mv.ndim == 4:
        return jax.vmap(lambda m: median_filter_flow(m, k))(mv)
    h, w = mv.shape[:2]
    p = jnp.pad(mv, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
    planes = [
        jax.lax.slice(p, (i, j, 0), (i + h, j + w, 2))
        for i in range(k)
        for j in range(k)
    ]
    return _median_select(planes)


def _refine_2d_subpixel(gray0, gray1, flow, patch_size: int, costfn: str):
    h, w = gray0.shape
    pm = patch_size // 2
    ys, xs = jnp.mgrid[0:h, 0:w]
    ys = ys.astype(jnp.int32)
    xs = xs.astype(jnp.int32)
    iu = jnp.round(flow[..., 0]).astype(jnp.int32)
    iv = jnp.round(flow[..., 1]).astype(jnp.int32)
    f0 = gray0.astype(jnp.int32)

    def boxsum(d):
        p = jnp.pad(d, ((pm, pm), (0, 0)))
        a = jnp.zeros_like(d)
        for k in range(patch_size):
            a = a + jax.lax.slice(p, (k, 0), (k + h, w))
        p = jnp.pad(a, ((0, 0), (pm, pm)))
        o = jnp.zeros_like(d)
        for k in range(patch_size):
            o = o + jax.lax.slice(p, (0, k), (h, k + w))
        return o

    def cost(dy, dx):
        g = _gather_padded_u8(gray1, ys + iv + dy, xs + iu + dx)
        g = g.astype(jnp.int32)
        d = jnp.abs(f0 - g) if costfn == "sad" else (f0 - g) * (f0 - g)
        return boxsum(d).astype(jnp.float32)

    c0 = cost(0, 0)
    cxm, cxp = cost(0, -1), cost(0, 1)
    cym, cyp = cost(-1, 0), cost(1, 0)

    def delta(cm, cc, cp):
        if costfn == "sad":
            # SAD of a translated signal is V-shaped (piecewise linear),
            # not parabolic: the equiangular fit delta = (cm - cp) /
            # (2 (max(cm, cp) - c0)) recovers the V's vertex EXACTLY
            # (a parabola systematically underestimates it ~2x)
            d = (cm - cp) / jnp.maximum(
                2.0 * (jnp.maximum(cm, cp) - cc), 1e-12
            )
        else:  # ssd: quadratic near the minimum - parabola fit
            denom = cm + cp - 2.0 * cc
            d = jnp.where(
                denom > 0, (cm - cp) / jnp.maximum(2.0 * denom, 1e-12), 0.0
            )
        # only trust an interior minimum of the 1-D cost section
        d = jnp.where((cm >= cc) & (cp >= cc), d, 0.0)
        return jnp.clip(d, -0.5, 0.5)

    du = delta(cxm, c0, cxp)
    dv = delta(cym, c0, cyp)
    return jnp.stack([iu.astype(jnp.float32) + du, iv.astype(jnp.float32) + dv], axis=-1)


@functools.partial(jax.jit, static_argnames=("patch_size", "costfn"))
def refine_flow_subpixel(
    gray0: jnp.ndarray,
    gray1: jnp.ndarray,
    flow: jnp.ndarray,
    patch_size: int = 5,
    costfn: str = "sad",
) -> jnp.ndarray:
    """Subpixel flow refinement: parabola fit on the local cost surface.

    For each pixel, the patch cost is evaluated at the ROUNDED integer
    flow and its 4 axis neighbors (same zero-padded patch convention as
    the exact search), and a 1-D parabola per axis places the analytic
    minimum within [-0.5, 0.5] of the integer winner. Pixels whose
    integer flow is not an interior minimum of the sampled section keep
    their integer value. The warp is applied per pixel (each patch is
    compared at the CENTER pixel's displacement); wherever the flow is
    locally constant - almost everywhere after median smoothing - this
    equals the exact windowed cost.

    A quality extension over the reference, which emits integer flows
    only (me_pyramid.py:130-205). Accepts [H, W] or [B, H, W] frames
    with flow [..., H, W, 2]; returns round(flow) + subpixel offset.
    """
    if costfn not in ("sad", "ssd"):
        raise ValueError(f"subpixel refinement needs sad/ssd, got {costfn!r}")
    gray0 = jnp.asarray(gray0)
    gray1 = jnp.asarray(gray1)
    flow = jnp.asarray(flow)
    if gray0.ndim == 3:
        return jax.vmap(
            lambda a, b, f: _refine_2d_subpixel(a, b, f, patch_size, costfn)
        )(gray0, gray1, flow)
    return _refine_2d_subpixel(gray0, gray1, flow, patch_size, costfn)


def estimate_motion_pyramid(
    gray0: jnp.ndarray,
    gray1: jnp.ndarray,
    levels: int = 3,
    search_size: int = 15,
    patch_size: int = 5,
    seed_mode: str = "fixed",
    method: str = "exact",
    smooth: int = 0,
    warp_bound="auto",
    subpixel: int = 0,
    refine: str = "auto",
):
    """Coarse-to-fine driver (me_test.py:76-90): returns per-level flows,
    index 0 = coarsest, last = full resolution. Accepts [H, W] frames or
    batched [B, H, W] stacks (per-level flows come back [B, h, w, 2]) -
    batching amortizes the per-level dispatches for serving.

    Serving note: the driver can be wrapped in ``jax.jit`` - the whole
    pyramid then runs as ONE program and returns the same flow as the
    eager driver (the exact search has no seed bound to size).

    ``smooth`` > 0 median-filters each level's flow (kernel size
    ``smooth``) before seeding the next level and on the final output -
    a quality extension over the reference (see median_filter_flow).
    ``subpixel`` > 0 replaces that single median with ``subpixel``
    rounds of (equiangular subpixel refinement -> median smooth) per
    level (see refine_flow_subpixel) - an iterative median-regularized
    local descent on the cost surface. On the Middlebury pair it cuts
    the EPE a further ~35% over the integer+median flow (converged by
    ~12 rounds); each round costs 5 patch-cost maps + one median, far
    below the search itself. Rounds without an interleaved median
    measure WORSE than integer flow (the raw per-pixel fit is noisy) -
    hence the ``smooth`` kernel (default 5 when smooth == 0) is always
    applied inside the loop.

    ``warp_bound`` passes through to the fast mode (see
    estimate_motion_vector): the 'auto' default preserves seeds of any
    magnitude (the seed base is gather-warped once per level; only the
    bounded search residual uses masked shifts). An explicit int bound
    clamps each level's seed base once and warns when the upscaled
    flow actually saturates there.

    ``refine`` closes the fast mode's quality gap: the fast search's
    candidate costs read NEIGHBORS' displacements at window edges
    (_estimate_2d_fast docstring), which costs ~1.6 px EPE vs the exact
    search on Middlebury. 'auto' (the default, active for
    method='fast') runs the measured-best HYBRID schedule: the
    COARSEST level uses the unseeded exact search outright (it seeds
    everything downstream and is the cheapest level), and every later
    level runs the fast iteration followed by ONE seeded-EXACT pass
    around its median-smoothed flow. On Middlebury (smooth=9) this
    scores BETTER than the reference-faithful full-exact pyramid - EPE
    3.08 vs 3.44 (PARITY.md) - because the fast rounds' interleaved medians
    regularize the seeds the exact pass then searches around. With
    ``levels=1`` 'auto' stays pure fast (there is no cheap coarsest
    level to trade). 'exact' forces the same refinement passes for any
    method; 'none' disables refinement (pure fast).
    """
    from oclcomputervision_jax.ops.pyramid import gaussian_pyramid

    gray0 = jnp.asarray(gray0)
    gray1 = jnp.asarray(gray1)
    if gray0.ndim == 3:
        from oclcomputervision_jax.ops._layout import guard_batch_first

        guard_batch_first(gray0.shape, "estimate_motion_pyramid")
    batched = gray0.ndim == 3  # [B, H, W] luma stack
    pyr0 = gaussian_pyramid(gray0, 2, levels, batched=batched)
    pyr1 = gaussian_pyramid(gray1, 2, levels, batched=batched)
    if refine not in ("auto", "exact", "none"):
        raise ValueError(f"unknown refine mode {refine!r}")
    # 'auto' needs >= 2 levels: with a single level the "coarsest" IS
    # the full-resolution frame, and swapping the requested fast search
    # for a full-res unseeded exact one would silently cost orders of
    # magnitude (the single-level fast call is the documented serving
    # mode) - levels=1 'auto' stays pure fast.
    do_refine = refine == "exact" or (
        refine == "auto" and method == "fast" and levels > 1
    )
    flows = []
    seed = None
    for lv in range(levels):
        lv_method = method
        if do_refine and method == "fast" and lv == 0:
            # hybrid schedule: the coarsest level seeds everything and
            # is the cheapest - use the unseeded exact search outright
            lv_method = "exact"
        mv = estimate_motion_vector(
            pyr0[lv], pyr1[lv], search_size, patch_size, seed=seed,
            seed_mode=seed_mode, method=lv_method, warp_bound=warp_bound,
        )
        if do_refine and lv > 0:
            # one seeded-exact pass around the median-smoothed flow:
            # re-evaluates every pixel's 3x3x3-round search exactly
            # (the fast candidate costs read neighbors' displacements
            # at window edges; this removes that approximation). The
            # outlier tail is clipped to _REFINE_CLIP px first: such a
            # value in a fast flow is noise, and re-searching around the
            # cap beats keeping it.
            sk = smooth if smooth > 0 else 5
            rs = jnp.clip(median_filter_flow(mv, sk), -_REFINE_CLIP, _REFINE_CLIP)
            mv = estimate_motion_vector(
                pyr0[lv], pyr1[lv], search_size, patch_size,
                seed=rs, seed_mode="fixed", method="exact",
            )
        if subpixel > 0:
            sk = smooth if smooth > 0 else 5
            for _ in range(subpixel):
                mv = refine_flow_subpixel(pyr0[lv], pyr1[lv], mv, patch_size)
                mv = median_filter_flow(mv, sk)
            flows.append(mv)
            if lv + 1 < levels:
                seed = upscale_mv(mv, 2, mode=seed_mode)
        else:
            # ONE dispatch for (median smooth, next-level seed upscale):
            # eagerly, every separate jitted call is its own dispatch
            mv, nxt = _postprocess_level(
                mv, smooth, seed_mode, lv + 1 < levels
            )
            flows.append(mv)
            if nxt is not None:
                seed = nxt
    return flows


@functools.partial(jax.jit, static_argnames=("k", "mode", "upscale"))
def _postprocess_level(mv, k: int, mode: str, upscale: bool):
    """Fused per-level tail of estimate_motion_pyramid: optional median
    smooth + next-level seed upscale in ONE device dispatch."""
    if k > 0:
        mv = median_filter_flow(mv, k)
    return mv, (upscale_mv(mv, 2, mode=mode) if upscale else None)
