"""Histogram equalization (global + local-block).

Replaces the reference's three-dispatch device->host->device pipeline
(histeq/eq_opencl.py histGrid -> CPU calc_transfer_func -> histeqGlobal,
SURVEY.md §3.1) with ONE jitted function per op: tiled histogram ->
transfer-function LUT -> LUT gather, all resident on device.

Design notes:
- Histograms are built from hi/lo nibble one-hots contracted by a
  matmul (in place of hist.cl:69-75's per-thread LDS histogram). The
  products are 0/1 and the sums are counts below 2^24, so the result is
  exact at any matmul precision, TF32 included.
- The transfer function (eq_global.py:10-37 semantics) is 256-wide
  vector math, computed in float32 natively batched over blocks - the
  fusion the reference left as a TODO (eq_local_block.py:20).
- LUT application is gather-free (nibble matmul + 16-wide row dot);
  the local-block variant blends the 4 nearest block LUTs bilinearly
  (hist.cl:104-147 semantics) over half-block-aligned tiles.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def _nibble_onehots(x: jnp.ndarray):
    """Split uint8 pixels into hi/lo nibble one-hots ([..., 16] bf16 each).

    The nibble decomposition is the workhorse of every 256-entry table
    op here: v = 16*hi + lo turns one-hot-256 work (256 compares per
    pixel) into two one-hot-16s (32 compares) whose outer product a
    matmul contracts, with exact results.
    """
    nib = jnp.arange(16, dtype=jnp.uint8)
    hi1 = ((x >> 4)[..., None] == nib).astype(jnp.bfloat16)
    lo1 = ((x & 15)[..., None] == nib).astype(jnp.bfloat16)
    return hi1, lo1


def histogram256(x: jnp.ndarray, dtype=jnp.int32) -> jnp.ndarray:
    """Histogram of uint8 values along the last axis: [..., N] -> [..., 256].

    hist[16h+l] = sum_p hi1[p,h] * lo1[p,l]: one [16, N] @ [N, 16]
    matmul per histogram instead of a 256-wide compare sweep. Exact at
    any precision: 0/1 products accumulate in fp32 (counts < 2^24).
    """
    hi1, lo1 = _nibble_onehots(x)
    hl = jnp.einsum("...nh,...nl->...hl", hi1, lo1, preferred_element_type=jnp.float32)
    return hl.reshape(hl.shape[:-2] + (256,)).astype(dtype)


def hist_grid(gray: jnp.ndarray, tile: Tuple[int, int] = (32, 256)) -> jnp.ndarray:
    """Per-tile histogram grid [H//th, W//tw, 256] (hist.cl:41-90 layout).

    Tile defaults to the reference's workgroup coverage (32 rows x 256
    cols, eq_opencl.py:43-44); unlike the reference, any tile shape that
    divides the image is accepted.
    """
    th, tw = tile
    h, w = gray.shape
    if h % th or w % tw:
        raise ValueError(f"image {gray.shape} not divisible by tile {tile}")
    gh, gw = h // th, w // tw
    tiles = gray.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3).reshape(gh, gw, th * tw)
    return histogram256(tiles)


def calc_transfer_func(
    hist: jnp.ndarray, alpha: float, punch: float, clip: float
) -> jnp.ndarray:
    """256-entry float32 transfer LUT(s); batched over leading dims.

    Vectorized equivalent of eq_global.py:10-37: CDF -> punch requantize
    -> alpha-blend with identity -> clip [0,255] -> gain limit
    [I/clip, I*clip]. hist: [..., 256] -> LUT: [..., 256].
    """
    hist = hist.astype(jnp.float32)
    n = hist.shape[-1]
    idx = jnp.arange(n, dtype=jnp.float32)

    cdf = jnp.cumsum(hist, axis=-1) / jnp.sum(hist, axis=-1, keepdims=True)

    dark = jnp.argmax(cdf >= punch, axis=-1)[..., None].astype(jnp.float32)
    bright = jnp.argmax(cdf >= 1.0 - punch, axis=-1)[..., None].astype(jnp.float32)

    in_punch = (idx >= dark) & (idx < bright)
    hp = jnp.where(in_punch, hist, 0.0)
    cdf_punched = jnp.cumsum(hp, axis=-1) / jnp.sum(hp, axis=-1, keepdims=True)
    cdf = jnp.where(idx < dark, 0.0, jnp.where(idx >= bright, 1.0, cdf_punched))

    mapping = alpha * cdf * 255.0 + (1.0 - alpha) * idx
    mapping = jnp.clip(mapping, 0.0, 255.0)
    mapping = jnp.clip(mapping, idx / clip, idx * clip)
    return mapping


def clip_histogram(hist: jnp.ndarray, clip_limit: float) -> jnp.ndarray:
    """CLAHE contrast limiting (batched over leading dims): cap bins at
    clip_limit * mean-count, redistribute the excess uniformly."""
    hist = hist.astype(jnp.float32)
    n = hist.shape[-1]
    limit = clip_limit * jnp.sum(hist, axis=-1, keepdims=True) / n
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=-1, keepdims=True)
    return clipped + excess / n


def apply_lut(gray: jnp.ndarray, lut: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel LUT apply: out[p] = lut[gray[p]] (hist.cl:92-102).

    Gather-free nibble form: lut[v] = sum_h hi1[h] * (lo1 @ L^T)[h] with
    L[h, l] = lut[16h+l]. The inner contraction is a [N, 16] @ [16, 16]
    matmul; the outer is a 16-wide row dot. Each row has exactly one
    nonzero product, so integer-valued uint8 LUTs (values <= 255 are
    exact in bf16 and TF32) are exact at any precision; float32 LUTs
    ask for full f32 products.
    """
    hi1, lo1 = _nibble_onehots(gray)
    table = lut.reshape(16, 16)
    precision = None
    if lut.dtype == jnp.uint8:
        table = table.astype(jnp.bfloat16)
    else:
        precision = jax.lax.Precision.HIGHEST
    inner = jnp.einsum(
        "...l,hl->...h", lo1, table, precision=precision,
        preferred_element_type=jnp.float32,
    )
    out = jnp.einsum(
        "...h,...h->...",
        hi1.astype(jnp.float32),
        inner,
        precision=precision,
        preferred_element_type=jnp.float32,
    )
    return out.astype(lut.dtype)


@functools.partial(jax.jit, static_argnames=("alpha", "punch", "clip"))
def _histeq_global_2d(gray, alpha, punch, clip):
    hist = histogram256(gray.reshape(-1))
    lut = calc_transfer_func(hist, alpha, punch, clip).astype(jnp.uint8)
    return apply_lut(gray, lut)


def histeq_global(
    gray: jnp.ndarray, alpha: float = 1.0, punch: float = 0.05, clip: float = 2.0
) -> jnp.ndarray:
    """Global histogram equalization of uint8 [H, W] or [B, H, W].

    Single fused jitted op (vs the reference's 2 device dispatches + CPU
    stage, eq_global.py:39-62). Defaults match eq_global.py:39.

    Rank-3 inputs are BATCH-FIRST luma stacks; a channels-last-looking
    [H, W, C<=4] input raises (ops/_layout.py) - equalize the Y channel
    of color images, as the reference demo does (histeq_test.py:120-130).
    """
    gray = jnp.asarray(gray)
    if gray.ndim == 3:
        from oclcomputervision_jax.ops._layout import guard_batch_first

        guard_batch_first(gray.shape, "histeq_global")
    if gray.ndim == 3:
        return jax.vmap(lambda g: _histeq_global_2d(g, alpha, punch, clip))(gray)
    return _histeq_global_2d(gray, alpha, punch, clip)


def block_mappings(
    gray: jnp.ndarray,
    alpha: float,
    punch: float,
    clip: float,
    blockshape: Tuple[int, int],
    clahe_clip: float = 0.0,
) -> jnp.ndarray:
    """Per-block transfer LUTs [nby, nbx, 256], built entirely on device.

    Fuses what the reference did in a Python double loop on host
    (eq_local_block.py:22-27) into one batched calc_transfer_func.
    ``clahe_clip`` > 0 applies CLAHE contrast limiting per block first.
    """
    grid = hist_grid(gray, tile=blockshape)
    if clahe_clip > 0:
        grid = clip_histogram(grid, clahe_clip)
    return calc_transfer_func(grid, alpha, punch, clip)


def apply_block_mappings(
    gray: jnp.ndarray, mappings: jnp.ndarray, blockshape: Tuple[int, int]
) -> jnp.ndarray:
    """Bilinear blend of the 4 nearest block LUTs (hist.cl:104-147).

    Semantics: trunc-toward-zero block indexing from block centers, s/t
    clamped to [0, 1], edge blocks clamped, float32 blend, truncating
    uint8 cast - numerically identical to the reference kernel.

    Formulation: pad the image by a half block so every pixel lands
    in a full (bh, bw) tile whose 4 neighbor LUTs are CONSTANT (block
    neighborhoods only change at half-block boundaries; clamping at the
    borders becomes edge-replication of the LUT grid - where the
    replicated rows coincide, the blend weight cancels exactly). Each
    corner LUT is then applied with the gather-free nibble contraction
    (batched [bh*bw, 16] @ [16, 16] matmuls per tile) and blended
    with the in-tile (s, t) ramps.
    """
    nby, nbx = mappings.shape[:2]
    bh, bw = blockshape
    h, w = gray.shape
    nty = nby + 1
    pad_top = bh // 2
    band = jnp.pad(gray, ((pad_top, nty * bh - h - pad_top), (0, 0)))
    out = apply_block_mappings_band(band, mappings, blockshape, 0, w)
    return out[pad_top : pad_top + h]


def apply_block_mappings_band(
    band: jnp.ndarray,
    mappings: jnp.ndarray,
    blockshape: Tuple[int, int],
    ty0: int,
    w: int,
) -> jnp.ndarray:
    """Blend a blend-tile-aligned row band against the global LUT grid.

    ``band`` [nty_loc*bh, w] holds PADDED rows [ty0*bh, (ty0+nty_loc)*bh)
    of the half-block-shifted image (padded row = image row + bh//2,
    out-of-image rows zero); ``mappings`` is the full [nby, nbx, 256]
    grid. Returns the blended uint8 band (same rows). ty0 > 0 is the
    row-sharded entry point (parallel.histeq_local_sharded); the
    single-device path passes the whole padded image with ty0 = 0.
    """
    nby, nbx = mappings.shape[:2]
    bh, bw = blockshape
    ntx = nbx + 1
    nty_loc = band.shape[0] // bh

    pad_left = bw // 2
    g = jnp.pad(band, ((0, 0), (pad_left, ntx * bw - w - pad_left)))
    tiles = g.reshape(nty_loc, bh, ntx, bw)
    hi1, lo1 = _nibble_onehots(tiles)  # [nty_loc, bh, ntx, bw, 16]

    # padded LUT grid with edge replication: P[k] = M[clip(k-1, 0, n-1)],
    # rows rebased to this band's global tile range
    py = jnp.clip(ty0 + jnp.arange(nty_loc + 1) - 1, 0, nby - 1)
    px = jnp.clip(jnp.arange(ntx + 1) - 1, 0, nbx - 1)
    p_grid = (
        mappings[py][:, px].reshape(nty_loc + 1, ntx + 1, 16, 16).astype(jnp.float32)
    )

    def corner_val(l_tbl):
        # l_tbl: [nty_loc, ntx, 16, 16] fractional LUT values; the one-hot
        # contraction is exact only with full f32 products (not TF32)
        hi = jax.lax.Precision.HIGHEST
        inner = jnp.einsum(
            "yixjl,yxhl->yixjh", lo1, l_tbl, precision=hi,
            preferred_element_type=jnp.float32,
        )
        return jnp.einsum(
            "yixjh,yixjh->yixj",
            hi1.astype(jnp.float32),
            inner,
            precision=hi,
            preferred_element_type=jnp.float32,
        )

    v00 = corner_val(p_grid[:-1, :-1])
    v01 = corner_val(p_grid[:-1, 1:])
    v10 = corner_val(p_grid[1:, :-1])
    v11 = corner_val(p_grid[1:, 1:])

    t = (jnp.arange(bh, dtype=jnp.float32) / bh)[None, :, None, None]
    s = (jnp.arange(bw, dtype=jnp.float32) / bw)[None, None, None, :]
    out = (
        (1 - s) * (1 - t) * v00
        + s * (1 - t) * v01
        + (1 - s) * t * v10
        + s * t * v11
    )
    out = out.reshape(nty_loc * bh, ntx * bw)[:, pad_left : pad_left + w]
    return jnp.clip(out, 0.0, 255.0).astype(jnp.uint8)


@functools.partial(
    jax.jit, static_argnames=("alpha", "punch", "clip", "blockshape", "clahe_clip")
)
def _histeq_local_2d(gray, alpha, punch, clip, blockshape, clahe_clip=0.0):
    mappings = block_mappings(gray, alpha, punch, clip, blockshape, clahe_clip)
    return apply_block_mappings(gray, mappings, blockshape)


def histeq_local_block(
    gray: jnp.ndarray,
    alpha: float = 0.5,
    punch: float = 0.05,
    clip: float = 3.0,
    blockshape: Tuple[int, int] = (256, 256),
    clahe_clip: float = 0.0,
) -> jnp.ndarray:
    """Local-block (CLAHE-style) histeq of uint8 [H, W] or [B, H, W].

    One fused jitted op: per-block histograms -> batched transfer LUTs ->
    bilinear 4-LUT blend (the on-chip pipeline the reference TODO'd at
    eq_local_block.py:20). Defaults match eq_local_block.py:10. Unlike
    the reference GPU path (hardcoded to 256x256 blocks via the 8-cell
    aggregation, eq_local_block.py:24-26), any block shape dividing the
    image works.
    """
    gray = jnp.asarray(gray)
    if gray.ndim == 3:
        from oclcomputervision_jax.ops._layout import guard_batch_first

        guard_batch_first(gray.shape, "histeq_local_block")
    bs = tuple(blockshape)
    if gray.ndim == 3:
        return jax.vmap(
            lambda g: _histeq_local_2d(g, alpha, punch, clip, bs, clahe_clip)
        )(gray)
    return _histeq_local_2d(gray, alpha, punch, clip, bs, clahe_clip)
