"""RAISR per-pixel filter apply for Hopper GPUs (Pallas through Triton).

For every output pixel p the learned filter of its hash bucket is
applied to the 11x11 neighbourhood of the cheap upscale
(super_resolution/raisr.cl:318-331):

    out[c, p] = sum_q bank[fidx(p), q] * up[c, p + q - m]
    fidx(p)   = bucket(p) * scale^2 + pixel_type(p)

One program computes a BLOCK_H x BLOCK_W output tile of one image. It
reads the tile's bucket ids once, derives the pixel type from the tile
coordinates, and for each of the fl*fl taps gathers that tap's
coefficient per pixel from the transposed bank [fl*fl, num_filters]
(a tap's coefficients are contiguous, so one warp's gather touches a
few cache lines; the whole bank, 418 KB at x2, stays in L2) and loads
the shifted input tile (the tile plus its halo stays in L1 across the
taps). Channels share the coefficient gather. Accumulation is float32
in the plain form's tap order (ops.raisr.apply_filters), so only FMA
contraction separates the two.

The plain forms do far more work: apply_filters materialises a
[H, W, fl*fl] float32 gather (484 B per output pixel at fl=11). This
kernel reads the input once per tap from cache and writes each output
once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from oclcomputervision_jax.utils.config import RaisrConfig

BLOCK_H = 16
BLOCK_W = 64
NUM_WARPS = 8


def _make_kernel(fl: int, s: int, nchan: int):
    npt = s * s

    def kernel(x_ref, bucket_ref, bank_ref, out_ref):
        b = pl.program_id(0)
        r0 = pl.program_id(1) * BLOCK_H
        c0 = pl.program_id(2) * BLOCK_W
        rows = r0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_H, BLOCK_W), 0)
        cols = c0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_H, BLOCK_W), 1)
        bucket = bucket_ref[b, pl.ds(r0, BLOCK_H), pl.ds(c0, BLOCK_W)]
        fidx = bucket * npt + (rows % s) * s + cols % s
        acc = [jnp.zeros((BLOCK_H, BLOCK_W), jnp.float32) for _ in range(nchan)]
        for ti in range(fl):
            for tj in range(fl):
                coef = bank_ref[ti * fl + tj, fidx]
                for c in range(nchan):
                    acc[c] = acc[c] + coef * x_ref[
                        b, c, pl.ds(r0 + ti, BLOCK_H), pl.ds(c0 + tj, BLOCK_W)
                    ]
        for c in range(nchan):
            out_ref[b, c, pl.ds(r0, BLOCK_H), pl.ds(c0, BLOCK_W)] = acc[c]

    return kernel


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def apply_filters_pallas(
    up: jnp.ndarray,
    bucket: jnp.ndarray,
    filters: jnp.ndarray,
    cfg: RaisrConfig,
    interpret: bool = False,
) -> jnp.ndarray:
    """Filter ``up`` [B, H, W, C] float32 with the bank's per-pixel filter.

    ``bucket`` [B, H, W] int32 holds hash buckets in
    [0, num_angle * num_strength * num_coherence); ``filters`` is the
    [num_filters, fl, fl] bank. Returns [B, H, W, C] float32. Borders
    replicate the edge pixel, as in ops.raisr.apply_filters.
    """
    b, h, w, nchan = up.shape
    fl = cfg.filter_len
    m = fl // 2
    hp = -(-h // BLOCK_H) * BLOCK_H
    wp = -(-w // BLOCK_W) * BLOCK_W
    # planar channels with the filter halo plus tile padding, so every
    # tap load of every tile is in bounds
    x = jnp.pad(
        jnp.moveaxis(up.astype(jnp.float32), -1, 1),
        ((0, 0), (0, 0), (m, m + hp - h), (m, m + wp - w)),
        mode="edge",
    )
    bk = jnp.pad(bucket.astype(jnp.int32), ((0, 0), (0, hp - h), (0, wp - w)))
    bank_t = filters.reshape(-1, fl * fl).astype(jnp.float32).T
    out = pl.pallas_call(
        _make_kernel(fl, cfg.scale, nchan),
        grid=(b, hp // BLOCK_H, wp // BLOCK_W),
        out_shape=jax.ShapeDtypeStruct((b, nchan, hp, wp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="raisr_apply",
    )(x, bk, bank_t)
    return jnp.moveaxis(out[:, :, :h, :w], 1, -1)
