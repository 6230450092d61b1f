"""RAISR super-resolution inference.

Rebuild of the reference's fused mega-kernel (super_resolution/raisr.cl:108-338)
as one jitted batched pipeline:

  cheap bilinear upscale -> RGB->YUV -> Sobel gradients ->
  9x9 Gaussian-weighted structure tensor (separable) ->
  eigenanalysis -> (angle, strength, coherence, pixel-type) hash ->
  per-pixel filter select from the learned bank -> 11x11 filter -> RGB.

Everything up to the hash is elementwise work and small stencils that
XLA fuses. The per-pixel filter apply is the hot stage; on a GPU it runs
the Pallas kernel in ops/pallas/raisr_apply.py, elsewhere the plain
gather form ``apply_filters`` (``_apply_bank`` is the one dispatch).

Semantics match oracle/raisr.py (see its docstring for the
'shipped'/'full' fidelity discussion and reference bug list).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from oclcomputervision_jax.oracle import raisr as oracle_raisr
from oclcomputervision_jax.utils.config import RaisrConfig


def _correlate2d_valid(img: jnp.ndarray, kern_np: np.ndarray) -> jnp.ndarray:
    """'valid' correlation of [H, W] with a small constant kernel.

    Unrolled as k*k shifted FMAs: cheaper than a real conv dispatch for
    3x3, and XLA fuses the whole stencil.
    """
    kh, kw = kern_np.shape
    h = img.shape[0] - kh + 1
    w = img.shape[1] - kw + 1
    out = jnp.zeros((h, w), img.dtype)
    for i in range(kh):
        for j in range(kw):
            if kern_np[i, j] != 0.0:
                out = out + jnp.float32(kern_np[i, j]) * jax.lax.slice(
                    img, (i, j), (i + h, j + w)
                )
    return out


def _gauss_blur_valid(img: jnp.ndarray, k1d: np.ndarray) -> jnp.ndarray:
    """Separable 'valid' blur with a 1D kernel (structure-tensor window)."""
    k = k1d.shape[0]
    h = img.shape[0] - k + 1
    out = jnp.zeros((h, img.shape[1]), img.dtype)
    for i in range(k):
        out = out + jnp.float32(k1d[i]) * jax.lax.slice(img, (i, 0), (i + h, img.shape[1]))
    w = img.shape[1] - k + 1
    out2 = jnp.zeros((h, w), img.dtype)
    for j in range(k):
        out2 = out2 + jnp.float32(k1d[j]) * jax.lax.slice(out, (0, j), (h, j + w))
    return out2


def _blur_k1(cfg: RaisrConfig) -> np.ndarray:
    """1D factor of the separable structure-tensor Gaussian window."""
    g = cfg.gauss_len // 2
    w2d = oracle_raisr.gaussian2d((cfg.gauss_len, cfg.gauss_len), cfg.gauss_sigma)
    return w2d[g] / np.sqrt(w2d[g, g])


def _eigen_bucket(a, b, d, cfg: RaisrConfig):
    """Structure tensor (a, b; b, d) -> (angle, strength, coherence)
    indices, elementwise on arrays of any shape."""
    t = a + d
    det = a * d - b * b
    disc = jnp.sqrt(jnp.maximum(t * t / 4.0 - det, 0.0))
    l1 = t / 2.0 + disc
    l2 = t / 2.0 - disc

    theta = jnp.arctan2(b, l1 - d)
    theta = jnp.where(theta < 0, theta + jnp.pi, theta)

    sq1 = jnp.sqrt(jnp.maximum(l1, 0.0))
    sq2 = jnp.sqrt(jnp.maximum(l2, 0.0))
    denom = sq1 + sq2
    coherence = jnp.where(denom != 0, (sq1 - sq2) / jnp.where(denom == 0, 1.0, denom), 0.0)

    angle_idx = jnp.clip(
        (theta / jnp.pi * cfg.num_angle).astype(jnp.int32), 0, cfg.num_angle - 1
    )
    sq = jnp.asarray(cfg.strength_quantizers, jnp.float32)
    strength_idx = jnp.sum(l1[..., None] >= sq, axis=-1).astype(jnp.int32)
    cq = jnp.asarray(cfg.coherence_quantizers, jnp.float32)
    coherence_idx = jnp.sum(coherence[..., None] >= cq, axis=-1).astype(jnp.int32)
    return angle_idx, strength_idx, coherence_idx


def hash_components(up_y: jnp.ndarray, cfg: RaisrConfig):
    """Per-pixel (angle_idx, strength_idx, coherence_idx), each [H, W] int32."""
    g = cfg.gauss_len // 2
    pad = g + 1
    y = jnp.pad(up_y.astype(jnp.float32), pad, mode="edge")
    gx = _correlate2d_valid(y, oracle_raisr.SOBEL_X)
    gy = _correlate2d_valid(y, oracle_raisr.SOBEL_Y)

    k1 = _blur_k1(cfg)
    a = _gauss_blur_valid(gx * gx, k1)
    b = _gauss_blur_valid(gx * gy, k1)
    d = _gauss_blur_valid(gy * gy, k1)
    return _eigen_bucket(a, b, d, cfg)


def hash_image(up_y: jnp.ndarray, cfg: RaisrConfig) -> jnp.ndarray:
    """Per-pixel (angle, strength, coherence) bucket [H, W] int32.

    The sigma=2 9x9 Gaussian of the reference (raisr.py:80-82) is
    separable to fp precision; we blur gx^2/gxgy/gy^2 with the 1D factor
    on each axis (identical weights, fewer FLOPs than the reference's
    81-tap accumulation, raisr.cl:265-275).
    """
    angle_idx, strength_idx, coherence_idx = hash_components(up_y, cfg)
    return (angle_idx * cfg.num_strength + strength_idx) * cfg.num_coherence + coherence_idx


def pixel_type_map(h: int, w: int, scale: int) -> jnp.ndarray:
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return (yy % scale) * scale + (xx % scale)


def apply_filters(
    up: jnp.ndarray, fidx: jnp.ndarray, filters: jnp.ndarray, cfg: RaisrConfig
) -> jnp.ndarray:
    """out[p] = sum_q filters[fidx[p], q] * up[p + q - m], all channels."""
    fl = cfg.filter_len
    m = fl // 2
    squeeze = up.ndim == 2
    x = up[..., None] if squeeze else up
    h, w = x.shape[:2]
    xp = jnp.pad(x, ((m, m), (m, m), (0, 0)), mode="edge")
    sel = jnp.take(filters.reshape(-1, fl * fl), fidx.reshape(-1), axis=0).reshape(
        h, w, fl * fl
    )
    out = jnp.zeros_like(x)
    for i in range(fl):
        for j in range(fl):
            out = out + sel[:, :, i * fl + j, None] * jax.lax.slice(
                xp, (i, j, 0), (i + h, j + w, x.shape[2])
            )
    return out[..., 0] if squeeze else out


def ct_blend_weights(up_y: jnp.ndarray) -> jnp.ndarray:
    """Census-transform structure weights [..., H, W] in [0, 1]
    (oracle/raisr.ct_blend_weights twin; RAISR paper §V blending -
    w = clip((8 - LCC)/6, 0, 1) from the 3x3 census ring of the
    cheap-upscaled luma, edge-replicated borders)."""
    nd = up_y.ndim
    pad = [(0, 0)] * (nd - 2) + [(1, 1), (1, 1)]
    xp = jnp.pad(up_y, pad, mode="edge")
    h, w = up_y.shape[-2], up_y.shape[-1]
    lead = (0,) * (nd - 2)
    bits = [
        jax.lax.slice(
            xp, lead + (1 + dr, 1 + dc), up_y.shape[:-2] + (1 + dr + h, 1 + dc + w)
        )
        >= up_y
        for dr, dc in oracle_raisr.CT_RING
    ]
    lcc = sum(
        (bits[k] != bits[(k + 1) % 8]).astype(jnp.float32) for k in range(8)
    )
    return jnp.clip((8.0 - lcc) / 6.0, 0.0, 1.0)



def apply_filters_batched(yuv, bucket, filters, cfg: RaisrConfig) -> jnp.ndarray:
    """Plain per-pixel filter apply of [B, H, W, C] by hash bucket
    [B, H, W]: the gather form ``apply_filters`` per image (the
    reference the GPU kernel is compared with)."""
    h, w = yuv.shape[1:3]
    fidx = bucket * cfg.num_pixel_type + pixel_type_map(h, w, cfg.scale)
    return jax.vmap(lambda u, f: apply_filters(u, f, filters, cfg))(yuv, fidx)


def _apply_bank(yuv, bucket, filters, cfg: RaisrConfig) -> jnp.ndarray:
    """The one place the apply form is chosen: the Triton kernel on a
    GPU, the plain gather form elsewhere. A kernel failure raises; there
    is no silent fallback."""
    if jax.default_backend() == "gpu":
        from oclcomputervision_jax.ops.pallas.raisr_apply import (
            apply_filters_pallas,
        )

        return apply_filters_pallas(yuv, bucket, filters, cfg)
    return apply_filters_batched(yuv, bucket, filters, cfg)


def _csc(img, mat) -> jnp.ndarray:
    """3x3 color-space conversion of [..., 3] or [..., 4] channels.

    The reference uses 4x4 CSC matrices whose alpha row is identity
    (raisr.py:20-33), so a BGRA input's alpha channel passes through the
    conversion untouched - and then receives the same per-pixel learned
    filter as the YUV channels (raisr.cl:322-331's half4 FMA). Full f32
    precision: a TF32 product would cost up to ~1/3 of a uint8 level.
    """
    m = jnp.asarray(mat, jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    if img.shape[-1] == 4:
        return jnp.concatenate(
            [jnp.matmul(img[..., :3], m, precision=hi), img[..., 3:]], axis=-1
        )
    return jnp.matmul(img, m, precision=hi)


def _raisr_post(up, filters, cfg: RaisrConfig, gray: bool):
    """Pipeline after the cheap upscale: YUV -> hash -> filter -> uint8.

    ``up`` is the bilinear-upscaled float image in [0, 1], [B, H, W, C]
    (C=1 for gray). Split out so the spatially-sharded path
    (parallel/mesh.py) can feed a shard-local upscale computed at
    global coordinates.
    """
    yuv = up if gray else _csc(up, oracle_raisr.RGB2YUV.T)

    if cfg.fidelity == "shipped":
        out = yuv if gray else _csc(yuv, oracle_raisr.YUV2RGB.T)
    else:
        ai, si, ci = jax.vmap(lambda y: hash_components(y, cfg))(yuv[..., 0])
        bucket = (ai * cfg.num_strength + si) * cfg.num_coherence + ci
        filtered = _apply_bank(yuv, bucket, filters, cfg)
        if cfg.blend == "ct":
            wgt = ct_blend_weights(yuv[..., 0])[..., None]
            filtered = wgt * filtered + (1.0 - wgt) * yuv
        out = filtered if gray else _csc(filtered, oracle_raisr.YUV2RGB.T)

    out = jnp.clip(jnp.round(out * 255.0), 0, 255).astype(jnp.uint8)
    return out[..., 0] if gray else out


@functools.partial(jax.jit, static_argnames=("cfg", "gray"))
def _raisr_batched(imgs_u8, filters, cfg: RaisrConfig, gray: bool):
    """uint8 [B, H, W] (gray) or [B, H, W, C] in, uint8 [B, sH, sW(, C)] out."""
    from oclcomputervision_jax.ops.interpolation import _resize_plane

    x01 = imgs_u8.astype(jnp.float32) / 255.0
    h, w = x01.shape[1:3]
    x = x01[..., None] if gray else x01
    up = jax.vmap(
        lambda im: _resize_plane(im, (h * cfg.scale, w * cfg.scale), "bilinear")
    )(x)
    return _raisr_post(up, filters, cfg, gray)


def raisr_upsample(
    img: jnp.ndarray, filters: jnp.ndarray | None, cfg: RaisrConfig = RaisrConfig()
) -> jnp.ndarray:
    """RAISR upsample of uint8 [H, W], [H, W, 3/4], or batched [B, ...]."""
    img = jnp.asarray(img)
    if filters is None:
        filters = jnp.zeros((cfg.num_filters, cfg.filter_len, cfg.filter_len), jnp.float32)
    filters = jnp.asarray(filters, jnp.float32)
    gray = img.ndim == 2 or (img.ndim == 3 and img.shape[-1] not in (3, 4))
    single = img.ndim == 2 or (img.ndim == 3 and not gray)
    if single:
        return _raisr_batched(img[None], filters, cfg, gray)[0]
    return _raisr_batched(img, filters, cfg, gray)
