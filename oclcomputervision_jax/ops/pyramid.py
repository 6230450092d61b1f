"""Gaussian pyramid.

cv2.pyrDown (the reference's only pyramid primitive, pyramid/pyramid.py:12)
is a 5x5 binomial blur + 2x decimation. The scale-2 path deinterleaves
rows/cols into parity planes ONCE and blends them with shifted FMAs
(separable 5-tap = 3 even + 2 odd planes per axis), bit-identical to the
strided form. Other scales use a strided conv.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

_K1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
_K2D = np.outer(_K1D, _K1D)  # separable binomial, same as cv2.pyrDown


def _pyr_down_2x_plane(x: jnp.ndarray) -> jnp.ndarray:
    """One level at scale 2: [H, W] float32 -> [H//2, W//2].

    Parity-plane shift-adds: taps at even offsets {-2, 0, +2} read the
    even-row plane, odd offsets {-1, +1} the odd plane, so the stride-2
    decimation is one deinterleave per axis instead of 25 strided taps.
    """
    k0, k1, k2 = (jnp.float32(_K1D[0]), jnp.float32(_K1D[1]), jnp.float32(_K1D[2]))
    n, m = x.shape[0] // 2, x.shape[1] // 2
    xp = jnp.pad(x, ((2, 2), (2, 2)), mode="reflect")  # reflect-101, cv2 default
    # out row i covers xp rows 2i..2i+4: even plane taps i, i+1, i+2 and
    # odd plane taps i, i+1 (explicit :n slices keep odd sizes correct)
    e, o = xp[0::2], xp[1::2]
    v = k0 * (e[:n] + e[2 : n + 2]) + k2 * e[1 : n + 1] + k1 * (o[:n] + o[1 : n + 1])
    ve, vo = v[:, 0::2], v[:, 1::2]
    return (
        k0 * (ve[:, :m] + ve[:, 2 : m + 2])
        + k2 * ve[:, 1 : m + 1]
        + k1 * (vo[:, :m] + vo[:, 1 : m + 1])
    )


@functools.partial(jax.jit, static_argnames=("scale",))
def _pyr_down_f32(img: jnp.ndarray, scale: int) -> jnp.ndarray:
    """One level: [H, W, C] float32 -> [H//scale, W//scale, C]."""
    h, w, c = img.shape
    if scale == 2:
        return jnp.stack(
            [_pyr_down_2x_plane(img[..., ch]) for ch in range(c)], axis=-1
        )
    # reflect-101 padding (cv2's default border for pyrDown)
    x = jnp.pad(img, ((2, 2), (2, 2), (0, 0)), mode="reflect")
    x = x[None]  # NHWC
    kern = jnp.asarray(_K2D)[:, :, None, None] * jnp.eye(c, dtype=jnp.float32)[None, None]
    out = jax.lax.conv_general_dilated(
        x,
        kern,
        window_strides=(scale, scale),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        # full f32 products: TF32 would move taps by ~1e-3 relative
        precision=jax.lax.Precision.HIGHEST,
    )[0]
    return out[: h // scale, : w // scale]


def pyr_down(img: jnp.ndarray, scale: int = 2, batched=None) -> jnp.ndarray:
    """Blur + decimate one level; uint8 in -> uint8 out (round-to-nearest).

    Accepts [H, W], [H, W, C], [B, H, W], or [B, H, W, C]. Rank-3
    layout: ``batched=None`` (default) reads a trailing dim <= 4 as
    channels and raises on anything wider; True forces [B, H, W],
    False forces [H, W, C] (ops/_layout.py).
    """
    from oclcomputervision_jax.ops._layout import rank3_is_batched

    img = jnp.asarray(img)
    if img.ndim == 3 and rank3_is_batched(img.shape, batched, "pyr_down"):
        return jax.vmap(lambda x: pyr_down(x, scale, batched=False))(img)
    if img.ndim == 4:
        return jax.vmap(lambda x: pyr_down(x, scale, batched=False))(img)
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    is_int = jnp.issubdtype(img.dtype, jnp.integer)
    out = _pyr_down_f32(x.astype(jnp.float32), scale)
    if is_int:
        out = jnp.clip(jnp.round(out), 0, 255).astype(img.dtype)
    else:
        out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out


def gaussian_pyramid(
    img: jnp.ndarray, scale: int = 2, depth: int = 3, batched=None
) -> List[jnp.ndarray]:
    """List of ``depth`` levels, index 0 = COARSEST (pyramid.py:9-14).

    ``batched`` disambiguates rank-3 inputs exactly as in pyr_down.
    """
    img = jnp.asarray(img)
    if img.ndim == 3:
        from oclcomputervision_jax.ops._layout import rank3_is_batched

        # resolve once so every level below is unambiguous
        batched = rank3_is_batched(img.shape, batched, "gaussian_pyramid")
    pyramid = [img]
    src = pyramid[0]
    for _ in range(depth - 1):
        src = pyr_down(src, scale, batched=batched)
        pyramid.insert(0, src)
    return pyramid
