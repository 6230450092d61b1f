"""Align-corners bilinear/bicubic interpolation.

Separable resize: out = Wy @ img @ Wx^T, realized as two static-index
row-gather + weighted-sum passes. Because output/input sizes are static
under jit, the tap indices and weights are compile-time constants - XLA
lowers the gathers to contiguous row copies and fuses the tap blend, so
there is no dynamic gather on the hot path. Semantics match the reference's explicit LDS kernels
(basic/interpolation.cl:17-70, 132-211): align-corners mapping,
clamp-to-edge, Catmull-Rom a=-0.5 (cubic_matrix, interpolation.cl:73-78),
bicubic output clamped to the valid range (interpolation.cl:128).

``mapping`` selects the coordinate convention: "align_corners"
(default, the LDS kernels), "hw_sampler" (the reference's
bilinear_simple: align-corners normalized coordinate through the HW
sampler's implicit -0.5 texel offset, interpolation.cl:11-13 - NOT
bit-identical to the LDS variant, SURVEY.md fidelity note 11), or
"half_pixel" (cv2.INTER_LINEAR pixel centers).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from oclcomputervision_jax.oracle.interpolation import axis_weights


def _resize_plane(
    img: jnp.ndarray,
    out_hw: Tuple[int, int],
    method: str,
    mapping: str = "align_corners",
) -> jnp.ndarray:
    """Resize float [H, W, C] -> [h_out, w_out, C]; taps are constants."""
    h_in, w_in = img.shape[:2]
    h_out, w_out = out_hw

    yidx_np, yw_np = axis_weights(h_out, h_in, method, dtype=np.float32, mapping=mapping)
    xidx_np, xw_np = axis_weights(w_out, w_in, method, dtype=np.float32, mapping=mapping)
    n_tap = yw_np.shape[1]

    out = jnp.zeros((h_out, w_in) + img.shape[2:], img.dtype)
    for k in range(n_tap):
        out = out + jnp.asarray(yw_np[:, k])[:, None, None] * img[jnp.asarray(yidx_np[:, k])]

    out2 = jnp.zeros((h_out, w_out) + img.shape[2:], img.dtype)
    for k in range(n_tap):
        out2 = out2 + jnp.asarray(xw_np[:, k])[None, :, None] * out[:, jnp.asarray(xidx_np[:, k])]
    return out2


@functools.partial(jax.jit, static_argnames=("out_hw", "method", "clamp_hi", "mapping"))
def _resize_f32(img, out_hw, method, clamp_hi, mapping="align_corners"):
    out = _resize_plane(img, out_hw, method, mapping)
    if method == "bicubic":
        out = jnp.clip(out, 0.0, clamp_hi)
    return out


def resize(
    img: jnp.ndarray,
    out_hw: Tuple[int, int],
    method: str = "bilinear",
    mapping: str = "align_corners",
    batched=None,
) -> jnp.ndarray:
    """Resize of [H, W], [H, W, C], [B, H, W], or [B, H, W, C] to out_hw.

    Float output in the input's value range ([0, 255] for uint8 input).
    See the module docstring for the ``mapping`` conventions.
    Rank-3 layout: ``batched=None`` (default) reads a trailing dim <= 4
    as channels and raises on anything wider; True forces a [B, H, W]
    luma stack, False forces [H, W, C] (ops/_layout.py).
    """
    from oclcomputervision_jax.ops._layout import rank3_is_batched

    img = jnp.asarray(img)
    clamp_hi = 255.0 if jnp.issubdtype(img.dtype, jnp.integer) else 1.0
    out_hw = tuple(int(v) for v in out_hw)

    if img.ndim == 2:
        x = img.astype(jnp.float32)[..., None]
        return _resize_f32(x, out_hw, method, clamp_hi, mapping)[..., 0]
    if img.ndim == 3:
        if rank3_is_batched(img.shape, batched, "resize"):
            return jax.vmap(
                lambda x: _resize_f32(
                    x[..., None], out_hw, method, clamp_hi, mapping
                )[..., 0]
            )(img.astype(jnp.float32))
        return _resize_f32(img.astype(jnp.float32), out_hw, method, clamp_hi, mapping)
    if img.ndim == 4:
        return jax.vmap(lambda x: _resize_f32(x, out_hw, method, clamp_hi, mapping))(
            img.astype(jnp.float32)
        )
    raise ValueError(f"unsupported rank {img.ndim}")


def resize_uint8(
    img: jnp.ndarray,
    out_hw: Tuple[int, int],
    method: str = "bilinear",
    mapping: str = "align_corners",
    batched=None,
) -> jnp.ndarray:
    """uint8-in/uint8-out resize with round-to-nearest quantization."""
    out = resize(img, out_hw, method, mapping, batched=batched)
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def bilinear(img, out_hw):
    """Reference-named alias (basic/interpolation.py:37): the reference's
    ``bilinear`` method dispatches bilinear_simple, whose HW-sampler
    numerics ``mapping="hw_sampler"`` reproduces."""
    return resize_uint8(img, out_hw, "bilinear", mapping="hw_sampler")


def bilinear_lds(img, out_hw):
    """Reference-named alias (basic/interpolation.py:73): explicit
    align-corners math (interpolation.cl:39-70)."""
    return resize_uint8(img, out_hw, "bilinear")


def bicubic(img, out_hw):
    """Reference-named alias (basic/interpolation.py:55)."""
    return resize_uint8(img, out_hw, "bicubic")
