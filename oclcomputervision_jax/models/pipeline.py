"""Batched on-chip enhancement pipelines.

The reference dispatches each op separately with host round-trips
between them (copy-in / kernel / copy-out per call - SURVEY.md §3);
here a whole multi-op pipeline is ONE jitted function over a batch of
images, resident on device end to end, and shardable over a mesh via
parallel.data_parallel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from oclcomputervision_jax.utils.config import HistEqConfig, LocalHistEqConfig


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """One config for the fused enhance() pipeline."""

    equalize: str = "global"  # 'global' | 'local' | 'none'
    histeq: HistEqConfig = HistEqConfig()
    local: LocalHistEqConfig = LocalHistEqConfig()
    # 'raisr' runs learned super-resolution after equalize (pass the
    # trained RaisrModel to EnhancePipeline); 'none' skips it
    superres: str = "none"
    # output size (H, W) after resize, None = keep
    resize_to: Optional[Tuple[int, int]] = None
    resize_method: str = "bicubic"
    pyramid_depth: int = 0  # >0: also return a Gaussian pyramid


class EnhancePipeline:
    """Compose equalize -> superres -> resize -> pyramid into one
    jitted program.

    Works on uint8 [H, W] or batched [B, H, W] luma stacks; the batch
    axis is the data-parallel axis for multi-chip execution.
    """

    def __init__(self, cfg: EnhanceConfig = EnhanceConfig(), raisr_model=None):
        """``raisr_model``: a trained models.raisr.RaisrModel, required
        when cfg.superres == 'raisr' (the filter bank rides the jitted
        program as a captured constant, so one pipeline instance serves
        one bank)."""
        self.cfg = cfg
        if cfg.superres == "raisr":
            if raisr_model is None or raisr_model.filters is None:
                raise ValueError(
                    "cfg.superres='raisr' needs a trained RaisrModel "
                    "(EnhancePipeline(cfg, raisr_model=model))"
                )
            self._raisr_filters = jnp.asarray(raisr_model.filters, jnp.float32)
            self._raisr_cfg = raisr_model.cfg
        elif cfg.superres != "none":
            raise ValueError(f"unknown superres mode {cfg.superres!r}")
        self._fn = jax.jit(self._build)

    def _build(self, gray: jnp.ndarray):
        from oclcomputervision_jax.ops.histeq import histeq_global, histeq_local_block
        from oclcomputervision_jax.ops.interpolation import resize_uint8
        from oclcomputervision_jax.ops.pyramid import gaussian_pyramid

        cfg = self.cfg
        x = gray
        batched = x.ndim == 3  # [B, H, W] luma stack
        if cfg.equalize == "global":
            h = cfg.histeq
            x = histeq_global(x, h.alpha, h.punch, h.clip)
        elif cfg.equalize == "local":
            l = cfg.local
            x = histeq_local_block(x, l.alpha, l.punch, l.clip, l.blockshape)
        if cfg.superres == "raisr":
            from oclcomputervision_jax.ops.raisr import raisr_upsample

            # handles [H, W] and [B, H, W]
            x = raisr_upsample(x, self._raisr_filters, self._raisr_cfg)
        if cfg.resize_to is not None:
            x = resize_uint8(
                x, cfg.resize_to, cfg.resize_method, batched=batched
            )
        if cfg.pyramid_depth > 0:
            return x, gaussian_pyramid(x, 2, cfg.pyramid_depth, batched=batched)
        return x

    def __call__(self, gray):
        return self._fn(jnp.asarray(gray))

    def sharded(self, mesh, axis: str = "data"):
        """Data-parallel variant over a Mesh (batch split across chips)."""
        from oclcomputervision_jax.parallel import data_parallel

        inner = self._build
        return jax.jit(data_parallel(inner, mesh, axis))
