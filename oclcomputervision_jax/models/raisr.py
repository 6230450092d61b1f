"""RAISR model: learned filter bank + JAX least-squares trainer.

The reference only LOADS pre-trained filters from a pickle that is not
in its repo (super_resolution/raisr.py:77, download pointer in
download-pre-trained-weights.txt) - so this framework ships the training
side too, per the RAISR paper (arXiv:1606.01299 §III): for each hash
bucket b, solve ridge least squares

    filters[b] = argmin_f sum_{p: hash(p)=b} (patch(p) . f - hr(p))^2

where patch(p) is the 11x11 cheap-upscaled-luma patch around HR pixel p.

Design: the normal-equation accumulation is a pair of matmuls
per pixel chunk - G += onehot^T @ rowwise_outer(P), r += onehot^T @ (P*y)
- wrapped in lax.scan, so arbitrarily many training pixels stream
through fixed [buckets, 121, 121] fp32 accumulators. That step is the
framework's canonical multi-chip training step: data-parallel over pixel
chunks with a psum over the accumulators (see parallel/).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from oclcomputervision_jax.oracle import raisr as oracle_raisr
from oclcomputervision_jax.ops import raisr as ops_raisr
from oclcomputervision_jax.utils.config import RaisrConfig

_HIGHEST = jax.lax.Precision.HIGHEST


def extract_patches(img: jnp.ndarray, fl: int) -> jnp.ndarray:
    """All fl x fl patches (edge-padded) of [H, W] -> [H*W, fl*fl]."""
    m = fl // 2
    h, w = img.shape
    xp = jnp.pad(img, m, mode="edge")
    cols = []
    for i in range(fl):
        for j in range(fl):
            cols.append(jax.lax.slice(xp, (i, j), (i + h, j + w)).reshape(-1))
    return jnp.stack(cols, axis=1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _training_arrays(hr_y01: jnp.ndarray, cfg: RaisrConfig):
    """From one HR luma image: (patches [N,121], targets [N], fidx [N]).

    LR is the 2x2 box-mean of HR (the standard RAISR degradation);
    cheap upscale and hashing use the exact inference path so train and
    apply see identical features.
    """
    s = cfg.scale
    h, w = hr_y01.shape
    h -= h % s
    w -= w % s
    hr = hr_y01[:h, :w]
    lr = hr.reshape(h // s, s, w // s, s).mean(axis=(1, 3))
    from oclcomputervision_jax.ops.interpolation import _resize_plane

    up = _resize_plane(lr[..., None].astype(jnp.float32), (h, w), "bilinear")[..., 0]
    bucket = ops_raisr.hash_image(up, cfg)
    ptype = ops_raisr.pixel_type_map(h, w, s)
    fidx = bucket * cfg.num_pixel_type + ptype
    patches = extract_patches(up, cfg.filter_len)
    return patches, hr.reshape(-1).astype(jnp.float32), fidx.reshape(-1)


@functools.partial(jax.jit, static_argnames=("num_filters", "chunk"))
def accumulate_normal_eq(patches, targets, fidx, num_filters: int, chunk: int = 1024):
    """Stream pixels through the G/r accumulators with lax.scan.

    Returns G [NF, 121, 121], r [NF, 121], counts [NF].
    """
    n, d = patches.shape
    pad = (-n) % chunk
    patches = jnp.pad(patches, ((0, pad), (0, 0)))
    targets = jnp.pad(targets, (0, pad))
    # padded pixels get an out-of-range bucket -> one-hot row of zeros
    fidx = jnp.pad(fidx, (0, pad), constant_values=num_filters)
    steps = patches.shape[0] // chunk

    def body(carry, xs):
        g, r, cnt = carry
        p, y, f = xs
        onehot = (f[:, None] == jnp.arange(num_filters)[None, :]).astype(jnp.float32)
        outer = p[:, :, None] * p[:, None, :]  # [chunk, d, d]
        # full f32 products: patch values are not exact in TF32, and the
        # ridge solve amplifies Gram errors (cond(G) ~ 1e7)
        g = g + jnp.einsum(
            "nb,nij->bij", onehot, outer, precision=_HIGHEST,
            preferred_element_type=jnp.float32,
        )
        r = r + jnp.einsum(
            "nb,ni,n->bi", onehot, p, y, precision=_HIGHEST,
            preferred_element_type=jnp.float32,
        )
        cnt = cnt + jnp.sum(onehot, axis=0)
        return (g, r, cnt), None

    init = (
        jnp.zeros((num_filters, d, d), jnp.float32),
        jnp.zeros((num_filters, d), jnp.float32),
        jnp.zeros((num_filters,), jnp.float32),
    )
    xs = (
        patches.reshape(steps, chunk, d),
        targets.reshape(steps, chunk),
        fidx.reshape(steps, chunk),
    )
    (g, r, cnt), _ = jax.lax.scan(body, init, xs)
    return g, r, cnt


@functools.partial(jax.jit, static_argnames=("filter_len",))
def solve_filters(g, r, cnt, filter_len: int, ridge: float = 0.03):
    """Per-bucket delta-biased ridge solve.

    The raw normal equations are badly conditioned (image patches are
    highly correlated; cond(G) ~ 1e7) and buckets can have fewer samples
    than the 121 filter taps, so unregularized solves yield huge
    coefficients that amplify quantization noise at inference. The ridge
    is scaled per bucket by the mean Gram diagonal and strengthened for
    sample-starved buckets, biasing toward the identity (delta) filter -
    empty buckets degrade exactly to the cheap upscale.
    """
    d = filter_len * filter_len
    delta = jnp.zeros((d,), jnp.float32).at[d // 2].set(1.0)
    diag_mean = jnp.einsum("bii->b", g) / d
    starve = 1.0 + d / (cnt + 1.0)
    lam = (ridge * diag_mean * starve + 1e-8)[:, None]
    gi = g + lam[..., None] * jnp.eye(d, dtype=jnp.float32)[None]
    ri = r + lam * delta[None, :]
    f = jnp.linalg.solve(gi, ri[..., None])[..., 0]
    return f.reshape(-1, filter_len, filter_len)


def dihedral_transforms(img: np.ndarray):
    """The 8 symmetries of the square: 4 rotations x optional mirror."""
    out = []
    for k in range(4):
        r = np.rot90(img, k)
        out.append(r)
        out.append(np.fliplr(r))
    return out


# Per-scale ridge tuned on a VALIDATION split only (right 40% of
# under_exposure, never trained on; frame11 - the reported frame - is
# untouched by training AND tuning; see examples/train_banks.py for the
# full protocol). The optimum is sharp at small ridge (0.002 collapses
# by 2 dB - ill-conditioned buckets), flat above.
RIDGE_BY_SCALE = {2: 0.004, 3: 0.01, 4: 0.01}


def train_filters(
    hr_images: Sequence[np.ndarray],
    cfg: RaisrConfig = RaisrConfig(),
    ridge: float | None = None,
    chunk: int = 1024,
    augment: bool = False,
) -> jnp.ndarray:
    """Train the filter bank from uint8 HR images (gray or RGB).

    ``ridge=None`` selects the held-out-tuned per-scale default
    (RIDGE_BY_SCALE, 0.03 for unlisted scales).

    ``augment`` accumulates every image under all 8 dihedral transforms
    (RAISR paper §IV "8x augmentation"): rotated/mirrored edges fill the
    angle buckets a small corpus would leave starved. The paper permutes
    the accumulated G/r across buckets instead of re-hashing; re-hashing
    the transformed images costs 8x the (cheap) accumulation but is
    exact even where the hash is not perfectly equivariant (quantizer
    edges, image borders).

    ``augment=True`` uses the augmented statistics everywhere;
    ``augment="starved"`` keeps the NATIVE-orientation filters for
    buckets with enough samples (>= 2 taps^2) and uses the symmetrized
    ones only where the native solve is sample-starved - measured better
    than either extreme when the corpus orientation statistics match the
    deployment (augment-everywhere dilutes well-fed buckets by ~0.2-0.35
    dB on the held-out frame, while starved buckets still gain).

    Returns filters [num_filters, fl, fl] float32.
    """
    if ridge is None:
        ridge = RIDGE_BY_SCALE.get(cfg.scale, 0.03)
    d = cfg.filter_len * cfg.filter_len
    g = jnp.zeros((cfg.num_filters, d, d), jnp.float32)
    r = jnp.zeros((cfg.num_filters, d), jnp.float32)
    cnt = jnp.zeros((cfg.num_filters,), jnp.float32)
    g8, r8, c8 = g, r, cnt
    for img in hr_images:
        img = np.asarray(img)
        if img.ndim == 3:
            y01 = (img.astype(np.float64) / 255.0) @ oracle_raisr.RGB2YUV[0]
        else:
            y01 = img.astype(np.float64) / 255.0
        variants = dihedral_transforms(y01) if augment else [y01]
        for k, v in enumerate(variants):
            p, t, f = _training_arrays(jnp.asarray(v.copy(), jnp.float32), cfg)
            dg, dr, dc = accumulate_normal_eq(p, t, f, cfg.num_filters, chunk)
            g8, r8, c8 = g8 + dg, r8 + dr, c8 + dc
            if k == 0:  # identity transform = the native statistics
                g, r, cnt = g + dg, r + dr, cnt + dc
    if not augment:
        return solve_filters(g8, r8, c8, cfg.filter_len, ridge)
    f_aug = solve_filters(g8, r8, c8, cfg.filter_len, ridge)
    if augment != "starved":
        return f_aug
    f_nat = solve_filters(g, r, cnt, cfg.filter_len, ridge)
    starved = (cnt < 2.0 * d)[:, None, None]
    return jnp.where(starved, f_aug, f_nat)


@dataclasses.dataclass
class RaisrModel:
    """Filter bank container with train / save / load / upsample."""

    cfg: RaisrConfig = RaisrConfig()
    filters: jnp.ndarray | None = None

    def train(self, hr_images: Sequence[np.ndarray], **kw) -> "RaisrModel":
        self.filters = train_filters(hr_images, self.cfg, **kw)
        return self

    def upsample(self, img) -> jnp.ndarray:
        """uint8 in -> uint8 out at cfg.scale x (reference raisr.py:85 API)."""
        return ops_raisr.raisr_upsample(img, self.filters, self.cfg)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            filters=np.asarray(self.filters),
            cfg=np.array(
                [
                    self.cfg.num_angle,
                    self.cfg.num_strength,
                    self.cfg.num_coherence,
                    self.cfg.filter_len,
                    self.cfg.scale,
                ]
            ),
        )

    @classmethod
    def load(
        cls, path: str, fidelity: str = "full", blend: str = "none"
    ) -> "RaisrModel":
        z = np.load(path)
        na, ns, nc, fl, sc = (int(v) for v in z["cfg"])
        cfg = RaisrConfig(
            num_angle=na,
            num_strength=ns,
            num_coherence=nc,
            filter_len=fl,
            scale=sc,
            fidelity=fidelity,
            blend=blend,
        )
        return cls(cfg=cfg, filters=jnp.asarray(z["filters"]))
