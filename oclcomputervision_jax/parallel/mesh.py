"""Multi-chip scaling: jax.sharding Mesh + shard_map strategies.

The reference is strictly single-device (one OpenCL queue, host-blocking
ev.wait() per dispatch - SURVEY.md §5 C15); scaling here uses shard_map:

- data parallelism (dp): batches of images sharded over the mesh; each
  op is already batch-first, so pjit-sharding the batch axis is enough.
- spatial parallelism (sp): one huge image sharded by rows; histograms
  are per-shard then psum'd (the tiny 256-bin reduce is the
  only collective), LUT application stays local. This is the analogue
  of sequence parallelism in this domain.
- tensor parallelism (tp): the RAISR filter bank (864 x 121 x 121
  normal-equation accumulators) sharded over buckets for the solve.

All collectives are XLA's (psum / all_gather / ppermute), which it hands
to NCCL on GPUs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Build a Mesh over the available devices (default: 1-D data mesh)."""
    devices = devices if devices is not None else jax.devices()
    if shape is None:
        shape = (len(devices),)
    arr = np.asarray(devices)[: int(np.prod(shape))].reshape(shape)
    return Mesh(arr, tuple(axis_names))


def data_parallel(fn, mesh: Mesh, axis: str = "data"):
    """Shard a batch-first op over the mesh's data axis.

    fn maps [b, ...] -> [b, ...]; the wrapper accepts a global batch
    divisible by the axis size and runs fn on each shard.
    """
    return shard_map(
        fn,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=P(axis),
        check_vma=False,
    )


def histeq_global_sharded(
    gray: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    alpha: float = 1.0,
    punch: float = 0.05,
    clip: float = 2.0,
) -> jnp.ndarray:
    """Spatially-sharded global histeq: rows split over the mesh.

    Each device histograms its row shard, a psum (256 x int32)
    builds the global histogram, every device computes the identical
    LUT, and applies it to its local rows. One collective total.
    """
    from oclcomputervision_jax.ops.histeq import (
        apply_lut,
        calc_transfer_func,
        histogram256,
    )

    def shard_fn(g):
        hist = histogram256(g.reshape(-1))
        hist = jax.lax.psum(hist, axis)
        lut = calc_transfer_func(hist, alpha, punch, clip).astype(jnp.uint8)
        return apply_lut(g, lut)

    sharded = shard_map(
        shard_fn, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
        check_vma=False,
    )
    return sharded(gray)


def histeq_local_sharded(
    gray: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    alpha: float = 0.5,
    punch: float = 0.05,
    clip: float = 3.0,
    blockshape: Tuple[int, int] = (256, 256),
    clahe_clip: float = 0.0,
) -> jnp.ndarray:
    """Row-sharded local-block (CLAHE-style) histeq.

    LUTs are bit-identical to the single-device op's; the blend's
    einsums contract at local tile shapes, so FMA regrouping can flip
    outputs exactly ON a uint8 truncation boundary (+-1 on a
    measure-zero pixel set).

    Each device histograms and solves LUTs for its own block rows
    (local), all_gathers the tiny LUT grid (nby x nbx x 256 - the only
    traffic besides halos), exchanges a half-block pixel halo with
    its neighbors via ppermute (zero-filled at the global edges,
    matching the single-device zero pad), and blends its rows against
    the global grid with the shared band kernel
    (ops.histeq.apply_block_mappings_band).

    Requires the row count to split into whole block rows per device:
    h % (ndev * blockshape[0]) == 0.
    """
    from oclcomputervision_jax.ops.histeq import (
        apply_block_mappings_band,
        calc_transfer_func,
        clip_histogram,
        hist_grid,
    )

    bh, bw = blockshape
    n = mesh.shape[axis]
    h, w = gray.shape
    if h % (n * bh):
        raise ValueError(f"rows {h} not divisible by ndev*bh = {n}*{bh}")
    h_loc = h // n
    bh2 = bh // 2

    def shard_fn(g):
        g = g.reshape(h_loc, w)
        grid = hist_grid(g, blockshape)
        if clahe_clip > 0:
            grid = clip_histogram(grid, clahe_clip)
        m_loc = calc_transfer_func(grid, alpha, punch, clip)
        m_all = jax.lax.all_gather(m_loc, axis, axis=0, tiled=True)

        # half-block halo from the row neighbors (zeros at global edges)
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]
        top = jax.lax.ppermute(g[-bh2:], axis, fwd)
        bot = jax.lax.ppermute(g[:bh2], axis, bwd)
        band = jnp.concatenate([top, g, bot], axis=0)  # [h_loc + bh, w]

        ty0 = jax.lax.axis_index(axis) * (h_loc // bh)
        out = apply_block_mappings_band(band, m_all, blockshape, ty0, w)
        return out[bh2 : bh2 + h_loc]

    sharded = shard_map(
        shard_fn, mesh=mesh, in_specs=P(axis, None), out_specs=P(axis, None),
        check_vma=False,
    )
    return sharded(gray)


def motion_fast_sharded(
    gray0: jnp.ndarray,
    gray1: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
) -> jnp.ndarray:
    """Row-sharded fast-mode dense motion estimation (sp).

    Each device holds a row shard of BOTH frames, exchanges
    fast_halo_rows() = sum(1 + step + pm) true boundary rows with its
    neighbors (two ppermute shifts per frame), runs the band-local
    residual iteration with true-image-edge masks
    (ops.motion._fast_residual_band), and crops the halo. BIT-IDENTICAL
    to the single-device fast mode: garbage from a band edge creeps
    inward by at most the halo.

    Unseeded (the pyramid's coarsest level / single-pair serving); a
    seeded variant would first warp frame1 by the seed base per shard,
    which needs a seed-magnitude-sized halo - use dp over frame batches
    for seeded pyramids instead.
    """
    from oclcomputervision_jax.ops.motion import (
        _fast_residual_band,
        fast_halo_rows,
    )

    n = mesh.shape[axis]
    h, w = gray0.shape
    if h % n:
        raise ValueError(f"rows {h} not divisible by mesh axis {n}")
    h_loc = h // n
    hh = fast_halo_rows(search_size, patch_size)
    if hh > h_loc:
        raise ValueError(
            f"halo {hh} exceeds shard rows {h_loc}; use fewer devices"
        )

    def shard_fn(g0, g1):
        g0 = g0.reshape(h_loc, w)
        g1 = g1.reshape(h_loc, w)
        i = jax.lax.axis_index(axis)
        fwd = [(k, k + 1) for k in range(n - 1)]  # send bottom rows down
        bwd = [(k + 1, k) for k in range(n - 1)]  # send top rows up
        exts = []
        for g in (g0, g1):
            top = jax.lax.ppermute(g[-hh:], axis, fwd)  # from the shard above
            bot = jax.lax.ppermute(g[:hh], axis, bwd)   # from the shard below
            # global edges receive zeros from ppermute - exactly the
            # out-of-image zero fill the band contract asks for
            exts.append(jnp.concatenate([top, g, bot], axis=0).astype(jnp.int32))
        r0 = i * h_loc - hh
        res = _fast_residual_band(
            exts[0], exts[1], r0, h, w, search_size, patch_size, costfn
        )
        return res[hh : hh + h_loc].astype(jnp.float32)

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis, None, None),
        check_vma=False,
    )
    return sharded(gray0, gray1)


def motion_exact_sharded(
    gray0: jnp.ndarray,
    gray1: jnp.ndarray,
    mesh: Mesh,
    axis: str = "data",
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
) -> jnp.ndarray:
    """Row-sharded EXACT dense motion estimation (sp).

    Each device holds a row shard of both frames, exchanges
    exact_halo_rows() = patch_margin + sum(steps) true boundary rows with
    its neighbors (two ppermute shifts per frame), runs the exact
    windowed search (ops.motion._estimate_2d) on its extended band, and
    crops the halo. BIT-IDENTICAL to the
    single-device exact mode: the exact search is purely per-pixel -
    every output reads only frame rows within pm + sum(steps) of itself - so
    a band carrying that many true rows reproduces the full-image
    result, and the zeros ppermute delivers at the global edges ARE the
    oracle's zero padding (me_pyramid.py:89-127's get_region_padded).
    Unlike the fast mode there is no cross-pixel state flow, hence no
    garbage-creep terms in the halo.

    Unseeded (the pyramid's coarsest level / single-pair serving) -
    the same scope as motion_fast_sharded; use dp over frame batches
    for seeded pyramid levels.
    """
    from oclcomputervision_jax.ops.motion import _estimate_2d, exact_halo_rows

    n = mesh.shape[axis]
    h, w = gray0.shape
    if h % n:
        raise ValueError(f"rows {h} not divisible by mesh axis {n}")
    h_loc = h // n
    hh = exact_halo_rows(search_size, patch_size)
    if hh > h_loc:
        raise ValueError(
            f"halo {hh} exceeds shard rows {h_loc}; use fewer devices"
        )

    def shard_fn(g0, g1):
        g0 = g0.reshape(h_loc, w)
        g1 = g1.reshape(h_loc, w)
        fwd = [(k, k + 1) for k in range(n - 1)]  # send bottom rows down
        bwd = [(k + 1, k) for k in range(n - 1)]  # send top rows up
        exts = []
        for g in (g0, g1):
            top = jax.lax.ppermute(g[-hh:], axis, fwd)  # from the shard above
            bot = jax.lax.ppermute(g[:hh], axis, bwd)   # from the shard below
            # global edges receive zeros from ppermute - exactly the
            # oracle's out-of-image zero fill
            exts.append(jnp.concatenate([top, g, bot], axis=0))
        res = _estimate_2d(
            exts[0], exts[1], jnp.zeros((1,), jnp.float32), search_size,
            patch_size, "fixed", False, costfn,
        )
        return res[hh : hh + h_loc]

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=P(axis, None, None),
        check_vma=False,
    )
    return sharded(gray0, gray1)


def raisr_train_step(
    patches: jnp.ndarray,
    targets: jnp.ndarray,
    fidx: jnp.ndarray,
    num_filters: int,
    filter_len: int,
    mesh: Mesh,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
    chunk: int = 256,
    ridge: float = 0.03,
) -> jnp.ndarray:
    """One full distributed RAISR training step.

    dp: training pixels sharded over ``dp_axis``; every device streams
    its shard through the normal-equation accumulators (matmuls in a
    lax.scan), then G/r/cnt are psum'd.
    tp: the per-bucket ridge solve is sharded over ``tp_axis`` (each
    device solves num_filters/tp buckets), then all_gather'd.

    Returns the filter bank [num_filters, filter_len, filter_len].
    """
    from oclcomputervision_jax.models.raisr import accumulate_normal_eq, solve_filters

    tp = mesh.shape[tp_axis]
    assert num_filters % tp == 0, (num_filters, tp)

    def step(p, t, f):
        g, r, cnt = accumulate_normal_eq(p[0], t[0], f[0], num_filters, chunk)
        g = jax.lax.psum(g, dp_axis)
        r = jax.lax.psum(r, dp_axis)
        cnt = jax.lax.psum(cnt, dp_axis)
        # tp: solve only this device's bucket shard
        ti = jax.lax.axis_index(tp_axis)
        nb = num_filters // tp
        gs = jax.lax.dynamic_slice_in_dim(g, ti * nb, nb, axis=0)
        rs = jax.lax.dynamic_slice_in_dim(r, ti * nb, nb, axis=0)
        cs = jax.lax.dynamic_slice_in_dim(cnt, ti * nb, nb, axis=0)
        fs = solve_filters(gs, rs, cs, filter_len, ridge)
        return jax.lax.all_gather(fs, tp_axis, axis=0, tiled=True)

    n = patches.shape[0]
    dp = mesh.shape[dp_axis]
    assert n % dp == 0, (n, dp)
    # reshape to [dp, n/dp, ...] so the leading axis shards over dp and
    # is consumed inside the shard (tp devices replicate the data)
    ps = patches.reshape(dp, n // dp, -1)
    ts = targets.reshape(dp, n // dp)
    fs = fidx.reshape(dp, n // dp)

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(dp_axis), P(dp_axis), P(dp_axis)),
        out_specs=P(),
        check_vma=False,
    )
    return sharded(ps, ts, fs)


def raisr_upsample_sharded(
    lr: jnp.ndarray,
    filters: jnp.ndarray,
    cfg,
    mesh: Mesh,
    axis: str = "data",
    halo: int = 8,
) -> jnp.ndarray:
    """Spatially-sharded RAISR inference: LR rows split over the mesh.

    Each device holds a row shard of the LR [H, W] image, exchanges
    ``halo`` boundary rows with its neighbors (two ppermute
    shifts), upsamples its extended shard, runs the hash/filter stages,
    and crops ``scale*halo`` rows from the HR output. Bit-identical to
    the single-device result (interior seams AND global edges).

    The subtlety is the align-corners upscale: HR row q samples LR row
    q*(H-1)/(H*scale-1), which depends on the GLOBAL height - resizing
    the extended shard with shard-local coordinates warps the mapping
    everywhere (~30% of pixels off). So the vertical taps are
    precomputed per shard at global coordinates (host-side constants,
    selected by axis_index) and applied as a sparse [hr_ext, lr_ext]
    tap-matrix matmul at full f32 precision (no dynamic gather). Out-of-image extended
    rows clamp to the boundary HR row, which is exactly the edge
    padding the hash/apply stages use (ops/raisr.py), so global edges
    match too. halo=8 LR rows covers the post-upscale receptive field
    (Sobel 1 + 9x9 tensor 4 + 11x11 filter 5 = 10 HR rows) plus the
    bilinear support.
    """
    from oclcomputervision_jax.oracle.interpolation import axis_weights
    from oclcomputervision_jax.ops.raisr import _raisr_post

    n = mesh.shape[axis]
    h, w = lr.shape
    assert h % n == 0, (h, n)
    s = cfg.scale
    h_loc = h // n
    assert halo <= h_loc, (halo, h_loc)
    # the halo must cover the post-upscale receptive field (Sobel 1 +
    # gauss_len//2 tensor + filter_len//2 filter HR rows) plus the
    # bilinear upscale support, or interior shard seams corrupt silently
    min_halo = -(-(cfg.gauss_len // 2 + 1 + cfg.filter_len // 2) // s) + 1
    assert halo >= min_halo, (halo, min_halo)
    rows_lr = h_loc + 2 * halo
    rows_hr = rows_lr * s

    yidx_g, yw_g = axis_weights(h * s, h, "bilinear", dtype=np.float32)
    xidx_g, xw_g = axis_weights(w * s, w, "bilinear", dtype=np.float32)
    n_tap = yw_g.shape[1]

    # Per-shard vertical tap tables [n, rows_hr, n_tap]: extended-shard
    # HR row q is global HR row (i*h_loc - halo)*s + q (clamped); its
    # taps are the global ones rebased to extended-shard-local LR rows.
    idx_all = np.zeros((n, rows_hr, n_tap), np.int32)
    wgt_all = np.zeros((n, rows_hr, n_tap), np.float32)
    for i in range(n):
        q_g = np.clip((i * h_loc - halo) * s + np.arange(rows_hr), 0, h * s - 1)
        # clamp rebased indices into the extended shard: out-of-shard taps
        # (the first extended rows of interior shards reference LR rows
        # above the halo) only occur inside the s*halo crop, where the
        # halo assert above guarantees the result is discarded - clamping
        # keeps the one-hot from silently zero-weighting them
        idx_all[i] = np.clip(yidx_g[q_g] - (i * h_loc - halo), 0, rows_lr - 1)
        wgt_all[i] = yw_g[q_g]
    idx_c = jnp.asarray(idx_all)
    wgt_c = jnp.asarray(wgt_all)

    def shard_fn(x):
        x = x[0]  # [h/n, w]
        i = jax.lax.axis_index(axis)
        perm_up = [(k, k - 1) for k in range(1, n)]  # send top rows upward
        perm_dn = [(k, k + 1) for k in range(n - 1)]  # send bottom rows down
        # the shard above sends its LAST rows down, the one below its
        # FIRST rows up
        top_rows = jax.lax.ppermute(x[-halo:], axis, perm_dn)  # from above
        bot_rows = jax.lax.ppermute(x[:halo], axis, perm_up)  # from below
        # edge shards replicate their own boundary rows (never sampled
        # with nonzero weight - clamped taps stay inside the image)
        top = jnp.where(i == 0, jnp.repeat(x[:1], halo, axis=0), top_rows)
        bot = jnp.where(i == n - 1, jnp.repeat(x[-1:], halo, axis=0), bot_rows)
        ext = jnp.concatenate([top, x, bot], axis=0).astype(jnp.float32) / 255.0

        # vertical pass at global coordinates: sparse tap matrix @ shard
        idx_i = idx_c[i]  # [rows_hr, n_tap]
        wgt_i = wgt_c[i]
        lanes = jnp.arange(rows_lr, dtype=jnp.int32)
        taps = jnp.sum(
            wgt_i[..., None] * (idx_i[..., None] == lanes).astype(jnp.float32),
            axis=1,
        )  # [rows_hr, rows_lr]
        v = jnp.matmul(taps, ext, precision=jax.lax.Precision.HIGHEST)
        # horizontal pass: global == local (full rows), static taps
        up = jnp.zeros((rows_hr, w * s), jnp.float32)
        for k in range(n_tap):
            up = up + jnp.asarray(xw_g[:, k])[None, :] * v[:, jnp.asarray(xidx_g[:, k])]

        hr_ext = _raisr_post(up[None, ..., None], filters, cfg, True)[0]
        return hr_ext[s * halo : rows_hr - s * halo][None]

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(axis, None),
        check_vma=False,
    )
    return sharded(lr.reshape(n, h // n, w)).reshape(h * s, w * s)
