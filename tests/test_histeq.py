"""Histeq: JAX op vs NumPy oracle (the reference-CPU-path contract)."""

import numpy as np
import pytest

from oclcomputervision_jax import oracle
from oclcomputervision_jax.ops import histeq as ops


def _pad_to(img, mh, mw):
    h, w = img.shape
    return img[: h - h % mh, : w - w % mw]


class TestHistogram:
    def test_histogram256_matches_bincount(self, rng):
        x = rng.integers(0, 256, size=4096, dtype=np.uint8)
        got = np.asarray(ops.histogram256(x))
        want = np.bincount(x, minlength=256)
        np.testing.assert_array_equal(got, want)

    def test_hist_grid_matches_oracle(self, lenna_gray):
        g = _pad_to(lenna_gray, 32, 256)
        got = np.asarray(ops.hist_grid(g, tile=(32, 256)))
        want = oracle.hist_grid(g, tile=(32, 256))
        np.testing.assert_array_equal(got, want.astype(np.int64))

    def test_hist_grid_sums_to_full_histogram(self, lenna_gray):
        g = _pad_to(lenna_gray, 32, 256)
        grid = np.asarray(ops.hist_grid(g))
        np.testing.assert_array_equal(
            grid.sum(axis=(0, 1)), np.bincount(g.reshape(-1), minlength=256)
        )


class TestTransferFunc:
    @pytest.mark.parametrize(
        "alpha,punch,clip", [(1.0, 0.05, 2.0), (0.5, 0.05, 3.0), (0.8, 0.01, 10.0)]
    )
    def test_matches_float64_oracle_within_half_level(self, lenna_gray, alpha, punch, clip):
        hist = np.bincount(lenna_gray.reshape(-1), minlength=256)
        want = oracle.calc_transfer_func(hist, alpha, punch, clip)
        got = np.asarray(ops.calc_transfer_func(hist, alpha, punch, clip))
        assert np.max(np.abs(got - want)) < 0.01

    def test_zero_maps_to_zero(self, lenna_gray):
        # gain limit collapses to [0,0] at I=0 (eq_global.py:36)
        hist = np.bincount(lenna_gray.reshape(-1), minlength=256)
        got = np.asarray(ops.calc_transfer_func(hist, 1.0, 0.05, 2.0))
        assert got[0] == 0.0

    def test_batched_equals_loop(self, rng):
        hists = rng.integers(0, 1000, size=(3, 4, 256)).astype(np.float32)
        got = np.asarray(ops.calc_transfer_func(hists, 0.5, 0.05, 3.0))
        for i in range(3):
            for j in range(4):
                single = np.asarray(ops.calc_transfer_func(hists[i, j], 0.5, 0.05, 3.0))
                np.testing.assert_allclose(got[i, j], single, atol=1e-5)


class TestGlobalHisteq:
    @pytest.mark.parametrize(
        "alpha,punch,clip", [(1.0, 0.05, 2.0), (0.5, 0.02, 4.0)]
    )
    def test_matches_oracle_within_1ulp(self, under_exposure_gray, alpha, punch, clip):
        g = under_exposure_gray
        want = oracle.histeq_global(g, alpha, punch, clip)
        got = np.asarray(ops.histeq_global(g, alpha, punch, clip))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        # the 1-level differences come only from fp32-vs-fp64 LUT rounding
        assert (diff > 0).mean() < 0.01

    def test_batched(self, under_exposure_gray):
        g = under_exposure_gray[:256, :256]
        batch = np.stack([g, g[::-1].copy()])
        got = np.asarray(ops.histeq_global(batch))
        single0 = np.asarray(ops.histeq_global(batch[0]))
        single1 = np.asarray(ops.histeq_global(batch[1]))
        np.testing.assert_array_equal(got[0], single0)
        np.testing.assert_array_equal(got[1], single1)


class TestLocalBlockHisteq:
    def test_matches_oracle_within_1ulp(self, under_exposure_gray):
        g = _pad_to(under_exposure_gray, 256, 256)
        want = oracle.histeq_local_block(g.copy())
        got = np.asarray(ops.histeq_local_block(g))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01

    def test_general_blockshape(self, lenna_gray):
        # the reference GPU path was hardcoded to 256x256 blocks
        # (eq_local_block.py:24-26); ours generalizes.
        g = _pad_to(lenna_gray, 128, 64)
        want = oracle.histeq_local_block(g.copy(), blockshape=(128, 64))
        got = np.asarray(ops.histeq_local_block(g, blockshape=(128, 64)))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_mappings_match_oracle(self, lenna_gray):
        g = _pad_to(lenna_gray, 256, 256)
        got = np.asarray(ops.block_mappings(g, 0.5, 0.05, 3.0, (256, 256)))
        nby, nbx = g.shape[0] // 256, g.shape[1] // 256
        for i in range(nby):
            for j in range(nbx):
                blk = g[i * 256 : (i + 1) * 256, j * 256 : (j + 1) * 256]
                h = np.bincount(blk.reshape(-1), minlength=256)
                want = oracle.calc_transfer_func(h, 0.5, 0.05, 3.0)
                assert np.max(np.abs(got[i, j] - want)) < 0.01


class TestClaheClipLimit:
    def test_clip_histogram_conserves_mass(self, rng):
        h = rng.integers(0, 5000, size=256).astype(np.float64)
        c = oracle.clip_histogram(h, 2.0)
        assert abs(c.sum() - h.sum()) < 1e-6
        assert c.max() <= 2.0 * h.sum() / 256 + h.sum() / 256  # limit + redistribution

    def test_ops_matches_oracle(self, under_exposure_gray):
        g = under_exposure_gray[:512, :1024]
        want = oracle.histeq_local_block(
            g.copy(), 0.8, 0.01, 10.0, (128, 128), clahe_clip=2.5
        )
        got = np.asarray(
            ops.histeq_local_block(g, 0.8, 0.01, 10.0, (128, 128), clahe_clip=2.5)
        )
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_limiting_reduces_amplification(self, under_exposure_gray):
        # contrast limiting must tame flat-region noise amplification:
        # the clipped LUT stays closer to identity in sparse bins
        g = under_exposure_gray[:256, :256]
        raw = np.asarray(ops.block_mappings(g, 1.0, 0.01, 100.0, (128, 128)))
        lim = np.asarray(
            ops.block_mappings(g, 1.0, 0.01, 100.0, (128, 128), clahe_clip=1.5)
        )
        ident = np.arange(256, dtype=np.float32)
        assert np.abs(lim - ident).mean() < np.abs(raw - ident).mean()
