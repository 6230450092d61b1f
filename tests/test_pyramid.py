"""Gaussian pyramid: JAX op vs NumPy oracle vs cv2.pyrDown."""

import numpy as np

from oclcomputervision_jax.oracle import pyramid as onp
from oclcomputervision_jax.ops import pyramid as ops


class TestOracleVsCv2:
    def test_pyr_down_matches_cv2(self, lenna_gray):
        import cv2

        want = cv2.pyrDown(lenna_gray, dstsize=(lenna_gray.shape[1] // 2, lenna_gray.shape[0] // 2))
        got = onp.pyr_down(lenna_gray)
        # cv2 uses fixed-point arithmetic; allow 1 gray level
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_pyramid_order_coarsest_first(self, lenna_gray):
        pyr = onp.gaussian_pyramid(lenna_gray, 2, 3)
        assert len(pyr) == 3
        assert pyr[0].shape == (lenna_gray.shape[0] // 4, lenna_gray.shape[1] // 4)
        assert pyr[2].shape == lenna_gray.shape


class TestOps:
    def test_matches_oracle_exact_tolerance(self, lenna_gray):
        want = onp.pyr_down(lenna_gray)
        got = np.asarray(ops.pyr_down(lenna_gray))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_matches_cv2(self, frames_gray):
        import cv2

        g0, _ = frames_gray
        want = cv2.pyrDown(g0, dstsize=(g0.shape[1] // 2, g0.shape[0] // 2))
        got = np.asarray(ops.pyr_down(g0))
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.02

    def test_color_input(self, lenna_rgb):
        got = np.asarray(ops.pyr_down(lenna_rgb[:128, :128]))
        want = onp.pyr_down(lenna_rgb[:128, :128])
        assert got.shape == (64, 64, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_pyramid_levels(self, lenna_gray):
        pyr = ops.gaussian_pyramid(lenna_gray, 2, 3)
        opyr = onp.gaussian_pyramid(lenna_gray, 2, 3)
        for a, b in zip(pyr, opyr):
            assert a.shape == b.shape
            assert np.abs(np.asarray(a).astype(int) - b.astype(int)).max() <= 1
