"""Randomized-geometry fuzzing: every op vs its oracle across shapes.

The fixed-shape tests missed a real bug once (the batched-pipeline
rank-3 misinterpretation); these sweep odd sizes, extreme aspect
ratios, and degenerate inputs.
"""

import numpy as np
import pytest

from oclcomputervision_jax import oracle
from oclcomputervision_jax.ops import histeq, interpolation, motion, pyramid


@pytest.fixture(scope="module")
def frng():
    return np.random.default_rng(1234)


class TestHisteqShapes:
    @pytest.mark.parametrize("hw", [(17, 33), (1, 512), (257, 3), (64, 64)])
    def test_global_any_shape(self, frng, hw):
        g = frng.integers(0, 256, size=hw, dtype=np.uint8)
        got = np.asarray(histeq.histeq_global(g))
        want = oracle.histeq_global(g)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    @pytest.mark.parametrize("hw,bs", [((96, 96), (32, 32)), ((60, 120), (20, 40)),
                                       ((128, 64), (128, 64))])
    def test_local_any_blockshape(self, frng, hw, bs):
        g = frng.integers(0, 256, size=hw, dtype=np.uint8)
        got = np.asarray(histeq.histeq_local_block(g, blockshape=bs))
        want = oracle.histeq_local_block(g.copy(), blockshape=bs)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_constant_image(self):
        g = np.full((64, 64), 128, np.uint8)
        out = np.asarray(histeq.histeq_global(g))
        assert out.shape == g.shape  # no NaN poisoning from degenerate CDF
        assert np.isfinite(out.astype(np.float64)).all()


class TestResizeShapes:
    @pytest.mark.parametrize("src,dst", [((7, 13), (29, 5)), ((100, 3), (50, 9)),
                                         ((33, 65), (66, 130)), ((2, 2), (7, 7))])
    @pytest.mark.parametrize("method", ["bilinear", "bicubic"])
    def test_arbitrary_resize(self, frng, src, dst, method):
        g = frng.integers(0, 256, size=src, dtype=np.uint8)
        got = np.asarray(interpolation.resize(g, dst, method))
        want = oracle.resize_align_corners(g, dst, method)
        assert got.shape == tuple(dst)
        assert np.max(np.abs(got - want)) < 0.05

    def test_single_pixel_source(self):
        g = np.full((1, 1), 77, np.uint8)
        out = np.asarray(interpolation.resize_uint8(g, (8, 8), "bilinear"))
        assert (out == 77).all()


class TestPyramidShapes:
    @pytest.mark.parametrize("hw", [(31, 47), (8, 256), (100, 10)])
    def test_odd_sizes(self, frng, hw):
        g = frng.integers(0, 256, size=hw, dtype=np.uint8)
        got = np.asarray(pyramid.pyr_down(g))
        want = oracle.pyr_down(g)
        assert got.shape == want.shape == (hw[0] // 2, hw[1] // 2)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class TestMotionShapes:
    @pytest.mark.parametrize("hw", [(17, 23), (40, 12)])
    def test_small_frames_bitexact(self, frng, hw):
        f0 = frng.integers(0, 256, size=hw, dtype=np.uint8)
        f1 = frng.integers(0, 256, size=hw, dtype=np.uint8)
        got = np.asarray(motion.estimate_motion_vector(f0, f1, 15, 5))
        want = oracle.estimate_motion_vector(f0, f1, 15, 5)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("search,patch", [(11, 5), (15, 3), (21, 7)])
    def test_parameter_variants_bitexact(self, frng, search, patch):
        f0 = frng.integers(0, 256, size=(24, 36), dtype=np.uint8)
        f1 = frng.integers(0, 256, size=(24, 36), dtype=np.uint8)
        got = np.asarray(motion.estimate_motion_vector(f0, f1, search, patch))
        want = oracle.estimate_motion_vector(f0, f1, search, patch)
        np.testing.assert_array_equal(got, want)
