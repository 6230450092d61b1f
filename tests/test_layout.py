"""Rank-3 layout guards: a batched luma stack passed to ANY public op
either works (explicit batched=) or raises - never silently processes
the wrong axes (VERDICT r3 item 6)."""

import numpy as np
import pytest

from oclcomputervision_jax.ops import histeq, interpolation, motion, pyramid


@pytest.fixture(scope="module")
def stack(frames_gray):
    # [B, H, W] luma stack whose W > 4 makes the layout unambiguous
    g = frames_gray[0][:32, :48]
    return np.stack([g, g[::-1], 255 - g])


class TestChannelsLastOps:
    def test_pyr_down_batched_stack_matches_per_image(self, stack):
        got = np.asarray(pyramid.pyr_down(stack, 2, batched=True))
        want = np.stack([np.asarray(pyramid.pyr_down(s, 2)) for s in stack])
        np.testing.assert_array_equal(got, want)

    def test_pyr_down_rank3_default_rejects_wide_trailing(self, stack):
        # a [B, H, W] stack used to be read as [H, W, C]: B became H and
        # the blur ran over the wrong axes with no error
        with pytest.raises(ValueError, match="batched"):
            pyramid.pyr_down(stack, 2)

    def test_pyr_down_channels_default_still_works(self, stack):
        rgb = np.stack([stack[0]] * 3, axis=-1)  # [H, W, 3]
        out = np.asarray(pyramid.pyr_down(rgb, 2))
        assert out.shape == (16, 24, 3)
        np.testing.assert_array_equal(
            out[..., 0], np.asarray(pyramid.pyr_down(stack[0], 2))
        )

    def test_pyr_down_rank4_batch_of_color(self, stack):
        rgba = np.stack([np.stack([s] * 4, axis=-1) for s in stack])
        out = np.asarray(pyramid.pyr_down(rgba, 2))
        assert out.shape == (3, 16, 24, 4)

    def test_gaussian_pyramid_batched(self, stack):
        pyr = pyramid.gaussian_pyramid(stack, 2, 3, batched=True)
        assert [p.shape for p in pyr] == [(3, 8, 12), (3, 16, 24), (3, 32, 48)]
        single = pyramid.gaussian_pyramid(stack[0], 2, 3)
        for p_b, p_s in zip(pyr, single):
            np.testing.assert_array_equal(np.asarray(p_b[0]), np.asarray(p_s))

    def test_gaussian_pyramid_rank3_default_rejects(self, stack):
        with pytest.raises(ValueError, match="batched"):
            pyramid.gaussian_pyramid(stack, 2, 3)

    def test_resize_batched_stack_matches_per_image(self, stack):
        got = np.asarray(
            interpolation.resize_uint8(stack, (16, 24), "bilinear", batched=True)
        )
        want = np.stack(
            [
                np.asarray(interpolation.resize_uint8(s, (16, 24), "bilinear"))
                for s in stack
            ]
        )
        np.testing.assert_array_equal(got, want)

    def test_resize_rank3_default_rejects_wide_trailing(self, stack):
        with pytest.raises(ValueError, match="batched"):
            interpolation.resize(stack, (16, 24))

    def test_resize_batched_false_forces_channels(self, stack):
        # explicit override: treat the 48-wide trailing dim as channels
        out = np.asarray(
            interpolation.resize(
                stack.transpose(1, 2, 0), (16, 24), batched=False
            )
        )
        assert out.shape == (16, 24, 3)


class TestBatchFirstOps:
    def test_histeq_global_rejects_channels_last(self, stack):
        rgb = np.stack([stack[0]] * 3, axis=-1)
        with pytest.raises(ValueError, match="luma"):
            histeq.histeq_global(rgb)

    def test_histeq_local_rejects_channels_last(self, stack):
        rgb = np.stack([stack[0]] * 3, axis=-1)
        with pytest.raises(ValueError, match="luma"):
            histeq.histeq_local_block(rgb, blockshape=(16, 16))

    def test_motion_rejects_channels_last(self, stack):
        rgb = np.stack([stack[0]] * 3, axis=-1)
        with pytest.raises(ValueError, match="luma"):
            motion.estimate_motion_vector(rgb, rgb)

    def test_histeq_global_batch_first_still_works(self, stack):
        out = np.asarray(histeq.histeq_global(stack))
        assert out.shape == stack.shape
        np.testing.assert_array_equal(
            out[0], np.asarray(histeq.histeq_global(stack[0]))
        )


class TestPipelineNoSpecialCase:
    def test_enhance_pipeline_batched_resize_and_pyramid(self, stack):
        from oclcomputervision_jax.models.pipeline import (
            EnhanceConfig, EnhancePipeline,
        )

        cfg = EnhanceConfig(
            equalize="global", resize_to=(24, 36), pyramid_depth=2
        )
        pipe = EnhancePipeline(cfg)
        out_b, pyr_b = pipe(stack)
        out_s, pyr_s = pipe(stack[0])
        assert out_b.shape == (3, 24, 36)
        np.testing.assert_array_equal(np.asarray(out_b[0]), np.asarray(out_s))
        for pb, ps in zip(pyr_b, pyr_s):
            np.testing.assert_array_equal(np.asarray(pb[0]), np.asarray(ps))
