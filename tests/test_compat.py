"""Compat layer: the reference's public API shapes and semantics."""

import numpy as np
import pytest

from oclcomputervision_jax import compat, oracle


class TestHisteqCompat:
    def test_histeq_global_gpu_vs_cpu_paths(self, under_exposure_gray, capsys):
        g = under_exposure_gray[:128, :256]
        gpu = compat.histeq_global(g, 1, 0.05, 2, use_gpu=True)
        # the reference's three-part breakdown shape (eq_global.py:56):
        # hist GPU + eq GPU ms, transfer-func CPU ms
        import re

        out = capsys.readouterr().out
        assert re.search(
            r"global histogram equalization took GPU: "
            r"\d+\.\d{3} \+ \d+\.\d{3} ms, CPU: \d+\.\d{3} ms",
            out,
        ), out
        cpu = compat.histeq_global(g, 1, 0.05, 2, use_gpu=False)
        assert np.abs(gpu.astype(int) - cpu.astype(int)).max() <= 1

    def test_local_block_defaults(self, under_exposure_gray):
        g = under_exposure_gray[:512, :1024]
        out = compat.histeq_local_block(g.copy())
        assert out.shape == g.shape and out.dtype == np.uint8

    def test_calc_transfer_func_matches_oracle(self, lenna_gray):
        hist = np.bincount(lenna_gray.reshape(-1), minlength=256)
        np.testing.assert_array_equal(
            compat.calc_transfer_func(hist, 1, 0.05, 2),
            oracle.calc_transfer_func(hist, 1, 0.05, 2),
        )


class TestUtilityCompat:
    def test_bicubic_fills_dst_and_returns_elapsed(self, lenna_rgb):
        util = compat.Utility()
        src = lenna_rgb[:64, :64]
        dst = np.zeros((128, 128, 3), np.uint8)
        ms = util.bicubic(src, dst)
        assert isinstance(ms, list) and len(ms) == 1
        assert dst.mean() > 10  # actually written
        # lds aliases exist (reference API parity)
        assert util.bicubic_lds == util.bicubic  # same JAX op

    def test_bilinear(self, lenna_gray):
        # the reference's `bilinear` method = bilinear_simple = the HW
        # sampler's half-texel numerics (SURVEY.md fidelity note 11)
        util = compat.Utility()
        src = np.stack([lenna_gray[:32, :32]] * 3, axis=-1)
        dst = np.zeros((64, 64, 3), np.uint8)
        util.bilinear(src, dst)
        from oclcomputervision_jax.oracle.interpolation import resize_uint8

        want = resize_uint8(src, (64, 64), "bilinear", mapping="hw_sampler")
        assert np.abs(dst.astype(int) - want.astype(int)).max() <= 1

    def test_bilinear_lds_is_align_corners_and_differs_from_simple(self, lenna_gray):
        util = compat.Utility()
        src = np.stack([lenna_gray[:32, :32]] * 3, axis=-1)
        d_simple = np.zeros((64, 64, 3), np.uint8)
        d_lds = np.zeros((64, 64, 3), np.uint8)
        util.bilinear(src, d_simple)
        util.bilinear_lds(src, d_lds)
        from oclcomputervision_jax.oracle.interpolation import resize_uint8

        want = resize_uint8(src, (64, 64), "bilinear")
        assert np.abs(d_lds.astype(int) - want.astype(int)).max() <= 1
        # the two conventions are observably different kernels
        assert not np.array_equal(d_simple, d_lds)


class TestMotionCompat:
    def test_estimate_motion_vector_signature(self, frames_gray):
        g0, g1 = frames_gray
        mv = compat.estimate_motion_vector(
            g0[:32, :48], g1[:32, :48], searchSize=15, patchSize=5, pyrScale=2
        )
        assert mv.shape == (32, 48, 2) and mv.dtype == np.float32

    def test_upscale_mv(self):
        mv = np.random.default_rng(0).uniform(0.5, 2, (8, 10, 2)).astype(np.float32)
        up = compat.upscale_mv(mv, 2)
        assert up.shape == (16, 20, 2)

    def test_flo_roundtrip(self, tmp_path, flow_gt):
        p = str(tmp_path / "x.flo")
        compat.write_flo(flow_gt, p)
        np.testing.assert_array_equal(compat.read_flo(p), flow_gt)

    def test_cpu_local_histeq_mutates_input_in_place(self, under_exposure_gray):
        # the reference's CPU path writes the result back into its
        # input (eq_local_block.py:76) - the compat layer reproduces
        # that observable contract (VERDICT r2 missing item 3)
        g = under_exposure_gray[:128, :256].copy()
        before = g.copy()
        out = compat.histeq_local_block(g, blockshape=(64, 128), use_gpu=False)
        assert out is g
        assert not np.array_equal(g, before)

    def test_reference_public_name_parity(self):
        # every module-level name reference user code can import from
        # me_pyramid.py / me_test.py resolves here (VERDICT r2 item 7)
        for name in (
            "mv2hsv", "gaussian2d", "SSD", "SAD", "WSAD", "get_displacement",
            "get_region_padded", "estimate_motion_vector", "visualizeME",
            "visualizeSearch", "read_flo", "write_flo", "upscale_mv",
            "calc_transfer_func", "histeq_global", "histeq_local_block",
            "gaussian_pyramid",
        ):
            assert hasattr(compat, name), name

    def test_reference_runtime_class_names(self):
        # all three reference device-runtime class names resolve, with
        # the reference's method signatures (eq_opencl.py:8,
        # basic/interpolation.py:16, super_resolution/raisr.py:18) -
        # VERDICT r3 missing item 1
        assert compat.clHistEq is compat.HistEq
        assert compat.clUtility is compat.Utility
        assert compat.ClRaisr is compat.Raisr
        eq = compat.clHistEq.getInstance()
        for m in ("histGrid", "histeqGlobal", "histeqLocalBlock"):
            assert callable(getattr(eq, m)), m
        util = compat.clUtility()
        for m in ("bilinear", "bicubic", "bilinear_lds", "bicubic_lds"):
            assert callable(getattr(util, m)), m
        assert callable(getattr(compat.ClRaisr, "upsample"))

    def test_reference_style_runtime_snippet(self, frames_gray):
        # a verbatim reference-style usage of clUtility: fill a
        # preallocated dst and get the per-event elapsed-ms list back
        # (basic/interpolation.py:152-165)
        src = np.stack([frames_gray[0][:32, :48]] * 3, axis=-1)
        dst = np.zeros((64, 96, 3), np.uint8)
        util = compat.clUtility()
        ms = util.bilinear_lds(src, dst)
        assert isinstance(ms, list) and len(ms) == 1
        assert dst.any()

    def test_cost_helpers_match_reference_math(self):
        rng = np.random.default_rng(3)
        p0 = rng.integers(0, 256, (5, 5)).astype(np.uint8)
        p1 = rng.integers(0, 256, (5, 5)).astype(np.uint8)
        f0, f1 = p0.astype(np.float32), p1.astype(np.float32)
        assert compat.SAD(p0, p1) == float(np.abs(f0 - f1).sum())
        assert compat.SSD(p0, p1) == float(((f0 - f1) ** 2).sum())
        w = compat.gaussian2d((5, 5), 2.0)
        # WSAD keeps the shipped np.dot-as-matmul quirk (fidelity note 9)
        assert compat.WSAD(p0, p1) == pytest.approx(
            float(np.abs(f0 @ w - f1 @ w).sum()), rel=1e-6
        )

    def test_get_region_padded_matches_zero_padded_gather(self, frames_gray):
        g0 = frames_gray[0]
        h, w = g0.shape
        for (r, c) in ((0, 0), (2, 3), (h - 1, w - 1), (-2, 5), (h + 3, w + 3)):
            size = 5
            got = compat.get_region_padded(g0, r - 2, r + 3, c - 2, c + 3, size)
            yy, xx = np.mgrid[r - 2 : r + 3, c - 2 : c + 3]
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            want = np.where(
                valid, g0[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)], 0
            )
            np.testing.assert_array_equal(got, want)

    def test_reference_style_snippet_matches_oracle(self, frames_gray):
        # the reference's own per-pixel search loop (me_pyramid.py:140-158)
        # written against the compat names must agree with the oracle
        g0 = frames_gray[0][:24, :32]
        g1 = frames_gray[1][:24, :32]
        want = oracle.estimate_motion_vector(g0, g1, 15, 5)
        for (row, col) in ((0, 0), (5, 7), (23, 31), (12, 16)):
            patch = compat.get_region_padded(
                g0, row - 2, row + 3, col - 2, col + 3, 5
            )
            centerX, centerY = col, row
            step = 15 // 2 - 5 // 2
            while step >= 1:
                sbs = 5 + step * 2
                region = compat.get_region_padded(
                    g1, centerY - sbs // 2, centerY + sbs // 2 + 1,
                    centerX - sbs // 2, centerX + sbs // 2 + 1, sbs,
                )
                d = compat.get_displacement(patch, region, step)
                centerX += d[1]
                centerY += d[0]
                step //= 2
            assert (centerX - col, centerY - row) == tuple(
                int(v) for v in want[row, col]
            )


class TestRaisrCompat:
    def test_upsample_api(self, lenna_gray):
        r = compat.Raisr(0)
        src = lenna_gray[:64, :64]
        dst = np.zeros((128, 128), np.uint8)
        ms = r.upsample(src, dst, 2)
        assert len(ms) == 1 and dst.std() > 5

    def test_wrong_scale_prints_fatal(self, lenna_gray, capsys):
        r = compat.Raisr(0)
        out = r.upsample(lenna_gray[:16, :16], np.zeros((48, 48), np.uint8), 3)
        assert out == []
        assert "Fatal" in capsys.readouterr().out


class TestPipeline:
    def test_enhance_pipeline(self, under_exposure_gray):
        from oclcomputervision_jax.models.pipeline import EnhanceConfig, EnhancePipeline

        g = under_exposure_gray[:256, :512]
        pipe = EnhancePipeline(EnhanceConfig(resize_to=(128, 256), pyramid_depth=2))
        out, pyr = pipe(g)
        assert out.shape == (128, 256)
        assert [p.shape for p in pyr] == [(64, 128), (128, 256)]

    def test_sharded_pipeline_matches(self, under_exposure_gray):
        import jax

        from oclcomputervision_jax import parallel
        from oclcomputervision_jax.models.pipeline import EnhanceConfig, EnhancePipeline

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        g = under_exposure_gray[:128, :256]
        batch = np.stack([np.roll(g, i, 0) for i in range(8)])
        pipe = EnhancePipeline(EnhanceConfig())
        mesh = parallel.make_mesh((8,), ("data",))
        got = np.asarray(pipe.sharded(mesh)(batch))
        want = np.asarray(pipe(batch))
        np.testing.assert_array_equal(got, want)

    def test_batched_pipeline_resizes_each_image(self, under_exposure_gray):
        # regression: rank-3 [B, H, W] stacks must not be interpreted as
        # [H, W, C] by the resize/pyramid stages
        from oclcomputervision_jax.models.pipeline import EnhanceConfig, EnhancePipeline

        g = under_exposure_gray[:256, :512]
        batch = np.stack([g, g[::-1].copy()])
        pipe = EnhancePipeline(EnhanceConfig(resize_to=(128, 256), pyramid_depth=2))
        out, pyr = pipe(batch)
        assert out.shape == (2, 128, 256)
        assert [p.shape for p in pyr] == [(2, 64, 128), (2, 128, 256)]
        single, _ = pipe(batch[0])
        np.testing.assert_array_equal(np.asarray(out)[0], np.asarray(single))

    def test_raisr_superres_pipeline(self, under_exposure_gray):
        # equalize -> learned 2x SR fused in one jitted program; the
        # result must match running the stages separately
        from oclcomputervision_jax.models.pipeline import EnhanceConfig, EnhancePipeline
        from oclcomputervision_jax.models.raisr import RaisrModel
        from oclcomputervision_jax.ops.histeq import histeq_global
        from oclcomputervision_jax.ops.raisr import raisr_upsample
        from oclcomputervision_jax.utils.assets import asset_path

        model = RaisrModel.load(asset_path("raisr_filters_x2.npz"))
        g = under_exposure_gray[:64, :128]
        batch = np.stack([g, g[::-1].copy()])
        pipe = EnhancePipeline(EnhanceConfig(superres="raisr"), raisr_model=model)
        out = np.asarray(pipe(batch))
        assert out.shape == (2, 128, 256) and out.dtype == np.uint8
        want = np.asarray(
            raisr_upsample(histeq_global(batch), model.filters, model.cfg)
        )
        np.testing.assert_array_equal(out, want)

    def test_raisr_superres_requires_model(self):
        from oclcomputervision_jax.models.pipeline import EnhanceConfig, EnhancePipeline

        with pytest.raises(ValueError, match="RaisrModel"):
            EnhancePipeline(EnhanceConfig(superres="raisr"))
        with pytest.raises(ValueError, match="superres"):
            EnhancePipeline(EnhanceConfig(superres="bogus"))


class TestHistEqRuntime:
    def test_clHistEq_api(self, under_exposure_gray):
        from oclcomputervision_jax import oracle

        cleq = compat.clHistEq.getInstance()
        assert cleq is compat.HistEq.getInstance()
        g = under_exposure_gray[:256, :512]
        grid, ms = cleq.histGrid(g)
        assert grid.shape == (8, 2, 256) and grid.dtype == np.uint32
        np.testing.assert_array_equal(grid, oracle.hist_grid(g, (32, 256)))
        hist = grid.sum(axis=(0, 1))
        mapping = oracle.calc_transfer_func(hist, 1, 0.05, 2).astype(np.uint8)
        eq, ms = cleq.histeqGlobal(g, mapping)
        np.testing.assert_array_equal(eq, mapping[g])
        mappings = np.stack(
            [
                np.stack(
                    [
                        oracle.calc_transfer_func(
                            np.bincount(
                                g[i * 128 : (i + 1) * 128, j * 256 : (j + 1) * 256].reshape(-1),
                                minlength=256,
                            ),
                            0.5, 0.05, 3,
                        )
                        for j in range(2)
                    ]
                )
                for i in range(2)
            ]
        )
        leq, ms = cleq.histeqLocalBlock(g, mappings, (128, 256))
        want = oracle.apply_block_mappings(g, mappings.astype(np.float32), (128, 256))
        assert np.abs(leq.astype(int) - want.astype(int)).max() <= 1
