"""RAISR: JAX op vs NumPy oracle; trainer sanity; quality vs bilinear."""

import numpy as np
import pytest

from oclcomputervision_jax.oracle import raisr as onp
from oclcomputervision_jax.ops import raisr as ops
from oclcomputervision_jax.models.raisr import RaisrModel, train_filters
from oclcomputervision_jax.utils import psnr
from oclcomputervision_jax.utils.config import RaisrConfig


@pytest.fixture(scope="module")
def tiny_cfg():
    return RaisrConfig(fidelity="full")


@pytest.fixture(scope="module")
def trained(lenna_gray_mod, tiny_cfg):
    return train_filters([lenna_gray_mod], tiny_cfg, chunk=512)


@pytest.fixture(scope="module")
def lenna_gray_mod():
    from oclcomputervision_jax.utils import load_gray

    return load_gray("lenna.png")[:128, :128]


class TestShippedMode:
    def test_matches_oracle(self, lenna_gray_mod):
        cfg = RaisrConfig(fidelity="shipped")
        want = onp.raisr_upsample(lenna_gray_mod, None, cfg)
        got = np.asarray(ops.raisr_upsample(lenna_gray_mod, None, cfg))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_color_shipped_is_yuv_roundtrip_of_bilinear(self, lenna_rgb):
        cfg = RaisrConfig(fidelity="shipped")
        src = lenna_rgb[:64, :64]
        got = np.asarray(ops.raisr_upsample(src, None, cfg))
        want = onp.raisr_upsample(src, None, cfg)
        diff = np.abs(got.astype(int) - want.astype(int))
        # At 2x, odd pixels are exact neighbor means -> out*255 hits x.5
        # exactly, so fp32-vs-fp64 noise flips the rounding on ~half of
        # them (the reference's own fp16 kernel differs from both). A
        # bitwise match is ill-posed here; bound the error instead.
        assert diff.max() <= 2
        assert psnr(got, want) > 48


class TestHash:
    def test_bucket_agreement_ops_vs_oracle(self, lenna_gray_mod, tiny_cfg):
        x01 = lenna_gray_mod.astype(np.float64) / 255.0
        up = onp.cheap_upscale(x01, 2)
        want = onp.hash_image(up, tiny_cfg)
        got = np.asarray(ops.hash_image(np.asarray(up, np.float32), tiny_cfg))
        agree = (got == want).mean()
        # fp32 separable blur vs fp64 2D blur: disagreements only at
        # quantizer boundaries
        assert agree > 0.99, agree

    def test_bucket_range(self, lenna_gray_mod, tiny_cfg):
        x01 = lenna_gray_mod.astype(np.float32) / 255.0
        up = onp.cheap_upscale(x01, 2).astype(np.float32)
        b = np.asarray(ops.hash_image(up, tiny_cfg))
        assert b.min() >= 0
        assert b.max() < tiny_cfg.num_angle * tiny_cfg.num_strength * tiny_cfg.num_coherence


class TestFullPipeline:
    def test_ops_matches_oracle(self, lenna_gray_mod, trained, tiny_cfg):
        filters = np.asarray(trained)
        lr = lenna_gray_mod[:64, :64]
        want = onp.raisr_upsample(lr, filters, tiny_cfg)
        got = np.asarray(ops.raisr_upsample(lr, filters, tiny_cfg))
        # ~1% of pixels land in a different hash bucket (fp32 vs fp64
        # noise at quantizer edges and the angle 0<->pi wraparound on
        # near-flat gradients, mostly along borders) and get a
        # different-but-valid filter; bound the global error.
        assert psnr(got, want) > 35, psnr(got, want)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert (diff > 2).mean() < 0.02

    def test_apply_filters_matches_oracle_given_same_hash(
        self, lenna_gray_mod, trained, tiny_cfg
    ):
        # the per-pixel filter gather+apply itself is deterministic:
        # identical hash map in -> near-identical output out.
        filters = np.asarray(trained)
        x01 = lenna_gray_mod[:48, :48].astype(np.float64) / 255.0
        up = onp.cheap_upscale(x01, 2)
        bucket = onp.hash_image(up, tiny_cfg)
        ptype = onp.pixel_type_map(*up.shape, tiny_cfg.scale)
        fidx = onp.filter_index(bucket, ptype, tiny_cfg)
        want = onp.apply_filters(up, fidx, filters, tiny_cfg)
        got = np.asarray(
            ops.apply_filters(
                np.asarray(up, np.float32)[..., None],
                np.asarray(fidx),
                np.asarray(filters, np.float32),
                tiny_cfg,
            )
        )[..., 0]
        assert np.max(np.abs(got - want)) < 1e-3

    def test_batched(self, lenna_gray_mod, trained, tiny_cfg):
        lr = lenna_gray_mod[:32, :32]
        s = np.asarray(ops.raisr_upsample(lr, trained, tiny_cfg))
        b = np.asarray(ops.raisr_upsample(np.stack([lr, lr]), trained, tiny_cfg))
        np.testing.assert_array_equal(b[0], s)

    @pytest.mark.parametrize("fidelity", ["shipped", "full"])
    def test_four_channel_bgra(self, lenna_rgb, trained, tiny_cfg, fidelity):
        # the reference's ClRaisr consumes BGRA images; the 4x4 CSC passes
        # alpha through and the learned filter applies to it like YUV
        # (raisr.py:20-33, raisr.cl:322-331)
        cfg = RaisrConfig(fidelity=fidelity)
        filters = None if fidelity == "shipped" else np.asarray(trained)
        src3 = lenna_rgb[:32, :32]
        alpha = np.full(src3.shape[:2] + (1,), 200, np.uint8)
        src4 = np.concatenate([src3, alpha], axis=-1)
        out4 = np.asarray(ops.raisr_upsample(src4, filters, cfg))
        assert out4.shape == (64, 64, 4) and out4.dtype == np.uint8
        # RGB result is independent of the extra channel
        out3 = np.asarray(ops.raisr_upsample(src3, filters, cfg))
        np.testing.assert_array_equal(out4[..., :3], out3)
        # constant alpha stays ~constant through upscale + filtering
        # (filters have ~unit DC response; the tiny test-corpus bank is
        # a few percent off unity in edge buckets)
        adiff = np.abs(out4[..., 3].astype(int) - 200)
        assert adiff.mean() < 2 and adiff.max() <= 32


def _kernel_on_cpu(monkeypatch):
    """Route ops.raisr's apply dispatch to the GPU kernel, run in Pallas
    interpret mode (callers use the un-jitted _raisr_post, so no cached
    trace of the plain route is reused)."""
    import functools

    import jax

    from oclcomputervision_jax.ops.pallas import raisr_apply

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        raisr_apply,
        "apply_filters_pallas",
        functools.partial(raisr_apply.apply_filters_pallas, interpret=True),
    )


def _upscaled(src, cfg):
    import jax.numpy as jnp

    from oclcomputervision_jax.ops.interpolation import _resize_plane

    x = jnp.asarray(src, jnp.float32) / 255.0
    if x.ndim == 2:
        x = x[..., None]
    h, w = x.shape[:2]
    return _resize_plane(x, (h * cfg.scale, w * cfg.scale), "bilinear")[None]


def _color_src(img, nchan):
    if nchan == 1:
        return img
    chans = [img, np.roll(img, 7, 0), np.roll(img, 3, 1)]
    if nchan == 4:
        chans.append(np.full_like(img, 180))
    return np.stack(chans, -1)


class TestKernelPipeline:
    """The whole inference path with the GPU apply kernel (interpret
    mode) against the plain gather form the CPU takes."""

    @pytest.mark.parametrize("nchan", [1, 3, 4])
    def test_kernel_pipeline_matches_plain(
        self, lenna_gray_mod, trained, tiny_cfg, nchan, monkeypatch
    ):
        src = _color_src(lenna_gray_mod[:24, :40], nchan)
        up = _upscaled(src, tiny_cfg)
        gray = nchan == 1
        want = np.asarray(ops._raisr_post(up, trained, tiny_cfg, gray))
        _kernel_on_cpu(monkeypatch)
        got = np.asarray(ops._raisr_post(up, trained, tiny_cfg, gray))
        assert got.shape == want.shape and got.dtype == np.uint8
        # same float32 taps in the same order; FMA contraction may flip
        # a rounding exactly at a .5 boundary
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class TestCtBlend:
    """Census-transform structure blending (RAISR paper §V) - a quality
    extension over the reference kernel, which has no blending stage."""

    def test_weight_patterns(self):
        # flat patch: all census bits tie as >= -> LCC 0 -> full filter
        flat = np.full((8, 8), 0.5)
        np.testing.assert_array_equal(onp.ct_blend_weights(flat), 1.0)
        # checkerboard peaks: bits alternate around the ring -> LCC 8 ->
        # cheap upscale (valley centers tie as >= on every neighbor and
        # read as flat - the standard census >= tie-break; exact ties
        # are measure-zero on real noise)
        yy, xx = np.mgrid[0:8, 0:8]
        board = ((yy + xx) % 2).astype(np.float64)
        w = onp.ct_blend_weights(board)
        np.testing.assert_array_equal(w[1:-1, 1:-1][board[1:-1, 1:-1] == 1.0], 0.0)
        # clean vertical edge: one contiguous run -> LCC 2 -> full filter
        edge = np.zeros((8, 8))
        edge[:, 4:] = 1.0
        assert (onp.ct_blend_weights(edge) == 1.0).all()

    def test_jnp_twin_matches_oracle(self, lenna_gray_mod):
        up = onp.cheap_upscale(
            lenna_gray_mod[:48, :52].astype(np.float64) / 255.0, 2
        ).astype(np.float32)
        want = onp.ct_blend_weights(up.astype(np.float64))
        got = np.asarray(ops.ct_blend_weights(np.asarray(up)))
        # same comparisons on the same fp32 values; the weight set is
        # tiny so fp32-vs-fp64 arithmetic cannot flip it
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_interleaved_blend_matches_oracle(self, lenna_gray_mod, trained):
        cfg = RaisrConfig(fidelity="full", blend="ct")
        lr = lenna_gray_mod[:64, :64]
        want = onp.raisr_upsample(lr, np.asarray(trained), cfg)
        got = np.asarray(ops.raisr_upsample(lr, trained, cfg))
        assert psnr(got, want) > 35, psnr(got, want)
        assert (np.abs(got.astype(int) - want.astype(int)) > 2).mean() < 0.02

    @pytest.mark.parametrize("nchan", [1, 3])
    def test_kernel_pipeline_blend_matches_plain(
        self, lenna_gray_mod, trained, nchan, monkeypatch
    ):
        cfg = RaisrConfig(fidelity="full", blend="ct")
        src = _color_src(lenna_gray_mod[:24, :40], nchan)
        up = _upscaled(src, cfg)
        want = np.asarray(ops._raisr_post(up, trained, cfg, nchan == 1))
        _kernel_on_cpu(monkeypatch)
        got = np.asarray(ops._raisr_post(up, trained, cfg, nchan == 1))
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_blend_fades_noise_toward_cheap_upscale(self, trained, tiny_cfg):
        # pure-noise input: census randomness is high everywhere, so the
        # blended output must sit closer to the cheap upscale than the
        # unblended filtered output does
        from oclcomputervision_jax.ops.interpolation import resize_uint8

        rng = np.random.default_rng(3)
        lr = rng.integers(0, 256, (48, 48), np.uint8)
        cheap = np.asarray(resize_uint8(lr, (96, 96), "bilinear")).astype(int)
        plain = np.asarray(ops.raisr_upsample(lr, trained, tiny_cfg)).astype(int)
        blended = np.asarray(
            ops.raisr_upsample(
                lr, trained, RaisrConfig(fidelity="full", blend="ct")
            )
        ).astype(int)
        assert np.abs(blended - cheap).mean() < np.abs(plain - cheap).mean()


class TestTraining:
    def test_self_upscale_beats_bilinear(self, lenna_gray_mod, trained, tiny_cfg):
        # degrade lenna, restore with filters trained on it: RAISR must
        # beat the cheap bilinear upscale it starts from.
        from oclcomputervision_jax.ops.interpolation import resize_uint8

        hr = lenna_gray_mod
        lr = hr.reshape(64, 2, 64, 2).mean(axis=(1, 3)).round().astype(np.uint8)
        bil = np.asarray(resize_uint8(lr, hr.shape, "bilinear"))
        ra = np.asarray(ops.raisr_upsample(lr, trained, tiny_cfg))
        p_b, p_r = psnr(bil, hr), psnr(ra, hr)
        assert p_r > p_b + 0.3, (p_b, p_r)

    def test_filters_near_unit_dc(self, trained):
        # learned filters should roughly preserve flat patches
        dc = np.asarray(trained).sum(axis=(1, 2))
        assert np.abs(np.median(dc) - 1.0) < 0.2

    def test_model_save_load_roundtrip(self, trained, tiny_cfg, tmp_path):
        m = RaisrModel(cfg=tiny_cfg, filters=trained)
        p = str(tmp_path / "bank.npz")
        m.save(p)
        m2 = RaisrModel.load(p)
        np.testing.assert_allclose(np.asarray(m2.filters), np.asarray(trained))
        assert m2.cfg.num_filters == tiny_cfg.num_filters


class TestAugmentation:
    def test_dihedral_transforms_are_the_8_symmetries(self):
        from oclcomputervision_jax.models.raisr import dihedral_transforms

        img = np.arange(12, dtype=np.uint8).reshape(3, 4)
        ts = dihedral_transforms(img)
        assert len(ts) == 8
        # all distinct, and the group contains each image exactly once
        flat = {t.tobytes() + bytes(t.shape[0]) for t in ts}
        assert len(flat) == 8
        # closure spot-checks
        assert np.array_equal(ts[0], img)
        assert np.array_equal(ts[2], np.rot90(img))
        assert np.array_equal(ts[1], np.fliplr(img))

    def test_augmented_training_fills_angle_buckets(self, lenna_gray_mod):
        # a strongly oriented corpus leaves opposite-angle buckets
        # starved; 8x augmentation must even them out
        from oclcomputervision_jax.models.raisr import (
            _training_arrays,
            accumulate_normal_eq,
            dihedral_transforms,
        )
        from oclcomputervision_jax.utils.config import RaisrConfig

        cfg = RaisrConfig()
        # synthetic OBLIQUE stripes (~21 deg): axis-aligned gradients are
        # degenerate for the hash (gx == 0 exactly -> atan2(0,0) = 0),
        # so an oblique angle is needed for rotations to land in
        # distinct quarters
        yy, xx = np.mgrid[0:64, 0:64]
        img = (127 + 120 * np.sin(0.5 * xx + 0.2 * yy)).astype(np.float64) / 255.0

        def counts(variants):
            cnt = np.zeros(cfg.num_filters, np.float32)
            for v in variants:
                _, _, f = _training_arrays(np.asarray(v.copy(), np.float32), cfg)
                _, _, c = accumulate_normal_eq(
                    np.zeros((f.size, 121), np.float32),
                    np.zeros(f.size, np.float32),
                    f,
                    cfg.num_filters,
                    chunk=512,
                )
                cnt += np.asarray(c)
            return cnt.reshape(cfg.num_angle, -1).sum(axis=1)

        plain = counts([img])
        aug = counts(dihedral_transforms(img))
        # vertical stripes: horizontal-gradient buckets dominate, the
        # 90-degree-rotated buckets are near-empty until augmentation
        na = cfg.num_angle
        quarter = plain.reshape(4, na // 4).sum(axis=1)
        assert quarter.max() > 10 * (quarter.min() + 1)
        quarter_aug = aug.reshape(4, na // 4).sum(axis=1)
        assert quarter_aug.max() < 3 * quarter_aug.min()


class TestScale3:
    def test_train_and_upsample_scale3(self, lenna_gray_mod):
        # the reference hard-fails on any scale but 2 (raisr.py:91-93);
        # our trainer/inference are scale-generic
        cfg = RaisrConfig(scale=3, fidelity="full")
        hr = lenna_gray_mod[:96, :96]
        m = RaisrModel(cfg=cfg).train([hr], chunk=256)
        lr = hr.reshape(32, 3, 32, 3).mean(axis=(1, 3)).round().astype(np.uint8)
        ra = np.asarray(m.upsample(lr))
        assert ra.shape == (96, 96)
        from oclcomputervision_jax.ops.interpolation import resize_uint8

        bil = np.asarray(resize_uint8(lr, (96, 96), "bilinear"))
        assert psnr(ra, hr) > psnr(bil, hr)

    def test_shipped_x3_bank_loads(self):
        from oclcomputervision_jax.utils import asset_path

        m = RaisrModel.load(asset_path("raisr_filters_x3.npz"))
        assert m.cfg.scale == 3
        assert m.filters.shape == (24 * 3 * 3 * 9, 11, 11)


class TestDispatch:
    """ops.raisr._apply_bank picks the apply form from the platform, and
    a kernel failure on the GPU raises instead of rerouting."""

    def test_kernel_error_raises(self, lenna_gray_mod, trained, tiny_cfg, monkeypatch):
        import jax

        from oclcomputervision_jax.ops.pallas import raisr_apply

        def boom(*a, **k):
            raise RuntimeError("boom")

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(raisr_apply, "apply_filters_pallas", boom)
        up = _upscaled(lenna_gray_mod[:16, :16], tiny_cfg)
        with pytest.raises(RuntimeError, match="boom"):
            ops._raisr_post(up, trained, tiny_cfg, True)

    def test_cpu_takes_plain_form(self, lenna_gray_mod, trained, tiny_cfg, monkeypatch):
        from oclcomputervision_jax.ops.pallas import raisr_apply

        def boom(*a, **k):
            raise AssertionError("the kernel must not run off the GPU")

        monkeypatch.setattr(raisr_apply, "apply_filters_pallas", boom)
        up = _upscaled(lenna_gray_mod[:16, :16], tiny_cfg)
        out = np.asarray(ops._raisr_post(up, trained, tiny_cfg, True))
        assert out.shape == (1, 32, 32) and out.dtype == np.uint8


class TestShippedBankQuality:
    def test_x2_beats_bicubic_on_untouched_frame(self):
        # The quality gate under the honest protocol (VERDICT r2 item 3):
        # banks are trained on lenna/frame10/under_exposure-left (+ one
        # pyramid level each), the ridge is tuned on under_exposure's
        # right 40% ONLY, and frame11 - this frame - is untouched by
        # both. Full-frame numbers (examples/train_banks.py --report-
        # only): x2 +1.48 dB over bicubic, x3 +0.91, x4 +0.93. The gate
        # runs on a central crop to keep the CPU-backend suite fast
        # (measured margin 1.15 dB there).
        from oclcomputervision_jax.models.raisr import RaisrModel
        from oclcomputervision_jax.ops.interpolation import resize_uint8
        from oclcomputervision_jax.utils import asset_path, load_gray

        hr = load_gray("frame11.png")[112:368, 128:512]
        lr = hr.reshape(128, 2, 192, 2).mean(axis=(1, 3)).round().astype(np.uint8)
        m = RaisrModel.load(asset_path("raisr_filters_x2.npz"), fidelity="full")
        ra = np.asarray(m.upsample(lr))
        bic = np.asarray(resize_uint8(lr, hr.shape, "bicubic"))
        assert psnr(ra, hr) - psnr(bic, hr) >= 1.0


class TestScale4:
    def test_shipped_x4_bank_upsamples(self, lenna_gray_mod):
        from oclcomputervision_jax.ops.interpolation import resize_uint8
        from oclcomputervision_jax.utils import asset_path

        m = RaisrModel.load(asset_path("raisr_filters_x4.npz"))
        assert m.cfg.scale == 4
        assert m.filters.shape == (24 * 3 * 3 * 16, 11, 11)
        hr = lenna_gray_mod[:128, :128]
        lr = hr.reshape(32, 4, 32, 4).mean(axis=(1, 3)).round().astype(np.uint8)
        ra = np.asarray(m.upsample(lr))
        assert ra.shape == (128, 128)
        bil = np.asarray(resize_uint8(lr, (128, 128), "bilinear"))
        assert psnr(ra, hr) > psnr(bil, hr)
