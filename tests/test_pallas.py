"""The hand-written GPU kernel and the XLA paths that serve the other ops.

The RAISR apply kernel (ops/pallas/raisr_apply.py) runs here in Pallas
interpret mode against the plain gather form. The histogram, LUT,
local-block and block-matching ops have no kernel of their own; their
XLA paths are checked against the NumPy oracle at the geometries the
kernels they replaced were tested at.
"""

import numpy as np
import pytest

from oclcomputervision_jax import oracle


class TestHistKernel:
    def test_exact_vs_bincount(self, rng):
        from oclcomputervision_jax.ops.histeq import histogram256

        x = rng.integers(0, 256, size=(3, 4096), dtype=np.uint8)
        got = np.asarray(histogram256(x))
        want = np.stack([np.bincount(r, minlength=256) for r in x])
        np.testing.assert_array_equal(got.astype(np.int64), want)

    def test_multi_chunk_accumulation(self, rng):
        from oclcomputervision_jax.ops.histeq import histogram256

        x = rng.integers(0, 256, size=(1, 5 * 4096 + 17), dtype=np.uint8)
        got = np.asarray(histogram256(x))[0]
        np.testing.assert_array_equal(
            got.astype(np.int64), np.bincount(x[0], minlength=256)
        )


class TestApplyKernel:
    def test_exact_vs_gather(self, rng):
        from oclcomputervision_jax.ops.histeq import apply_lut

        x = rng.integers(0, 256, size=(2, 4096), dtype=np.uint8)
        luts = rng.integers(0, 256, size=(2, 256), dtype=np.uint8)
        got = np.stack([np.asarray(apply_lut(x[i], luts[i])) for i in range(2)])
        want = np.stack([luts[i][x[i]] for i in range(2)])
        np.testing.assert_array_equal(got, want)


class TestFusedHisteq:
    def test_matches_oracle(self, rng):
        from oclcomputervision_jax.ops import histeq_global

        img = rng.integers(0, 256, size=(128, 1280), dtype=np.uint8)
        got = np.asarray(histeq_global(img))
        want = oracle.histeq_global(img)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_matches_xla_twin(self, under_exposure_gray):
        from oclcomputervision_jax.ops import histeq_global

        g = under_exposure_gray[:512, :1024]
        got = np.asarray(histeq_global(g))
        want = oracle.histeq_global(g)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1

    def test_batched(self, rng):
        from oclcomputervision_jax.ops import histeq_global

        imgs = rng.integers(0, 256, size=(2, 64, 1280), dtype=np.uint8)
        got = np.asarray(histeq_global(imgs))
        for i in range(2):
            np.testing.assert_array_equal(got[i], np.asarray(histeq_global(imgs[i])))

    def test_unaligned_geometry_is_padded_and_exact(self, rng):
        from oclcomputervision_jax.ops import histeq_global

        img = rng.integers(0, 256, size=(100, 100), dtype=np.uint8)
        got = np.asarray(histeq_global(img))
        want = oracle.histeq_global(img)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class TestLocalEqKernel:
    def test_matches_xla_twin_1ulp(self, under_exposure_gray):
        from oclcomputervision_jax.ops import histeq_local_block

        g = under_exposure_gray[:512, :1024]
        got = np.asarray(histeq_local_block(g, 0.5, 0.05, 3.0, (256, 256)))
        want = oracle.histeq_local_block(g, 0.5, 0.05, 3.0, (256, 256))
        d = np.abs(got.astype(int) - want.astype(int))
        # float32 blend vs the oracle's: flips only values essentially
        # ON an integer truncation boundary
        assert d.max() <= 1 and (d > 0).mean() < 0.001

    def test_batched_matches_single(self, under_exposure_gray):
        from oclcomputervision_jax.ops import histeq_local_block

        g = under_exposure_gray[:512, :512]
        g2 = g[::-1].copy()
        got = np.asarray(histeq_local_block(np.stack([g, g2])))
        for i, x in enumerate((g, g2)):
            np.testing.assert_array_equal(got[i], np.asarray(histeq_local_block(x)))

    def test_fused_matches_xla_twin(self, under_exposure_gray):
        # with and without CLAHE contrast limiting
        from oclcomputervision_jax.ops import histeq as H

        g = under_exposure_gray[:512, :1024]
        for clahe in (0.0, 2.0):
            want = oracle.histeq_local_block(
                g, 0.5, 0.05, 3.0, (256, 256), clahe_clip=clahe
            )
            got = np.asarray(
                H.histeq_local_block(g, 0.5, 0.05, 3.0, (256, 256), clahe)
            )
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= 1 and (d > 0).mean() < 0.001


def _kernel_case(rng, scale, h, w, nchan, bucket_fill=None, batch=1):
    from oclcomputervision_jax.utils.config import RaisrConfig

    cfg = RaisrConfig(scale=scale)
    up = rng.random((batch, h, w, nchan), dtype=np.float32)
    nb = cfg.num_angle * cfg.num_strength * cfg.num_coherence
    if bucket_fill is None:
        bucket = rng.integers(0, nb, (batch, h, w)).astype(np.int32)
    else:
        bucket = np.full((batch, h, w), bucket_fill % nb, np.int32)
    filters = (
        rng.standard_normal((cfg.num_filters, cfg.filter_len, cfg.filter_len))
        .astype(np.float32) * 0.05
    )
    return cfg, up, bucket, filters


def _plain_apply(cfg, up, bucket, filters):
    from oclcomputervision_jax.ops import raisr as R

    out = []
    for u, b in zip(up, bucket):
        fidx = b * cfg.num_pixel_type + np.asarray(
            R.pixel_type_map(b.shape[0], b.shape[1], cfg.scale)
        )
        out.append(np.asarray(R.apply_filters(u, fidx, filters, cfg)))
    return np.stack(out)


class TestRaisrApplyKernel:
    """ops/pallas/raisr_apply.py in interpret mode vs ops.raisr.apply_filters
    (same float32 taps in the same order: only FMA contraction differs)."""

    @pytest.mark.parametrize("nchan", [1, 3, 4])
    @pytest.mark.parametrize("scale", [2, 3, 4])
    def test_matches_reference_apply(self, rng, scale, nchan):
        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

        cfg, up, bucket, filters = _kernel_case(rng, scale, 16, 64, nchan)
        got = np.asarray(
            apply_filters_pallas(up, bucket, filters, cfg, interpret=True)
        )
        want = _plain_apply(cfg, up, bucket, filters)
        assert got.shape == want.shape == (1, 16, 64, nchan)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    @pytest.mark.parametrize("hw", [(17, 65), (9, 30), (33, 70)])
    def test_unaligned_geometry_padded(self, rng, hw):
        # widths and heights that are not tile multiples: the wrapper
        # pads with edge replication and crops; the border pixels must
        # still see the edge-replicated neighbourhood
        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

        cfg, up, bucket, filters = _kernel_case(rng, 2, hw[0], hw[1], 1)
        got = np.asarray(
            apply_filters_pallas(up, bucket, filters, cfg, interpret=True)
        )
        want = _plain_apply(cfg, up, bucket, filters)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    @pytest.mark.parametrize("fill", [0, -1])
    def test_extreme_bucket_ids(self, rng, fill):
        # the first and the last bucket: the last one's pixel types
        # index the final rows of the bank
        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

        cfg, up, bucket, filters = _kernel_case(rng, 3, 16, 64, 3, bucket_fill=fill)
        got = np.asarray(
            apply_filters_pallas(up, bucket, filters, cfg, interpret=True)
        )
        want = _plain_apply(cfg, up, bucket, filters)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    @pytest.mark.parametrize("nchan", [1, 3])
    def test_lowers_for_cuda(self, nchan):
        # the Triton route lowers here without a GPU: export for 'cuda'
        # runs the Pallas -> Triton lowering of the real (non-interpret)
        # kernel and names it, so lowering errors surface before a chip run
        import jax
        import jax.numpy as jnp
        from jax import export

        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas
        from oclcomputervision_jax.utils.config import RaisrConfig

        cfg = RaisrConfig(scale=3)
        up = jax.ShapeDtypeStruct((2, 48, 200, nchan), jnp.float32)
        bucket = jax.ShapeDtypeStruct((2, 48, 200), jnp.int32)
        bank = jax.ShapeDtypeStruct((cfg.num_filters, 11, 11), jnp.float32)
        exp = export.export(
            jax.jit(lambda u, b, f: apply_filters_pallas(u, b, f, cfg)),
            platforms=["cuda"],
            disabled_checks=[
                export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
            ],
        )(up, bucket, bank)
        assert 'name = "raisr_apply"' in exp.mlir_module()
        assert exp.out_avals[0].shape == (2, 48, 200, nchan)

    @pytest.mark.gpu
    def test_compiled_kernel_matches_plain_on_gpu(self, gpu, rng):
        # the kernel as compiled for the card, at a real width
        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

        cfg, up, bucket, filters = _kernel_case(rng, 2, 512, 1024, 3, batch=2)
        got = np.asarray(apply_filters_pallas(up, bucket, filters, cfg))
        want = _plain_apply(cfg, up, bucket, filters)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    def test_batched_matches_single(self, rng):
        from oclcomputervision_jax.ops.pallas.raisr_apply import apply_filters_pallas

        cfg, up, bucket, filters = _kernel_case(rng, 2, 16, 64, 1, batch=2)
        got = np.asarray(
            apply_filters_pallas(up, bucket, filters, cfg, interpret=True)
        )
        for i in range(2):
            single = np.asarray(
                apply_filters_pallas(
                    up[i : i + 1], bucket[i : i + 1], filters, cfg, interpret=True
                )
            )
            np.testing.assert_array_equal(got[i], single[0])


class TestMeExactKernel:
    """The unseeded exact search vs oracle/motion."""

    @pytest.mark.parametrize(
        "ss,ps,h,w,costfn",
        [
            (15, 5, 48, 70, "sad"),   # default geometry
            (15, 5, 33, 129, "sad"),  # odd rows
            (9, 3, 64, 80, "sad"),    # two-round schedule
            (11, 5, 25, 31, "ssd"),   # ssd cost, tiny frame
        ],
    )
    def test_bit_identical_to_xla_twin(self, rng, ss, ps, h, w, costfn):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector

        g0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        g1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        want = oracle.estimate_motion_vector(g0, g1, ss, ps, costfn=costfn)
        got = np.asarray(estimate_motion_vector(g0, g1, ss, ps, costfn=costfn))
        np.testing.assert_array_equal(got, want)

    def test_batched_real_content(self):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector
        from oclcomputervision_jax.utils import load_gray

        f10 = np.asarray(load_gray("frame10.png"))[::6, ::6]
        f11 = np.asarray(load_gray("frame11.png"))[::6, ::6]
        b0, b1 = np.stack([f10, f11]), np.stack([f11, f10])
        got = np.asarray(estimate_motion_vector(b0, b1, 15, 5))
        for i in range(2):
            want = oracle.estimate_motion_vector(b0[i], b1[i], 15, 5)
            np.testing.assert_array_equal(got[i], want)


@pytest.mark.usefixtures("no_persistent_cache")
class TestMeExactSeededKernel:
    """The seeded exact search vs oracle/motion, eagerly and under
    jax.jit, for seeds of any extent."""

    @pytest.mark.parametrize(
        "ss,ps,h,w,costfn,mode,B",
        [
            (15, 5, 48, 70, "sad", "shipped", 8),   # pyramid defaults
            (15, 5, 33, 129, "sad", "fixed", 8),    # odd rows
            (9, 3, 40, 56, "ssd", "shipped", 8),    # two rounds, ssd
            (15, 5, 30, 40, "sad", "shipped", 12),  # wider clamp
        ],
    )
    def test_bit_identical_to_xla_twin(self, rng, ss, ps, h, w, costfn, mode, B):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector

        g0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        g1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        # seeds up to 1.5x B px
        seed = rng.uniform(-1.5 * B, 1.5 * B, (h, w, 2)).astype(np.float32)
        want = oracle.estimate_motion_vector(
            g0, g1, ss, ps, seed=seed, seed_mode=mode, costfn=costfn
        )
        got = np.asarray(
            estimate_motion_vector(
                g0, g1, ss, ps, seed=seed, seed_mode=mode, costfn=costfn
            )
        )
        np.testing.assert_array_equal(got, want)

    def test_batched_real_content(self, rng):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector
        from oclcomputervision_jax.utils import load_gray

        f10 = np.asarray(load_gray("frame10.png"))[::6, ::6]
        f11 = np.asarray(load_gray("frame11.png"))[::6, ::6]
        b0, b1 = np.stack([f10, f11]), np.stack([f11, f10])
        seed = rng.uniform(-6, 6, b0.shape + (2,)).astype(np.float32)
        got = np.asarray(estimate_motion_vector(b0, b1, 15, 5, seed=seed))
        for i in range(2):
            want = oracle.estimate_motion_vector(b0[i], b1[i], 15, 5, seed=seed[i])
            np.testing.assert_array_equal(got[i], want)

    @pytest.mark.parametrize("reach", [6.0, 20.0, 40.0])
    def test_jit_matches_eager_and_oracle(self, rng, reach):
        # tracer and concrete seeds take the same search, which agrees
        # with the oracle for any seed extent
        import jax

        from oclcomputervision_jax.ops.motion import estimate_motion_vector

        h, w = 36, 52
        g0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        g1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        seed = rng.uniform(-reach, reach, (h, w, 2)).astype(np.float32)
        want = oracle.estimate_motion_vector(g0, g1, 15, 5, seed=seed)
        eager = np.asarray(estimate_motion_vector(g0, g1, 15, 5, seed=seed))
        jitted = np.asarray(
            jax.jit(lambda a, b, s: estimate_motion_vector(a, b, 15, 5, seed=s))(
                g0, g1, seed
            )
        )
        np.testing.assert_array_equal(eager, want)
        np.testing.assert_array_equal(jitted, want)


class TestMeFastKernel:
    """The fast search vs oracle.estimate_motion_fast (the per-round
    gather form written plainly). Unseeded, the masked-shift warp
    ('auto') and the gather warp are the same search."""

    @pytest.mark.parametrize(
        "ss,ps,h,w,costfn",
        [
            (15, 5, 48, 70, "sad"),   # pyramid defaults
            (15, 5, 33, 129, "ssd"),  # odd rows
            (9, 3, 40, 56, "sad"),    # two rounds, small patch
            (7, 5, 24, 40, "sad"),    # single round
        ],
    )
    def test_unseeded_bit_identical(self, rng, ss, ps, h, w, costfn):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector

        g0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        g1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        want = oracle.estimate_motion_fast(g0, g1, ss, ps, costfn=costfn)
        for wb in ("auto", "gather"):
            got = np.asarray(
                estimate_motion_vector(
                    g0, g1, ss, ps, method="fast", costfn=costfn, warp_bound=wb
                )
            )
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("mode", ["shipped", "fixed"])
    def test_seeded_bit_identical(self, rng, mode):
        # the gather warp re-reads the whole field every round, exactly
        # as the oracle does (the masked-shift warp samples the seed
        # base at the shifted pixel instead - see _estimate_2d_fast)
        from oclcomputervision_jax.ops.motion import estimate_motion_vector

        h, w = 40, 60
        g0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        g1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        seed = rng.uniform(-12, 12, (h, w, 2)).astype(np.float32)
        want = oracle.estimate_motion_fast(g0, g1, 15, 5, seed=seed, seed_mode=mode)
        got = np.asarray(
            estimate_motion_vector(
                g0, g1, 15, 5, seed=seed, seed_mode=mode, method="fast",
                warp_bound="gather",
            )
        )
        np.testing.assert_array_equal(got, want)

    def test_batched_real_content(self):
        from oclcomputervision_jax.ops.motion import estimate_motion_vector
        from oclcomputervision_jax.utils import load_gray

        f10 = np.asarray(load_gray("frame10.png"))[::6, ::6]
        f11 = np.asarray(load_gray("frame11.png"))[::6, ::6]
        b0, b1 = np.stack([f10, f11]), np.stack([f11, f10])
        got = np.asarray(estimate_motion_vector(b0, b1, 15, 5, method="fast"))
        for i in range(2):
            want = oracle.estimate_motion_fast(b0[i], b1[i], 15, 5)
            np.testing.assert_array_equal(got[i], want)
