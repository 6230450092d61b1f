"""Native C++ host runtime vs the NumPy oracles."""

import numpy as np
import pytest

native = pytest.importorskip("oclcomputervision_jax.utils._native")

from oclcomputervision_jax import oracle
from oclcomputervision_jax.utils import asset_path, read_flo


class TestFloCodec:
    def test_decode_matches_numpy(self):
        with open(asset_path("flow10.flo"), "rb") as f:
            raw = f.read()
        got = native.decode_flo(raw)
        # numpy reference decode (bypass the native fast path)
        import numpy as np

        w = int(np.frombuffer(raw, np.int32, 1, 4)[0])
        h = int(np.frombuffer(raw, np.int32, 1, 8)[0])
        want = np.frombuffer(raw, np.float32, 2 * w * h, 12).reshape(h, w, 2)
        np.testing.assert_array_equal(got, want)

    def test_read_flo_uses_native(self):
        f = read_flo(asset_path("flow10.flo"))
        assert f.shape == (480, 640, 2)

    def test_rejects_garbage(self):
        with pytest.raises(ValueError):
            native.decode_flo(b"not a flo file at all")


class TestHostKernels:
    def test_hist_grid(self, lenna_gray):
        g = lenna_gray[:256, :512]
        got = native.hist_grid(g, (32, 256))
        want = oracle.hist_grid(g, (32, 256))
        np.testing.assert_array_equal(got, want)

    def test_transfer_func(self, lenna_gray):
        hist = np.bincount(lenna_gray.reshape(-1), minlength=256).astype(np.float64)
        got = native.calc_transfer_func(hist, 0.7, 0.05, 3.0)
        want = oracle.calc_transfer_func(hist, 0.7, 0.05, 3.0)
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_apply_lut(self, rng):
        img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
        lut = rng.integers(0, 256, size=256, dtype=np.uint8)
        np.testing.assert_array_equal(native.apply_lut(img, lut), lut[img])

    def test_tile_pack(self, rng):
        img = rng.integers(0, 256, size=(20, 300), dtype=np.uint8)
        out = native.tile_pack(img, (8, 128), pad_value=7)
        assert out.shape == (3, 3, 8, 128)
        np.testing.assert_array_equal(out[0, 0], img[:8, :128])
        assert (out[2, 2, 4:, :] == 7).all()  # padded rows
        np.testing.assert_array_equal(out[1, 2, :, :44], img[8:16, 256:300])


class TestBlockMatch:
    @pytest.mark.parametrize("seed_mode", ["shipped", "fixed"])
    def test_matches_python_oracle(self, frames_gray, seed_mode, rng):
        g0, g1 = frames_gray
        f0 = g0[100:140, 200:260]
        f1 = g1[100:140, 200:260]
        seed = rng.uniform(-3, 3, size=f0.shape + (2,)).astype(np.float32)
        got = native.block_match(f0, f1, 15, 5, seed=seed, seed_mode=seed_mode)
        want = oracle.estimate_motion_vector(f0, f1, 15, 5, seed=seed, seed_mode=seed_mode)
        np.testing.assert_array_equal(got, want)

    def test_no_seed(self, frames_gray):
        g0, g1 = frames_gray
        f0 = g0[100:132, 200:248]
        f1 = g1[100:132, 200:248]
        got = native.block_match(f0, f1, 15, 5)
        want = oracle.estimate_motion_vector(f0, f1, 15, 5)
        np.testing.assert_array_equal(got, want)
