"""The tooling around the library: asset decoding without cv2/PIL, the
compile-cache location, blocking, and chip_smoke.py rehearsed at toy
sizes on the CPU (its phases are the GPU smoke run's own code)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["lenna.png", "frame10.png", "frame11.png"])
def test_png_decoder_matches_cv2(name):
    import cv2

    from oclcomputervision_jax.utils import asset_path
    from oclcomputervision_jax.utils.assets import decode_png

    got = decode_png(asset_path(name))
    want = cv2.imread(asset_path(name), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(got, want)


def test_loaders_fall_back_to_the_png_decoder(monkeypatch):
    # with cv2 and PIL unimportable, load_image/load_gray still read PNGs
    import builtins

    from oclcomputervision_jax.utils import assets

    real_import = builtins.__import__

    def no_imaging(name, *a, **k):
        if name in ("cv2", "PIL") or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imaging)
    rgb = assets.load_image("frame10.png")
    gray = assets.load_gray("frame10.png")
    monkeypatch.undo()
    import cv2

    want = cv2.imread(assets.asset_path("frame10.png"), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(rgb, want)
    np.testing.assert_array_equal(gray, cv2.cvtColor(want, cv2.COLOR_RGB2GRAY))


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compile_cache() == str(tmp_path)
        assert enable_compile_cache("w1") == os.path.join(str(tmp_path), "w1")
        assert jax.config.jax_compilation_cache_dir == os.path.join(str(tmp_path), "w1")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_into_the_checkout(monkeypatch):
    import jax

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert "/.jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_block_propagates_errors():
    from oclcomputervision_jax.utils.profiling import timed

    class Broken:
        def block_until_ready(self):
            raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="device fault"):
        timed(lambda: Broken())


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )


@pytest.mark.parametrize("args", [["chip_smoke.py"], ["chip_smoke.py", "--multi"], ["bench.py"]])
def test_device_scripts_refuse_the_cpu(args):
    r = _run(args, ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and "metric" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def _name(phase):
    return phase.__name__.removeprefix("phase_")


@pytest.mark.parametrize("phase", chip_smoke.SINGLE, ids=_name)
def test_single_card_phase_at_toy_size(phase):
    phase(chip_smoke.TINY, np.random.default_rng(0))


@pytest.mark.parametrize("phase", chip_smoke.MULTI, ids=_name)
def test_multi_card_phase_on_virtual_devices(phase):
    phase(chip_smoke.TINY, np.random.default_rng(0))
