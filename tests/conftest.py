"""Test env: run everything on the CPU backend with 8 virtual devices, so
the whole suite (incl. multi-device sharding tests) needs no GPU. Tests
that need a GPU carry the ``gpu`` marker and skip here (see ``gpu``
below); run them on a GPU machine with ``python -m pytest -m gpu tests/``
and JAX_PLATFORMS unset. The suite itself runs with JAX_PLATFORMS=cpu."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
import pytest

from oclcomputervision_jax.utils.cache import enable_compile_cache

# persistent compilation cache, one directory per xdist worker:
# concurrent reads/writes from several processes on one directory have
# crashed jax's compilation-cache code
enable_compile_cache(os.path.join("tests", os.environ.get("PYTEST_XDIST_WORKER", "main")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided
    here, at run time, never at import or collection (every xdist worker
    must collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; JAX found none")
    return devs[0]


# Bound live-executable accumulation in the single test process.
#
# Both r4 full-suite segfaults AND the r5 repro (cache disabled for the
# whole seeded-ME class) died at the ~197th test inside XLA CPU
# compile/load paths - different tests, different code paths
# (get_executable_and_time in r4, plain backend_compile_and_load in
# r5), same cumulative point. The crash follows the test COUNT, not any
# test: a resource the CPU client accumulates per live compiled
# executable (LLVM ORC JIT code memory) runs out ~200 heavyweight
# compiles in, and the next compile segfaults. Dropping references to
# old executables every 30 tests keeps the live set far from the
# threshold; the persistent disk cache makes the re-JITs cheap.
_TESTS_SINCE_CLEAR = [0]


@pytest.fixture(autouse=True)
def _bound_live_executables():
    yield
    _TESTS_SINCE_CLEAR[0] += 1
    if _TESTS_SINCE_CLEAR[0] >= 30:
        _TESTS_SINCE_CLEAR[0] = 0
        import jax as _jax

        _jax.clear_caches()


@pytest.fixture
def no_persistent_cache():
    """Disable the persistent compilation cache for one test.

    XLA's CPU executable (de)serialization has segfaulted three times
    deep into long suite runs (r4: put_executable_and_time AND
    get_executable_and_time, always on the rebased seeded-ME
    executable; standalone runs of the same test read and write the
    entry fine). Tests whose executables trip it opt out - they
    recompile every run (~25 s) instead of crashing the suite.

    Toggling jax_compilation_cache_dir alone is NOT enough: the cache
    object and the is_cache_used() verdict are memoized in module
    globals once the first compile initializes them, so the flag flip
    must be paired with reset_cache() (and again on restore, so later
    tests re-initialize with the directory)."""
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    _cc.reset_cache()


@pytest.fixture(scope="session")
def lenna_gray():
    from oclcomputervision_jax.utils import load_gray

    return load_gray("lenna.png")


@pytest.fixture(scope="session")
def lenna_rgb():
    from oclcomputervision_jax.utils import load_image

    return load_image("lenna.png")


@pytest.fixture(scope="session")
def under_exposure_gray():
    from oclcomputervision_jax.utils import load_gray

    return load_gray("under_exposure.jpg")


@pytest.fixture(scope="session")
def frames_gray():
    from oclcomputervision_jax.utils import load_gray

    return load_gray("frame10.png"), load_gray("frame11.png")


@pytest.fixture(scope="session")
def flow_gt():
    from oclcomputervision_jax.utils import asset_path, read_flo

    return read_flo(asset_path("flow10.flo"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
