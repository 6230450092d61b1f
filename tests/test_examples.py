"""Smoke coverage for the example harnesses (SURVEY C11-C13): each demo
must run end-to-end headless on the CPU backend. The reference's demos
were interactive-only and untestable; these are the pytest twins of the
'manual drive' rows in PARITY.md."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, args, timeout=900):
    # force the CPU backend inside the subprocess
    code = (
        "import jax, sys, runpy;"
        "jax.config.update('jax_platforms', 'cpu');"
        f"sys.argv = [{script!r}, *{args!r}];"
        f"runpy.run_path({script!r}, run_name='__main__')"
    )
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_me_demo_runs_and_scores(tmp_path):
    r = _run(
        "examples/me_demo.py",
        ["--levels", "2", "--method", "fast", "--refine", "none",
         "--outdir", str(tmp_path), "--probe", "120", "200"],
        # --refine none: the hybrid's exact passes cost ~2 min on the
        # 1-core CPU backend; the hybrid itself is covered by
        # test_motion.TestHybridRefine
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "EPE" in r.stdout and "layer 1" in r.stdout
    assert (tmp_path / "layer0.flo").exists()
    assert (tmp_path / "probe_120_200.png").exists()


def test_histeq_demo_writes_panel(tmp_path):
    out = str(tmp_path / "panel.png")
    r = _run("examples/histeq_demo.py", ["--out", out])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)


def test_interpolation_bench_protocol(tmp_path):
    # the 1024^2 -> 2048^2 lenna protocol with PSNR vs the fp64 oracle
    # (interpolation.py:109-246's benchmark, headless)
    r = _run("examples/interpolation_bench.py", [], timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    for method in ("bilinear", "bicubic"):
        assert f"{method}: cv2 took" in r.stdout
        assert f"{method}: JAX took" in r.stdout
    # oracle agreement is part of the protocol: PSNR lines must parse
    # and the library output must be near-exact vs the oracle
    import re

    vals = [float(m) for m in re.findall(r"PSNR vs oracle: ([0-9.]+|inf)", r.stdout.replace("inf", "99"))]
    assert len(vals) == 4 and min(vals[1::2]) > 50  # library rows


def test_profile_device_reports_ops():
    # a CPU trace has no GPU device plane: the helper must say so rather
    # than report a device time of zero
    import jax
    import jax.numpy as jnp
    import pytest

    from oclcomputervision_jax.utils.profiling import profile_device

    f = jax.jit(lambda x: jnp.sum(x @ x))
    x = jnp.ones((256, 256), jnp.float32)
    _ = f(x)  # warmup/compile outside the trace
    with pytest.raises(RuntimeError, match="no GPU stream events"):
        profile_device(f, x)


def test_profile_leaf_sum_excludes_control_flow_wrappers():
    # A cond/while wrapper event spans its executed branch on the same
    # timeline line; counting both would double the device total. Only
    # leaf intervals may count.
    from oclcomputervision_jax.utils.profiling import _sum_leaf_ops

    events = [
        (0, 1000, "fusion.1"),          # leaf
        (1000, 500, "cond.23.clone"),   # wrapper: contains the branch
        (1010, 480, "branch_5_fun"),    # nested leaf
        (1600, 200, "fusion.2"),        # leaf after the cond closes
    ]
    prof = _sum_leaf_ops({(0, 0): events})
    assert "cond.23.clone" not in prof
    assert prof["branch_5_fun"] == 0.48
    assert abs(prof["__total__"] - (1.0 + 0.48 + 0.2)) < 1e-9
    # two threads stay independent; same-name leaves accumulate
    prof2 = _sum_leaf_ops({(0, 0): events, (0, 1): [(0, 100, "fusion.1")]})
    assert abs(prof2["fusion.1"] - 1.1) < 1e-9
