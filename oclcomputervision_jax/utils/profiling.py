"""Timing helpers.

The reference returned per-dispatch elapsed milliseconds from OpenCL
event profiling (histeq/eq_opencl.py:6-7). The equivalent here keeps the
same "(result, elapsed_ms)" API shape, using block_until_ready wall time
under jit; jax.profiler traces can be enabled around any timed region.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Tuple


def _block(x: Any) -> None:
    import jax

    jax.block_until_ready(x)


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run fn(*args, **kwargs), blocking on the result; return (result, ms)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _block(out)
    return out, (time.perf_counter() - t0) * 1000.0


class Timer:
    """Accumulating wall-clock timer (milliseconds)."""

    def __init__(self) -> None:
        self.total_ms = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        yield
        self.total_ms += (time.perf_counter() - t0) * 1000.0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Wrap a region in a jax.profiler trace (device timeline in TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_device(fn: Callable, *args, logdir: str | None = None) -> dict:
    """Per-kernel GPU milliseconds of one fn(*args) call, from a profiler
    trace: {kernel_name: ms}, plus '__total__' (their sum).

    Reads the trace's GPU device planes ("/device:GPU:<n>") and counts
    the events on their stream lines (kernels and copies, as the CUDA
    tracer records them). Raises RuntimeError when the trace has no GPU
    device events - a CPU run has no device time to report. fn should
    be jitted and already warmed up (compilation inside the trace is
    host time, not device time).
    """
    import glob
    import os
    import tempfile

    import jax

    logdir = logdir or tempfile.mkdtemp(prefix="ocv_profile_")
    with jax.profiler.trace(logdir):
        jax.block_until_ready(fn(*args))
    traces = sorted(glob.glob(os.path.join(logdir, "plugins/profile/*/*.xplane.pb")))
    if not traces:
        raise RuntimeError(f"jax.profiler wrote no trace under {logdir}")
    return device_ops_ms(traces[-1])


def device_ops_ms(xplane_path: str) -> dict:
    """{kernel_name: ms} + '__total__' over the GPU stream lines of one
    .xplane.pb trace (see profile_device)."""
    from jax.profiler import ProfileData

    by_line: dict = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            by_line[(plane.name, line.name)] = [
                (e.start_ns / 1e3, e.duration_ns / 1e3, e.name) for e in line.events
            ]
    if not any(by_line.values()):
        raise RuntimeError(
            f"{xplane_path}: no GPU stream events in the trace (not a GPU run?)"
        )
    return _sum_leaf_ops(by_line)


def _sum_leaf_ops(by_thread: dict) -> dict:
    """{op: ms} + '__total__' over LEAF trace intervals only.

    ``by_thread`` maps line key -> [(start_us, dur_us, name), ...].
    Intervals on one line are well-nested, so a stack walk marks
    parents; only events with no contained child are counted, so a
    wrapper event spanning its children is not counted twice.
    """
    per_op: dict = {}
    total = 0.0

    def _close(entry):
        nonlocal total
        _end, name, ms, has_child = entry
        if not has_child:
            per_op[name] = per_op.get(name, 0.0) + ms
            total += ms

    for events in by_thread.values():
        events.sort(key=lambda t: (t[0], -t[1]))
        stack: list = []  # [end_ts, name, ms, has_child]
        for ts, dur, name in events:
            while stack and ts >= stack[-1][0]:
                _close(stack.pop())
            if stack:
                stack[-1][3] = True
            stack.append([ts + dur, name, dur / 1e3, False])
        while stack:
            _close(stack.pop())
    per_op["__total__"] = total
    return per_op


def bench_op(fn: Callable, *args, warmup: int = 2, iters: int = 20) -> float:
    """Median wall-clock ms of fn(*args) after warmup, blocking each call."""
    for _ in range(warmup):
        _block(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]
