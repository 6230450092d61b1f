"""Serving-style video pipeline: enhancement + dense motion at frame rate.

The reference's production story was one interactive window equalizing
one video frame at a time with host round-trips per stage
(histeq_test.py). This harness shows the on-device equivalent: a
synthetic (or real, --video) stream processed in device-resident
batches - fused histeq -> resize per frame plus fast dense motion
between consecutive frames - reporting sustained frames/sec.

  python examples/video_pipeline.py [--frames 64] [--width 1280 --height 768]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.utils.cache import enable_compile_cache

    enable_compile_cache()

    from oclcomputervision_jax.ops.histeq import histeq_global
    from oclcomputervision_jax.ops.motion import estimate_motion_vector

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--video", default=None, help="optional real video path")
    args = ap.parse_args()

    h, w = args.height, args.width

    if args.video:
        import cv2

        cap = cv2.VideoCapture(args.video)
        frames = []
        while len(frames) < args.frames:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(cv2.resize(f, (w, h)), cv2.COLOR_BGR2GRAY))
        frames = [jnp.asarray(f) for f in frames]
    else:
        # synthetic panning scene (smooth content so ME has structure)
        keys = jax.random.split(jax.random.PRNGKey(0), 1)
        base = jax.random.uniform(keys[0], (h + 256, w + 256))
        k = jnp.ones((16, 16)) / 256.0
        base = jax.lax.conv_general_dilated(
            base[None, :, :, None], k[:, :, None, None], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )[0, :, :, 0]
        base = (base * 255).astype(jnp.uint8)
        frames = [
            jax.lax.dynamic_slice(base, (2 * i, 3 * i), (h, w))
            for i in range(args.frames)
        ]
    frames = jax.block_until_ready(frames)
    n = len(frames)
    print(f"{n} frames of {w}x{h}")

    @jax.jit
    def per_frame(prev, cur, acc):
        eq = histeq_global(cur)
        mv = estimate_motion_vector(prev, cur, 15, 5, method="fast")
        return acc + jnp.sum(eq, dtype=jnp.float32) + jnp.sum(mv)

    # warmup/compile
    acc = jnp.float32(0)
    acc = per_frame(frames[0], frames[1], acc)
    float(acc)

    mp = h * w / 1e6

    # (a) SUSTAINED throughput: one jitted lax.scan dispatch covers the
    # whole frame chain (bench.py's timing discipline - no host-overlap
    # ambiguity; this is the number bench.py emits as video_pipeline_fps)
    stack = jax.block_until_ready(jnp.stack(frames))

    @jax.jit
    def chain(fs):
        def step(acc, pc):
            prev, cur = pc
            return per_frame(prev, cur, acc), None

        return jax.lax.scan(step, jnp.float32(0), (fs[:-1], fs[1:]))[0]

    float(chain(stack))  # compile
    t0 = time.perf_counter()
    float(chain(stack))
    dt_scan = (time.perf_counter() - t0) / (n - 1)
    print(
        f"sustained (one scan dispatch): {dt_scan * 1e3:.2f} ms/frame = "
        f"{1 / dt_scan:.1f} fps ({mp / dt_scan:.0f} MP/s)"
    )

    # (b) STREAMING mode: one dispatch per frame, as a server receiving
    # frames would issue them. The host enqueues asynchronously, so
    # device execution of frame i overlaps the enqueue of frame i+1 -
    # wall/frames therefore measures pipelined streaming throughput.
    # It approaches (a) when per-frame device time exceeds the ~1-2 ms
    # async enqueue cost, and is NOT the per-frame latency (that is
    # enqueue + device + readback for a single frame).
    acc = jnp.float32(0)
    t0 = time.perf_counter()
    for i in range(1, n):
        acc = per_frame(frames[i - 1], frames[i], acc)
    float(acc)  # forced readback: completes the whole chain
    dt = (time.perf_counter() - t0) / (n - 1)
    print(
        f"streaming (dispatch per frame): {dt * 1e3:.2f} ms/frame = "
        f"{1 / dt:.1f} fps ({mp / dt:.0f} MP/s)"
    )


if __name__ == "__main__":
    main()
