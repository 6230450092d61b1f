"""Headless histogram-equalization demo (histeq_test.py equivalent).

The reference demo is an interactive cv2 window over a missing video
with alpha/punch/clip trackbars (histeq_test.py:53-145); this version
takes the same parameters as flags, equalizes the Y channel of a still
(or every frame of a video if --video is given), and writes a
side-by-side comparison against OpenCV CLAHE (the reference's baseline,
histeq_test.py:61,128).

  python examples/histeq_demo.py --alpha 1.0 --punch 0.05 --clip 2.0
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "out")

import numpy as np


def equalize_bgr(bgr, alpha, punch, clip, local):
    import cv2

    from oclcomputervision_jax import ops

    ycrcb = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
    y = ycrcb[:, :, 0]
    if local:
        h, w = y.shape
        bs = (min(256, h // 2), min(256, w // 2))
        y2 = y[: h - h % bs[0], : w - w % bs[1]]
        eq = np.asarray(ops.histeq_local_block(y2, alpha, punch, clip, bs))
        y = y.copy()
        y[: eq.shape[0], : eq.shape[1]] = eq
    else:
        y = np.asarray(ops.histeq_global(y, alpha, punch, clip))
    ycrcb = ycrcb.copy()
    ycrcb[:, :, 0] = y
    return cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2BGR)


def plot_hist(bgr, height=120):
    """Per-channel histogram overlay strip (histeq_test.py:63-99
    equivalent): channel histograms come from the device histogram
    grid, drawn as B/G/R curves on a black strip as wide as the image."""
    import cv2

    from oclcomputervision_jax.ops.histeq import histogram256

    w = bgr.shape[1]
    strip = np.zeros((height, w, 3), np.uint8)
    for c, color in enumerate(((255, 0, 0), (0, 255, 0), (0, 0, 255))):
        hist = np.asarray(histogram256(bgr[:, :, c].reshape(-1))).astype(np.float64)
        hist = hist / max(hist.max(), 1) * (height - 2)
        xs = np.linspace(0, w - 1, 256).astype(int)
        pts = np.stack([xs, height - 1 - hist.astype(int)], axis=1)
        cv2.polylines(strip, [pts.reshape(-1, 1, 2)], False, color, 1)
    return strip


def main():
    import cv2

    from oclcomputervision_jax.utils import asset_path
    from oclcomputervision_jax.utils.profiling import timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=asset_path("under_exposure.jpg"))
    ap.add_argument("--video", default=None, help="optional video path")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--punch", type=float, default=0.05)
    ap.add_argument("--clip", type=float, default=2.0)
    ap.add_argument("--local", action="store_true", help="local-block (CLAHE-style)")
    ap.add_argument("--out", default=os.path.join(_OUT, "histeq_demo.png"))
    args = ap.parse_args()

    if args.video:
        cap = cv2.VideoCapture(args.video)
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.resize(frame, (1280, 768))
            out, ms = timed(
                equalize_bgr, frame, args.alpha, args.punch, args.clip, args.local
            )
            n += 1
            print(f"frame {n}: {ms:.2f} ms")
        return

    bgr = cv2.imread(args.image)
    ours, ms = timed(equalize_bgr, bgr, args.alpha, args.punch, args.clip, args.local)
    print(f"ours ({'local' if args.local else 'global'}): {ms:.2f} ms (incl. compile)")

    # OpenCV CLAHE baseline, reference settings (histeq_test.py:61)
    clahe = cv2.createCLAHE(clipLimit=2, tileGridSize=(3, 5))
    ycrcb = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
    ycrcb[:, :, 0] = clahe.apply(ycrcb[:, :, 0])
    baseline = cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2BGR)

    panel = np.hstack([bgr, ours, baseline])
    hists = np.hstack([plot_hist(bgr), plot_hist(ours), plot_hist(baseline)])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cv2.imwrite(args.out, np.vstack([panel, hists]))
    print(f"wrote {args.out} (original | ours | cv2-CLAHE, with histograms)")


if __name__ == "__main__":
    main()
