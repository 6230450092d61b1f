"""Train + ship the RAISR filter banks under an honest quality protocol.

Round-2's banks used a per-scale ridge tuned on frame11 PSNR - the same
frame the PARITY quality table reports - i.e. test-set tuning (VERDICT
r2 weakness 3). This script is the shipped-bank provenance under a
proper split:

  TRAIN   lenna, frame10, the left 60% of under_exposure, plus one
          pyrDown level of each (scale diversity; the reference's
          missing bank was BSDS500-trained - in-repo assets are all we
          have, download-pre-trained-weights.txt:1).
  VAL     the right 40% of under_exposure (never trained on): the
          per-scale ridge is grid-searched on VAL PSNR only.
  REPORT  frame11 - untouched by training AND tuning; the PARITY table
          and tests/test_raisr.py quality gate measure here.

Usage:  python examples/train_banks.py [--scales 2 3 4] [--report-only]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

RIDGE_GRID = (0.002, 0.004, 0.006, 0.01, 0.015, 0.03)


def corpus():
    from oclcomputervision_jax.oracle.pyramid import pyr_down
    from oclcomputervision_jax.utils import load_gray, load_image

    ue = load_image("under_exposure.jpg")
    split = int(ue.shape[1] * 0.6)
    train = [load_image("lenna.png"), load_image("frame10.png"), ue[:, :split]]
    # one pyramid level of each: filters see both native and halved scale
    train += [pyr_down(load_gray(n)) for n in ("lenna.png", "frame10.png")]
    train += [pyr_down(np.asarray(load_gray("under_exposure.jpg"))[:, :split])]
    val = np.asarray(load_gray("under_exposure.jpg"))[:, split:]
    return train, val


def degrade(hr, s):
    h, w = (hr.shape[0] // s) * s, (hr.shape[1] // s) * s
    hr = hr[:h, :w]
    lr = hr.reshape(h // s, s, w // s, s).mean(axis=(1, 3)).round().astype(np.uint8)
    return hr, lr


def quality(model, hr_img):
    from oclcomputervision_jax.ops.interpolation import resize_uint8
    from oclcomputervision_jax.utils import psnr

    s = model.cfg.scale
    hr, lr = degrade(hr_img, s)
    ra = np.asarray(model.upsample(lr))
    bic = np.asarray(resize_uint8(lr, hr.shape, "bicubic"))
    return psnr(ra, hr), psnr(bic, hr)


def main():
    from oclcomputervision_jax.utils.cache import enable_compile_cache

    enable_compile_cache()

    from oclcomputervision_jax.models.raisr import RaisrModel, train_filters
    from oclcomputervision_jax.utils import load_gray
    from oclcomputervision_jax.utils.assets import asset_path
    from oclcomputervision_jax.utils.config import RaisrConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--scales", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument(
        "--report-only", action="store_true",
        help="skip training; report frame11 PSNR of the shipped banks",
    )
    args = ap.parse_args()

    report = load_gray("frame11.png")
    for s in args.scales:
        bank = asset_path(f"raisr_filters_x{s}.npz")
        if args.report_only:
            m = RaisrModel.load(bank, fidelity="full")
            p_r, p_b = quality(m, report)
            print(f"x{s}: frame11 PSNR raisr {p_r:.2f} bicubic {p_b:.2f} "
                  f"(+{p_r - p_b:.2f})")
            continue
        train, val = corpus()
        cfg = RaisrConfig(scale=s, fidelity="full")
        # the G/r accumulators are ridge-independent: accumulate once,
        # re-solve per grid point
        import jax.numpy as jnp

        from oclcomputervision_jax.models.raisr import (
            _training_arrays,
            accumulate_normal_eq,
            solve_filters,
        )
        from oclcomputervision_jax.oracle import raisr as oracle_raisr

        d = cfg.filter_len**2
        g = jnp.zeros((cfg.num_filters, d, d), jnp.float32)
        r = jnp.zeros((cfg.num_filters, d), jnp.float32)
        cnt = jnp.zeros((cfg.num_filters,), jnp.float32)
        for img in train:
            img = np.asarray(img)
            if img.ndim == 3:
                y01 = (img.astype(np.float64) / 255.0) @ oracle_raisr.RGB2YUV[0]
            else:
                y01 = img.astype(np.float64) / 255.0
            p, t, f = _training_arrays(jnp.asarray(y01, jnp.float32), cfg)
            dg, dr, dc = accumulate_normal_eq(p, t, f, cfg.num_filters)
            g, r, cnt = g + dg, r + dr, cnt + dc
        best = (None, -1.0, None)
        for ridge in RIDGE_GRID:
            f = solve_filters(g, r, cnt, cfg.filter_len, ridge)
            m = RaisrModel(cfg=cfg, filters=f)
            p_val, _ = quality(m, val)
            print(f"x{s} ridge={ridge}: val PSNR {p_val:.3f}")
            if p_val > best[1]:
                best = (ridge, p_val, f)
        ridge, p_val, f = best
        m = RaisrModel(cfg=cfg, filters=f)
        m.save(bank)
        p_r, p_b = quality(m, report)
        print(
            f"x{s}: shipped ridge={ridge} (val {p_val:.2f}); frame11 PSNR "
            f"raisr {p_r:.2f} bicubic {p_b:.2f} (+{p_r - p_b:.2f})"
        )


if __name__ == "__main__":
    main()
