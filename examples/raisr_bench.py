"""RAISR benchmark (super_resolution/raisr.py __main__ equivalent).

The reference benchmarked against Set5 assets and pre-trained filters
that are not in its repo (raisr.py:143-147,77); this harness uses the
in-repo images: it loads (or trains) the shipped filter bank, degrades
a held-out image 2x, restores it with bilinear / bicubic / RAISR, and
reports PSNR for each plus kernel timing over 20 iterations.

  python examples/raisr_bench.py [--image frame11.png] [--train]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from oclcomputervision_jax.models.raisr import RaisrModel, train_filters
    from oclcomputervision_jax.ops.interpolation import resize_uint8
    from oclcomputervision_jax.utils import asset_path, load_gray, load_image, psnr
    from oclcomputervision_jax.utils.config import RaisrConfig
    from oclcomputervision_jax.utils.profiling import bench_op, timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default="frame11.png", help="held-out eval asset")
    ap.add_argument("--train", action="store_true", help="retrain instead of loading")
    ap.add_argument("--loop", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()

    bank = asset_path("raisr_filters_x2.npz")
    if args.train or not os.path.isfile(bank):
        cfg = RaisrConfig(fidelity="full")
        imgs = [load_image(n) for n in ("lenna.png", "frame10.png", "under_exposure.jpg")]
        model, ms = timed(lambda: RaisrModel(cfg=cfg).train(imgs))
        print(f"trained filter bank in {ms:.0f} ms on {jax.devices()[0]}")
        model.save(bank)
    else:
        model = RaisrModel.load(bank)

    hr = load_gray(args.image)
    h, w = (hr.shape[0] // 2) * 2, (hr.shape[1] // 2) * 2
    hr = hr[:h, :w]
    lr = hr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)

    bil = np.asarray(resize_uint8(lr, (h, w), "bilinear"))
    bic = np.asarray(resize_uint8(lr, (h, w), "bicubic"))
    ra, ms = timed(model.upsample, lr)
    ra = np.asarray(ra)
    print(f"first RAISR call (incl. compile): {ms:.1f} ms")

    dev = jnp.asarray(lr)
    ms = bench_op(model.upsample, dev, iters=args.loop)
    mp_out = h * w / 1e6
    print(f"RAISR 2x single image: {ms:.2f} ms = {mp_out / ms * 1000:.0f} MP out/s"
          " (dispatch-bound at this size; see the batched rate below)")

    # serving rate: a resident batch amortizes the per-dispatch overhead
    batch = jnp.asarray(np.stack([np.asarray(lr)] * args.batch))
    ms = bench_op(model.upsample, batch, iters=max(3, args.loop // 4))
    print(
        f"RAISR 2x batch-{args.batch}: {ms / args.batch:.2f} ms/img = "
        f"{args.batch * mp_out / ms * 1000:.0f} MP out/s"
    )
    print(
        "PSNR vs HR: bilinear {:.3f}  bicubic {:.3f}  raisr {:.3f}".format(
            psnr(bil, hr), psnr(bic, hr), psnr(ra, hr)
        )
    )


if __name__ == "__main__":
    main()
