"""Pyramidal motion-estimation harness (me_test.py equivalent, headless).

Runs the 3-level coarse-to-fine block-matching flow on the Middlebury
frame10/11 pair, writes layer{0,1,2}.flo like the reference
(me_test.py:83-92), saves HSV flow visualizations, and - unlike the
reference, which only compared flows visually - scores every level
against the flow10.flo ground truth with average endpoint error.

  python examples/me_demo.py [--seed-mode fixed|shipped]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "out")

import numpy as np


def main():
    from oclcomputervision_jax.ops.motion import estimate_motion_pyramid
    from oclcomputervision_jax.utils import asset_path, epe, load_gray, read_flo, write_flo
    from oclcomputervision_jax.utils.profiling import timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed-mode", default="fixed", choices=["fixed", "shipped"])
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--method", default="exact", choices=["exact", "fast"])
    ap.add_argument("--smooth", type=int, default=0,
                    help="median-filter kernel between levels (0=off; 9 halves EPE)")
    ap.add_argument("--subpixel", type=int, default=0,
                    help="rounds of (equiangular subpixel refine -> median) per "
                         "level (0=off; 12 cuts EPE a further ~35%% over --smooth 9)")
    ap.add_argument("--outdir", default=_OUT)
    ap.add_argument("--probe", type=int, nargs=2, metavar=("Y", "X"),
                    help="also write the zoomed search view at this pixel")
    ap.add_argument("--refine", default="auto",
                    choices=["auto", "exact", "none"],
                    help="hybrid refinement schedule for --method fast "
                         "(see estimate_motion_pyramid)")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    g0 = load_gray("frame10.png")
    g1 = load_gray("frame11.png")
    gt = read_flo(asset_path("flow10.flo"))

    flows, ms = timed(
        estimate_motion_pyramid, g0, g1, args.levels, 15, 5, args.seed_mode,
        args.method, args.smooth, subpixel=args.subpixel, refine=args.refine,
    )
    print(f"{args.levels}-level pyramid flow: {ms:.1f} ms (incl. compile)")

    print(f"zero-flow EPE baseline: {epe(np.zeros_like(gt), gt):.3f}")
    for lv, mv in enumerate(flows):
        mv = np.asarray(mv)
        scale = 2 ** (len(flows) - 1 - lv)
        gts = gt[::scale, ::scale] / scale
        gts = gts[: mv.shape[0], : mv.shape[1]]
        path = os.path.join(args.outdir, f"layer{lv}.flo")
        write_flo(mv, path)
        print(
            f"layer {lv} {mv.shape[1]}x{mv.shape[0]}: EPE {epe(mv, gts):.3f} -> {path}"
        )
        try:
            import cv2

            from oclcomputervision_jax.compat import mv2hsv

            cv2.imwrite(os.path.join(args.outdir, f"layer{lv}.png"), mv2hsv(mv, scale))
        except ImportError:
            pass

    try:
        import cv2

        if hasattr(cv2, "optflow"):
            base = cv2.optflow.calcOpticalFlowSparseToDense(g0, g1)
            print(f"cv2 sparse-to-dense baseline EPE: {epe(base, gt):.3f}")
    except Exception:
        pass

    overlay = write_search_overlay(
        g0, np.asarray(flows[-1]), 15, 5, os.path.join(args.outdir, "search_overlay.png")
    )
    if overlay:
        print(f"search/flow overlay -> {overlay}")

    if args.probe:
        py, px = args.probe
        zoom = write_probe_zoom(
            g0, g1, np.asarray(flows[-1]), py, px, 15, 5,
            os.path.join(args.outdir, f"probe_{py}_{px}.png"),
        )
        if zoom:
            print(f"zoomed probe view -> {zoom}")


def write_search_overlay(g0, mv, search_size, patch_size, path, grid=24):
    """Headless equivalent of the reference's visualizeSearch/visualizeME
    cv2 windows (me_pyramid.py:51-84, 129): draws, on frame 0, the
    search window + patch box at a sparse probe grid and the matched
    displacement as an arrow, then writes ONE annotated image instead of
    popping a window per pixel.
    """
    try:
        import cv2
    except ImportError:
        return None
    img = cv2.cvtColor(g0, cv2.COLOR_GRAY2BGR)
    pm, sm = patch_size // 2, search_size // 2
    h, w = g0.shape
    for y in range(grid, h - grid, grid):
        for x in range(grid, w - grid, grid):
            u, v = mv[y, x]
            cv2.rectangle(img, (x - sm, y - sm), (x + sm, y + sm), (80, 80, 80), 1)
            cv2.rectangle(img, (x - pm, y - pm), (x + pm, y + pm), (0, 200, 0), 1)
            cv2.arrowedLine(
                img, (x, y), (int(round(x + u)), int(round(y + v))),
                (0, 0, 255), 1, tipLength=0.35,
            )
    cv2.imwrite(path, img)
    return path


def write_probe_zoom(g0, g1, mv, y, x, search_size, patch_size, path, scale=12):
    """Headless twin of the reference's per-candidate visualizeSearch
    loop (me_pyramid.py:59-64, 75-84): writes ONE zoomed image of probe
    (y, x)'s search region in frame 1 with the zero-displacement
    candidate box (red) and the matched best box (green), next to the
    30x-style zoomed patch from frame 0, instead of a cv2.waitKey()
    stepper per candidate.
    """
    try:
        import cv2
    except ImportError:
        return None
    import numpy as np

    pm, sm = patch_size // 2, search_size // 2
    h, w = g0.shape
    y = int(np.clip(y, sm, h - sm - 1))
    x = int(np.clip(x, sm, w - sm - 1))
    region = g1[y - sm : y + sm + 1, x - sm : x + sm + 1]
    big = cv2.cvtColor(region, cv2.COLOR_GRAY2BGR)
    big = cv2.resize(
        big, (big.shape[1] * scale, big.shape[0] * scale),
        interpolation=cv2.INTER_NEAREST,
    )

    def box(img, cy, cx, color):
        cv2.rectangle(
            img,
            ((cx - pm) * scale, (cy - pm) * scale),
            ((cx + pm + 1) * scale - 1, (cy + pm + 1) * scale - 1),
            color,
            2,
        )

    u, v = mv[y, x]
    box(big, sm, sm, (0, 0, 255))  # zero-displacement candidate
    box(big, sm + int(round(v)), sm + int(round(u)), (0, 255, 0))  # match
    patch = g0[y - pm : y + pm + 1, x - pm : x + pm + 1]
    pz = cv2.cvtColor(patch, cv2.COLOR_GRAY2BGR)
    pz = cv2.resize(
        pz, (patch_size * scale, patch_size * scale),
        interpolation=cv2.INTER_NEAREST,
    )
    panel = np.zeros((big.shape[0], big.shape[1] + pz.shape[1] + scale, 3), np.uint8)
    panel[:, : big.shape[1]] = big
    panel[: pz.shape[0], big.shape[1] + scale :] = pz
    cv2.imwrite(path, panel)
    return path


if __name__ == "__main__":
    main()
