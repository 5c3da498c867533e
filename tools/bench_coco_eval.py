#!/usr/bin/env python
"""Full-scale COCO-protocol evaluation benchmark (host CPU).

VERDICT r4 missing #4: the matcher tiers were microbenched per-case
(DESIGN.md finding 21) but a coco_eval at REAL density — 80 classes x ~5k
images x 10 IoU thresholds x ~100 post-NMS detections/image — had never
actually been run. This tool generates a synthetic detection set at that
scale and times ``aznet_tpu.eval.coco_eval.coco_eval`` end to end:

  - gt: ~7 objects/image, Zipf-ish class frequencies (a few head classes
    dominate, a long tail — the shape that stresses the per-class loops),
    log-uniform sizes spanning the small/medium/large area ranges, ~2%
    crowd boxes;
  - detections: ~85% of gts re-found with jittered boxes and high scores
    (1-3 dets each — duplicate suppression load), plus random false
    positives to ~100 dets/image, assigned mostly to classes present in
    the image (realistic confusion), spread over all 80 classes globally.

Run (host CPU only — safe while anything trains on the card):
  python tools/bench_coco_eval.py                 # C++ tier (default)
  python tools/bench_coco_eval.py --images 500    # quick shape check
  python tools/bench_coco_eval.py --tiers native,numpy

Prints one JSON line per tier: wall-clock, AP/AR summary (tiers must agree
— asserted), dets/s. Reference equivalent: pycocotools ``COCOeval`` (the
reference repo's COCO path is unverified — mount empty, SURVEY.md §2.2).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_coco_scale_set(n_images: int = 5000, n_classes: int = 81,
                        dets_per_img: int = 100, seed: int = 0):
    """Synthetic (all_boxes, roidb) at COCO post-NMS density."""
    rng = np.random.RandomState(seed)
    n_fg = n_classes - 1
    # Zipf-ish class popularity (COCO: 'person' is ~30% of instances).
    pop = 1.0 / np.arange(1, n_fg + 1) ** 0.9
    pop /= pop.sum()
    roidb = []
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in range(n_images)]
                 for _ in range(n_classes)]
    img_hw = (480.0, 640.0)

    for i in range(n_images):
        n_gt = rng.poisson(7) + 1
        cls = rng.choice(n_fg, size=n_gt, p=pop) + 1
        # log-uniform sizes 8..400 px -> covers small/medium/large ranges
        w = np.exp(rng.uniform(np.log(8.0), np.log(400.0), n_gt))
        h = w * np.exp(rng.uniform(-0.7, 0.7, n_gt))
        x1 = rng.uniform(0, img_hw[1] - w)
        y1 = rng.uniform(0, img_hw[0] - np.minimum(h, img_hw[0] - 1))
        gt = np.stack([x1, y1, x1 + w - 1, y1 + h - 1], 1).astype(np.float32)
        crowd = rng.rand(n_gt) < 0.02
        roidb.append({"boxes": gt, "gt_classes": cls.astype(np.int64),
                      "crowd": crowd})

        # Detections: jittered copies of most gts + false positives.
        det_boxes, det_cls, det_scores = [], [], []
        for g in range(n_gt):
            if rng.rand() < 0.85:
                for _ in range(rng.randint(1, 4)):
                    bw, bh = gt[g, 2] - gt[g, 0], gt[g, 3] - gt[g, 1]
                    jit = rng.normal(0, 0.08, 4) * np.array([bw, bh, bw, bh])
                    det_boxes.append(gt[g] + jit)
                    det_cls.append(cls[g])
                    det_scores.append(rng.uniform(0.5, 1.0))
        n_fp = max(dets_per_img - len(det_boxes), 0)
        fw = np.exp(rng.uniform(np.log(8.0), np.log(300.0), n_fp))
        fh = fw * np.exp(rng.uniform(-0.7, 0.7, n_fp))
        fx = rng.uniform(0, img_hw[1] - fw)
        fy = rng.uniform(0, img_hw[0] - np.minimum(fh, img_hw[0] - 1))
        for j in range(n_fp):
            det_boxes.append(np.array(
                [fx[j], fy[j], fx[j] + fw[j] - 1, fy[j] + fh[j] - 1]))
            # 60% of FPs land on classes present in the image (confusions),
            # the rest anywhere — keeps per-(class,image) density realistic.
            det_cls.append(cls[rng.randint(n_gt)] if rng.rand() < 0.6
                           else rng.choice(n_fg, p=pop) + 1)
            det_scores.append(rng.uniform(0.01, 0.6))
        det_boxes = np.asarray(det_boxes, np.float32).reshape(-1, 4)
        det_cls = np.asarray(det_cls)
        det_scores = np.asarray(det_scores, np.float32)
        for c in np.unique(det_cls):
            m = det_cls == c
            all_boxes[int(c)][i] = np.concatenate(
                [det_boxes[m], det_scores[m, None]], 1).astype(np.float32)
    return all_boxes, roidb


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=5000)
    p.add_argument("--classes", type=int, default=81)
    p.add_argument("--dets-per-img", type=int, default=100)
    p.add_argument("--tiers", default="native,numpy",
                   help="comma list of matcher tiers to time: native,numpy")
    args = p.parse_args()

    from aznet_tpu.eval.coco_eval import coco_eval
    from aznet_tpu.utils import native

    t0 = time.perf_counter()
    all_boxes, roidb = make_coco_scale_set(args.images, args.classes,
                                           args.dets_per_img)
    n_dets = sum(all_boxes[c][i].shape[0] for c in range(1, args.classes)
                 for i in range(args.images))
    print(f"# generated {args.images} images, {n_dets} dets "
          f"({n_dets / args.images:.1f}/img), "
          f"{sum(r['boxes'].shape[0] for r in roidb)} gts in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    results = {}
    for tier in args.tiers.split(","):
        if tier == "native" and not native.coco_match_available():
            print("# native tier unavailable (make -C csrc); skipping",
                  flush=True)
            continue
        os.environ["AZNET_NO_NATIVE_COCO"] = "1" if tier == "numpy" else "0"
        t0 = time.perf_counter()
        out = coco_eval(all_boxes, roidb, args.classes)
        dt = time.perf_counter() - t0
        summary = {k: round(float(out[k]), 4) for k in
                   ("AP", "AP50", "AP75", "AP_small", "AP_medium",
                    "AP_large", "AR@1", "AR@10", "AR@100")}
        results[tier] = summary
        print(json.dumps({"tier": tier, "wall_s": round(dt, 1),
                          "dets_per_s": round(n_dets / dt),
                          **summary}), flush=True)
    if len(results) == 2:
        a, b = results.values()
        assert a == b, f"tier results diverge: {a} vs {b}"
        print("# tiers agree on every metric", flush=True)


if __name__ == "__main__":
    main()
