#!/usr/bin/env python
"""Training-step benchmark: step time, MFU, prefetcher overlap.

Measures the full-width compiled train step (forward + backward + SGD)
with the scan-difference timer bench.py uses, plus:

  - MFU: XLA's own cost analysis of the compiled step (flops) divided by
    measured time, against the device's published bf16 peak
    (``aznet_tpu/utils/device.py``; GPU runs only).
  - prefetch overlap: host minibatch-build time (the _Prefetcher's work)
    vs device step time — the fraction of host work hidden behind compute.

Reference equivalent: the solver loop this replaces (SURVEY.md §3.3;
reference trains single-GPU Caffe, no throughput tooling beyond log
timestamps).

Usage:
  python tools/bench_train.py [--net az|frcnn] [--cfg ...] [--set K V ...]
  python tools/bench_train.py --cpu --smoke     # CPU sanity run
"""

import argparse
import json
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args():
    p = argparse.ArgumentParser(description="aznet_tpu training-step benchmark")
    p.add_argument("--net", choices=("az", "frcnn"), default="az")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 800),
                   help="training blob shape (default: the 600x800 scale)")
    p.add_argument("--steps", type=int, nargs=2, default=(2, 6),
                   metavar=("LO", "HI"), help="scan-difference step counts")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--smoke", action="store_true",
                   help="tiny smallnet config (CPU sanity)")
    p.add_argument("--ims-per-batch", type=int, default=0,
                   help="override TRAIN.IMS_PER_BATCH (0 = cfg value); "
                        "the MFU-vs-batch lever, DESIGN.md finding 26")
    p.add_argument("--remat", action="store_true",
                   help="set TRAIN.REMAT_TRUNK (trunk rematerialization)")
    return p.parse_args()


def main():
    args = parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax
    import jax.numpy as jnp

    from bench import scan_diff_time
    from aznet_tpu.utils import device
    from aznet_tpu.config import Config, cfg_from_file, cfg_from_list
    from aznet_tpu.data.imdb import get_imdb
    from aznet_tpu.data.minibatch import get_az_minibatch, get_frcnn_minibatch
    from aznet_tpu.models import AZNet, FRCNN
    from aznet_tpu.train import (make_az_train_state, make_az_train_step,
                                 make_frcnn_train_state)
    from aznet_tpu.train.train_frcnn import make_frcnn_train_step

    cfg = Config()
    if args.cfg:
        cfg = cfg_from_file(cfg, args.cfg)
    if args.smoke:
        cfg = cfg_from_list(cfg, [
            "MODEL.BACKBONE", "smallnet", "MODEL.FC_DIM", "32",
            "MODEL.NUM_TEMPLATES", "5", "MODEL.NUM_CLASSES", "4",
            "MODEL.COMPUTE_DTYPE", "float32",
            "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96",
            "TRAIN.REGIONS_PER_IMAGE", "16"])
        args.canvas = (64, 96)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)
    if args.ims_per_batch:
        cfg = cfg_from_list(cfg, ["TRAIN.IMS_PER_BATCH",
                                  str(args.ims_per_batch)])
    if args.remat:
        cfg = cfg_from_list(cfg, ["TRAIN.REMAT_TRUNK", "True"])

    device.setup_compile_cache()
    canvas = tuple(args.canvas)
    rng = np.random.RandomState(0)
    imdb = get_imdb("synthetic_train" if args.smoke else "synthetic_hard_train")
    entries = [imdb.roidb[i % len(imdb.roidb)]
               for i in range(cfg.TRAIN.IMS_PER_BATCH)]

    # --- host minibatch build (the _Prefetcher's per-step work) ---------
    def build_batch():
        if args.net == "az":
            return get_az_minibatch(imdb, entries, cfg, rng, canvas=canvas)
        props = [np.concatenate(
            [e["boxes"].astype(np.float32),
             np.ones((e["boxes"].shape[0], 1), np.float32)], axis=1)
            for e in entries]
        return get_frcnn_minibatch(imdb, entries, props, cfg, rng,
                                   canvas=canvas)

    t0 = time.perf_counter()
    n_host = 5
    for _ in range(n_host):
        batch_np = build_batch()
    host_ms = (time.perf_counter() - t0) / n_host * 1000.0

    # --- compiled step -----------------------------------------------------
    if args.net == "az":
        model = AZNet(model_cfg=cfg.MODEL)
        state = make_az_train_state(cfg, model, jax.random.PRNGKey(0),
                                    image_hw=canvas)
        step = make_az_train_step(
            model, pos_weights=(cfg.TRAIN.ZOOM_POS_WEIGHT,
                                cfg.TRAIN.ADJ_POS_WEIGHT),
            remat_trunk=cfg.TRAIN.REMAT_TRUNK)
    else:
        model = FRCNN(model_cfg=cfg.MODEL)
        state = make_frcnn_train_state(cfg, model, jax.random.PRNGKey(0),
                                       image_hw=canvas)
        step = make_frcnn_train_step(model)

    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    key = jax.random.PRNGKey(1)

    # XLA's own flop count for ONE step (fwd+bwd+SGD).
    cost = jax.jit(step).lower(state, batch, key).compile().cost_analysis()
    c = cost[0] if isinstance(cost, (list, tuple)) else (cost or {})
    flops = float(c.get("flops", 0.0)) or None

    def pipeline_n(n):
        @jax.jit
        def pipe(st, b, k):
            def body(carry, _):
                st2, metrics = step(carry, b, k)
                return st2, metrics["loss"]

            st_out, losses = jax.lax.scan(body, st, None, length=n)
            # state.step increments per iteration -> fold_in differs ->
            # the body cannot be hoisted out of the scan.
            return jnp.sum(losses)

        return pipe

    lo, hi = args.steps
    plo, phi = pipeline_n(lo), pipeline_n(hi)
    for _ in range(2):  # compile + warm up
        float(plo(state, batch, key))
        float(phi(state, batch, key))
    dt, contended = scan_diff_time(lambda: float(plo(state, batch, key)),
                                   lambda: float(phi(state, batch, key)),
                                   lo, hi)
    if contended:
        print("# contended: trial spread exceeded 2x; minimum estimate",
              flush=True)

    b = int(batch["images"].shape[0])
    out = {
        "metric": f"train_step_{args.net}",
        "value": round(dt * 1000.0, 2),
        "unit": "ms/step",
        "images_per_sec": round(b / dt, 2),
        "batch": b,
        "remat": bool(cfg.TRAIN.REMAT_TRUNK),
        "canvas": list(canvas),
        "host_batch_ms": round(host_ms, 2),
        # Fraction of host minibatch work hidden behind one device step
        # when the prefetcher (train/loop.py, default-on) overlaps them.
        "prefetch_overlap": round(min(1.0, dt * 1000.0 / max(host_ms, 1e-9)),
                                  3),
    }
    out["device"] = device.describe()
    if flops:
        out["step_tflops"] = round(flops / 1e12, 4)
        out["tflops_per_sec"] = round(flops / dt / 1e12, 2)
        if device.on_gpu():
            out["mfu_vs_bf16_peak"] = round(
                flops / dt / device.peaks()["bf16_flops"], 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
