#!/usr/bin/env python
"""Per-stage timing of the propose pipeline (the ``caffe time`` role).

Reference equivalent (SURVEY.md §5.1): the layer-wise benchmark binary
``caffe time``. Reports preprocess / trunk / search / end-to-end ms-per-image
on the current backend (each stage warmed, then timed over ``--reps``
calls with scalar-dependency chaining). Calls
``utils/device.py::setup_compile_cache`` before the first compile.
"""

import argparse
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description="aznet_tpu stage timings")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--raw-hw", type=int, nargs=2, default=(375, 500))
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 800))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="calibrate + time the XLA int8 trunk / int8 "
                        "heads (vgg16 only)")
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax
    import jax.numpy as jnp

    from aznet_tpu.config import Config, cfg_from_file, cfg_from_list
    from aznet_tpu.api import build_az_net, make_propose_batch, _cast_inference_params
    from aznet_tpu.ops.preprocess import preprocess_image
    from aznet_tpu.search import az_search
    from aznet_tpu.utils import device

    device.setup_compile_cache()
    cfg = Config()
    if args.cfg:
        cfg = cfg_from_file(cfg, args.cfg)
    if args.set_cfgs:
        cfg = cfg_from_list(cfg, args.set_cfgs)

    net = build_az_net(cfg)
    if args.int8:
        from aznet_tpu.ops.quant import (calibrate_head_int8,
                                         calibrate_trunk_int8,
                                         with_int8_scales)

        rngc = np.random.RandomState(7)
        calib = rngc.randint(
            0, 256, (2,) + tuple(args.canvas) + (3,)).astype(np.float32)
        calib -= np.asarray(cfg.PIXEL_MEANS, np.float32)
        scales = calibrate_trunk_int8(net, calib, batch_size=2)
        head_scales = calibrate_head_int8(net, calib, scales)
        cfg = with_int8_scales(cfg, scales, head_scales)
        net = build_az_net(cfg, params=net.params)
        print(f"# int8: {len(scales)}+2 scales calibrated", flush=True)
    b = args.batch
    rng = np.random.RandomState(0)
    ims = jnp.asarray(rng.randint(0, 256, (b,) + tuple(args.raw_hw) + (3,)).astype(np.uint8))
    ch, cw = args.canvas
    blob_dtype = jnp.bfloat16 if cfg.MODEL.COMPUTE_DTYPE == "bfloat16" else jnp.float32

    stages = []

    def timed(name, jf, *xs):
        out = jf(*xs)  # compile + first output (feeds the next stage)
        stages.append((name, jf, xs))
        return out

    def run_all():
        # Warm EVERY stage before timing ANY, then measure each with
        # scalar-dependency chaining.
        for _ in range(2):
            for name, jf, xs in stages:
                out = jf(*xs)
                float(jnp.sum(jax.tree_util.tree_leaves(out)[0].astype(jnp.float32)))
        for name, jf, xs in stages:
            t0 = time.perf_counter()
            acc = jnp.float32(0)
            for _ in range(args.reps):
                acc = acc + jnp.sum(
                    jax.tree_util.tree_leaves(jf(*xs))[0].astype(jnp.float32))
            float(acc)
            dt = (time.perf_counter() - t0) / args.reps
            print(f"{name:12s}: {dt / b * 1000:7.2f} ms/img  ({b / dt:7.1f} img/s)")

    prep = jax.jit(lambda x: jax.vmap(
        lambda im: preprocess_image(im, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0],
                                    cfg.TEST.MAX_SIZE, ch, cw, dtype=blob_dtype)[0])(x))
    blobs = timed("preprocess", prep, ims)

    trunk = jax.jit(lambda p, x: net.model.apply(p, x, method="features"))
    p16 = _cast_inference_params(net.params, cfg)
    feats = timed("trunk", trunk, p16, blobs)

    def search_fn(params, feats):
        def roi_fwd(f, r):
            return net.model.apply(params, f, r, method="roi_forward")

        return jax.vmap(lambda f: az_search(
            roi_fwd, f, (args.canvas[0], args.canvas[1]), cfg.SEAR,
            num_templates=cfg.MODEL.NUM_TEMPLATES))(feats)

    timed("search", jax.jit(search_fn), p16, feats)

    e2e = jax.jit(make_propose_batch(net.model, cfg, (ch, cw)))
    timed("end-to-end", e2e, net.params, ims)

    run_all()


if __name__ == "__main__":
    main()
