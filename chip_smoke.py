#!/usr/bin/env python
"""Smoke run of AZ-Net on one NVIDIA GPU, through the user entry points.

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases (one card), each printing one line and failing the run on error:

 1. card name and power limit (nvidia-smi), ``require_gpu``, compile cache,
    ``make -C csrc``;
 2. full-width VGG-16 propose (``Config()`` defaults) through
    ``make_propose_batch`` at b8 and b32 on the 608x800 canvas, and
    ``im_propose`` on three images;
 3. fused propose + Fast R-CNN detect (21 classes), one batch of 8;
 4. three AZ train steps at full VGG-16 width on synthetic data;
 5. ResNet-50 propose at 1080p, one batch of 2;
 6. correctness against the plain references: device search vs the NumPy
    oracle, every NMS implementation vs the host ``nms``, bf16 trunk vs
    float32;
 7. NMS A/B: Triton kernels vs the fixpoint, alone and inside propose;
 8. the calibrated XLA int8 trunk vs float32, and one int8 propose batch;
 9. the checks behind the tests marked ``gpu``.

Weights are random (seeded). Rates are informational, not benchmark
results. The last line of standard output is one JSON object naming the
device. Exits non-zero, with no result line, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the phases run at. ``Sizes()`` is the card's run; tests build
    tiny ones for a CPU rehearsal."""

    model: dict = dataclasses.field(default_factory=dict)  # MODEL overrides
    sear: dict = dataclasses.field(default_factory=dict)   # SEAR overrides
    test: dict = dataclasses.field(default_factory=dict)   # TEST overrides
    train: dict = dataclasses.field(default_factory=dict)  # TRAIN overrides
    raw_hw: tuple = (375, 500)
    canvas: tuple = (608, 800)
    batches: tuple = (8, 32)
    detect_batch: int = 8
    train_ims: int = 2
    train_steps: int = 3
    resnet: dict = dataclasses.field(default_factory=lambda: {
        "MODEL": {"BACKBONE": "resnet50"},
        "TEST": {"SCALES": (1080,), "MAX_SIZE": 1920},
        "SEAR": {"MAX_LEVELS": 7, "FRONTIER_CAP": 128, "CAND_BUF": 4096,
                 "NUM_PROPOSALS": 1000}})
    resnet_raw_hw: tuple = (1080, 1920)
    resnet_batch: int = 2
    nms_streams: tuple = (16, 4096)
    reps: int = 5
    interpret: bool = False  # Pallas interpreter: CPU rehearsals only


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def query_smi() -> str:
    """``name, power.limit`` of the card, read outside JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis=n/a"
    gib = lambda v: f"{v / 2**30:.2f}GiB"
    return (f"args={gib(m.argument_size_in_bytes)} "
            f"out={gib(m.output_size_in_bytes)} "
            f"temp={gib(m.temp_size_in_bytes)} "
            f"code={gib(m.generated_code_size_in_bytes)}")


def _peak() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    v = stats.get("peak_bytes_in_use")
    return "peak=n/a" if v is None else f"peak={v / 2**30:.2f}GiB"


def compile_timed(fn, *args):
    """(compiled program, compile seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def time_calls(fn, *args, reps=5):
    """Median seconds per call, each ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _cfg(overrides):
    from aznet_tpu.config import Config, cfg_from_dict

    return cfg_from_dict(Config(), overrides)


def _check_props(boxes, scores, valid, what):
    boxes, scores, valid = (np.asarray(x) for x in (boxes, scores, valid))
    assert np.isfinite(boxes).all() and np.isfinite(scores[valid]).all(), what
    assert valid.sum() > 0, f"{what}: no proposals"
    return int(valid.sum())


def _cos_rel(out, ref):
    out = np.asarray(out, np.float32).ravel()
    ref = np.asarray(ref, np.float32).ravel()
    cos = float(out @ ref / max(np.linalg.norm(out) * np.linalg.norm(ref),
                                1e-12))
    rel = float(np.abs(out - ref).mean() / max(np.abs(ref).mean(), 1e-12))
    return cos, rel


def _bound(phase, name, value, limit, below=True):
    ok = value < limit if below else value > limit
    rel = "<" if below else ">"
    log(phase, f"{name}: {value:.6g} (bound {rel} {limit}) "
        f"{'ok' if ok else 'FAIL'}")
    assert ok, f"{name} {value} misses bound {rel} {limit}"


class Smoke:
    """Phase state shared across the one-card run."""

    def __init__(self, sizes: Sizes):
        import jax

        self.s = sizes
        self.cfg = _cfg({"MODEL": sizes.model, "SEAR": sizes.sear,
                         "TEST": sizes.test, "TRAIN": sizes.train})
        self.rng = np.random.RandomState(0)
        self.key = jax.random.PRNGKey(0)

    def raw_images(self, b, hw=None):
        hw = hw or self.s.raw_hw
        return self.rng.randint(0, 256, (b,) + tuple(hw) + (3,)).astype(
            np.uint8)

    # -- phase 1 ----------------------------------------------------------
    def device(self, require, smi):
        import jax

        from aznet_tpu.utils import device

        log(1, f"card: {smi()}")
        require()
        cache = device.setup_compile_cache()
        subprocess.run(["make", "-s", "-C", os.path.join(REPO, "csrc")],
                       check=True)
        info = device.describe()
        log(1, f"jax {jax.__version__} {info} compile_cache={cache} "
            f"csrc built")
        return info

    # -- phase 2 ----------------------------------------------------------
    def propose(self):
        import jax.numpy as jnp

        from aznet_tpu.api import build_az_net, im_propose, make_propose_batch

        self.net = build_az_net(self.cfg)
        self.canvas = self.s.canvas
        fn = make_propose_batch(self.net.model, self.cfg, self.canvas)
        self.propose_programs = {}
        for b in self.s.batches:
            ims = jnp.asarray(self.raw_images(b))
            prog, csec = compile_timed(fn, self.net.params, ims)
            n = _check_props(*prog(self.net.params, ims), f"propose b{b}")
            dt = time_calls(prog, self.net.params, ims, reps=self.s.reps)
            self.propose_programs[b] = (prog, ims)
            log(2, f"propose b{b} canvas={self.canvas}: compile {csec:.1f}s "
                f"{_mem(prog)} {_peak()} live[0..]={n} "
                f"{b / dt:.1f} img/s (informational)")
        for i in range(3):
            props = im_propose(self.net, self.raw_images(1)[0])
            assert props.ndim == 2 and props.shape[1] == 5 and len(props)
            assert np.isfinite(props).all()
        log(2, f"im_propose x3: {len(props)} proposals on the last image")

    # -- phase 3 ----------------------------------------------------------
    def detect(self):
        import jax.numpy as jnp

        from aznet_tpu.api import (build_frcnn_net,
                                   make_fused_detect_batch_padded,
                                   share_trunk)
        from aznet_tpu.ops.preprocess import compute_scale

        fr = share_trunk(build_frcnn_net(self.cfg), self.net)
        fn = make_fused_detect_batch_padded(self.net.model, fr.model,
                                            self.cfg, self.cfg, self.canvas)
        b = self.s.detect_batch
        h, w = self.s.raw_hw
        scale = compute_scale(h, w, self.cfg.TEST.SCALES[0],
                              self.cfg.TEST.MAX_SIZE)
        args = (self.net.params, fr.params,
                jnp.asarray(self.raw_images(b)),
                jnp.asarray(np.tile([[h, w]], (b, 1)).astype(np.float32)),
                jnp.full((b,), scale, jnp.float32))
        prog, csec = compile_timed(fn, *args)
        boxes, p_scores, valid, det_scores, det_boxes = prog(*args)
        _check_props(boxes, p_scores, valid, "fused detect")
        det_scores = np.asarray(det_scores)
        assert det_scores.shape[-1] == self.cfg.MODEL.NUM_CLASSES
        assert np.allclose(det_scores.sum(-1), 1.0, atol=1e-3)
        assert np.isfinite(np.asarray(det_boxes)).all()
        dt = time_calls(prog, *args, reps=self.s.reps)
        log(3, f"fused detect b{b} classes={det_scores.shape[-1]}: compile "
            f"{csec:.1f}s {_mem(prog)} {b / dt:.1f} img/s (informational)")

    # -- phase 4 ----------------------------------------------------------
    def train(self):
        import jax
        import jax.numpy as jnp

        from aznet_tpu.config import cfg_from_dict
        from aznet_tpu.data.imdb import get_imdb
        from aznet_tpu.data.minibatch import get_az_minibatch
        from aznet_tpu.models import AZNet
        from aznet_tpu.train import make_az_train_state, make_az_train_step

        cfg = cfg_from_dict(self.cfg, {"TRAIN": {
            "IMS_PER_BATCH": self.s.train_ims}})
        imdb = get_imdb("synthetic_hard_train")
        entries = [imdb.roidb[i] for i in range(cfg.TRAIN.IMS_PER_BATCH)]
        batch = get_az_minibatch(imdb, entries, cfg, self.rng,
                                 canvas=self.canvas)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        model = AZNet(model_cfg=cfg.MODEL)
        state = make_az_train_state(cfg, model, self.key,
                                    image_hw=self.canvas)
        step = make_az_train_step(model)
        prog, csec = compile_timed(step, state, batch, self.key)
        losses = []
        t0 = time.perf_counter()
        for i in range(self.s.train_steps):
            state, metrics = prog(state, batch, jax.random.fold_in(self.key,
                                                                   i))
            losses.append(float(metrics["loss"]))
        dt = (time.perf_counter() - t0) / self.s.train_steps
        assert np.isfinite(losses).all(), losses
        log(4, f"train {self.s.train_steps} AZ steps b{self.s.train_ims} "
            f"canvas={self.canvas}: compile {csec:.1f}s {_mem(prog)} "
            f"losses={[round(x, 4) for x in losses]} "
            f"{dt * 1e3:.1f} ms/step (informational)")

    # -- phase 5 ----------------------------------------------------------
    def resnet(self):
        import jax.numpy as jnp

        from aznet_tpu.api import (_canvas_for, build_az_net,
                                   make_propose_batch)
        from aznet_tpu.config import cfg_from_dict

        cfg = cfg_from_dict(self.cfg, self.s.resnet)
        net = build_az_net(cfg)
        canvas = _canvas_for(*self.s.resnet_raw_hw, cfg)
        fn = make_propose_batch(net.model, cfg, canvas)
        ims = jnp.asarray(self.raw_images(self.s.resnet_batch,
                                          self.s.resnet_raw_hw))
        prog, csec = compile_timed(fn, net.params, ims)
        n = _check_props(*prog(net.params, ims), "resnet50 propose")
        dt = time_calls(prog, net.params, ims, reps=self.s.reps)
        log(5, f"resnet50 propose b{self.s.resnet_batch} canvas={canvas}: "
            f"compile {csec:.1f}s {_mem(prog)} {_peak()} live={n} "
            f"{self.s.resnet_batch / dt:.2f} img/s (informational)")

    # -- phase 6 ----------------------------------------------------------
    def _blob(self):
        """One preprocessed image on the propose canvas (+ valid extents)."""
        import jax.numpy as jnp

        from aznet_tpu.ops.preprocess import preprocess_image

        cfg = self.cfg
        blob, _, hw = preprocess_image(
            jnp.asarray(self.raw_images(1)[0]), cfg.PIXEL_MEANS,
            cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE, self.canvas[0],
            self.canvas[1], dtype=jnp.float32)
        return blob, (int(hw[0]), int(hw[1]))

    def correctness(self):
        import jax
        import jax.numpy as jnp

        from aznet_tpu.api import build_az_net
        from aznet_tpu.config import cfg_from_dict
        from aznet_tpu.search import az_search, az_search_oracle

        cfg32 = cfg_from_dict(self.cfg, {"MODEL": {
            "COMPUTE_DTYPE": "float32"}})
        net32 = build_az_net(cfg32, params=self.net.params)
        self.blob, hw = self._blob()
        params = net32.params
        model = net32.model
        with jax.default_matmul_precision("highest"):
            self.feat32 = jax.jit(lambda p, x: model.apply(
                p, x, method="features"))(params, self.blob[None])
            feat = self.feat32[0]
            head = jax.jit(lambda p, f, r: model.apply(
                p, f, r, method="roi_forward"))
            k = cfg32.MODEL.NUM_TEMPLATES
            boxes, scores, valid = jax.jit(lambda p, f: az_search(
                lambda f_, r_: model.apply(p, f_, r_, method="roi_forward"),
                f, hw, cfg32.SEAR, num_templates=k,
                offset=cfg32.BOX_OFFSET))(params, feat)
            ob, osc = az_search_oracle(
                lambda f, r: head(params, jnp.asarray(f), jnp.asarray(r)),
                np.asarray(feat), hw, cfg32.SEAR, num_templates=k,
                offset=cfg32.BOX_OFFSET)
        nv = int(np.asarray(valid).sum())
        assert nv == len(osc) and nv > 0, (nv, len(osc))
        log(6, f"search vs oracle (f32 highest, {hw}): {nv} == {len(osc)} "
            f"proposals ok")
        _bound(6, "search score max abs err",
               float(np.abs(np.asarray(scores[:nv]) - osc).max()), 1e-4)
        _bound(6, "search box max abs err (px)",
               float(np.abs(np.asarray(boxes[:nv]) - ob).max()), 0.1)

        feat_bf16 = jax.jit(lambda p, x: self.net.model.apply(
            p, x, method="features"))(self.net.params, self.blob[None])
        cos, rel = _cos_rel(feat_bf16, self.feat32)
        _bound(6, "bf16 trunk vs f32 cosine", cos, 0.999, below=False)
        _bound(6, "bf16 trunk vs f32 mean rel err", rel, 2e-2)

        self.nms_exact()

    def _captured_candidates(self, n_images=2):
        """The candidate buffers the search hands to NMS, for real images:
        the search run with ``nms_topk`` replaced by a pass-through."""
        import jax
        import jax.numpy as jnp

        from aznet_tpu.api import _cast_inference_params
        from aznet_tpu.ops.preprocess import preprocess_image
        from aznet_tpu.search import az_search, propose

        cfg, model = self.cfg, self.net.model

        def one(params, image):
            params = _cast_inference_params(params, cfg)
            blob, _, hw = preprocess_image(
                image, cfg.PIXEL_MEANS, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE,
                self.canvas[0], self.canvas[1], dtype=jnp.bfloat16)
            feat = model.apply(params, blob[None], method="features")[0]
            return az_search(
                lambda f, r: model.apply(params, f, r, method="roi_forward"),
                feat, hw, cfg.SEAR, num_templates=cfg.MODEL.NUM_TEMPLATES,
                offset=cfg.BOX_OFFSET)

        passthrough = lambda b, s, t, k, valid, offset: (b, s, valid)
        with mock.patch.object(propose, "nms_topk", passthrough):
            out = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
                self.net.params, jnp.asarray(self.raw_images(n_images)))
        return [np.asarray(x) for x in out]

    def nms_exact(self):
        import jax
        import jax.numpy as jnp

        from aznet_tpu.ops.nms import nms_mask
        from aznet_tpu.utils.gpu_checks import (device_keep_order,
                                                diverse_boxes,
                                                host_keep_order)

        rng = np.random.RandomState(3)
        s, n = self.s.nms_streams
        self.nms_boxes = diverse_boxes(rng, (s, n))
        self.nms_scores = rng.rand(s, n).astype(np.float32)
        self.cands = self._captured_candidates(min(self.s.batches))
        thresh = self.cfg.SEAR.NMS_THRESH
        for impl in ("fixpoint", "triton"):
            f = jax.jit(jax.vmap(lambda b, sc, v, t, i=impl: nms_mask(
                b, sc, t, valid=v, offset=self.cfg.BOX_OFFSET, impl=i,
                interpret=self.s.interpret and i == "triton"),
                in_axes=(0, 0, 0, None)), static_argnums=3)
            keep = np.asarray(f(jnp.asarray(self.nms_boxes),
                                jnp.asarray(self.nms_scores),
                                jnp.ones((s, n), bool), 0.5))
            for i in range(s):
                assert (device_keep_order(keep[i], self.nms_scores[i])
                        == host_keep_order(self.nms_boxes[i],
                                           self.nms_scores[i], 0.5,
                                           self.cfg.BOX_OFFSET)), (impl, i)
            cb, cs, cv = self.cands
            keep = np.asarray(f(jnp.asarray(cb), jnp.asarray(cs),
                                jnp.asarray(cv), thresh))
            for i in range(len(cb)):
                want = host_keep_order(cb[i], cs[i], thresh,
                                       self.cfg.BOX_OFFSET, valid=cv[i])
                assert device_keep_order(keep[i], cs[i]) == want, (impl, i)
            log(6, f"NMS {impl}: keep set and order == host nms on {s}x{n} "
                f"streams and {len(cb)}x{cb.shape[1]} real candidate "
                f"buffers ({int(cv.sum())} live) ok")

    # -- phase 7 ----------------------------------------------------------
    def nms_ab(self):
        import jax
        import jax.numpy as jnp

        from aznet_tpu.api import make_propose_batch
        from aznet_tpu.ops.nms import fixpoint_iterations, nms_mask
        from aznet_tpu.utils import device

        s, n = self.s.nms_streams
        b, sc = jnp.asarray(self.nms_boxes), jnp.asarray(self.nms_scores)
        progs = {impl: jax.jit(jax.vmap(lambda bb, ss, i=impl: nms_mask(
            bb, ss, 0.5, impl=i,
            interpret=self.s.interpret and i == "triton")))
            for impl in ("fixpoint", "triton")}
        t = {impl: [] for impl in progs}
        for impl in ("fixpoint", "triton", "triton", "fixpoint"):
            t[impl].append(time_calls(progs[impl], b, sc, reps=self.s.reps))
        iters = np.asarray(jax.jit(jax.vmap(lambda bb, ss: fixpoint_iterations(
            bb, ss, 0.5)))(b, sc))
        ms = {k: 1e3 * min(v) for k, v in t.items()}
        log(7, f"NMS {s}x{n} diverse: fixpoint {ms['fixpoint']:.3f} ms, "
            f"triton {ms['triton']:.3f} ms ({s * n / ms['triton'] / 1e3:.1f} "
            f"Mboxes/s); fixpoint sweeps min/median/max "
            f"{iters.min()}/{int(np.median(iters))}/{iters.max()} "
            f"(informational)")
        cb, cs, cv = (jnp.asarray(x) for x in self.cands)
        it_real = np.asarray(jax.jit(jax.vmap(lambda bb, ss, vv: (
            fixpoint_iterations(bb, ss, self.cfg.SEAR.NMS_THRESH, valid=vv,
                                offset=self.cfg.BOX_OFFSET))))(cb, cs, cv))
        real = {impl: jax.jit(jax.vmap(lambda bb, ss, vv, i=impl: nms_mask(
            bb, ss, self.cfg.SEAR.NMS_THRESH, valid=vv,
            offset=self.cfg.BOX_OFFSET, impl=i,
            interpret=self.s.interpret and i == "triton")))
            for impl in ("fixpoint", "triton")}
        t = {k: [] for k in real}
        for k in ("fixpoint", "triton", "triton", "fixpoint"):
            t[k].append(time_calls(real[k], cb, cs, cv, reps=self.s.reps))
        log(7, f"NMS on {cb.shape[0]}x{cb.shape[1]} real candidate buffers: "
            f"fixpoint {1e3 * min(t['fixpoint']):.3f} ms "
            f"(sweeps {it_real.tolist()}), triton "
            f"{1e3 * min(t['triton']):.3f} ms (informational)")

        bmax = max(self.s.batches)
        prog_auto, ims = self.propose_programs[bmax]
        auto = device.nms_impl()
        other = "fixpoint" if auto == "triton" else "triton"
        if self.s.interpret and other == "triton":
            log(7, "propose A/B skipped: the Triton kernels need a GPU")
            return
        with mock.patch.object(device, "nms_impl", lambda: other):
            # A new closure: JAX caches the trace of the function it has
            # seen, which chose `auto`.
            fn = make_propose_batch(self.net.model, self.cfg, self.canvas)
            prog_other, _ = compile_timed(fn, self.net.params, ims)
        progs = {auto: prog_auto, other: prog_other}
        t = {k: [] for k in progs}
        for k in (auto, other, other, auto, auto, other):
            t[k].append(bmax / time_calls(progs[k], self.net.params, ims,
                                          reps=2 * self.s.reps))
        desc = ", ".join(
            f"{k}{' (auto)' if k == auto else ''} "
            f"{np.median(v):.1f} img/s (runs {', '.join(f'{x:.1f}' for x in v)})"
            for k, v in t.items())
        log(7, f"propose b{bmax} CAND_BUF {self.cfg.SEAR.CAND_BUF}: {desc} "
            f"(informational)")

    # -- phase 8 ----------------------------------------------------------
    def int8(self):
        import jax
        import jax.numpy as jnp

        from aznet_tpu.api import build_az_net, make_propose_batch
        from aznet_tpu.ops.quant import (calibrate_head_int8,
                                         calibrate_trunk_int8,
                                         with_int8_scales)

        calib = np.stack([np.asarray(self._blob()[0]) for _ in range(2)])
        scales = calibrate_trunk_int8(self.net, calib, batch_size=2)
        head_scales = calibrate_head_int8(self.net, calib, scales)
        cfg8 = with_int8_scales(self.cfg, scales, head_scales)
        net8 = build_az_net(cfg8, params=self.net.params)
        feat8 = jax.jit(lambda p, x: net8.model.apply(
            p, x, method="features"))(net8.params, self.blob[None])
        cos, rel = _cos_rel(feat8, self.feat32)
        log(8, f"int8 trunk ({len(scales)} scales) vs f32")
        _bound(8, "int8 trunk vs f32 cosine", cos, 0.98, below=False)
        _bound(8, "int8 trunk vs f32 mean rel err", rel, 0.2)
        b = min(self.s.batches)
        fn = make_propose_batch(net8.model, cfg8, self.canvas)
        ims = jnp.asarray(self.raw_images(b))
        prog, csec = compile_timed(fn, net8.params, ims)
        n = _check_props(*prog(net8.params, ims), "int8 propose")
        dt = time_calls(prog, net8.params, ims, reps=self.s.reps)
        log(8, f"int8 propose b{b}: compile {csec:.1f}s {_mem(prog)} "
            f"live[0..]={n} {b / dt:.1f} img/s (informational)")

    # -- phase 9 ----------------------------------------------------------
    def gpu_checks(self, checks):
        for check in checks:
            log(9, f"{check.__name__}: {check()}")


def run_one_card(sizes: Sizes, require, smi, checks) -> dict:
    smoke = Smoke(sizes)
    info = smoke.device(require, smi)
    smoke.propose()
    smoke.detect()
    smoke.train()
    smoke.resnet()
    smoke.correctness()
    smoke.nms_ab()
    smoke.int8()
    smoke.gpu_checks(checks)
    return info


def run_four_cards(sizes: Sizes, require, smi) -> dict:
    """The sharded paths on 4 cards, each against the one-card program."""
    import jax
    import jax.numpy as jnp

    from aznet_tpu.api import build_az_net, make_propose_batch
    from aznet_tpu.config import cfg_from_dict
    from aznet_tpu.models import AZNet
    from aznet_tpu.parallel import (batch_sharding, make_mesh,
                                    param_sharding, replicate)
    from aznet_tpu.parallel.inference import (make_latency_propose,
                                              make_sharded_propose)
    from aznet_tpu.train import make_az_train_state, make_az_train_step
    from aznet_tpu.utils import device

    smoke = Smoke(sizes)
    info = smoke.device(require, smi)
    assert info["count"] >= 4, f"--four needs 4 devices, have {info}"
    # float32 at highest precision, and the one-card reference run on the
    # same per-card batch, so that both sides run the same arithmetic.
    cfg = cfg_from_dict(smoke.cfg, {"MODEL": {"COMPUTE_DTYPE": "float32"}})
    net = build_az_net(cfg)
    canvas = sizes.canvas
    b = max(sizes.batches)
    ims = jnp.asarray(smoke.raw_images(b))

    def same_proposals(got, want, what):
        gb, gs, gv = (np.asarray(x) for x in got)
        wb, ws, wv = want
        assert (gv == wv).all(), f"{what}: valid masks differ"
        err_s = float(np.abs(gs[wv] - ws[wv]).max())
        err_b = float(np.abs(gb[wv] - wb[wv]).max())
        log(4, f"{what}: {int(wv.sum())} proposals, score err {err_s:.3g} "
            f"(bound < 1e-4), box err {err_b:.3g} px (bound < 0.1)")
        assert err_s < 1e-4 and err_b < 0.1, what

    with jax.default_matmul_precision("highest"):
        single = jax.jit(make_propose_batch(net.model, cfg, canvas))
        per_card = b // 4
        ref = [np.concatenate(x) for x in zip(*(
            [np.asarray(y) for y in single(net.params,
                                           ims[i : i + per_card])]
            for i in range(0, b, per_card)))]
        mesh = make_mesh(4, model_parallel=1)
        sharded = make_sharded_propose(net.model, cfg, canvas, mesh)
        with mesh:
            got = sharded(net.params, ims)
        same_proposals(got, ref, f"sharded propose DP=4 b{b} vs one card")

        latency = make_latency_propose(net.model, cfg, canvas, mesh)
        with mesh:
            got = latency(net.params, ims[0])
        same_proposals([x[None] for x in got], [x[:1] for x in ref],
                       "latency propose (frontier over 4 cards) vs one card")

    # DP=2 x TP=2 train step vs the one-card step, float32 at highest.
    cfg32 = cfg_from_dict(cfg, {"MODEL": {"DROPOUT": 0.0},
                                "TRAIN": {"IMS_PER_BATCH": 4}})
    from aznet_tpu.data.imdb import get_imdb
    from aznet_tpu.data.minibatch import get_az_minibatch

    imdb = get_imdb("synthetic_hard_train")
    batch = get_az_minibatch(imdb, imdb.roidb[:4], cfg32, smoke.rng,
                             canvas=canvas)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = AZNet(model_cfg=cfg32.MODEL)
    state = make_az_train_state(cfg32, model, smoke.key, image_hw=canvas)
    step = make_az_train_step(model)
    with jax.default_matmul_precision("highest"):
        _, m1 = jax.jit(step)(state, batch, smoke.key)
        mesh22 = make_mesh(4, model_parallel=2)
        shard = jax.tree_util.tree_map(
            lambda _: replicate(mesh22), state,
            is_leaf=lambda x: hasattr(x, "ndim")).replace(
            params=param_sharding(mesh22, state.params))
        st4 = jax.device_put(state, shard)
        b4 = {k: jax.device_put(v, batch_sharding(mesh22, v.ndim))
              for k, v in batch.items()}
        with mesh22:
            _, m4 = jax.jit(step)(st4, b4, smoke.key)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    rel = abs(l4 - l1) / max(abs(l1), 1e-12)
    log(4, f"train DP=2 x TP=2 loss {l4:.6f} vs one card {l1:.6f}: rel "
        f"{rel:.3g} (bound < 1e-3)")
    assert np.isfinite(l4) and rel < 1e-3
    return device.describe()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded paths")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    from aznet_tpu.utils import device
    from aznet_tpu.utils.gpu_checks import CHECKS

    t0 = time.perf_counter()
    if args.four:
        info = run_four_cards(Sizes(), device.require_gpu, query_smi)
    else:
        info = run_one_card(Sizes(), device.require_gpu, query_smi, CHECKS)
    print(f"# all phases passed in {time.perf_counter() - t0:.0f}s",
          flush=True)
    print(json.dumps({"ok": True, "device": info}))


if __name__ == "__main__":
    main()
