"""CLI tool smoke tests via subprocess (guards the argparse surfaces)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SET = [
    "--set", "MODEL.BACKBONE", "smallnet", "MODEL.FC_DIM", "32",
    "MODEL.NUM_TEMPLATES", "5", "MODEL.NUM_CLASSES", "4",
    "MODEL.COMPUTE_DTYPE", "float32",
    "SEAR.FRONTIER_CAP", "16", "SEAR.CAND_BUF", "128",
    "SEAR.MAX_LEVELS", "2", "SEAR.NUM_PROPOSALS", "20",
    "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
    "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96",
    "TRAIN.REGIONS_PER_IMAGE", "16", "TRAIN.USE_FLIPPED", "False",
    "TRAIN.SNAPSHOT_ITERS", "10",
]


def _run(args, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env=env, timeout=timeout,
        capture_output=True, text=True,
    )


def test_help_screens():
    for tool in ("train_net", "test_net", "propose_net", "demo", "time_net",
                 "bench_train", "bench_fused_detect", "bench_coco_eval",
                 "ingest_data", "convert_caffe",
                 "verify_reference"):
        r = _run([f"tools/{tool}.py", "--help"], timeout=60)
        assert r.returncode == 0, r.stderr[-500:]
        assert "usage" in r.stdout.lower()


def test_bench_coco_eval_tiers_agree():
    # Tiny run of the COCO-scale eval benchmark: both matcher tiers must
    # produce identical metrics (asserted in-tool; finding 26a's harness).
    r = _run(["tools/bench_coco_eval.py", "--images", "8",
              "--dets-per-img", "30"], timeout=240)
    assert r.returncode == 0, r.stderr[-800:]
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    assert lines and all("AP" in x for x in lines)
    if len(lines) == 2:  # native tier present on this machine
        assert "tiers agree" in r.stdout


def test_train_then_recall_chain(tmp_path):
    out = str(tmp_path / "az")
    r = _run(["tools/train_net.py", "--cpu", "--net", "az",
              "--imdb", "synthetic_val", "--iters", "10", "--output", out]
             + SMALL_SET)
    assert r.returncode == 0, r.stderr[-800:]
    assert "done; checkpoints in" in r.stdout

    r2 = _run(["tools/test_net.py", "--cpu", "--mode", "recall",
               "--imdb", "synthetic_val", "--ckpt", out, "--max-images", "2"]
              + SMALL_SET)
    assert r2.returncode == 0, r2.stderr[-800:]
    table = json.loads(r2.stdout[r2.stdout.index("{"):])
    assert "300" in table and "AR" in table["300"]


def test_verify_reference(tmp_path):
    # Empty mount: says so and exits 0 (SURVEY.md §8 automation).
    empty = tmp_path / "ref_empty"
    empty.mkdir()
    r = _run(["tools/verify_reference.py", "--ref", str(empty)], timeout=60)
    assert r.returncode == 0 and "mount empty" in r.stdout

    # Populated mount: checklist runs, config diff lines up SEAR.Tz with
    # our SEAR.ZOOM_THRESH, API grep reports file:line.
    ref = tmp_path / "ref"
    (ref / "lib" / "detect").mkdir(parents=True)
    (ref / "lib" / "detect" / "config.py").write_text(
        "__C.SEAR.Tz = 0.3\n__C.TRAIN.BATCH_SIZE = 128\n")
    (ref / "lib" / "detect" / "test.py").write_text(
        "def im_propose(net, im):\n    pass\n")
    r = _run(["tools/verify_reference.py", "--ref", str(ref)], timeout=60)
    assert r.returncode == 0, r.stderr[-500:]
    assert "[CHECK] SEAR.ZOOM_THRESH" in r.stdout and "SEAR.Tz" in r.stdout
    assert "lib/detect/test.py:1" in r.stdout


def test_demo_runs(tmp_path):
    r = _run(["tools/demo.py", "--cpu", "--out", str(tmp_path / "demo.png")]
             + SMALL_SET)
    assert r.returncode == 0, r.stderr[-800:]
    assert "im_propose:" in r.stdout and "im_detect:" in r.stdout


def test_ingest_data_status_and_voc(tmp_path):
    r = _run(["tools/ingest_data.py", "status"], timeout=60)
    assert r.returncode == 0 and "synthetic_*" in r.stdout

    # Fabricated VOC layout: link + validate + roidb cache.
    src = tmp_path / "VOCdevkit"
    main = src / "VOC2007" / "ImageSets" / "Main"
    ann = src / "VOC2007" / "Annotations"
    img = src / "VOC2007" / "JPEGImages"
    for d in (main, ann, img):
        d.mkdir(parents=True)
    (main / "trainval.txt").write_text("")  # empty split: layout-only check
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               AZNET_DATA_DIR=str(tmp_path / "root"))
    r = subprocess.run(
        [sys.executable, "tools/ingest_data.py", "voc", "--src", str(src),
         "--year", "2007", "--splits", "trainval"],
        cwd=REPO, env=env, timeout=120, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-500:]
    assert "linked:" in r.stdout and "0 images" in r.stdout


def test_frcnn_init_trunk_from_stays_shared(tmp_path):
    """--init-trunk-from: FRCNN trains with the AZ trunk frozen; after
    training the two trunks are byte-identical, so share_trunk is a no-op
    and the fused shared-trunk detect program is valid (with real mAP)."""
    az_out = str(tmp_path / "az")
    r = _run(["tools/train_net.py", "--cpu", "--net", "az",
              "--imdb", "synthetic_val", "--iters", "4", "--output", az_out]
             + SMALL_SET)
    assert r.returncode == 0, r.stderr[-800:]

    fr_out = str(tmp_path / "frcnn")
    r2 = _run(["tools/train_net.py", "--cpu", "--net", "frcnn",
               "--imdb", "synthetic_val", "--iters", "4", "--output", fr_out,
               "--init-trunk-from", az_out] + SMALL_SET)
    assert r2.returncode == 0, r2.stderr[-800:]
    assert "trunk frozen" in r2.stdout

    import numpy as np

    import jax

    jax.config.update("jax_platforms", "cpu")
    from aznet_tpu.api import (build_az_net, build_frcnn_net, share_trunk,
                               trunks_shared)
    from aznet_tpu.config import Config, cfg_from_list
    from aznet_tpu.utils.checkpoint import Checkpointer

    cfg = cfg_from_list(Config(), SMALL_SET[1:])
    az = build_az_net(cfg)
    restored_az, _ = Checkpointer(az_out + "/deploy").restore(
        {"params": az.params})
    az.params = restored_az["params"]
    fr = build_frcnn_net(cfg)
    restored, _ = Checkpointer(fr_out + "/deploy").restore({"params": fr.params})
    fr.params = restored["params"]
    # byte-identical trunk VALUES after training (the actual guarantee)...
    a = jax.tree_util.tree_leaves(az.params["params"]["trunk"])
    b = jax.tree_util.tree_leaves(fr.params["params"]["trunk"])
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # ...so share_trunk at load time is a numerical no-op that enables the
    # fused program (trunks_shared is an identity check by design).
    share_trunk(fr, az)
    assert trunks_shared(az, fr)
