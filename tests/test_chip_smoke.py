"""CPU rehearsal of chip_smoke.py's phases at a tiny size (the platform
check injected), and its refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    model={"BACKBONE": "vgg16", "WIDTH": 0.125, "FC_DIM": 32,
           "NUM_TEMPLATES": 5},
    sear={"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 2,
          "NUM_PROPOSALS": 20},
    test={"SCALES": (64,), "MAX_SIZE": 96},
    train={"SCALES": (64,), "MAX_SIZE": 96, "REGIONS_PER_IMAGE": 16},
    raw_hw=(48, 64), canvas=(64, 128), batches=(2,), detect_batch=2,
    train_ims=1,
    train_steps=2,
    resnet={"MODEL": {"BACKBONE": "resnet50"},
            "TEST": {"SCALES": (64,), "MAX_SIZE": 96}},
    resnet_raw_hw=(48, 64), resnet_batch=1, nms_streams=(2, 300), reps=1,
    interpret=True)


def test_phases_rehearse_on_cpu(capsys):
    info = chip_smoke.run_one_card(TINY, jax.devices, lambda: "rehearsal",
                                   ())
    assert info["platform"] == "cpu"
    out = capsys.readouterr().out
    for phase in range(1, 9):
        assert f"[{phase}]" in out, phase
    assert "FAIL" not in out
    assert out.count("== host nms") == 2


def test_four_card_paths_rehearse_on_cpu_mesh(capsys):
    """--four's phase on 4 of the virtual CPU devices: sharded propose,
    latency propose and the DP=2 x TP=2 train step vs one device."""
    sizes = chip_smoke.dataclasses.replace(TINY, batches=(4,))
    info = chip_smoke.run_four_cards(sizes, jax.devices, lambda: "rehearsal")
    assert info["count"] >= 4
    out = capsys.readouterr().out
    assert out.count("vs one card") == 3, out


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_gpu():
    r = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
