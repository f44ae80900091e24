"""The port's training gates (hand3d_tpu_torch.tools.overfit_check and
generalization_check) and the preset-accuracy tool end to end on the CPU at
tiny budgets, as tests/test_gates.py runs the JAX tools: the tools RUN and
report. The learning bars themselves are judged by the card runs recorded
in PERF.md.
Also: the gates' synthetic data writers against tests/fixtures.py, byte for
byte, and their CPM checkpoint through both packages' loaders.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hand3d_tpu.cli._common import load_weight_trees as jax_load
from hand3d_tpu_torch.cli._common import load_weight_trees
from hand3d_tpu_torch.data import synthetic
from hand3d_tpu_torch.tools import generalization_check, overfit_check
from hand3d_tpu_torch.weights.convert import tree_to_flat

import fixtures
from torch_tmp import tmp_path  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_tool(module, *argv):
    env = dict(os.environ, OMP_NUM_THREADS=str(max(
        1, (os.cpu_count() or 1)
        // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))))
    proc = subprocess.run(
        [sys.executable, "-m", f"hand3d_tpu_torch.tools.{module}", *argv,
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=REPO, env=env)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert lines, f"no JSON summary:\n{proc.stdout[-800:]}\n" \
                  f"{proc.stderr[-2000:]}"
    return proc, json.loads(lines[-1])


def test_generalization_gate_smoke():
    proc, s = run_tool("generalization_check", "--smoke", "--crop-size",
                       "32", "--batch-size", "4")
    assert proc.returncode == 0 and s["ok"] is True, s
    assert s["smoke"] is True and s["learned"] is None
    assert s["b_killed_midrun"] is None  # a live SIGTERM at card scale only
    assert s["b_stopped_at"] == s["steps"] // 2 - 1
    assert s["resume_bitwise_equal"] is True
    assert s["lr_crossed"] is True and s["lr_values_seen"] == [1e-5, 1e-4]
    assert s["warm_start_equals_checkpoint"] is True
    assert s["warm_start_layers"] == 16  # conv1_1 .. conv5_1
    # 3 steps a device call in --smoke (windows 0-3 and 3-6): the eval set
    # for step 3 lands on the first window boundary after it, the run's end
    assert s["steps_per_call"] == 3
    assert [step for step, _ in s["val_epe_curve"]] == [6]
    assert np.isfinite(s["epe_initial_px"]) and s["epe_initial_px"] > 0


def test_overfit_gate_runs_end_to_end():
    proc, s = run_tool("overfit_check", "--steps", "2", "--only", "lifting",
                       "--records", "8")
    assert s["gate"] == "overfit_check" and list(s["trainers"]) == [
        "lifting"], s
    entry = s["trainers"]["lifting"]
    assert "error" not in entry, entry
    assert entry["steps"] == 4 and entry["min_ratio"] == 4.0
    assert entry["loss_first"] > 0 and len(entry["curve"]) == 4
    # 4 steps cannot reach the 4x drop: the gate reports the failure
    assert proc.returncode == (0 if entry["ok"] else 1)


def test_overfit_keep_then_qat_warm_start_then_preset_accuracy(tmp_path):
    """overfit_check --keep DIR leaves its records and final snapshots;
    --qat --warm-from DIR fine-tunes from them under the fake-quant view
    (the drop bar becomes the 0.9 backstop); preset_accuracy --overfit-dir
    DIR reads them and reports every row, the phase-packed ones too."""
    keep = str(tmp_path / "of")
    proc, s = run_tool("overfit_check", "--steps", "2", "--only", "lifting",
                       "--records", "8", "--keep", keep)
    assert "error" not in s["trainers"]["lifting"], s
    snap = os.path.join(keep, "snap_lifting", "snapshot-4.pt")
    assert os.path.exists(snap)
    assert os.path.exists(os.path.join(keep, "data", "rhd_training.bin"))
    proc, s = run_tool("overfit_check", "--steps", "2", "--only", "lifting",
                       "--records", "8", "--qat", "--warm-from", keep)
    entry = s["trainers"]["lifting"]
    assert s["qat"] is True and s["warm_from"] == keep
    assert "error" not in entry and entry["min_ratio"] == 0.9, entry
    cmd = overfit_check._trainers(2, "d", "w", "cpu", qat=True,
                                  warm_from=keep, run={"lifting"})
    argv = cmd["lifting"][0]
    assert "--qat" in argv and argv[argv.index("--weights") + 1] == snap
    assert "--weights" not in cmd["handsegnet"][0]

    doc = tmp_path / "presets.md"
    proc, s = run_tool("preset_accuracy", "--overfit-dir", keep, "--images",
                       "2", "--batch", "2", "--write-doc", str(doc))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "overfit weights loaded for scopes: ['PosePrior', " \
        "'ViewpointNet']" in proc.stderr
    assert list(s["presets"]) == ["seg_scale=0.5", "bf16", "int8",
                                  "int8_static", "int8_seg",
                                  "int8_seg_refiners", "int8_seg_pp",
                                  "phase_pack"]
    for row in s["presets"].values():
        assert all(np.isfinite(v) for m in row.values() for v in m.values())
    # the int8 rows are quantized: they move PoseNet's scoremap
    assert s["presets"]["int8"]["scoremap_rel_l2"]["max"] > 0
    table = doc.read_text()
    assert "| int8_static |" in table and "| int8_seg_pp |" in table


@pytest.mark.parametrize("name, kw", [
    ("make_rhd_bin", dict(num_records=3, seed=5)),
    ("make_rhd_bin", dict(num_records=2, seed=1, dominant="right")),
    ("make_rhd_bin_rendered", dict(num_records=3, seed=7)),
    ("make_rhd_bin_rendered", dict(num_records=2, seed=10_000)),
])
def test_synthetic_writers_equal_the_fixtures(name, kw, tmp_path):
    getattr(fixtures, name)(tmp_path / "jax.bin", **kw)
    getattr(synthetic, name)(tmp_path / "port.bin", **kw)
    assert (tmp_path / "port.bin").read_bytes() == \
        (tmp_path / "jax.bin").read_bytes()


def test_synthetic_cpm_checkpoint_loads_the_same_in_both(tmp_path):
    prefix, written = generalization_check.make_synthetic_cpm_checkpoint(
        str(tmp_path / "cpm-model-mpii"))
    got, want = load_weight_trees([prefix]), jax_load([prefix])
    assert sorted(got) == sorted(want) == ["HandSegNet", "PoseNet2D"]
    got, want = tree_to_flat(got), tree_to_flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert "PoseNet2D/conv5_2/weights" not in got
    np.testing.assert_array_equal(got["PoseNet2D/conv4_3/weights"],
                                  written["conv4_3"]["weights"])


def test_overfit_judge_reads_the_curve(tmp_path):
    log = tmp_path / "m.jsonl"
    rows = [{"step": s, "loss": v, "ts": 10.0 + s / 10, "lr": 1e-4}
            for s, v in ((0, 8.0), (10, 4.0), (20, 1.0), (30, 3.0),
                         (40, 2.0))]
    rows.append({"step": 40, "eval_epe_mean_px": 9.5, "ts": 20.0})
    log.write_text("".join(json.dumps(r) + "\n" for r in rows))
    losses, evals = overfit_check.read_curve(str(log))
    assert evals == {"eval_epe_mean_px": 9.5}
    entry = overfit_check.judge(losses, evals, 3.0,
                                ("eval_epe_mean_px", 15.0))
    # the median of the last three reports (1, 3, 2) is 2: a 4x drop
    assert entry["drop_ratio"] == 4.0 and entry["ok"] is True
    assert entry["ms_per_step"] == pytest.approx(100.0)
    assert not overfit_check.judge(losses, evals, 5.0, None)["ok"]
    assert not overfit_check.judge(losses, {}, 3.0,
                                   ("eval_epe_mean_px", 15.0))["ok"]
    assert not overfit_check.judge(losses, evals, 3.0,
                                   ("eval_epe_mean_px", 9.0))["ok"]


def test_gate_trainers_take_the_jax_tools_budgets():
    trainers = overfit_check._trainers(600, "d", "w", "cuda")
    assert list(trainers) == ["handsegnet", "posenet", "lifting", "joint"]
    steps = {k: int(v[0][v[0].index("--max-iter") + 1])
             for k, v in trainers.items()}
    assert steps == {"handsegnet": 600, "posenet": 3000, "lifting": 1200,
                     "joint": 1200}
    assert {k: (v[1], v[2]) for k, v in trainers.items()} == {
        "handsegnet": (5.0, None),
        "posenet": (0.9, ("eval_epe_mean_px", 15.0)),
        "lifting": (4.0, None),
        "joint": (0.9, ("eval_epe_mean_mm", 40.0))}
    joint = trainers["joint"][0]
    weights = joint[joint.index("--weights") + 1:joint.index("--weights") + 3]
    assert weights == [os.path.join("w", "snap_posenet", "snapshot-3000.pt"),
                       os.path.join("w", "snap_lifting", "snapshot-1200.pt")]
    # the JAX tool's default: 50 steps a device call
    assert all(v[0][v[0].index("--steps-per-call") + 1] == "50"
               for v in trainers.values())


def test_deterministic_flag_sets_the_deterministic_algorithms(monkeypatch):
    from hand3d_tpu_torch.cli import _common

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    args = _common.add_train_args(_common.base_parser(""), 1, [1e-4], [],
                                  "s").parse_args(["--deterministic",
                                                   "--device", "cpu"])
    try:
        assert _common.train_device(args) == torch.device("cpu")
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
