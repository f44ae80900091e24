"""The port's four training CLIs on the CPU (``--device cpu``), at small
sizes on the fixture's 320x320 records: they train, print the JAX CLIs'
lines, snapshot, resume exactly, log the scheduled LR, warm-start from a
snapshot, run the in-training eval, train device-resident
(``--steps-per-call``) under a named recompute policy, train under the int8
fake-quant view (``--qat``), train on a one-rank mesh (``--mesh 1x1``) as
without one, and refuse the flags and meshes that cannot run.
"""

import importlib
import json
import re

import pytest
import torch

from hand3d_tpu_torch.train import checkpoints, trainer

from fixtures import make_rhd_bin
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

STAGES = {  # small runs; HandSegNet has no crop-size flag (256^2 crops)
    "train_posenet": ["--crop-size", "32"],
    "train_handsegnet": ["--batch-size", "1"],
    "train_lifting": ["--variant", "local"],
    "train_joint": ["--crop-size", "32"],
}
# hand3d_tpu/train/loop.py's loss line
LOSS_LINE = re.compile(r"^Iteration (\d+)\t Loss \d\.\de[+-]\d\d\t [\d.]+ it/s$")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    with module_dir(tmp_path_factory, "cli") as d:
        yield str(make_rhd_bin(d / "t.bin", num_records=6, seed=3))


def main(name, argv):
    module = importlib.import_module(f"hand3d_tpu_torch.cli.{name}")
    return module.main(argv + ["--device", "cpu"])


def _argv(name, data, tmp_path, max_iter, *extra):
    return (["--data", data, "--batch-size", "2",
             "--max-iter", str(max_iter), "--show-loss-freq", "1",
             "--lr", "1e-4", "1e-5", "--lr-iter", "2",
             "--snapshot-dir", str(tmp_path / "snaps"),
             "--metrics-log", str(tmp_path / "m.jsonl"), *STAGES[name]]
            + list(extra))


@pytest.mark.parametrize("name", list(STAGES))
def test_cli_trains_snapshots_and_resumes_exactly(name, data, tmp_path,
                                                  capsys):
    main(name, _argv(name, data, tmp_path, 3))
    lines = capsys.readouterr().out.splitlines()
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines] == [0, 1, 2]
    snaps = str(tmp_path / "snaps")
    assert [s for s, _ in checkpoints.sorted_snapshots(snaps)] == [3]

    resumed = main(name, _argv(name, data, tmp_path, 5, "--resume"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"Resumed from {snaps}/snapshot-3.pt at step 3"
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines[1:]] == [3, 4]
    assert [s for s, _ in checkpoints.sorted_snapshots(snaps)] == [5]

    # the log was appended across the restart, with the LR of each step
    rows = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [(r["step"], r["lr"]) for r in rows] == [
        (0, 1e-4), (1, 1e-4), (2, 1e-5), (3, 1e-5), (4, 1e-5)]
    assert all(r["loss"] == r["loss"] for r in rows)  # finite, not NaN

    straight = main(name, _argv(name, data, tmp_path / "s", 5))
    for a, b in zip(trainer.tree_leaves(resumed.params),
                    trainer.tree_leaves(straight.params)):
        assert torch.equal(a, b)


def test_posenet_in_training_eval_and_warm_start(data, tmp_path, capsys):
    argv = _argv("train_posenet", data, tmp_path, 4, "--eval-data", data,
                 "--eval-freq", "2", "--eval-batches", "1")
    state = main("train_posenet", argv)
    out = capsys.readouterr().out
    assert re.search(r"^Eval @ 2\t epe_mean_px \S+  epe_median_px \S+  "
                     r"auc_0_30px \S+$", out, re.M)
    assert "Eval @ 4\t" in out
    rows = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [r["step"] for r in rows if "eval_epe_mean_px" in r] == [2, 4]

    # a training snapshot warm-starts another run (params only)
    snapshot = checkpoints.latest_snapshot(str(tmp_path / "snaps"))
    warm = main("train_posenet", _argv("train_posenet", data, tmp_path / "w",
                                       0, "--weights", snapshot))
    for a, b in zip(trainer.tree_leaves(warm.params),
                    trainer.tree_leaves(state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flags,error,match", [
    (["--mesh", "3x1"], AssertionError, r"mesh 3x1 != 1 devices"),
    (["--mesh", "2x2"], NotImplementedError, "Out of scope this round"),
    (["--mesh", "2x1", "--steps-per-call", "2"], ValueError,
     "steps_per_call > 1 does not compose with a mesh"),
    (["--steps-per-call", "4", "--no-fused"], ValueError, "yield_raw"),
    (["--remat", "save_only_these_names"], TypeError, "policy factory"),
    (["--accum-steps", "3"], ValueError, "not divisible"),
    (["--remat", "not_a_policy"], ValueError, "unknown remat policy"),
])
def test_unported_flags_raise(data, tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        main("train_lifting", _argv("train_lifting", data, tmp_path, 1,
                                    *flags))


def test_mesh_1x1_equals_the_run_without_a_mesh(data, tmp_path, capsys):
    """--mesh 1x1 in one process (no launcher): a mesh of one rank, whose
    collectives change nothing: the same lines, snapshot and params, bit
    for bit."""
    plain = main("train_posenet", _argv("train_posenet", data, tmp_path, 3))
    plain_out = capsys.readouterr().out
    meshed = main("train_posenet", _argv("train_posenet", data,
                                         tmp_path / "m", 3, "--mesh", "1x1"))
    meshed_out = capsys.readouterr().out
    strip = re.compile(r"\t [\d.]+ it/s")
    assert strip.sub("", meshed_out) == strip.sub("", plain_out)
    for a, b in zip(trainer.tree_leaves(meshed.params),
                    trainer.tree_leaves(plain.params)):
        assert torch.equal(a, b)
    assert [s for s, _ in checkpoints.sorted_snapshots(
        str(tmp_path / "m" / "snaps"))] == [3]


def test_qat_trains_under_the_fake_quant_view(data, tmp_path, capsys,
                                              monkeypatch):
    """--qat (tests/test_torch_qat.py has the rest): train_lifting trains
    through the QAT view, its wide layers fake-quantized, and ends elsewhere
    than the float run."""
    from hand3d_tpu_torch.ops import quant

    calls = []
    fake = quant.fake_quant_layer
    monkeypatch.setattr(quant, "fake_quant_layer",
                        lambda *a: calls.append(1) or fake(*a))
    qat = main("train_lifting", _argv("train_lifting", data, tmp_path / "q",
                                      2, "--qat"))
    lines = capsys.readouterr().out.splitlines()
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines] == [0, 1]
    # conv_pose_2_2, fc_rel0, fc_rel1 and fc_xyz of the local variant
    assert len(calls) == 2 * 4
    monkeypatch.undo()
    plain = main("train_lifting", _argv("train_lifting", data, tmp_path / "f",
                                        2))
    assert any(not torch.equal(a, b) for a, b in zip(
        trainer.tree_leaves(qat.params), trainer.tree_leaves(plain.params)))


def test_remat_and_accumulation_train(data, tmp_path, capsys):
    main("train_posenet", _argv("train_posenet", data, tmp_path, 2,
                                "--remat", "--accum-steps", "2"))
    lines = capsys.readouterr().out.splitlines()
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines] == [0, 1]


@pytest.mark.parametrize("name", list(STAGES))
def test_resident_steps_under_a_remat_policy_equal_the_per_step_run(
        name, data, tmp_path, capsys):
    """--steps-per-call 3 --remat dots_saveable over 4 steps (windows 3 + 1,
    across the LR boundary at 2): the loss lines and the final state of the
    per-step run without remat, bit for bit (the CPU)."""
    resident = main(name, _argv(name, data, tmp_path / "r", 4,
                                "--steps-per-call", "3",
                                "--remat", "dots_saveable"))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("resident dataset: 6 records")
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines[1:]] == [
        0, 1, 2, 3]
    per_step = main(name, _argv(name, data, tmp_path / "p", 4))
    for a, b in zip(trainer.tree_leaves(resident.params),
                    trainer.tree_leaves(per_step.params)):
        assert torch.equal(a, b)
    rows = [json.loads(l) for l in open(tmp_path / "r" / "m.jsonl")]
    assert [(r["step"], r["lr"]) for r in rows] == [
        (0, 1e-4), (1, 1e-4), (2, 1e-5), (3, 1e-5)]
