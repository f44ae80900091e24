"""The port's training loop, snapshots and exports, on the CPU: exact resume
(after a stop and after SIGTERM), the non-finite halt, the step watchdog,
atomic snapshot writes, the .npz export that hand3d_tpu reads, and the eval
harnesses fed a training run's param tree.

The CPU runs the same float32 operations in the same order on every run, so
a resumed run must equal the uninterrupted one bit for bit.
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.weights import load_npz as j_load_npz
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import train_posenet
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.train import checkpoints, trainer
from hand3d_tpu_torch.train.loop import fit

from fixtures import make_rhd_bin
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                       coord_uv_noise=True, crop_center_noise=True,
                       crop_size=32)
LR_VALUES, LR_STEPS = [1e-4, 1e-5], [4]  # a resumed run crosses the boundary
FUSED = trainer.fuse_preprocess(train_posenet.loss_fn, preprocess_rhd, CFG)


def quiet(*args):
    pass


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 8 records at batch 2: 4 steps an epoch, so step 3 is mid-epoch
    return str(make_rhd_bin(tmp_path_factory.mktemp("loop") / "t.bin",
                            num_records=8, seed=9))


def _run(data, max_iter, snapshot_dir, loss=FUSED, **kw):
    pipeline = InputPipeline(RHDDataset("training", data), CFG, 2, seed=4,
                             yield_raw=True, device="cpu")
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(4))}, "cpu")
    kw.setdefault("show_loss_freq", 0)
    kw.setdefault("log", quiet)
    return fit(loss, params, trainer.make_optimizer(LR_VALUES, LR_STEPS),
               pipeline, max_iter, seed=4, snapshot_dir=snapshot_dir,
               snapshot_freq=0, **kw)


def _subprocess_env():
    return dict(os.environ, PYTHONPATH=REPO,
                OMP_NUM_THREADS=str(torch.get_num_threads()))


def assert_states_equal(a, b):
    assert a.step == b.step
    for x, y in zip(trainer.tree_leaves(a.params),
                    trainer.tree_leaves(b.params)):
        assert torch.equal(x, y)
    sa, sb = a.opt_state.state_dict(), b.opt_state.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, s in sa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def straight(data, tmp_path_factory):
    """Six uninterrupted steps."""
    return _run(data, 6, str(tmp_path_factory.mktemp("straight")))


def test_resume_equals_the_uninterrupted_run_bitwise(data, straight,
                                                     tmp_path):
    snaps = str(tmp_path / "snaps")
    first = _run(data, 3, snaps)
    assert first.step == 3
    assert [s for s, _ in checkpoints.sorted_snapshots(snaps)] == [3]
    resumed = _run(data, 6, snaps, resume=True)
    assert_states_equal(resumed, straight)
    assert straight.opt_state.param_groups[0]["lr"] == LR_VALUES[1]
    # the snapshot file holds the same state
    template = trainer.init_state(straight.params,
                                  trainer.make_optimizer(LR_VALUES, LR_STEPS))
    assert_states_equal(checkpoints.restore_snapshot(
        checkpoints.latest_snapshot(snaps), template), straight)


def test_snapshot_holds_only_what_weights_only_loads(data, straight,
                                                     tmp_path):
    path = checkpoints.save_snapshot(str(tmp_path), straight)
    assert os.path.basename(path) == "snapshot-6.pt"
    payload = torch.load(path, weights_only=True)
    assert payload["step"] == 6 and set(payload) == {"params", "opt_state",
                                                     "step"}
    # params only, in the TF layout: a warm start for fine-tuning or eval
    tree = checkpoints.load_snapshot_params(path)
    assert tree[posenet.SCOPE]["conv1_1"]["weights"].shape == (3, 3, 3, 64)
    np.testing.assert_array_equal(
        tree[posenet.SCOPE]["conv1_1"]["weights"],
        weights.params_to_jax(straight.params)[posenet.SCOPE]["conv1_1"]
        ["weights"])


_SIGTERM_SCRIPT = """
import sys, time
sys.path.insert(0, {tests!r})
import test_torch_train_loop as T

def slow(params, raw, generator):
    time.sleep(0.3)
    return T.FUSED(params, raw, generator)

state = T._run({data!r}, 6, {snaps!r}, loss=slow, show_loss_freq=1,
               log=lambda msg: print(msg, flush=True))
print("RETURNED-STEP", state.step, flush=True)
"""


def test_sigterm_snapshots_and_the_resumed_run_equals_the_straight_one(
        data, straight, tmp_path):
    snaps = str(tmp_path / "snaps")
    script = tmp_path / "train.py"
    script.write_text(_SIGTERM_SCRIPT.format(
        tests=os.path.join(REPO, "tests"), data=data, snaps=snaps))
    # the subprocess computes with this process's thread count, so its
    # steps round as the straight run's did
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, cwd=REPO, env=_subprocess_env())
    out = ""
    try:
        for line in proc.stdout:
            out += line
            if line.startswith("Iteration 1"):
                proc.send_signal(signal.SIGTERM)
                break
        out += proc.communicate(timeout=240)[0]
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-1000:]
    assert "saving snapshot at iteration" in out and "RETURNED-STEP" in out
    stopped = int(out.split("RETURNED-STEP")[1].split()[0])
    assert 2 <= stopped < 6
    assert [s for s, _ in checkpoints.sorted_snapshots(snaps)] == [stopped]
    assert_states_equal(_run(data, 6, snaps, resume=True), straight)


def test_a_non_finite_loss_halts_with_a_snapshot_at_i_plus_1(data, tmp_path):
    calls = []

    def poisoned(params, raw, generator):
        calls.append(1)
        loss = FUSED(params, raw, generator)
        return loss * float("nan") if len(calls) == 3 else loss

    snaps = str(tmp_path / "snaps")
    with pytest.raises(FloatingPointError, match="iteration 2"):
        _run(data, 6, snaps, loss=poisoned, show_loss_freq=1)
    (step, path), = checkpoints.sorted_snapshots(snaps)
    assert step == 3 and torch.load(path, weights_only=True)["step"] == 3


_WATCHDOG_SCRIPT = """
import time
import torch
from hand3d_tpu_torch.train import trainer
from hand3d_tpu_torch.train.loop import fit

class Pipeline:
    def iterate(self, epochs=None):
        while True:
            yield {{"x": torch.ones(1)}}
            time.sleep({step_sleep})

def loss_fn(params, batch, generator):
    return (params["w"] * batch["x"]).sum() ** 2

def eval_fn(state, step):
    time.sleep({eval_sleep})  # longer than step_timeout
    return {{"metric": 1.0}}

fit(loss_fn, {{"w": torch.ones(1)}}, trainer.make_optimizer([0.1], []),
    Pipeline(), 4, show_loss_freq=0, snapshot_freq=0, step_timeout=1.0,
    eval_fn=eval_fn, eval_freq=2)
time.sleep(1.5)  # longer than step_timeout: a live watchdog would fire
print("ALIVE")
"""


@pytest.mark.parametrize("step_sleep,eval_sleep,code", [
    (3600, 0, 17),  # a hung step: exit 17, for a supervisor to --resume
    (0, 1.5, 0),    # an eval longer than the timeout; disarmed after fit
])
def test_step_watchdog(tmp_path, step_sleep, eval_sleep, code):
    script = tmp_path / "w.py"
    script.write_text(_WATCHDOG_SCRIPT.format(step_sleep=step_sleep,
                                              eval_sleep=eval_sleep))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=240, cwd=REPO,
                          env=_subprocess_env())
    assert proc.returncode == code, proc.stderr[-1000:]
    if code:
        assert "step watchdog" in proc.stdout
    else:
        assert "ALIVE" in proc.stdout and "Eval @ 2" in proc.stdout


def _tiny_state():
    return trainer.init_state({"a": {"w": torch.ones(4)}},
                              trainer.make_optimizer([0.1], []))


def test_snapshot_write_survives_a_failed_serialization(tmp_path,
                                                        monkeypatch):
    state = _tiny_state()
    good = checkpoints.save_snapshot(str(tmp_path), state, step=1)

    def boom(*args, **kw):
        raise RuntimeError("killed during serialization")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(RuntimeError, match="serialization"):
        checkpoints.save_snapshot(str(tmp_path), state, step=2)
    monkeypatch.undo()

    def torn(fd):
        raise OSError("killed during the write")

    monkeypatch.setattr(os, "fsync", torn)
    with pytest.raises(OSError):
        checkpoints.save_snapshot(str(tmp_path), state, step=3)
    monkeypatch.undo()
    # neither failure produced a snapshot; the good one is intact
    assert checkpoints.latest_snapshot(str(tmp_path)) == good
    assert os.path.exists(os.path.join(str(tmp_path), "snapshot-3.pt.tmp"))
    restored = checkpoints.restore_snapshot(good, _tiny_state())
    assert torch.equal(restored.params["a"]["w"], torch.ones(4))
    # the next save sweeps the torn .tmp file
    checkpoints.save_snapshot(str(tmp_path), state, step=4)
    assert sorted(os.listdir(tmp_path)) == ["snapshot-4.pt"]


def test_snapshot_prune_keeps_the_new_snapshot(tmp_path):
    state = _tiny_state()
    stale = checkpoints.save_snapshot(str(tmp_path), state, step=5000)
    new = checkpoints.save_snapshot(str(tmp_path), state, step=100)
    assert os.path.exists(new) and not os.path.exists(stale)
    assert checkpoints.latest_snapshot(str(tmp_path)) == new
    with pytest.raises(ValueError, match="keep=0"):
        checkpoints.save_snapshot(str(tmp_path), state, step=101, keep=0)
    with pytest.raises(ValueError, match="differs"):
        checkpoints.restore_snapshot(new, trainer.init_state(
            {"b": {"w": torch.ones(4)}}, trainer.make_optimizer([0.1], [])))


def test_weights_round_trip_numpy_port_numpy(tmp_path):
    tree = {posenet.SCOPE: posenet.init(np.random.default_rng(1))}
    back = weights.params_to_jax(weights.params_from_jax(tree, "cpu"))
    flat, flat_back = weights.tree_to_flat(tree), weights.tree_to_flat(back)
    assert flat.keys() == flat_back.keys()
    for k in flat:
        assert flat_back[k].dtype == np.float32
        np.testing.assert_array_equal(flat_back[k], flat[k])
    path = str(tmp_path / "p.npz")
    weights.save_npz(path, tree)
    for k, v in weights.tree_to_flat(weights.load_npz(path)).items():
        np.testing.assert_array_equal(v, flat[k])


def test_export_loads_in_the_jax_package_and_gives_the_port_forward(
        straight, tmp_path):
    """A trained tree exported by the port runs in hand3d_tpu's PoseNet as
    it runs in the port's (1e-5 of the largest value, as
    tests/test_torch_models.py holds the two networks)."""
    path = str(tmp_path / "posenet.npz")
    checkpoints.export_params(path, straight.params)
    image = np.random.default_rng(2).random((2, 32, 32, 3), np.float32) - 0.5
    want = j_posenet.apply(j_load_npz(path)[posenet.SCOPE], image)[-1]
    with torch.no_grad():
        got = posenet.apply(straight.params[posenet.SCOPE],
                            torch.from_numpy(image))[-1]
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    back = checkpoints.import_params(path)
    np.testing.assert_array_equal(
        back[posenet.SCOPE]["conv1_1"]["weights"],
        np.asarray(j_load_npz(path)[posenet.SCOPE]["conv1_1"]["weights"]))


def test_harnesses_take_a_training_tree_on_its_device(data, straight):
    """The in-training eval hands the harness the live tree, with no copy
    through numpy: the metrics equal those of the numpy export."""
    dataset = RHDDataset("evaluation", data)
    live = straight.params[posenet.SCOPE]
    exported = weights.params_to_jax(straight.params)[posenet.SCOPE]
    got = harnesses.eval2d_gt_cropped(live, dataset, 4, device="cpu")
    want = harnesses.eval2d_gt_cropped(exported, dataset, 4, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert all(t.requires_grad and t.grad is None
               for t in trainer.tree_leaves(straight.params))
    with pytest.raises(ValueError, match="not on"):
        harnesses._device_params(live, torch.device("meta"))
