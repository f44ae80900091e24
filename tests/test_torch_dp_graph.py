"""The data-parallel train step as a CUDA graph (``trainer.DataParallelStep``).

On the card (marked ``gpu``; they skip without one): one NCCL rank on a 1x1
mesh, in a process of its own (``tests/torch_dp_graph_worker.py``), holds
graphed steps to eager ones bit for bit under deterministic algorithms,
counts the replays, reads its losses one step behind (``StepLoss``) and
counts the replays that queued behind a running step, refuses a state that
is not the captured one, runs a batch of other shapes eagerly, and
captures one step of each train CLI's loss (PoseNet's also with the
preprocess in the input pipeline, a step that draws nothing). On the CPU:
the binding of this step and of the resident step to the state of their
first call, its eager path on a gloo mesh of one rank, and what a
``StepLoss`` reading returns. Imports torch and the port only (no jax), so
the card's tests run with ``--noconftest``.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import train_posenet
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.synthetic import make_rhd_bin
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train import trainer
from hand3d_tpu_torch.utils import profiling

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_graph_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
WORKER_TIMEOUT_S = 900
BEHIND_STEPS = 6  # the worker's
CLIS = ["posenet", "posenet_unfused", "handsegnet", "lifting", "joint"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    """What the worker saw on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    d = tmp_path_factory.mktemp("dp_graph")
    data = str(d / "train.bin")
    make_rhd_bin(data, num_records=16, seed=3)
    env = dict(os.environ, PYTHONPATH=REPO,
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, WORKER, str(_free_port()), data, str(d)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(d / "result.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.gpu
def test_graphed_steps_equal_eager_steps_bitwise(card):
    got = card["steps"]
    assert card["backend"] == "nccl"
    assert got["graph"] == got["eager"]
    assert got["equal"], "params or Adam moments differ"
    assert got["counters"] == {"train.step_graph.replays": 4,
                               "train.step_graph.eager": 0}


@pytest.mark.gpu
def test_losses_read_one_step_behind_equal_eager_losses_bitwise(card):
    got = card["behind"]
    assert got["kinds"] == ["StepLoss"]
    assert len(got["graph"]) == BEHIND_STEPS
    assert got["first_reads"] == got["graph"]  # kept readings hold
    assert got["graph"] == got["eager"]
    assert got["equal"], "params or Adam moments differ"
    assert got["counters"] == {"train.step_graph.replays": BEHIND_STEPS,
                               "train.step_graph.eager": 0}


@pytest.mark.gpu
def test_replays_behind_a_running_step_count_as_in_flight(card):
    # every replay after the first was launched before the previous
    # step's loss was read
    assert card["behind"]["in_flight"] == BEHIND_STEPS - 1


@pytest.mark.gpu
def test_a_loss_read_at_once_leaves_nothing_in_flight(card):
    assert card["steps"]["in_flight"] == 0


@pytest.mark.gpu
def test_a_state_replaced_after_capture_raises(card):
    got = card["steps"]
    assert got["replaced"] is not None and "bound" in got["replaced"]
    assert got["replaced_counters"] == {"train.step_graph.replays": 0,
                                        "train.step_graph.eager": 0}


@pytest.mark.gpu
def test_a_batch_of_other_shapes_runs_eagerly(card):
    half, after = card["steps"]["half"], card["steps"]["after_half"]
    assert half["graph"] == half["eager"] and half["equal"]
    assert half["counters"] == {"train.step_graph.replays": 0,
                                "train.step_graph.eager": 1}
    # the graph takes the captured shapes again afterwards
    assert after["graph"] == after["eager"] and after["equal"]
    assert after["counters"] == {"train.step_graph.replays": 1,
                                 "train.step_graph.eager": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("cli", CLIS)
def test_each_train_cli_loss_captures(card, cli):
    got = card["clis"][cli]
    assert (got["draws"] == 0) == (cli == "posenet_unfused"), got
    assert got["graph"] == got["eager"] and got["equal"], got
    assert got["counters"] == {"train.step_graph.replays": 1,
                               "train.step_graph.eager": 0}


@pytest.fixture(scope="module")
def cpu_job(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dp_graph_cpu") / "train.bin")
    make_rhd_bin(path, num_records=4, seed=1)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_size=32)
    raw = RHDDataset("training", path).raw_batch(np.arange(2))
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(0))}, "cpu")
    loss = trainer.fuse_preprocess(train_posenet.loss_fn, preprocess_rhd,
                                   cfg)
    return loss, params, {k: torch.from_numpy(v) for k, v in raw.items()}


@pytest.mark.parametrize("kind", ["data_parallel", "resident"])
def test_a_graph_step_is_bound_to_the_state_of_its_first_call(cpu_job, kind):
    loss, params, raw = cpu_job
    opt = trainer.make_optimizer([1e-4], [])
    state = trainer.init_state(params, opt)
    if kind == "resident":
        # the two records as the dataset on the device, one window of one
        # step over both
        step = trainer.make_resident_train_step(loss, opt)
        idx = np.arange(2)[None]
        state, _ = step(state, raw, idx, 0, 0)

        def load(other):
            step.load(other, raw, idx, 0, 1)
    else:
        step = trainer.DataParallelStep(loss, opt, mesh_lib.make_mesh(1, 1))
        step.load(state, raw, (0, 0))
        step.run(state)
        assert step.fits(raw)
        assert not step.fits({k: v[:1] for k, v in raw.items()})

        def load(other):
            step.load(other, raw, (0, 1))
    load(state)  # the state of the first call, stepped on
    with pytest.raises(ValueError, match="bound to the state"):
        load(trainer.init_state(params, opt))


def test_dp_step_on_a_gloo_mesh_is_eager(cpu_job):
    loss, params, raw = cpu_job
    opt = trainer.make_optimizer([1e-4], [])
    state = trainer.init_state(params, opt)
    step = trainer.make_train_step(loss, opt, mesh=mesh_lib.make_mesh(1, 1))
    assert isinstance(step, trainer.DataParallelStep) and not step.nccl
    before = profiling.counters()
    for i in range(2):
        state, metrics = step(state, raw, (0, i))
        assert np.isfinite(metrics["loss"].item())
    assert state.step == 2 and step.bound is None
    after = profiling.counters()
    assert all(after.get(k, 0) == before.get(k, 0) for k in (
        "train.step_graph.replays", "train.step_graph.eager"))


def test_a_step_loss_reading_returns_its_own_value():
    src = torch.tensor(1.5)
    first = trainer.StepLoss(src)
    src.fill_(float("inf"))  # the next step overwrites its static loss
    later = [trainer.StepLoss(src) for _ in range(3)]
    assert first.done()
    assert float(first) == 1.5 and first.item() == 1.5
    assert isinstance(first.item(), float)
    assert np.isfinite(float(first))
    assert not np.isfinite(float(later[-1]))
    assert float(first) == 1.5  # kept, and read again after later ones
    small = torch.tensor(0.1)  # an f32 value read as the tensor reads it
    assert float(trainer.StepLoss(small)) == small.item()
