"""The plain references agree with the program, and a run whose timed path
is broken underneath comes out not correct (CPU, small sizes); the TF32
control fails on the card."""

import multiprocessing

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.reference import cascade as ref
from benchmark.reference import check_cascade, posenet_train
from benchmark.tests import _drive

SEED = 2 ** 31 + 29


def test_cascade_reference_matches_program():
    from hand3d_tpu_torch.serving import HandPoseEstimator

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    weights = inputs.make_weights(SEED, cpu)
    frames = inputs.make_frames(SEED, 4, (64, 96), cpu)
    got = HandPoseEstimator(weights, batch_size=2, input_hw=(64, 96),
                            device="cpu").predict(frames)
    numbers, per_frame = check_cascade.judge(ref.to_torch(weights, cpu),
                                             frames, got, cpu)
    assert numbers["seg_err"] < 1e-4 and numbers["pose_gap"] < 1e-4
    assert per_frame["box_tau"] == 0.0 and per_frame["uv_gap"] < 1e-5
    assert len(per_frame["passes"]) == 4 and (per_frame["passes"] >= 1).all()


@pytest.mark.parametrize("name,fault,correct", [
    ("chp3d-f32.offline-b32", None, True),
    ("chp3d-f32.offline-b32", "answer", False),
    ("chp3d-f32.offline-b32", "box", False),
    ("chp3d-f32.offline-b32", "half_outputs", False),
    ("chp3d-f32.webcam-http", None, True),
    ("chp3d-f32.webcam-http", "answer", False),
    ("chp3d-f32.webcam-http", "box", False),
    ("posenet-train.resident-b8", "unchanged", False),
    ("posenet-train.resident-b8", "half_batch", False),
])
def test_run_correct_unless_broken(name, fault, correct):
    got, numbers = _drive.drive(name, fault)
    assert got is correct, numbers


def test_sound_training_runs_read_far_below_the_faults():
    # the training cells' limits are set from cuDNN's rounding on the card;
    # the CPU's convolutions round otherwise, so here a sound run is held
    # to a tenth of what the faults read (loss 1e-3, gradients 3e-2, the
    # window's losses 0.2)
    _, numbers = _drive.drive("posenet-train.resident-b8")
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 3e-3
    assert numbers["delta_gap"] < 1e-2
    assert numbers["window_loss_gap"] < 2e-2


def test_a_window_that_skips_steps_fails_the_window_number():
    # the first steps run as windows of 1 and 2: only the whole window's
    # losses show a step at a later position that never ran
    _, numbers = _drive.drive("posenet-train.resident-b8", "short_window")
    assert numbers["window_loss_gap"] > 0.2 and numbers["delta_gap"] < 1e-2


@pytest.mark.parametrize("fault,correct", [
    ("no_exchange", False), ("unchanged", False), ("half_batch", False)])
def test_data_parallel_run_correct_unless_broken(fault, correct):
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    name = "posenet-train.dp4-b8"
    world = _drive.SMALL[name]["chips"]
    port = harness.free_port()
    procs = [ctx.Process(target=_drive.rank_main,
                         args=(r, world, port, name, fault, SEED, out))
             for r in range(world)]
    for p in procs:
        p.start()
    got, numbers = out.get(timeout=600)
    for p in procs:
        p.join(60)
        assert not p.is_alive() and p.exitcode == 0
    assert got is correct, numbers


def test_training_reference_follows_the_draw_rule():
    # two ranks' global batch is the ranks' batches in rank order
    rows = posenet_train.step_rows(SEED, 3, 64, 4, ranks=2)
    perm = np.arange(64)
    np.random.RandomState(SEED).shuffle(perm)
    assert np.array_equal(rows[:4], perm[0::2][:32].reshape(8, 4)[3])
    assert np.array_equal(rows[4:], perm[1::2][:32].reshape(8, 4)[3])


@pytest.mark.gpu
def test_control_fails(cuda):
    from benchmark import control

    for name in ("chp3d-f32.offline-b32", "posenet-train.resident-b8"):
        run = harness.Run(name, 0, 0, 0, device=cuda)
        if run.workload["generator"] == "train":
            out = control.trained(run, SEED, cuda)
        else:
            run.params.update(check_frames=8)
            out = control.served(run, SEED, cuda, program=False)
        limits = run.workload["limits"]
        assert any(v > limits[k] for k, v in out["control"].items()), out
