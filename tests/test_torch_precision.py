"""The port's exact-f32 contract: every entry point that puts parameters on
a CUDA device turns TF32 off first (``hand3d_tpu_torch.precision``).

This machine has no card. The tests stub ``torch.cuda.is_available`` so the
entry points go as far as moving their first parameter to the device, which
then fails; by that point both TF32 flags must be off. Both flags are
restored after each test.
"""

import importlib

import pytest
import torch

from hand3d_tpu_torch import precision, weights
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.serving import HandPoseEstimator

from fixtures import make_rhd_bin
from torch_tmp import tmp_path  # noqa: F401


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (PyTorch's cuDNN default), restored afterwards."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def fake_card(monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_exact_f32_turns_tf32_off_for_cuda(fake_card):
    assert precision.exact_f32("cuda") == torch.device("cuda")
    assert tf32_flags() == (False, False)


def test_exact_f32_leaves_cpu_alone(tf32_on):
    assert precision.exact_f32("cpu") == torch.device("cpu")
    assert tf32_flags() == (True, True)


def test_exact_f32_refuses_a_missing_card(monkeypatch, tf32_on):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        precision.exact_f32("cuda:0")
    assert tf32_flags() == (True, True)


def _entry_points(tmp_path):
    data = RHDDataset("evaluation",
                      str(make_rhd_bin(tmp_path / "r.bin", num_records=2)))
    cascade = weights.random_params(0)
    lifting = weights.random_lifting_params("proposed", 0)
    return {
        "estimator": lambda: HandPoseEstimator(cascade, batch_size=1,
                                               device="cuda"),
        "eval2d_gt_cropped": lambda: harnesses.eval2d_gt_cropped(
            cascade["PoseNet2D"], data, 2, device="cuda"),
        "eval2d_full_image": lambda: harnesses.eval2d_full_image(
            cascade, data, 2, device="cuda"),
        "eval3d_lifting": lambda: harnesses.eval3d_lifting(
            "proposed", lifting, data, 2, device="cuda"),
        "eval3d_from_posenet": lambda: harnesses.eval3d_from_posenet(
            "proposed", dict(lifting, PoseNet2D=cascade["PoseNet2D"]), data,
            2, device="cuda"),
        "eval_full_pipeline": lambda: harnesses.eval_full_pipeline(
            cascade, data, 2, device="cuda"),
    }


@pytest.mark.parametrize("name", ["estimator", "eval2d_gt_cropped",
                                  "eval2d_full_image", "eval3d_lifting",
                                  "eval3d_from_posenet", "eval_full_pipeline"])
def test_cuda_entry_points_turn_tf32_off_first(tmp_path, fake_card, name):
    # without a CUDA build the first parameter moved to the card fails
    with pytest.raises((AssertionError, RuntimeError)):
        _entry_points(tmp_path)[name]()
    assert tf32_flags() == (False, False)


@pytest.mark.parametrize("cli", ["eval2d_gt_cropped", "eval2d", "eval3d",
                                 "eval_full", "train_posenet",
                                 "train_handsegnet", "train_lifting",
                                 "train_joint"])
def test_clis_default_to_cuda_and_refuse_a_missing_card(tmp_path, monkeypatch,
                                                        cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_rhd_bin(tmp_path / "r.bin", num_records=2)
    argv = ["--data", str(data)] + (["--dataset", "rhd"]
                                    if cli == "eval_full" else [])
    module = importlib.import_module(f"hand3d_tpu_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
