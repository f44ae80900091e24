"""Quantization-aware training in the port's four trainers (``--qat``), on
the CPU at small sizes: it composes with the fused preprocess,
``--accum-steps``, ``--remat <policy>`` and ``--steps-per-call K`` (the
resident path equals the per-step path bit for bit, as without QAT), its
step reads nothing from the host, and its snapshot is a float tree whose
``quantize_params_int8`` is the deployment tree.
"""

import importlib

import numpy as np
import pytest
import torch

from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import _common, train_posenet
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import resident_data
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.ops import quant
from hand3d_tpu_torch.train import checkpoints, trainer

from fixtures import make_rhd_bin
from test_torch_resident import NoHostReads
from test_torch_train_cli import LOSS_LINE, STAGES, _argv
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    with module_dir(tmp_path_factory, "qat") as d:
        yield str(make_rhd_bin(d / "t.bin", num_records=6, seed=3))


def main(name, argv):
    module = importlib.import_module(f"hand3d_tpu_torch.cli.{name}")
    return module.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("name", list(STAGES))
def test_qat_resident_under_remat_equals_the_per_step_run(name, data,
                                                          tmp_path, capsys):
    """--qat --steps-per-call 3 --remat dots_saveable over 4 steps (windows
    3 + 1): the loss lines and the final state of the per-step --qat run,
    bit for bit (the CPU); and the fake quantizers are in the step: the
    float run's state differs."""
    resident = main(name, _argv(name, data, tmp_path / "r", 4, "--qat",
                                "--steps-per-call", "3",
                                "--remat", "dots_saveable"))
    r_lines = capsys.readouterr().out.splitlines()[1:]
    per_step = main(name, _argv(name, data, tmp_path / "p", 4, "--qat"))
    p_lines = capsys.readouterr().out.splitlines()
    assert all(LOSS_LINE.match(l) for l in r_lines + p_lines)
    assert [l.split("\t")[:2] for l in r_lines] == \
        [l.split("\t")[:2] for l in p_lines]
    for a, b in zip(trainer.tree_leaves(resident.params),
                    trainer.tree_leaves(per_step.params)):
        assert torch.equal(a, b)
    floats = main(name, _argv(name, data, tmp_path / "f", 4))
    assert any(not torch.equal(a, b) for a, b in zip(
        trainer.tree_leaves(floats.params),
        trainer.tree_leaves(per_step.params)))


def test_qat_accumulates_and_snapshots_a_float_tree(data, tmp_path, capsys):
    """--qat with --accum-steps 2 trains; the snapshot holds the float
    layout only, and quantize_params_int8 of it is the deployment tree,
    equal to quantizing the run's final params."""
    state = main("train_posenet", _argv("train_posenet", data, tmp_path, 2,
                                        "--qat", "--accum-steps", "2"))
    lines = capsys.readouterr().out.splitlines()
    assert [int(LOSS_LINE.match(l).group(1)) for l in lines] == [0, 1]
    snap = checkpoints.load_snapshot_params(
        checkpoints.latest_snapshot(str(tmp_path / "snaps")))
    keys = {k for layer in snap[posenet.SCOPE].values() for k in layer}
    assert keys == {"weights", "biases"}
    deployed = quant.quantize_params_int8(weights.params_from_jax(snap,
                                                                  "cpu"))
    want = quant.quantize_params_int8(state.params)
    for path, layer in quant.layer_paths(want).items():
        got = quant.layer_paths(deployed)[path]
        assert set(got) == set(layer)
        for k in layer:
            assert torch.equal(got[k], layer[k].detach()), (path, k)
    assert sum("weights_q" in l for l in
               quant.layer_paths(deployed).values()) == 25


def test_maybe_qat_views_the_loss_params():
    """maybe_qat hands the loss the QAT view (same tensors, "weights_fq" on
    the eligible layers) with --qat, the params as they are without."""
    seen = []
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(0))}, "cpu")

    def loss(p, batch, generator):
        seen.append(p)
        return 0.0

    class Args:
        qat = True

    _common.maybe_qat(loss, Args)(params, None, None)
    Args.qat = False
    _common.maybe_qat(loss, Args)(params, None, None)
    view, plain = seen
    assert plain is params
    layer = view[posenet.SCOPE]["conv4_1"]
    assert set(layer) == {"weights_fq", "biases"}
    assert layer["weights_fq"] is params[posenet.SCOPE]["conv4_1"]["weights"]
    assert set(view[posenet.SCOPE]["conv5_2"]) == {"weights", "biases"}


def test_no_host_read_in_a_resident_qat_step(data):
    """The fake quantizers read nothing from the host inside a resident
    step (a captured CUDA graph on the card): no .item(), no nonzero."""
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_size=32)
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(0))}, "cpu")

    class Args:
        qat = True

    fused = trainer.fuse_preprocess(
        _common.maybe_qat(train_posenet.loss_fn, Args), preprocess_rhd, cfg)
    opt = trainer.make_optimizer([1e-4], [])
    state = trainer.init_state(params, opt)
    step = trainer.make_resident_train_step(fused, opt, remat="dots_saveable")
    raw = resident_data(RHDDataset("training", data), "cpu")
    state, _ = step(state, raw, np.array([[0, 1]]), 0, 0)  # builds the step
    step.load(state, raw, np.array([[2, 3]]), 0, 1)  # host-side draws
    with NoHostReads():
        state, metrics = step.run(state, 1, 1)
    assert state.step == 2 and metrics.shape == (2, 1)
