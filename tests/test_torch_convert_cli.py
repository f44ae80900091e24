"""``python -m hand3d_tpu_torch.cli.convert_weights`` against
``tools/convert_weights.py``: the same flags on the same reference files
write the same .npz, key for key and bit for bit."""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from hand3d_tpu.weights import tf_ckpt as jax_tf_ckpt
from hand3d_tpu_torch.cli import convert_weights

from torch_tmp import module_dir, tmp_path  # noqa: F401
from torch_weight_files import (cpm_flat, pose_pickle_flat, seg_pickle_flat,
                                snapshot_ckpt_flat, write_reference_pickle)

JAX_TOOL = str(Path(__file__).resolve().parents[1] / "tools"
               / "convert_weights.py")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0)
    with module_dir(tmp_path_factory, "convert") as d:
        write_reference_pickle(d / "seg.pickle", seg_pickle_flat(rng))
        write_reference_pickle(d / "pose.pickle", pose_pickle_flat(rng))
        cpm = cpm_flat(rng)
        jax_tf_ckpt.write_checkpoint(str(d / "cpm-model-mpii"), cpm)
        # the CPM variables alone, as a warm start without optimizer state
        jax_tf_ckpt.write_checkpoint(
            str(d / "cpm-weights"),
            {k: v for k, v in cpm.items() if k.startswith("CPM/")
             and "Adam" not in k})
        jax_tf_ckpt.write_checkpoint(str(d / "model-300"),
                                     snapshot_ckpt_flat(rng))
        yield {k: str(d / n) for k, n in (
            ("seg", "seg.pickle"), ("pose", "pose.pickle"),
            ("cpm", "cpm-model-mpii"), ("cpm_weights", "cpm-weights"),
            ("snapshot", "model-300"))}


def run_jax_tool(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", *argv])
    runpy.run_path(JAX_TOOL, run_name="__main__")


CASES = {
    "pickles": ["{seg}", "{pose}"],
    "pickles_exclude": ["{seg}", "{pose}", "--exclude", "PosePrior",
                        "ViewpointNet"],
    "cpm_posenet": ["--tf-checkpoint", "{cpm}", "--cpm-target", "posenet",
                    "--snapshot"],
    "cpm_handsegnet": ["--tf-checkpoint", "{cpm}", "--cpm-target",
                       "handsegnet", "--snapshot"],
    "cpm_without_optimizer_state": ["--tf-checkpoint", "{cpm_weights}",
                                    "--cpm-target", "posenet"],
    "snapshot": ["--tf-checkpoint", "{snapshot}", "--snapshot"],
    "pickles_and_checkpoint": ["{seg}", "--tf-checkpoint", "{cpm}",
                               "--cpm-target", "handsegnet", "--snapshot"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_writes_the_jax_tools_npz(files, case, tmp_path, monkeypatch,
                                  capsys):
    argv = [a.format(**files) for a in CASES[case]]
    run_jax_tool(argv + ["--out", str(tmp_path / "jax.npz")], monkeypatch)
    want_line = capsys.readouterr().out.replace(str(tmp_path / "jax.npz"),
                                                "OUT")
    convert_weights.main(argv + ["--out", str(tmp_path / "port.npz")])
    got_line = capsys.readouterr().out.replace(str(tmp_path / "port.npz"),
                                               "OUT")
    assert got_line == want_line
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_nothing_to_convert_exits(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="nothing to convert"):
        run_jax_tool(["--out", str(tmp_path / "j.npz")], monkeypatch)
    with pytest.raises(SystemExit, match="nothing to convert"):
        convert_weights.main(["--out", str(tmp_path / "p.npz")])


def test_the_npz_loads_as_weights(files, tmp_path):
    """The converted file is a --weights file of every port CLI."""
    from hand3d_tpu_torch.cli._common import load_weight_trees

    out = str(tmp_path / "w.npz")
    convert_weights.main([files["seg"], files["pose"], "--out", out])
    direct = load_weight_trees([files["seg"], files["pose"]])
    loaded = load_weight_trees([out])
    assert loaded.keys() == direct.keys()
    for scope in direct:
        for name, leaves in direct[scope].items():
            for leaf, v in leaves.items():
                np.testing.assert_array_equal(loaded[scope][name][leaf], v)
