"""The port's eval CLIs against hand3d_tpu's, on the CPU.

Each CLI runs on the same fixture file with the same weights, an .npz of
JAX-initialized params (the JAX package's export, ``save_npz``), and must
print the JAX CLI's lines: the progress lines and the metric lines, to the
three decimals they show (and eval_full's "Wrote" line of --plot). The port
runs with ``--device cpu``.
"""

import importlib
import pickle
import sys

import jax
import numpy as np
import pytest

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import PosePriorNetwork
from hand3d_tpu.weights import save_npz

from fixtures import make_rhd_bin, make_stb_bin
from torch_tmp import module_dir, tmp_path  # noqa: F401


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    with module_dir(tmp_path_factory, "cli") as d:
        cascade = str(d / "cascade.npz")
        save_npz(cascade, JaxCascade().init(jax.random.PRNGKey(7)))
        lifting = str(d / "local.npz")
        save_npz(lifting,
                 PosePriorNetwork("local").init(jax.random.PRNGKey(8)))
        yield {"rhd": str(make_rhd_bin(d / "rhd.bin", num_records=3)),
               "stb": str(make_stb_bin(d / "stb.bin", num_records=3)),
               "cascade": cascade, "local": lifting,
               "plot": str(d / "fig9.png")}


def run_cli(package, name, argv, monkeypatch, capsys):
    module = importlib.import_module(f"{package}.cli.{name}")
    capsys.readouterr()
    if package == "hand3d_tpu":
        monkeypatch.setattr(sys, "argv", ["prog"] + argv)
        module.main()
    else:
        module.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


CASES = {
    "eval2d_gt_cropped": ("eval2d_gt_cropped", ["--weights", "{cascade}"]),
    "eval2d": ("eval2d", ["--weights", "{cascade}", "--no-wrist"]),
    "eval2d_320": ("eval2d", ["--weights", "{cascade}", "--no-wrist",
                              "--no-scale-to-size"]),
    "eval3d_local": ("eval3d", ["--weights", "{local}", "--variant",
                                "local"]),
    "eval3d_from_posenet": ("eval3d", ["--weights", "{cascade}",
                                       "--from-posenet"]),
    "eval_full_stb": ("eval_full", ["--weights", "{cascade}", "--dataset",
                                    "stb", "--data", "{stb}", "--plot",
                                    "{plot}"]),
    # --quantize int8 (after tests/test_cli.py's test_cli_eval3d_quantized):
    # each int8 layer is bit-equal to JAX's on the same input and the 3D
    # metrics agree to the printed digits (the 2D ones below need not)
    "eval3d_local_int8": ("eval3d", ["--weights", "{local}", "--variant",
                                     "local", "--quantize", "int8"]),
    "eval3d_from_posenet_int8": ("eval3d", ["--weights", "{cascade}",
                                            "--from-posenet", "--quantize",
                                            "int8"]),
    "eval_full_stb_int8": ("eval_full", ["--weights", "{cascade}",
                                         "--dataset", "stb", "--data",
                                         "{stb}", "--quantize", "int8"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_cli_prints_the_jax_lines(files, monkeypatch, capsys, case):
    name, args = CASES[case]
    argv = [a.format(**files) for a in args] + ["--batch-size", "2"]
    if "--data" not in argv:
        argv += ["--data", files["rhd"]]
    want = run_cli("hand3d_tpu", name, argv, monkeypatch, capsys)
    got = run_cli("hand3d_tpu_torch", name, argv, monkeypatch, capsys)
    assert any("EPE" in line for line in want)
    assert got == want
    if "--plot" in argv:  # --plot imports matplotlib only when asked for
        assert any(line.startswith("Wrote ") for line in got)


@pytest.mark.parametrize("name, args", [
    ("eval2d_gt_cropped", []), ("eval2d", ["--no-wrist"])])
def test_port_2d_clis_run_quantized(files, monkeypatch, capsys, name, args):
    """--quantize int8 of the 2D evals: the JAX CLI's lines, with EPEs of
    the int8 PoseNet. With random weights its 32x32 argmaxes sit near ties
    that one int8 grid step on either side moves (tests/test_torch_quant.py
    holds the cascade flip-aware), so the 2D metrics are not compared."""
    argv = ["--weights", files["cascade"], "--data", files["rhd"],
            "--batch-size", "2", *args]
    plain = run_cli("hand3d_tpu_torch", name, argv, monkeypatch, capsys)
    got = run_cli("hand3d_tpu_torch", name, argv + ["--quantize", "int8"],
                  monkeypatch, capsys)
    want = run_cli("hand3d_tpu", name, argv + ["--quantize", "int8"],
                   monkeypatch, capsys)
    assert len(got) == len(want) and got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert g.split(":")[0] == w.split(":")[0]
        value = float(g.split(":")[1].split()[0])
        assert np.isfinite(value)
    assert got != plain  # the quantized PoseNet answers otherwise


def test_port_cli_rejects_other_weight_formats(files, tmp_path):
    """A file in none of the weight formats falls through to the reference
    pickle reader, which refuses it, as the JAX CLI's does."""
    from hand3d_tpu.cli._common import load_weight_trees as jax_load
    from hand3d_tpu_torch.cli import eval3d

    junk = tmp_path / "w.bin"
    junk.write_bytes(b"not a weight file")
    with pytest.raises(pickle.UnpicklingError):
        jax_load([str(junk)])
    with pytest.raises(pickle.UnpicklingError):
        eval3d.main(["--data", files["rhd"], "--device", "cpu",
                     "--weights", str(junk)])
