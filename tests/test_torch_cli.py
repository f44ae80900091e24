"""The port's eval CLIs against hand3d_tpu's, on the CPU.

Each CLI runs on the same fixture file with the same weights, an .npz of
JAX-initialized params (the JAX package's export, ``save_npz``), and must
print the JAX CLI's lines: the progress lines and the metric lines, to the
three decimals they show (and eval_full's "Wrote" line of --plot). The port
runs with ``--device cpu``.
"""

import importlib
import sys

import jax
import pytest

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import PosePriorNetwork
from hand3d_tpu.weights import save_npz

from fixtures import make_rhd_bin, make_stb_bin


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cascade = str(d / "cascade.npz")
    save_npz(cascade, JaxCascade().init(jax.random.PRNGKey(7)))
    lifting = str(d / "local.npz")
    save_npz(lifting, PosePriorNetwork("local").init(jax.random.PRNGKey(8)))
    return {"rhd": str(make_rhd_bin(d / "rhd.bin", num_records=3)),
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


def test_port_cli_rejects_other_weight_formats(files, tmp_path):
    from hand3d_tpu_torch.cli import eval3d

    with pytest.raises(ValueError, match="only .npz"):
        eval3d.main(["--data", files["rhd"], "--device", "cpu",
                     "--weights", str(tmp_path / "w.pickle")])
