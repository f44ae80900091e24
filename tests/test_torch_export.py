"""AOT export of the port (hand3d_tpu_torch.export) on the CPU: the artifact
round trip, its container, the export CLI, and serving an artifact.

On the CPU the exported program calls the two registered ops' CPU
implementations (the kernels' plain twins); chip_smoke.py loads a card
artifact in a child process and sees both CUDA kernels launch.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from hand3d_tpu_torch import export, serving, weights
from hand3d_tpu_torch.cli import export_model
from hand3d_tpu_torch.models.cascade import ColorHandPose3D

from torch_tmp import module_dir, tmp_path  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
HW = (48, 64)


@pytest.fixture(scope="module")
def params():
    return weights.random_params(1)


@pytest.fixture(scope="module")
def artifact(params, tmp_path_factory):
    """An f32 artifact at batch 2, 48x64, written to a file."""
    with module_dir(tmp_path_factory, "export") as d:
        path = d / "cascade.h3dx"
        blob = export.export_estimator(params, str(path), batch_size=2,
                                       input_hw=HW, device="cpu")
        assert path.read_bytes() == blob
        yield str(path)


@pytest.fixture(scope="module")
def npz(params, tmp_path_factory):
    """``params`` as an .npz weights file."""
    with module_dir(tmp_path_factory, "weights") as d:
        weights.save_npz(str(d / "w.npz"), params)
        yield d / "w.npz"


def frames(n, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                dtype=np.uint8)


def assert_equal_outputs(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_round_trip_equals_the_live_estimator(params, artifact):
    """The loaded program serves what the live estimator serves, bit for
    bit, with the last chunk of a ragged request zero-padded."""
    est = export.ExportedEstimator.load(artifact)
    assert (est.batch_size, est.input_hw) == (2, HW)
    assert est.meta["format"] == "torch.export"
    assert est.meta["device"] == "cpu" and est.meta["compute_dtype"] is None
    live = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                     device="cpu")
    images = frames(3, *HW, seed=0)
    assert_equal_outputs(est.predict(images), live.predict(images))
    with pytest.raises(ValueError, match="expected"):
        est.predict(frames(1, 40, 64, seed=0))


def test_artifact_holds_both_kernels_as_registered_ops(params):
    """torch.export of the cascade on the CPU; both kernels are graph ops."""
    module = export._Cascade(
        ColorHandPose3D(), serving.device_params(params, torch.device("cpu")),
        serving.hand_side_tensor(True, 1, "cpu"))
    program = torch.export.export(module, (torch.zeros((1, *HW, 3)),))
    targets = {str(n.target) for n in program.graph.nodes}
    assert "hand3d.flood_fill.default" in targets
    assert "hand3d.decode_upsampled.default" in targets


def test_bf16_round_trip_equals_the_live_estimator(params, tmp_path):
    blob = export.export_estimator(params, batch_size=1, input_hw=HW,
                                   compute_dtype="bfloat16", device="cpu")
    est = export.ExportedEstimator.load(blob)
    assert est.meta["compute_dtype"] == "bfloat16"
    live = serving.HandPoseEstimator(params, batch_size=1, input_hw=HW,
                                     compute_dtype="bfloat16", device="cpu")
    images = frames(2, *HW, seed=1)
    assert_equal_outputs(est.predict(images), live.predict(images))


def test_rejects_a_bad_magic_and_a_jax_artifact(artifact):
    with pytest.raises(ValueError, match="bad magic"):
        export.ExportedEstimator.load(b"NOPE" + bytes(16))
    from hand3d_tpu.export import export_estimator as jax_export
    from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade

    jax_blob = jax_export(JaxCascade().init(jax.random.PRNGKey(0)),
                          batch_size=1, input_hw=(32, 32))
    with pytest.raises(ValueError, match="JAX artifact.*StableHLO"):
        export.ExportedEstimator.load(jax_blob)
    blob = Path(artifact).read_bytes()
    (hlen,) = struct.unpack_from("<I", blob, 4)
    head = blob[8:8 + hlen].replace(b'"version": 1', b'"version": 9')
    with pytest.raises(ValueError, match="version 9"):
        export.ExportedEstimator.load(
            blob[:4] + struct.pack("<I", len(head)) + head + blob[8 + hlen:])


def test_unported_export_options_raise(params):
    with pytest.raises(NotImplementedError, match="out of scope"):
        export.export_estimator(params, phase_pack=True, device="cpu")
    # calibration needs images, which the exporter does not take (as JAX's)
    with pytest.raises(ValueError, match="None or 'int8'"):
        export.export_estimator(params, quantize="int8_static", device="cpu")


def test_int8_round_trip_equals_the_live_estimator(params, artifact):
    """export_estimator(quantize="int8"): the int8 weights and scales baked
    in (a quarter of the f32 artifact's bytes and a little more), the
    header records it, each int8 conv is the registered op
    torch.ops.hand3d.int8_conv, and the loaded artifact answers as the live
    HandPoseEstimator(quantize="int8") does, bit for bit."""
    blob = export.export_estimator(params, batch_size=2, input_hw=HW,
                                   quantize="int8", device="cpu")
    est = export.ExportedEstimator.load(blob)
    assert est.meta["quantize"] == "int8"
    f32_bytes = Path(artifact).stat().st_size
    assert 0.25 * f32_bytes < len(blob) < 0.3 * f32_bytes
    assert b"hand3d.int8_conv" in blob
    live = serving.HandPoseEstimator(params, batch_size=2, input_hw=HW,
                                     quantize="int8", device="cpu")
    images = frames(3, *HW, seed=5)
    assert_equal_outputs(est.predict(images), live.predict(images))
    # any resolution: SnapEstimator over either carries their int8 answers
    images = frames(2, 60, 100, seed=6)
    assert_equal_outputs(serving.SnapEstimator(est).predict(images),
                         serving.SnapEstimator(live).predict(images))


def test_snap_estimator_serves_an_artifact(params, artifact):
    """SnapEstimator over a loaded artifact takes any resolution, as the
    same wrapper over the live estimator does."""
    images = frames(2, 60, 100, seed=2)
    got = serving.SnapEstimator(
        export.ExportedEstimator.load(artifact)).predict(images)
    want = serving.SnapEstimator(serving.HandPoseEstimator(
        params, batch_size=2, input_hw=HW, device="cpu")).predict(images)
    assert_equal_outputs(got, want)
    np.testing.assert_array_equal(got["snap_hw"], HW)


def test_export_cli(params, npz, tmp_path, capsys):
    out = tmp_path / "c.h3dx"
    export_model.main(["--weights", str(npz), "--out", str(out),
                       "--batch-size", "1", "--input-hw", "48x64",
                       "--right-hand", "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    est = export.ExportedEstimator.load(str(out))
    assert est.meta["left_hand"] is False and est.batch_size == 1
    live = serving.HandPoseEstimator(params, batch_size=1, input_hw=HW,
                                     left_hand=False, device="cpu")
    images = frames(1, *HW, seed=3)
    assert_equal_outputs(est.predict(images), live.predict(images))
    with pytest.raises(NotImplementedError, match="out of scope"):
        export_model.main(["--weights", str(npz), "--out", str(out),
                           "--device", "cpu", "--phase-pack"])
    export_model.main(["--weights", str(npz), "--out", str(out),
                       "--batch-size", "1", "--input-hw", "48x64",
                       "--device", "cpu", "--quantize", "int8"])
    assert "quantize=int8" in capsys.readouterr().out
    est = export.ExportedEstimator.load(str(out))
    assert est.meta["quantize"] == "int8"
    live = serving.HandPoseEstimator(params, batch_size=1, input_hw=HW,
                                     quantize="int8", device="cpu")
    assert_equal_outputs(est.predict(images), live.predict(images))


def test_loading_needs_no_model_code_and_no_jax(artifact, tmp_path):
    """A process that imports only hand3d_tpu_torch.export, with jax
    blocked, loads the artifact and serves it; the port's model modules are
    never imported."""
    code = (
        "import sys, numpy as np\n"
        "sys.modules['jax'] = None\n"
        "from hand3d_tpu_torch.export import ExportedEstimator\n"
        f"est = ExportedEstimator.load({artifact!r})\n"
        "out = est.predict(np.zeros((1, 48, 64, 3), np.uint8))\n"
        "assert out['keypoint_uv21'].shape == (1, 21, 2)\n"
        "print(sorted(m for m, v in sys.modules.items() if v is not None\n"
        "             and (m.startswith('hand3d_tpu_torch.models')\n"
        "                  or m.split('.')[0] in ('jax', 'hand3d_tpu'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
