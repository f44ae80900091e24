"""The port's dataset and host tools (hand3d_tpu_torch/tools) against the
root JAX tools (tools/*.py), on the CPU: the dataset writers byte for byte,
the PNG reader against matplotlib, inspect_db's figure, bench_input,
average_params against JAX's on .npz files and snapshots of both packages,
run_baseline_parity's report path and all-rows drill on synthetic files,
and release_check's record with its steps stubbed.

Counterparts of tests/test_tools.py. The root tools are imported from
tools/ and run in this process, as that file runs them.
"""

import json
import pickle
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import PosePriorNetwork as JaxPosePrior
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.synthetic import make_rhd_bin
from hand3d_tpu_torch.tools import (average_params, bench_input,
                                    create_binary_db, create_stb_db,
                                    inspect_db, release_check,
                                    run_baseline_parity)
from hand3d_tpu_torch.train import checkpoints, trainer

from fixtures import make_stb_bin
from torch_tmp import tmp_path  # noqa: F401

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def root_tool(name):
    """A root JAX tool (tools/<name>.py) as a module."""
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


def run_root_tool(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def rhd_tree(root, rng, n=2):
    """An RHD_published_v2-shaped tree: RGB images, grey part masks, a
    pickle of per-sample annotations; returns the truth."""
    for sub in ("color", "mask"):
        (root / "evaluation" / sub).mkdir(parents=True)
    anno, truth = {}, {}
    for sid in range(n):
        xyz = rng.standard_normal((42, 3)).astype(np.float32)
        uv = (rng.random((42, 2)) * 320).astype(np.float32)
        vis = rng.integers(0, 2, 42).astype(np.float32)
        k = (np.eye(3) * 300 + rng.random((3, 3))).astype(np.float32)
        anno[sid] = {"xyz": xyz, "uv_vis": np.concatenate([uv, vis[:, None]],
                                                          1), "K": k}
        img = rng.integers(0, 256, (320, 320, 3), dtype=np.uint8)
        mask = rng.integers(0, 34, (320, 320), dtype=np.uint8)
        Image.fromarray(img).save(root / "evaluation" / "color"
                                  / ("%.5d.png" % sid))
        Image.fromarray(mask).save(root / "evaluation" / "mask"
                                   / ("%.5d.png" % sid))
        truth[sid] = (xyz, uv, vis, k, img, mask)
    with open(root / "evaluation" / "anno_evaluation.pickle", "wb") as f:
        pickle.dump(anno, f)
    return truth


def test_create_binary_db_equals_the_jax_tool(tmp_path, monkeypatch):
    root = tmp_path / "RHD_published_v2"
    truth = rhd_tree(root, np.random.default_rng(0))
    want, got = tmp_path / "jax.bin", tmp_path / "port.bin"
    run_root_tool(root_tool("create_binary_db"),
                  ["--rhd-path", str(root), "--out", str(want)], monkeypatch)
    create_binary_db.main(["--rhd-path", str(root), "--set", "evaluation",
                           "--out", str(got)])
    assert got.read_bytes() == want.read_bytes()
    raw = RHDDataset("evaluation", path=str(got)).raw_batch(np.arange(2))
    for sid, (xyz, uv, vis, k, img, mask) in truth.items():
        np.testing.assert_array_equal(raw["kp_xyz"][sid], xyz)
        np.testing.assert_array_equal(raw["kp_uv"][sid], uv)
        np.testing.assert_array_equal(raw["cam_mat"][sid], k)
        np.testing.assert_array_equal(raw["image"][sid], img)
        np.testing.assert_array_equal(raw["hand_parts"][sid], mask)
        np.testing.assert_array_equal(raw["kp_vis"][sid], vis.astype(np.uint8))


def test_create_stb_db_equals_the_jax_tool(tmp_path, monkeypatch):
    from scipy import io as scipy_io

    jax_tool = root_tool("create_stb_db")
    rng = np.random.default_rng(1)
    root = tmp_path / "StereoHandTracking"
    (root / "labels").mkdir(parents=True)
    (root / "B1Counting").mkdir()
    frames = 2
    for tool in (jax_tool, create_stb_db):
        monkeypatch.setattr(tool, "SEQUENCES", ["B1Counting"])
        monkeypatch.setattr(tool, "FRAMES_PER_SEQ", frames)
    hand_para = rng.random((3, 21, frames)) * 100
    hand_para[2] += 500
    scipy_io.savemat(str(root / "labels" / "B1Counting_BB.mat"),
                     {"handPara": hand_para})
    for i in range(frames):
        for side in ("left", "right"):
            # the right frames with an alpha channel, which the tools drop
            img = rng.integers(0, 256, (480, 640, 3 if side == "left" else 4),
                               dtype=np.uint8)
            Image.fromarray(img).save(root / "B1Counting"
                                      / f"BB_{side}_{i}.png")
    want, got = tmp_path / "jax.bin", tmp_path / "port.bin"
    run_root_tool(jax_tool, ["--stb-path", str(root), "--out", str(want)],
                  monkeypatch)
    create_stb_db.main(["--stb-path", str(root), "--out", str(got)])
    assert len(got.read_bytes()) == 2 * frames * 922104
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA", "P", "1"])
def test_png_reader_equals_matplotlib(mode, tmp_path):
    """load_png gives what the JAX tools' matplotlib.image.imread and
    round(x * 255) give, for every 8-bit PNG mode."""
    import matplotlib.image as mpimg

    rng = np.random.default_rng(2)
    shape = {"L": (7, 9), "RGB": (7, 9, 3), "RGBA": (7, 9, 4),
             "LA": (7, 9, 2), "P": (7, 9), "1": (7, 9)}[mode]
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    if mode == "P":
        im = Image.fromarray(arr % 5, "P")
        im.putpalette(rng.integers(0, 256, 15).tolist())
    elif mode == "1":
        im = Image.fromarray((arr > 127).astype(np.uint8) * 255).convert("1")
    else:
        im = Image.fromarray(arr, mode)
    path = str(tmp_path / f"{mode}.png")
    im.save(path)
    want = mpimg.imread(path)
    if want.dtype != np.uint8:
        want = (want * 255).round().astype(np.uint8)
    got = create_binary_db.load_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if mode == "L":  # a 16-bit PNG is refused, not rescaled
        wide = str(tmp_path / "wide.png")
        Image.fromarray(arr.astype(np.uint16) * 257).save(wide)
        with pytest.raises(ValueError, match="8 bits a channel"):
            create_binary_db.load_png(wide)


@pytest.mark.parametrize("dataset", ["rhd", "stb"])
def test_inspect_db_writes_figure(dataset, tmp_path, capsys):
    path = str(tmp_path / f"{dataset}.bin")
    if dataset == "rhd":
        make_rhd_bin(path, num_records=2)
    else:
        make_stb_bin(path, num_records=2)
    out = tmp_path / "inspect.png"
    inspect_db.main(["--dataset", dataset, "--data", path, "--num", "2",
                     "--out", str(out)])
    assert "must coincide" in capsys.readouterr().out
    with Image.open(out) as im:
        h, w = {"rhd": (320, 320), "stb": (480, 640)}[dataset]
        assert im.size == (2 * w, h)
        # the stored uv are drawn in green
        px = np.asarray(im.convert("RGB")).reshape(-1, 3)
        assert (px == inspect_db.GREEN).all(1).any()


def test_bench_input_smoke(capsys):
    bench_input.main(["--records", "16", "--batch", "4"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["memmap_rec_s"] > 0 and out["memmap_headroom_x"] > 0
    assert out["native_rec_s"] > 0 or "native_error" in out
    assert out["step_ms"] == bench_input.POSENET_RESIDENT_STEP_MS


def test_average_params_equals_jax_on_npz_and_snapshots(tmp_path):
    """.npz files, the port's .pt snapshots and the JAX package's .msgpack
    snapshots: the port's average equals JAX's tool's on the same inputs."""
    import optax

    from hand3d_tpu.train.checkpoints import save_snapshot as j_save
    from hand3d_tpu.train.trainer import init_state as j_init_state
    from hand3d_tpu.weights import load_npz as j_load_npz
    from hand3d_tpu.weights import save_npz as j_save_npz

    jax_tool = root_tool("average_params")
    rng = np.random.default_rng(3)
    trees = [{"net": {"w": rng.normal(size=(3, 2)).astype(np.float32),
                      "b": rng.normal(size=(2,)).astype(np.float32)}}
             for _ in range(3)]
    npz = [str(tmp_path / f"{i}.npz") for i in range(3)]
    for path, tree in zip(npz, trees):
        j_save_npz(path, tree)
    jax_tool.main(npz + ["--out", str(tmp_path / "jax.npz")])
    average_params.main(npz + ["--out", str(tmp_path / "port.npz")])
    want = j_load_npz(str(tmp_path / "jax.npz"))
    got = weights.load_npz(str(tmp_path / "port.npz"))
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["net"][k], want["net"][k])

    # the last 2 of 3 snapshots; the .msgpack ones by step, 10 after 9
    j_dir, t_dir = tmp_path / "jax_snaps", tmp_path / "port_snaps"
    opt = optax.sgd(0.1)
    for step, tree in zip((8, 9, 10), trees):
        j_save(str(j_dir), j_init_state(jax.tree_util.tree_map(
            jnp.asarray, tree), opt), step=step, keep=10)
        checkpoints.save_snapshot(str(t_dir), trainer.init_state(
            {"net": {"w": torch.from_numpy(tree["net"]["w"]),
                     "b": torch.from_numpy(tree["net"]["b"])}},
            trainer.make_optimizer([0.1], [])), step=step, keep=10)
    want = average_params.average_trees(trees[1:])
    for d in (j_dir, t_dir):
        out = str(tmp_path / f"{d.name}.npz")
        average_params.main(["--snapshots", str(d), "--last", "2",
                             "--out", out])
        got = weights.load_npz(out)
        for k in ("w", "b"):
            np.testing.assert_array_equal(got["net"][k], want["net"][k])


def write_pickles(weights_dir, variants):
    """Reference-format pickles ({name: ndarray}) of JAX-initialized trees."""
    from hand3d_tpu.weights.convert import tree_to_flat

    full = JaxCascade().init(jax.random.PRNGKey(0))
    flats = {
        "handsegnet-rhd.pickle": {"HandSegNet": full["HandSegNet"]},
        "posenet-rhd-stb.pickle": {"PoseNet2D": full["PoseNet2D"]},
        "posenet3d-rhd-stb.pickle": full,
        **{f"lifting-{v}.pickle": JaxPosePrior(v).init(
            jax.random.PRNGKey(1 + i)) for i, v in enumerate(variants)},
    }
    weights_dir.mkdir()
    for name, tree in flats.items():
        with open(weights_dir / name, "wb") as f:
            pickle.dump({k: np.asarray(v)
                         for k, v in tree_to_flat(tree).items()}, f)


def test_run_baseline_parity_report_path(tmp_path, capsys):
    """Discovery, skip reasons, verdicts, the JSON line and the markdown
    record; random weights, so the rows that run FAIL and the exit status
    is 1."""
    data = tmp_path / "data"
    data.mkdir()
    make_rhd_bin(str(data / "rhd_evaluation.bin"), num_records=1)
    write_pickles(tmp_path / "weights", ["direct"])
    doc = tmp_path / "baseline.md"
    rc = run_baseline_parity.main([
        "--data-dir", str(data), "--weights-dir", str(tmp_path / "weights"),
        "--rows", "1", "2", "7", "8", "12", "--batch-size", "1",
        "--device", "cpu", "--write-doc", str(doc)])
    s = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1 and s["gate"] == "baseline_parity" and not s["ok"]
    assert s["rows_run"] == [1, 7]
    for row in ("1", "7"):
        r = s["results"][row]
        assert set(r["measured"]) == set(run_baseline_parity.ROWS[int(row)][
            "expect"])
        assert r["ok"] is False
    skipped = {int(k): v for k, v in s["rows_skipped"].items()}
    assert "snap_pose" in skipped[2] and "bottleneck" in skipped[8]
    assert "stb" in skipped[12]
    text = doc.read_text()
    assert "| 1 |" in text and "SKIPPED" in text and "FAIL" in text


def test_run_baseline_parity_all_rows_drill(tmp_path):
    """All 13 BASELINE rows run and are judged (none skipped) on synthetic
    files, reference-shaped pickles and retrained snapshots of both
    packages (snap_pose the port's .pt, snap_seg JAX's .msgpack); the
    tolerance rule fires both ways."""
    import optax

    from hand3d_tpu.train.checkpoints import save_snapshot as j_save
    from hand3d_tpu.train.trainer import init_state as j_init_state

    data = tmp_path / "data"
    data.mkdir()
    make_rhd_bin(str(data / "rhd_evaluation.bin"), num_records=1)
    make_stb_bin(str(data / "stb_evaluation.bin"), num_records=1)
    write_pickles(tmp_path / "weights",
                  run_baseline_parity.VARIANT_BY_ROW.values())
    retrained = tmp_path / "retrained"
    params = weights.random_params(7)
    checkpoints.save_snapshot(str(retrained / "snap_pose"), trainer.init_state(
        weights.params_from_jax({"PoseNet2D": params["PoseNet2D"]}, "cpu"),
        trainer.make_optimizer([1e-4], [])), step=1)
    j_save(str(retrained / "snap_seg"), j_init_state(
        {"HandSegNet": jax.tree_util.tree_map(
            jnp.asarray, params["HandSegNet"])}, optax.sgd(0.1)), step=1)

    results = run_baseline_parity.run_rows(
        str(data), str(tmp_path / "weights"), retrained_dir=str(retrained),
        batch_size=1, progress=False, device="cpu")
    assert sorted(results) == list(range(1, 14))
    for row, r in results.items():
        assert not r.get("skipped"), (row, r)
        assert set(r["measured"]) == set(run_baseline_parity.ROWS[row][
            "expect"]), row
        assert r["ok"] in (True, False), row
        assert all(np.isfinite(v) for v in r["measured"].values()), (row, r)
    for k, v in results[1]["measured"].items():
        assert run_baseline_parity.tol_ok(k, v, v, 0.02)
        assert not run_baseline_parity.tol_ok(
            k, v, v + (1.0 if "auc" in k else max(1.0, abs(v))), 0.02)


def test_release_check_records_its_steps(tmp_path, monkeypatch, capsys):
    """Each step's rc, seconds and last JSON line land in one stamped
    record; a failed or timed-out step makes the record and the exit status
    say so."""
    py = sys.executable
    table = {
        "chip_smoke": ([py, "-c", "print('x'); print('{\"ok\": true}')"], 60),
        "overfit": ([py, "-c", "import sys; print('{\"gate\": 1}'); "
                               "sys.exit(3)"], 60),
        "preset": ([py, "-c", "import time; time.sleep(30)"], 1),
        "generalization": ([py, "-c", "print('{\"gate\": 2}')"], 60),
    }
    monkeypatch.setattr(release_check, "steps", lambda args, work: table)

    def run(*flags):
        rc = release_check.main(["--round", "7", "--out-dir", str(tmp_path),
                                 *flags])
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        record = json.loads((tmp_path / "RESULTS_torch_r07.json").read_text())
        return rc, summary, record

    rc, summary, record = run()
    assert rc == 1 and not summary["ok"] and not record["ok"]
    assert not record["partial"] and "commit" in record and record["card"]
    steps = record["steps"]
    assert steps["chip_smoke"]["ok"] and steps["chip_smoke"]["summary"] == {
        "ok": True}
    assert steps["overfit"]["returncode"] == 3
    assert steps["overfit"]["summary"] == {"gate": 1}
    assert steps["preset"]["returncode"] is None
    assert "timeout" in steps["preset"]["error"]
    assert steps["generalization"]["ok"]
    assert all(s["seconds"] >= 0 for s in steps.values())

    rc, summary, record = run("--steps", "chip_smoke", "generalization")
    assert rc == 0 and summary["ran_here"] == {"chip_smoke": True,
                                               "generalization": True}
    assert record["partial"] and not record["ok"]
    assert record["steps"]["overfit"]["skipped"]
