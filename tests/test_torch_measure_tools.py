"""The port's measuring tools (hand3d_tpu_torch.tools.profile_stages,
memory_report, roofline) against the JAX package and the root JAX tools,
on the CPU.

- roofline: the layer tables and GFLOP totals equal the root tool's
  generators (tools/roofline.py); each layer's bytes and time equal its
  ``conv_cost`` but for the TPU lane-fill factor; the int8 gate and the
  refinement names differ from the root tool where the root tool is wrong;
  weight bytes shrink with --batch;
- memory_report: cascade inference's args and out bytes equal JAX's
  ``memory_analysis()`` of the same function; a train row's args are the
  train state (params and Adam's two moments and counters) and the batch;
- profile_stages: each stage equals the same-named JAX stage on the same
  numpy inputs (scoremaps and coordinates within 1e-5, masks and decoded
  keypoints exactly where the margin exceeds 1e-5; the full cascade through
  parity.check_cascade);
- the three CLIs run with --device cpu and print every row the root tools
  print; the default device (cuda) raises without a card.
"""

import contextlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import segmentation as j_seg
from hand3d_tpu.ops.keypoints import decode_upsampled as j_decode
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.models.cascade import ColorHandPose3D
from hand3d_tpu_torch.ops import segmentation
from hand3d_tpu_torch.tools import (card, memory_report, profile_stages,
                                    roofline)

from test_torch_cascade import _jax_fields, _jax_rerun

TOOLS = Path(__file__).resolve().parents[1] / "tools"
ATOL = 1e-5  # scoremaps and coordinates; float noise here is ~1e-9
FLIP_BOUND = 1e-5  # margins below this may flip a mask pixel or a keypoint
STAGE_BATCH, STAGE_HW, STAGE_CROP = 2, (64, 64), 32


def root_roofline():
    """tools/roofline.py as a module."""
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__("roofline")
    finally:
        sys.path.remove(str(TOOLS))


def run_main(main, argv):
    """(stdout, return value) of ``main(argv)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv)
    return out.getvalue(), ret


# --- roofline ----------------------------------------------------------------

# the root tool's refinement units are 1 and 2 (conv7_*, conv8_*); the
# model's, and the port's table's, are conv6_* and conv7_*
def _jax_name(name):
    for n, j in (("conv7_", "conv8_"), ("conv6_", "conv7_")):
        if name.startswith(n) and name[len(n):] in "1234567":
            return j + name[len(n):]
    return name


@pytest.mark.parametrize("hw, seg_scale", [((240, 320), 1.0),
                                           ((240, 320), 0.5)])
def test_roofline_tables_equal_the_root_tools(hw, seg_scale):
    jr = root_roofline()
    got = roofline.stage_layers(hw, seg_scale)
    sh, sw = round(hw[0] * seg_scale), round(hw[1] * seg_scale)
    want = {"HandSegNet": list(jr.handsegnet_layers(sh, sw)),
            "PoseNet": list(jr.posenet_layers()),
            "Prior+Viewpoint": list(jr.prior_layers())}
    for stage in want:
        assert [r[1:] for r in got[stage]] == [r[1:] for r in want[stage]]
    # names: HandSegNet's and PoseNet's encoder equal; refinement units
    # renamed; the lifting towers carry the model's prefixes
    assert [r[0] for r in got["HandSegNet"]] == \
        [r[0] for r in want["HandSegNet"]]
    assert [_jax_name(r[0]) for r in got["PoseNet"]] == \
        [r[0] for r in want["PoseNet"]]
    assert [r[0] for r in got["Prior+Viewpoint"]][:2] == \
        ["conv_pose_0_1", "conv_pose_0_2"]
    out = roofline.roofline(got, {"f32": 1e12}, 1e12, batch=1)
    gflop = {k: round(s["gflop"], 2) for k, s in out["stages"].items()}
    if seg_scale == 1.0:
        assert gflop == {"HandSegNet": 61.30, "PoseNet": 60.32,
                         "Prior+Viewpoint": 0.20}
        assert round(out["total_gflop"], 2) == 121.82
    want_f = sum(jr.conv_cost(*r[1:], rate=1.0)[0]
                 for rows in want.values() for r in rows)
    assert out["total_gflop"] * 1e9 == pytest.approx(want_f, rel=1e-12)


def test_roofline_costs_equal_the_root_tools_but_for_lane_fill():
    """At 2 operand bytes, batch 1 and the root tool's rates, a layer's
    bytes and time equal its conv_cost's; the layers with cin < 128 differ
    by the TPU's lane-fill factor alone, which the card has no use for."""
    jr = root_roofline()
    differ = []
    for rows in roofline.stage_layers((240, 320)).values():
        for name, h, w, k, cin, cout in rows:
            f, nbytes, t, hbm_bound = roofline.conv_cost(
                h, w, k, cin, cout, jr.R_WIDE, jr.BW_HBM, batch=1,
                dtype_bytes=2)
            jf, jt, jbw = jr.conv_cost(h, w, k, cin, cout, jr.R_WIDE)
            _, jt_hbm, _ = jr.conv_cost(h, w, k, cin, cout, float("inf"))
            assert f == jf
            assert nbytes == pytest.approx(jt_hbm * jr.BW_HBM, rel=1e-12)
            if cin >= 128:
                assert (t, hbm_bound) == (pytest.approx(jt, rel=1e-12), jbw)
            else:
                lane_fill = cin / 128.0
                assert t == pytest.approx(
                    max(f / jr.R_WIDE, jt_hbm), rel=1e-12)
                assert jt == pytest.approx(
                    max(f / (jr.R_WIDE * lane_fill), jt_hbm), rel=1e-12)
                differ.append(name)
    assert "conv1_2" in differ and "conv3_2" not in differ


def test_roofline_int8_gate_is_ops_quants():
    """The int8 rate goes to the layers ops.quant quantizes; the root tool
    also gives it the four float heads (cin >= 128, cout < 32)."""
    layers = roofline.stage_layers((240, 320))
    out = roofline.roofline(layers, {"f32": 1e12, "int8": 2e12}, 1e15,
                            batch=1, int8=True)
    port = {(s, r["name"]) for s, st in out["stages"].items()
            for r in st["layers"] if r["path"] == "int8"}
    root = {(s, name) for s, rows in layers.items()
            for name, h, w, k, cin, cout in rows if cin >= 128}
    assert root - port == {("PoseNet", "conv5_2"), ("PoseNet", "conv6_7"),
                           ("PoseNet", "conv7_7"), ("HandSegNet", "conv6_2")}
    assert port <= root
    scoped = roofline.roofline(layers, {"f32": 1e12, "int8": 2e12}, 1e15,
                               batch=1, int8=True, int8_scope="handsegnet")
    assert {r["path"] for r in scoped["stages"]["PoseNet"]["layers"]} == \
        {"f32"}


def test_roofline_weight_bytes_shrink_with_batch():
    layers = roofline.stage_layers((240, 320))
    one, many = (roofline.roofline(layers, {"f32": 1e18}, 1e12, batch=b)
                 for b in (1, 128))
    for stage in layers:
        for a, b in zip(one["stages"][stage]["layers"],
                        many["stages"][stage]["layers"]):
            weight = 4 * a["k"] ** 2 * a["cin"] * a["cout"]
            assert a["bytes"] - b["bytes"] == pytest.approx(
                weight * (1 - 1 / 128), rel=1e-12)
    assert many["ms_per_frame"] < one["ms_per_frame"]


def test_roofline_measures_rates_on_the_cpu():
    rates = roofline.measure_rates("cpu", shapes=((3, 8, 6, 8),), batch=2,
                                   iters=1)
    assert set(rates) == set(roofline.PATHS)
    assert all(r["rate"] > 0 and r["shape"] == "3x3x8@6x8"
               and r["kernels"] == {} for r in rates.values())
    assert roofline.measure_hbm("cpu", nbytes=1 << 16, iters=1) > 0


def test_roofline_cli_prints_the_root_tools_rows(monkeypatch):
    jr = root_roofline()
    monkeypatch.setattr(sys, "argv", ["roofline", "--batch", "32"])
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        jr.main()
    text, out = run_main(roofline.main, [
        "--batch", "32", "--rate", "190", "--hbm", "819", "--per-layer",
        "--glue-ms", "0.5"])
    labels = [line.split()[0] for line in want.getvalue().splitlines()[1:]]
    got = [line.split()[0] for line in text.splitlines()]
    assert labels == ["stage", "HandSegNet", "PoseNet", "Prior+Viewpoint",
                      "glue", "TOTAL", "upper-bound"]
    for label in labels:
        assert label in got
    assert "conv7_7" in got and "conv8_7" not in got
    assert out["glue_ms"] == 0.5
    assert out["ms_per_frame"] == pytest.approx(
        sum(s["ms"] for s in out["stages"].values()) + 0.5)
    assert out["rates_source"] == "given (--rate/--hbm)"


# --- memory_report -----------------------------------------------------------

MEMORY_ARGV = ["--device", "cpu", "--batches", "1", "--hw", "64", "64",
               "--skip-train"]
TRAIN_ROWS = dict(batch=2, accums=[1, 2], crop=32)  # the CLI's: 8, 1 2 4, 256


@pytest.fixture(scope="module")
def memory_rows():
    """(printed text, rows): the CLI's inference row and ``train_reports``'
    rows at TRAIN_ROWS."""
    text, rows = run_main(memory_report.main, MEMORY_ARGV)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows += memory_report.train_reports(
            TRAIN_ROWS["batch"], TRAIN_ROWS["accums"], "cpu", card.card("cpu"),
            crop=TRAIN_ROWS["crop"])
    return text + out.getvalue(), rows


def test_memory_report_cli_prints_the_root_tools_rows(memory_rows,
                                                      monkeypatch):
    text, rows = memory_rows
    lines = text.splitlines()
    assert lines[0] == "backend: cpu (cpu)"
    tags = ["cascade inference batch 1 64x64",
            "posenet train step batch 2 accum=1",
            "posenet train step batch 2 accum=2",
            "posenet train step batch 2 accum=2 remat"]
    assert [r["config"] for r in rows] == tags
    for tag in tags:
        line = next(l for l in lines if l.startswith(tag + " "))
        for col in ("args", "out", "temp", "code"):
            assert f" {col} " in line
        assert "n/a" in line and "—" in line
    assert all(r["temp"] is None and "split" not in r for r in rows)
    # without --skip-train the CLI adds the train rows at the JAX tool's
    # defaults: batch 8, accum 1 2 4, 256x256 crops
    calls = []
    for name in ("inference_reports", "train_reports"):
        monkeypatch.setattr(memory_report, name, lambda *a, name=name, **k:
                            calls.append((name, a[:3], k)) or [])
    run_main(memory_report.main, MEMORY_ARGV[:-1])
    cpu = torch.device("cpu")
    assert calls == [("inference_reports", ([1], (64, 64), cpu), {}),
                     ("train_reports", (8, [1, 2, 4], cpu), {})]
    assert memory_report.CROP_SIZE == 256


def test_memory_report_peak_split_reads_the_allocator(monkeypatch):
    """PeakSplit's arithmetic on a scripted allocator: per op the bytes at
    its start, its peak and the bytes at its return."""
    reads = iter([100,                # when the mode is made
                  100, 150, 120,      # aten.add: a 20-byte output
                  120, 900, 130,      # aten.mm: 770 bytes of scratch
                  130, 140, 50])      # aten.sum: frees 80
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: next(reads))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: next(reads))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda d: None)
    x, y = torch.ones(2, 3), torch.ones(3, 2)
    with memory_report.PeakSplit("cuda") as split:
        (x + 1).mm(y).sum()
    assert split.result() == {"peak": 800, "op": "aten.mm.default",
                              "shapes": [[2, 3], [3, 2]], "tensors": 30,
                              "scratch": 770, "tensor_peak": 30}


def test_memory_report_inference_matches_jax_memory_analysis(memory_rows):
    params = weights.random_params(0)
    net = JaxCascade()
    spec = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), params)
    compiled = jax.jit(
        lambda p, im, h: net.inference(p, im, h).keypoint_coord3d).lower(
        spec, jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 2), jnp.float32)).compile()
    m = compiled.memory_analysis()
    row = memory_rows[1][0]
    assert row["args"] == m.argument_size_in_bytes
    assert row["out"] == m.output_size_in_bytes


def test_memory_report_train_args_are_the_state_and_the_batch(memory_rows):
    tree = posenet.init(np.random.default_rng(0))
    param_bytes = sum(a["weights"].nbytes + a["biases"].nbytes
                      for a in tree.values())
    counters = 4 * 2 * len(tree)  # a float32 step a leaf
    b, c = TRAIN_ROWS["batch"], TRAIN_ROWS["crop"]
    batch = 4 * b * (c * c * 3 + c * c * 21 + 21)
    for row in memory_rows[1][1:]:
        assert row["args"] == 3 * param_bytes + counters + batch
        assert row["out"] == 3 * param_bytes + counters + 4  # + the loss


# --- profile_stages ----------------------------------------------------------


@pytest.fixture(scope="module")
def stage_runs():
    """The port's stages at batch 2, 64x64 and a 32x32 crop on the CPU, and
    their numpy inputs."""
    params_np = weights.random_params(0)
    params = weights.params_from_jax(params_np, "cpu")
    stages = profile_stages.build_stages(
        ColorHandPose3D(), params, STAGE_BATCH, STAGE_HW, 1.0, "cpu",
        torch.Generator().manual_seed(1), crop=STAGE_CROP)
    return params_np, params, stages


def _jax_stage(name, params):
    net = JaxCascade()
    return {
        "handsegnet": lambda im: net.inference_detection(params, im)[-1],
        "single_obj_scoremap": j_seg.single_obj_scoremap,
        "calc_center_bb": lambda sm: j_seg.calc_center_bb(
            j_seg.single_obj_scoremap(sm)),
        "crop_from_scoremap": net._crop_from_scoremap,
        "posenet": lambda cr: net.inference_pose2d(params, cr)[-1],
        "poseprior+viewpoint": lambda sm, hs: net.inference_pose3d(
            params, sm, hs),
        "decode_upsampled": lambda sm: j_decode(sm, 8),
    }[name]


def _held_mask(seg, got, want):
    """Whether the single-blob masks are equal; if not, the binary maps
    must differ only at pixels whose logit margin is below FLIP_BOUND, and
    the seeds only between foreground values within FLIP_BOUND of the
    maximum."""
    if np.array_equal(got, want):
        return True
    fg, det, seed = (t.numpy() for t in segmentation.foreground(
        torch.from_numpy(seg)))
    j_fg = np.asarray(jax.nn.softmax(seg, -1)[..., 1:].max(-1))
    j_seed = np.asarray(j_seg.find_max_location(j_fg))
    flipped = det != np.round(j_fg)
    margin = np.abs(seg[..., 1] - seg[..., 0])
    assert (margin[flipped] < FLIP_BOUND).all()
    moved = (seed != j_seed).any(1)
    for i in np.flatnonzero(moved):
        r, c = seed[i]
        assert j_fg[i].max() - j_fg[i, r, c] < FLIP_BOUND
    assert flipped.any() or moved.any()
    return False


def test_profile_stages_build_the_jax_tools_stages(stage_runs):
    _, _, stages = stage_runs
    assert tuple(stages) == profile_stages.STAGES
    image = stages["handsegnet"][1][0]
    assert image.shape == (STAGE_BATCH, *STAGE_HW, 3)
    assert -0.5 <= image.min() and image.max() < 0.5
    assert stages["posenet"][1][0].shape == (STAGE_BATCH, STAGE_CROP,
                                             STAGE_CROP, 3)
    sm = stages["decode_upsampled"][1][0]
    assert sm.shape == (STAGE_BATCH, 32, 32, 21) and 0 <= sm.min()
    seg = stages["single_obj_scoremap"][1][0]
    with torch.inference_mode():
        np.testing.assert_array_equal(
            seg, ColorHandPose3D().segment(stage_runs[1], image))


@pytest.mark.parametrize("name", [s for s in profile_stages.STAGES
                                  if s != "FULL cascade"])
def test_profile_stage_matches_the_jax_stage(stage_runs, name):
    params_np, _, stages = stage_runs
    fn, args = stages[name]
    with torch.inference_mode():
        got = fn(*args)
    got = [t.numpy() for t in (got if isinstance(got, tuple) else (got,))]
    np_args = [a.numpy() for a in args]
    want = jax.jit(lambda p, *a: _jax_stage(name, p)(*a))(params_np, *np_args)
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    assert [g.shape for g in got] == [w.shape for w in want]
    if name in ("single_obj_scoremap", "calc_center_bb"):
        mask = segmentation.single_obj_scoremap(args[0]).numpy()
        j_mask = np.asarray(jax.jit(j_seg.single_obj_scoremap)(np_args[0]))
        if _held_mask(np_args[0], mask, j_mask):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    elif name == "decode_upsampled":
        clear = parity.top2_gap(np_args[0]) > FLIP_BOUND
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(got[0][clear], want[0][clear])
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_profile_full_cascade_matches_jax(stage_runs):
    params_np, params, stages = stage_runs
    fn, (image, hand_side) = stages["FULL cascade"]
    with torch.inference_mode():
        out = fn(image, hand_side)
    got = parity.port_fields(params, image, hand_side)
    for k in ("hand_scoremap", "center", "scale_crop", "keypoint_coord3d",
              "keypoint_uv21"):
        np.testing.assert_array_equal(getattr(out, k).numpy(), got[k],
                                      err_msg=k)
    assert out.keypoints_scoremap is None
    net = JaxCascade()
    image_np, side_np = jnp.asarray(image.numpy()), jnp.asarray(
        hand_side.numpy())
    ref = _jax_fields(net, params_np, image_np, side_np)
    parity.check_cascade(ref, got, _jax_rerun(net, params_np, image_np,
                                              side_np),
                         scoremap_atol=ATOL / 2, coord3d_atol=ATOL,
                         flip_bound=FLIP_BOUND)


def test_profile_stages_cli_prints_the_root_tools_rows():
    text, rows = run_main(profile_stages.main, [
        "--device", "cpu", "--batch", "1", "--hw", "32", "32", "--iters", "1",
        "--dtype", "f32"])
    lines = text.splitlines()
    assert lines[0].startswith("# per-stage device time, batch=1 hw=32x32 "
                               "dtype=f32 seg_scale=1.0 quantize=None")
    for stage in profile_stages.STAGES:
        assert any(l.startswith(f"{stage:22s} ") and "ms/batch" in l
                   for l in lines), stage
    assert "img/s" in next(l for l in lines if l.startswith("FULL cascade"))
    assert [r["stage"] for r in rows] == list(profile_stages.STAGES)
    for r in rows:
        assert r["ms"] > 0 and r["card"] == "cpu"
        assert r["launches"] == {"flood_fill": 0, "decode_upsampled": 0}
        assert {"batch", "dtype", "quantize", "power_limit"} <= set(r)


@pytest.mark.parametrize("tool", ["profile_stages", "memory_report",
                                  "roofline"])
def test_default_device_is_the_card(tool):
    """With no card (as here) the default --device cuda raises."""
    main = {"profile_stages": profile_stages.main,
            "memory_report": memory_report.main,
            "roofline": roofline.main}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(main, [])
