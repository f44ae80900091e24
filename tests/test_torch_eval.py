"""The port's metrics and eval harnesses against hand3d_tpu's, on the CPU.

Both harnesses run end to end on the same fixture files (3 records, batch
2, so the last batch is padded) with the same weights: JAX-initialized
params as numpy trees, which the port moves to its device with
``params_from_jax``. The per-sample outputs (``dists``) are recorded from
each harness's EvalUtil and compared:

- lifting harnesses (continuous in their inputs): within 1e-6 m;
- argmax-decoded harnesses: wherever the keypoint's 32x32 top-2 gap in
  JAX's PoseNet scoremap exceeds 1e-5, where a flip of the argmax is not
  float noise: within 1e-4, plus, where the peak is in the clamped last row
  or column, the width of the plateau the upsampling makes there
  (``parity.peak_slack``) in the dists' pixels;
- cascade harnesses: each batch is first held to JAX by
  ``parity.check_cascade``; an image whose mask differs is held to JAX's
  stages rerun from the port's box there, and its dists are not compared.
"""

import dataclasses
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.data import preprocess as j_preprocess
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.data.stb import STBDataset as JaxSTB
from hand3d_tpu.eval import harnesses as j_harnesses
from hand3d_tpu.eval import metrics as j_metrics
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import VARIANTS, PosePriorNetwork
from hand3d_tpu.ops.image import resize_bilinear as j_resize
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.data.preprocess import preprocess_rhd, preprocess_stb
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses, metrics
from hand3d_tpu_torch.ops.image import resize_bilinear

from fixtures import make_rhd_bin, make_stb_bin
from torch_tmp import module_dir
from test_torch_cascade import _jax_fields, _jax_rerun

BATCH = 2
LIFT_ATOL = 1e-6  # m
DIST_ATOL = 1e-4  # px (2D) or m (3D)
FLIP_BOUND = 1e-5
SCOREMAP_ATOL = 1e-6
COORD3D_ATOL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    with module_dir(tmp_path_factory, "eval") as d:
        yield {"rhd": str(make_rhd_bin(d / "rhd.bin", num_records=3)),
               "stb": str(make_stb_bin(d / "stb.bin", num_records=3))}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def record_dists(monkeypatch, module):
    """Make ``module``'s harnesses record every batch fed to EvalUtil."""
    rows = []

    class Recording(module.EvalUtil):
        def feed_batch(self, dists, vis):
            rows.append(np.asarray(dists))
            super().feed_batch(dists, vis)

    monkeypatch.setattr(module, "EvalUtil", Recording)
    return rows


def run_both(monkeypatch, port_call, jax_call):
    """(port metrics, port dists, JAX metrics, JAX dists), dists [N, 21]."""
    got_rows = record_dists(monkeypatch, harnesses)
    want_rows = record_dists(monkeypatch, j_harnesses)
    got, want = port_call(), jax_call()
    return got, np.concatenate(got_rows), want, np.concatenate(want_rows)


def assert_same_metric_keys(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v).all(), k


# --- metrics -----------------------------------------------------------------


def test_metrics_equal_jax_exactly():
    rng = np.random.default_rng(0)
    dists = rng.random((10, 21)) * 40
    vis = rng.random((10, 21)) > 0.3
    vis[:, 3] = False  # a keypoint never visible is left out of the means
    gt, pred = rng.random((21, 2)), rng.random((21, 2))
    got, want = metrics.EvalUtil(), j_metrics.EvalUtil()
    for u in (got, want):
        u.feed_batch(dists[:6], vis[:6])
        u.feed_batch(dists[6:], vis[6:])
        u.feed(gt, np.ones(21), pred)
    for g, w in zip(got.get_measures(0.0, 30.0, 20),
                    want.get_measures(0.0, 30.0, 20)):
        np.testing.assert_array_equal(g, w)
    x, y = np.linspace(0, 1, 7), rng.random(7)
    assert metrics.calc_auc(x, y) == j_metrics.calc_auc(x, y)
    for g, w in zip(metrics.get_stb_ref_curves(),
                    j_metrics.get_stb_ref_curves()):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2] == w[2]


# --- lifting harnesses -------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval3d_lifting_matches(files, monkeypatch, variant):
    params = PosePriorNetwork(variant).init(jax.random.PRNGKey(1))
    got, g, want, w = run_both(
        monkeypatch,
        lambda: harnesses.eval3d_lifting(
            variant, np_tree(params), RHDDataset("evaluation", files["rhd"]),
            BATCH, device="cpu"),
        lambda: j_harnesses.eval3d_lifting(
            variant, params, JaxRHD("evaluation", files["rhd"]), BATCH))
    assert g.shape == w.shape == (3, 21)
    np.testing.assert_allclose(g, w, rtol=0, atol=LIFT_ATOL)
    assert_same_metric_keys(got, want)
    assert got["epe_mean_mm"] == pytest.approx(want["epe_mean_mm"],
                                               abs=1e3 * LIFT_ATOL)


def test_eval3d_from_posenet_matches(files, monkeypatch):
    params = PosePriorNetwork("proposed").init(jax.random.PRNGKey(2))
    params[j_posenet.SCOPE] = j_posenet.init(jax.random.PRNGKey(3))
    got, g, want, w = run_both(
        monkeypatch,
        lambda: harnesses.eval3d_from_posenet(
            "proposed", np_tree(params),
            RHDDataset("evaluation", files["rhd"]), BATCH, device="cpu"),
        lambda: j_harnesses.eval3d_from_posenet(
            "proposed", params, JaxRHD("evaluation", files["rhd"]), BATCH))
    np.testing.assert_allclose(g, w, rtol=0, atol=LIFT_ATOL)
    assert_same_metric_keys(got, want)


# --- argmax-decoded harnesses ------------------------------------------------


def _jax_data(cfg, raw, stb=False):
    pre = j_preprocess.preprocess_stb if stb else j_preprocess.preprocess_rhd
    return pre(JaxConfig(**dataclasses.asdict(cfg)),
               {k: jnp.asarray(v) for k, v in raw.items()})


def test_eval2d_gt_cropped_matches_flip_aware(files, monkeypatch):
    params = j_posenet.init(jax.random.PRNGKey(4))
    got, g, want, w = run_both(
        monkeypatch,
        lambda: harnesses.eval2d_gt_cropped(
            np_tree(params), RHDDataset("evaluation", files["rhd"]), BATCH,
            device="cpu"),
        lambda: j_harnesses.eval2d_gt_cropped(
            params, JaxRHD("evaluation", files["rhd"]), BATCH))
    raw = RHDDataset("evaluation", files["rhd"]).raw_batch([0, 1, 2])
    data = _jax_data(harnesses.GT_CROP_CONFIG, raw)
    sm = np.asarray(jax.jit(j_posenet.apply)(params, data["image_crop"])[-1])
    clear, slack = parity.peak_slack(sm, FLIP_BOUND)
    assert clear.sum() >= 21, clear.sum()
    # dists are in source pixels: crop pixels / crop_scale
    tol = DIST_ATOL + (np.linalg.norm(slack, axis=-1)
                       / np.asarray(data["crop_scale"])[:, None])
    assert (np.abs(g - w) <= tol)[clear].all(), np.abs(g - w)[clear].max()
    assert_same_metric_keys(got, want)


def _check_cascade_batches(params, dataset, cfg, pre, got_dists, want_dists,
                           hand_side_of, argmax_dists):
    """Hold each harness batch of the port to JAX flip-aware, and the dists
    of every image with JAX's mask: at its clear keypoints, within
    DIST_ATOL plus an edge plateau in dataset pixels, if the dists come
    from the argmax decode, else at every keypoint within DIST_ATOL.
    Returns how many dists were held."""
    net = JaxCascade()
    t_params = weights.params_from_jax(np_tree(params), "cpu")
    held = 0
    for bi, (idx, valid) in enumerate(harnesses.eval_batches(len(dataset),
                                                             BATCH)):
        raw = dataset.raw_batch(idx)
        j_data = _jax_data(cfg, raw, stb=pre is preprocess_stb)
        j_image = j_resize(j_data["image"], harnesses.NET_INPUT_HW)
        hand_side = hand_side_of(j_data)
        ref = _jax_fields(net, params, j_image, hand_side)
        t_data = pre(cfg, {k: torch.from_numpy(v) for k, v in raw.items()})
        t_image = resize_bilinear(t_data["image"], harnesses.NET_INPUT_HW)
        got = parity.port_fields(t_params, t_image,
                                 torch.from_numpy(np.asarray(hand_side)))
        summary = parity.check_cascade(
            ref, got, _jax_rerun(net, params, j_image, hand_side),
            scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
            flip_bound=FLIP_BOUND)
        rows = slice(bi * BATCH, bi * BATCH + valid)
        clear, slack = parity.peak_slack(ref["scoremap"], FLIP_BOUND)
        if argmax_dists:  # (u, v) crop px -> dataset px
            ih, iw = j_data["image"].shape[1:3]
            frame = np.array([iw / harnesses.NET_INPUT_HW[1],
                              ih / harnesses.NET_INPUT_HW[0]])
            tol = DIST_ATOL + np.linalg.norm(
                slack * frame / got["scale_crop"][:, :, None], axis=-1)
        else:
            clear, tol = np.ones((BATCH, 21), bool), np.full((BATCH, 21),
                                                             DIST_ATOL)
        clear[summary["images_rerun"]] = False
        g, w, c = got_dists[rows], want_dists[rows], clear[:valid]
        assert (np.abs(g - w) <= tol[:valid])[c].all(), np.abs(g - w)[c]
        held += int(c.sum())
    return held


@pytest.mark.parametrize("scale_to_size", [True, False])
def test_eval2d_full_image_matches_flip_aware(files, monkeypatch,
                                              scale_to_size):
    params = JaxCascade().init(jax.random.PRNGKey(5))
    kw = dict(use_wrist_coord=False, scale_to_size=scale_to_size)
    got, g, want, w = run_both(
        monkeypatch,
        lambda: harnesses.eval2d_full_image(
            np_tree(params), RHDDataset("evaluation", files["rhd"]), BATCH,
            device="cpu", **kw),
        lambda: j_harnesses.eval2d_full_image(
            params, JaxRHD("evaluation", files["rhd"]), BATCH, **kw))
    held = _check_cascade_batches(
        params, RHDDataset("evaluation", files["rhd"]),
        harnesses.full_image_config(**kw), preprocess_rhd, g, w,
        lambda data: jnp.tile(jnp.asarray([[1.0, 0.0]]), (BATCH, 1)),
        argmax_dists=True)
    assert held >= 10, held
    assert_same_metric_keys(got, want)


def test_eval_full_pipeline_matches_flip_aware(files, monkeypatch):
    """The 3D dists come from coord3d, which has no argmax: an image with
    JAX's mask is held at every keypoint."""
    params = JaxCascade().init(jax.random.PRNGKey(6))
    got, g, want, w = run_both(
        monkeypatch,
        lambda: harnesses.eval_full_pipeline(
            np_tree(params), STBDataset("evaluation", files["stb"]), BATCH,
            device="cpu"),
        lambda: j_harnesses.eval_full_pipeline(
            params, JaxSTB("evaluation", files["stb"]), BATCH))
    held = _check_cascade_batches(
        params, STBDataset("evaluation", files["stb"]),
        harnesses.FULL_PIPELINE_CONFIG, preprocess_stb, g, w,
        lambda data: data["hand_side"], argmax_dists=False)
    assert held >= 42, held
    assert_same_metric_keys(got, want)


# --- the streaming loop ------------------------------------------------------


def test_padded_last_batch_is_counted_once(files, monkeypatch):
    """3 records at batch 2: the second batch repeats record 2, and only its
    first row reaches the metrics."""
    assert [(i.tolist(), v) for i, v in harnesses.eval_batches(3, 2)] == \
        [([0, 1], 2), ([2, 2], 1)]
    rows = record_dists(monkeypatch, harnesses)
    seen = []
    harnesses.eval3d_lifting(
        "direct", weights.random_lifting_params("direct", 0),
        RHDDataset("evaluation", files["rhd"]), BATCH, device="cpu",
        progress=lambda bi, valid: seen.append((bi, valid)))
    assert [r.shape[0] for r in rows] == [2, 1]
    assert seen == [(0, 2), (1, 1)]
    rows.clear()
    harnesses.eval3d_lifting(
        "direct", weights.random_lifting_params("direct", 0),
        RHDDataset("evaluation", files["rhd"]), BATCH, device="cpu",
        max_batches=1)
    assert [r.shape[0] for r in rows] == [2]


def test_harness_producer_error_propagates(files, monkeypatch):
    """An IO failure on the producer thread raises in the caller instead of
    leaving it blocked on the queue."""
    dataset = RHDDataset("evaluation", files["rhd"])

    def boom(idx):
        raise OSError("truncated record file")

    monkeypatch.setattr(dataset, "raw_batch", boom)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="producer thread failed") as exc:
        harnesses.eval2d_gt_cropped(
            weights.random_params(0)["PoseNet2D"], dataset, BATCH,
            device="cpu")
    assert isinstance(exc.value.__cause__, OSError)
    for t in threading.enumerate():
        if t is not threading.current_thread() and t.daemon:
            t.join(timeout=10)
    assert threading.active_count() <= before


def test_harness_refuses_a_missing_gpu(files, monkeypatch):
    """device='cuda' without a card raises; nothing runs on the CPU
    instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harnesses.eval3d_lifting(
            "direct", weights.random_lifting_params("direct", 0),
            RHDDataset("evaluation", files["rhd"]), BATCH, device="cuda")
