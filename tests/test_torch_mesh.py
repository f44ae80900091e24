"""The port's data-parallel mesh against hand3d_tpu's, on the CPU.

Two gloo ranks (``tests/torch_mesh_worker.py``, spawned once for the module,
importing torch and the port only) run every multi-rank check in one go:
DP train steps of PoseNet, HandSegNet and lifting and PoseNet with
``accum_steps=2``; the eval2d_gt_cropped and eval_full harnesses; the
estimator; train_posenet's fit with a SIGTERM sent to one rank; and the
data-parallel graph step's body against the generator path. While
they run, this process computes the references: JAX's step on a 2x1 mesh of
two of conftest's virtual CPU devices, JAX's harnesses, and the port in one
process. Tolerances:

- loss: within 1e-6 of JAX's, relative;
- gradients of the first step (both sides at the same params): within 1e-5
  of each tensor's largest |g| of the port's own single-process gradients
  of the global batch; against JAX's as tests/test_torch_train_step.py
  holds them, 1e-5 of the largest |g|, or 2e-2 relative L2 where a kink
  flips: in PoseNet, and in HandSegNet on these noise images, where a
  max-pool near-tie after conv2_2 moves every gradient before it by up to
  4e-4 of its largest (measured: the same in one process of the port);
- params after each step: within what Adam makes of the two sides' own
  gradients, |adam(g_port) - adam(g_jax)|, plus 4 float32 ulps and 1e-3 lr
  a step: test_torch_train_step's one-step bound carried over the steps;
- the ranks: bit-equal in loss, gradients and params;
- eval: each rank's metrics equal, its dists held to JAX's as
  tests/test_torch_eval.py holds one process's;
- estimator: the gathered cascade fields held to one process's run by
  ``parity.check_cascade``, each rank's answers equal to them.
"""

import collections
import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hand3d_tpu.data.pipeline import epoch_indices as j_epoch_indices
from hand3d_tpu.eval import harnesses as j_harnesses
from hand3d_tpu.models import handsegnet as j_handsegnet
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.models.poseprior import PosePriorNetwork as JaxPrior
from hand3d_tpu.cli import train_handsegnet as j_train_handsegnet
from hand3d_tpu.cli import train_posenet as j_train_posenet
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.data.stb import STBDataset as JaxSTB
from hand3d_tpu.parallel import mesh as j_mesh_lib
from hand3d_tpu.train import trainer as j_trainer
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.cli import train_handsegnet, train_lifting, train_posenet
from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline, epoch_indices
from hand3d_tpu_torch.data.preprocess import (draw_noise, preprocess_rhd,
                                              preprocess_stb)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.serving import HandPoseEstimator
from hand3d_tpu_torch.train import trainer

from fixtures import make_rhd_bin, make_stb_bin
from test_torch_eval import DIST_ATOL, _check_cascade_batches, _jax_data
from test_torch_train_step import (GRAD_RTOL_OF_MAX, KINK_FLIP_REL_L2,
                                   _jax_lifting_loss)
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

WORLD = 2
BATCH = 4  # global train batch: 2 rows a rank
STEPS = 2
CROP = 32
EVAL_BATCH = 2  # global eval batch: 1 row a rank, the last one padded
SERVE_HW = (120, 160)
LOSS_RTOL = 1e-6
FLIP_BOUND = 1e-5
SCOREMAP_ATOL = 1e-6
COORD3D_ATOL = 1e-6
SPAWN_TIMEOUT_S = 300
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
KINK_STAGES = ("posenet", "handsegnet")
# stage -> (JAX loss, lr, accum_steps)
STAGES = {
    "posenet": (j_train_posenet.loss_fn, 1e-4, 1),
    "handsegnet": (j_train_handsegnet.loss_fn, 1e-5, 1),
    "lifting:proposed": (_jax_lifting_loss("proposed"), 1e-5, 1),
    "posenet_accum2": (j_train_posenet.loss_fn, 1e-4, 2),
}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _posenet_batches(rng):
    """Global batches whose ranks see different visibility: rank 0's rows
    have every keypoint visible, rank 1's three."""
    out = []
    for _ in range(STEPS):
        vis = np.zeros((BATCH, 21), bool)
        vis[:BATCH // 2] = True
        vis[BATCH // 2:, :3] = True
        out.append({
            "image_crop": rng.normal(0, 0.2, (BATCH, CROP, CROP, 3))
            .astype(np.float32),
            "scoremap": rng.random((BATCH, CROP, CROP, 21))
            .astype(np.float32),
            "keypoint_vis21": vis})
    return out


def _stage_inputs(name, rng):
    key = jax.random.PRNGKey(3)
    if name.startswith("posenet"):
        return {j_posenet.SCOPE: j_posenet.init(key)}, _posenet_batches(rng)
    if name == "handsegnet":
        labels = rng.random((STEPS, BATCH, CROP, CROP)) > 0.7
        return {j_handsegnet.SCOPE: j_handsegnet.init(key)}, [{
            "image": rng.normal(0, 0.2, (BATCH, CROP, CROP, 3))
            .astype(np.float32),
            "hand_mask": np.stack([~m, m], -1).astype(np.float32)}
            for m in labels]
    side = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (STEPS, BATCH))]
    return JaxPrior("proposed").init(key), [{
        "scoremap": rng.random((BATCH, 32, 32, 21)).astype(np.float32),
        "hand_side": s,
        "keypoint_xyz21_can": rng.normal(0, 0.3, (BATCH, 21, 3))
        .astype(np.float32),
        "rot_mat": rng.normal(0, 0.5, (BATCH, 3, 3)).astype(np.float32)}
        for s in side]


def _spec(d):
    rng = np.random.default_rng(17)
    stages = {}
    for name, (_, lr, accum) in STAGES.items():
        params, batches = _stage_inputs(name, rng)
        stages[name] = {"params": np_tree(params), "batches": batches,
                        "lr": lr, "accum": accum,
                        "loss": name.split("_")[0]}
    rhd = str(make_rhd_bin(d / "rhd.bin", num_records=3))
    os.makedirs(d / "fit")
    return {
        "stages": stages,
        "eval": {"rhd": rhd, "stb": str(make_stb_bin(d / "stb.bin",
                                                     num_records=3)),
                 "posenet_params": np_tree(j_posenet.init(
                     jax.random.PRNGKey(4))),
                 "cascade_params": np_tree(JaxCascade().init(
                     jax.random.PRNGKey(6))),
                 "batch": EVAL_BATCH},
        "serve": {"params": weights.random_params(2),
                  "images": rng.integers(0, 256, (3, *SERVE_HW, 3),
                                         dtype=np.uint8),
                  "batch": 2},
        "fit": {"rhd": str(make_rhd_bin(d / "train.bin", num_records=8,
                                        seed=5)),
                "dir": str(d / "fit")},
        "graph_body": {"rhd": str(d / "train.bin"), "batch": BATCH,
                       "params": stages["posenet"]["params"]},
    }


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The spawned ranks; ``results()`` waits for them once."""

    def __init__(self, d):
        self.spec = _spec(d)
        self.dir = d
        with open(d / "in.pkl", "wb") as f:
            pickle.dump(self.spec, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(WORLD), str(port),
             str(d / "in.pkl"), str(d)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    self.kill()
                    out, _ = p.communicate()
                logs.append((p.returncode, out))
            assert all(rc == 0 for rc, _ in logs), logs
            self._results = []
            for r in range(WORLD):
                with open(self.dir / f"rank{r}.pkl", "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _jax_evals(spec):
    """JAX's harness metrics and recorded dists on the eval files."""
    rows = []
    base = j_harnesses.EvalUtil

    class Recording(base):
        def feed_batch(self, dists, vis):
            rows.append(np.asarray(dists))
            super().feed_batch(dists, vis)

    out = {}
    j_harnesses.EvalUtil = Recording
    try:
        for key, run in (
                ("gt_cropped", lambda: j_harnesses.eval2d_gt_cropped(
                    spec["posenet_params"], JaxRHD("evaluation", spec["rhd"]),
                    EVAL_BATCH)),
                ("full", lambda: j_harnesses.eval_full_pipeline(
                    spec["cascade_params"], JaxSTB("evaluation", spec["stb"]),
                    EVAL_BATCH))):
            del rows[:]
            out[key] = (run(), np.concatenate(rows))
    finally:
        j_harnesses.EvalUtil = base
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned ranks, and the references computed here while they run:
    JAX's steps on the 2x1 mesh, the port's step-1 gradients in one
    process, JAX's harnesses."""
    with module_dir(tmp_path_factory, "mesh") as d:
        spawned = Ranks(d)
        try:
            mesh = j_mesh_lib.make_mesh(WORLD, 1,
                                        devices=jax.devices()[:WORLD])
            stages = spawned.spec["stages"]
            spawned.jax_steps = {name: _jax_steps(name, stages[name], mesh)
                                 for name in STAGES}
            spawned.port_grads = {name: _port_grads(name, stages[name])
                                  for name in STAGES}
            spawned.jax_evals = _jax_evals(spawned.spec["eval"])
            yield spawned
        finally:
            spawned.kill()


def _jax_steps(name, spec, mesh):
    """JAX's steps of a stage on the 2x1 mesh: per step the loss, the
    params after it and the global gradients at the params before it
    (accumulated as the step does)."""
    loss_fn, lr, accum = STAGES[name]
    opt = j_trainer.make_optimizer([lr], [])
    step = j_trainer.make_train_step(loss_fn, opt, mesh=mesh, donate=False,
                                     accum_steps=accum)
    grad = jax.jit(jax.grad(loss_fn))
    state = j_trainer.init_state(spec["params"], opt)
    key = jax.random.PRNGKey(0)
    out = []
    for batch in spec["batches"]:
        m = BATCH // accum
        # each microbatch sharded over the mesh, as the step computes it
        grads = [grad(state.params, jax.device_put(
            {k: v[j * m:(j + 1) * m] for k, v in batch.items()},
            j_mesh_lib.batch_sharding(mesh)), key) for j in range(accum)]
        grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum, *grads)
        placed = jax.device_put(batch, j_mesh_lib.batch_sharding(mesh))
        state, metrics = step(state, placed, key)
        out.append({"loss": float(metrics["loss"]),
                    "grads": weights.tree_to_flat(np_tree(grads)),
                    "params": weights.tree_to_flat(np_tree(state.params))})
    return out


def _port_grads(name, spec):
    """The port's step-1 gradients of the global batch in one process,
    accumulated as the step does, TF layout by path."""
    loss_fn = {"posenet": train_posenet.loss_fn,
               "handsegnet": train_handsegnet.loss_fn}.get(
        spec["loss"]) or train_lifting.make_loss("proposed")[0]
    accum = spec["accum"]
    state = trainer.init_state(
        weights.params_from_jax(spec["params"], "cpu"),
        trainer.make_optimizer([1.0], []))
    m = BATCH // accum
    total = None
    for j in range(accum):
        micro = {k: torch.from_numpy(np.ascontiguousarray(
            v[j * m:(j + 1) * m])) for k, v in spec["batches"][0].items()}
        _, g = trainer.value_and_grad(loss_fn, state.params, micro, None)
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return {p: weights.params_to_jax({"g": g / accum})["g"]
            for p, g in zip(trainer.tree_paths(state.params), total)}


class Adam64:
    """Adam (TF defaults) in float64 from ``p0``, one ``step(g)`` at a
    time."""

    def __init__(self, p0, lr):
        self.p, self.m, self.v, self.t, self.lr = (
            p0.astype(np.float64), 0.0, 0.0, 0, lr)

    def step(self, g):
        self.t += 1
        g = g.astype(np.float64)
        self.m = 0.9 * self.m + 0.1 * g
        self.v = 0.999 * self.v + 0.001 * g * g
        self.p = self.p - self.lr * (self.m / (1 - 0.9 ** self.t)) / (
            np.sqrt(self.v / (1 - 0.999 ** self.t)) + 1e-8)
        return self.p


@pytest.mark.parametrize("name", list(STAGES))
def test_dp_step_matches_jax_mesh_step(ranks, name):
    spec = ranks.spec["stages"][name]
    want = ranks.jax_steps[name]
    got, other = (r["stages"][name] for r in ranks.results())
    _, lr, _ = STAGES[name]
    before = weights.tree_to_flat(spec["params"])
    kinks = name.split("_")[0] in KINK_STAGES
    single = ranks.port_grads[name]
    adam = {}  # path -> the float64 Adam of each side's gradients
    for t, (g, o, w) in enumerate(zip(got, other, want), 1):
        # the ranks are bit-equal
        assert (g["loss"], g["digest"]) == (o["loss"], o["digest"])
        assert g["loss"] == pytest.approx(w["loss"], rel=LOSS_RTOL), t
        # gradients at the same params: step 1's (later steps start from
        # params that the two sides' own updates moved apart)
        for path, gg in (g["grads"].items() if t == 1 else ()):
            wg, sg = w["grads"][path], single[path]
            np.testing.assert_allclose(
                gg, sg, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(sg).max(),
                err_msg=path)
            if kinks:
                assert (np.linalg.norm(gg - wg)
                        <= KINK_FLIP_REL_L2 * np.linalg.norm(wg)), path
            else:
                np.testing.assert_allclose(
                    gg, wg, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(wg).max(),
                    err_msg=path)
        for path, p in g["params"].items():
            wp = w["params"][path]
            if t == 1:
                adam[path] = (Adam64(before[path], lr),
                              Adam64(before[path], lr))
            mine, theirs = adam[path]
            atol = (np.abs(mine.step(g["grads"][path])
                           - theirs.step(w["grads"][path]))
                    + 4 * t * np.spacing(np.abs(wp)).astype(np.float64)
                    + 1e-3 * lr * t)
            assert (np.abs(p - wp) <= atol).all(), (t, path)
            assert (p != before[path]).any(), path


def test_posenet_normalizer_is_global(ranks):
    """The ranks' visibility counts differ (21 and 3 a row): the DP loss is
    the global batch's, which the mean of the ranks' own losses (what a
    plain DDP average would give) misses."""
    want = ranks.jax_steps["posenet"][0]["loss"]
    got = [r["stages"]["posenet"][0] for r in ranks.results()]
    assert got[0]["loss"] == pytest.approx(want, rel=LOSS_RTOL)
    naive = np.mean([g["own_loss"] for g in got])
    assert abs(naive - want) > 1e-3, (naive, want)


def test_input_pipeline_shards_match_jax(tmp_path, monkeypatch):
    """Each shard's epoch indices and step count are JAX's; the shards'
    draws are the global batch's rows; more than one process without a
    mesh raises."""
    path = str(make_rhd_bin(tmp_path / "p.bin", num_records=9, seed=2))
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_size=CROP)
    dataset = RHDDataset("training", path)
    feats = []
    for i in range(WORLD):
        p = InputPipeline(dataset, cfg, 2, seed=3, process_shard=(i, WORLD),
                          device="cpu")
        np.testing.assert_array_equal(
            epoch_indices(9, 2, True, 3, process_shard=(i, WORLD)),
            j_epoch_indices(9, 2, True, 3, process_shard=(i, WORLD)))
        assert p.steps_per_epoch() == 2  # floor(9 / 2) // 2, as JAX's
        feats.append(next(iter(p)))
    idx = np.concatenate([epoch_indices(9, 2, True, 3, process_shard=(i, 2))
                          [0] for i in range(WORLD)])
    raw = {k: torch.from_numpy(v) for k, v in
           dataset.raw_batch(idx).items()}
    noise = draw_noise(cfg, raw, augment.generator(0, 3, 0, 0))
    whole = preprocess_rhd(cfg, raw, noise)
    for k, v in whole.items():
        torch.testing.assert_close(torch.cat([f[k] for f in feats]), v,
                                   rtol=0, atol=0, msg=k)
    monkeypatch.setattr(mesh_lib, "process_count", lambda: WORLD)
    with pytest.raises(ValueError, match="no ``mesh``"):
        InputPipeline(dataset, cfg, 2, device="cpu")


def _ranks_agree(results, key):
    (m0, d0), (m1, d1) = (r["eval"][key] for r in results)
    np.testing.assert_array_equal(d0, d1)
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k])
    return m0, d0


def test_eval2d_gt_cropped_on_two_ranks_matches_jax(ranks):
    spec = ranks.spec["eval"]
    got, g = _ranks_agree(ranks.results(), "gt_cropped")
    want, w = ranks.jax_evals["gt_cropped"]
    raw = RHDDataset("evaluation", spec["rhd"]).raw_batch([0, 1, 2])
    data = _jax_data(harnesses.GT_CROP_CONFIG, raw)
    sm = np.asarray(jax.jit(j_posenet.apply)(spec["posenet_params"],
                                             data["image_crop"])[-1])
    clear, slack = parity.peak_slack(sm, FLIP_BOUND)
    assert clear.sum() >= 21, clear.sum()
    tol = DIST_ATOL + (np.linalg.norm(slack, axis=-1)
                       / np.asarray(data["crop_scale"])[:, None])
    assert (np.abs(g - w) <= tol)[clear].all(), np.abs(g - w)[clear].max()
    assert set(got) == set(want)


def test_eval_full_on_two_ranks_matches_jax(ranks):
    spec = ranks.spec["eval"]
    got, g = _ranks_agree(ranks.results(), "full")
    want, w = ranks.jax_evals["full"]
    held = _check_cascade_batches(
        spec["cascade_params"], STBDataset("evaluation", spec["stb"]),
        harnesses.FULL_PIPELINE_CONFIG, preprocess_stb, g, w,
        lambda data: data["hand_side"], argmax_dists=False)
    assert held >= 42, held
    assert set(got) == set(want)


def test_estimator_on_two_ranks_holds_to_one_process(ranks):
    spec = ranks.spec["serve"]
    results = ranks.results()
    images, b = spec["images"], spec["batch"]
    one = HandPoseEstimator(spec["params"], batch_size=b,
                            input_hw=SERVE_HW, device="cpu")
    norm = np.pad(images.astype(np.float32) / 255.0 - 0.5,
                  ((0, -len(images) % b), (0, 0), (0, 0), (0, 0)))
    side = torch.tensor([[1.0, 0.0]] * b)
    fields = []
    for c, start in enumerate(range(0, len(norm), b)):
        chunk = torch.from_numpy(norm[start:start + b])
        ref = parity.port_fields(one.params, chunk, side)
        got = results[0]["serve"]["fields"][c]
        parity.check_cascade(
            ref, got, parity.port_rerun(one.params, chunk, side),
            scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
            flip_bound=FLIP_BOUND)
        fields.append(got)
    fields = {k: np.concatenate([f[k] for f in fields])[:len(images)]
              for k in fields[0]}
    for r in results:
        served = r["serve"]["served"]
        for k in ("keypoint_uv21", "keypoint_coord3d", "center",
                  "scale_crop"):
            np.testing.assert_array_equal(served[k], fields[k], err_msg=k)
    for k, v in results[0]["serve"]["served"].items():
        np.testing.assert_array_equal(v, results[1]["serve"]["served"][k])
    assert results[0]["serve"]["served"]["hand_scoremap"].shape == (
        3, *SERVE_HW, 2)


def test_sigterm_on_one_rank_stops_every_rank_at_one_step(ranks):
    """A SIGTERM to rank 1 during step 2: both ranks stop at the boundary
    of step 3, rank 0 writes the one snapshot, the metrics log has each
    step once."""
    r0, r1 = (r["fit"] for r in ranks.results())
    assert r0["step"] == r1["step"] == 3
    assert r0["snapshots"] == r1["snapshots"] == [3]
    assert any("signal on a peer: saving snapshot at iteration 3" in line
               for line in r0["lines"]), r0["lines"]
    assert r1["lines"] == []  # rank 0 reports
    steps = [json.loads(l)["step"] for l in
             open(os.path.join(ranks.spec["fit"]["dir"], "m.jsonl"))]
    assert collections.Counter(steps) == {0: 1, 1: 1, 2: 1}


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_graph_body_equals_the_generator_path_bitwise(ranks, accum):
    """The body of the data-parallel graph step, driven eagerly with its
    static inputs and planned draws, gives the generator path's losses,
    params and Adam moments bit for bit after three steps on each rank
    (with accum 2 each rank skips the microbatch it holds no row of, and
    joins its normalizer's all-reduce); the ranks agree."""
    got = [r["graph_body"][accum] for r in ranks.results()]
    for g in got:
        assert g["draws"] > 0
        assert g["graph"] == g["generator"]
        assert g["digest"]["graph"] == g["digest"]["generator"]
    assert got[0]["graph"] == got[1]["graph"]
    assert got[0]["digest"] == got[1]["digest"]


def test_dp_step_on_gloo_ranks_replays_nothing(ranks):
    """make_train_step(mesh=) on gloo ranks on the CPU takes the eager
    step: neither graph counter moves."""
    for r in ranks.results():
        assert r["graph_body"]["counters"] == {
            "train.step_graph.replays": 0, "train.step_graph.eager": 0}


def test_mesh_of_other_sizes_raises():
    """A mesh must cover the ranks, as in JAX; the model axis, the
    multislice mesh and spatial partitioning are ported (one process makes
    their 1-rank forms)."""
    with pytest.raises(AssertionError, match=r"mesh 3x1 != 1 devices"):
        mesh_lib.make_mesh(3, 1)
    with pytest.raises(AssertionError, match=r"mesh 1x2 != 1 devices"):
        mesh_lib.make_mesh(1, 2)
    with pytest.raises(AssertionError, match=r"mesh 2x1x1 != 1 devices"):
        mesh_lib.make_multislice_mesh(2, 1, 1)
    sliced = mesh_lib.make_multislice_mesh(1, 1, 1)
    assert sliced.mesh_dim_names == ("slice", "data", "model")
    assert mesh_lib.batch_shard_count(sliced) == 1
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    assert torch.equal(mesh_lib.spatial_constrainer(mesh_lib.make_mesh())(x),
                       x)
    mesh = mesh_lib.make_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh_lib.batch_shard_count(mesh) == 1
    assert mesh_lib.shard_rows(mesh, 4) == (0, 4)
    assert mesh_lib.param_sharding(mesh, {"a": {"w": 0}}) == {
        "a": {"w": ("replicate", "replicate")}}
    assert mesh_lib.init_distributed() == (0, 1)  # no arguments: nothing
