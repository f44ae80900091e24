"""The port's scale-out layer against hand3d_tpu/parallel/, on the CPU.

Four gloo ranks (``tests/torch_parallel_worker.py``, spawned once for the
module, importing torch and the port only) run every multi-rank check: tensor
parallelism (TP) on 1x4 and 2x2, the multislice meshes, spatial
partitioning (SP), GPipe (PP), the expert-parallel MoE layer (EP), the
estimator and a harness, fit with a snapshot and its resume on another mesh,
and the CLIs with --mesh 2x2. While they run, this process computes the
references: JAX on conftest's virtual CPU devices (its 2x2 and 2x4 meshes,
its pipeline and expert layers) and the port in one process. Tolerances:

- TP, multislice: gradients within 1e-6 of one process's and of JAX's
  (``test_tp4_grad_matches_single_device``'s bound);
- TP train steps: ``tests/test_torch_mesh.py``'s bounds (loss within 1e-6
  relative, the first step's gradients within 1e-5 of each tensor's
  largest, or 2e-2 relative L2 where a kink flips: a column-parallel input
  gradient is a sum of M partials in another order, so TP is held kink-aware
  where a kink follows, never bit for bit; params within Adam of the two
  sides' gradients); the ranks bit-equal in every tensor, gathered whole;
- SP: HandSegNet's output within 1e-6 of one process, gradients kink-aware;
- PP: the loss within 1e-6 (relative) of the sequential loss at every
  n_micro, gradients kink-aware;
- EP: outputs, aux loss and gradients within 1e-6 of JAX's sharded layer
  on the same global tokens, dropped tokens included;
- each rank's local shapes: the blocks JAX's rule asks for.
"""

import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hand3d_tpu.eval import harnesses as j_harnesses
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.models import handsegnet as j_handsegnet
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.models.cascade import ColorHandPose3D as JaxCascade
from hand3d_tpu.ops import nn as j_nn
from hand3d_tpu.ops.quant import quantize_params_int8 as j_quantize
from hand3d_tpu.parallel import expert as j_expert
from hand3d_tpu.parallel import mesh as j_mesh_lib
from hand3d_tpu.parallel import pipeline as j_pipeline
from hand3d_tpu.train import trainer as j_trainer
from hand3d_tpu_torch import parity, weights
from hand3d_tpu_torch.models import handsegnet, posenet
from hand3d_tpu_torch.ops import nn, phasepack
from hand3d_tpu_torch.parallel import expert, pipeline, spatial
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.serving import HandPoseEstimator
from hand3d_tpu_torch.train import losses, trainer

from fixtures import make_rhd_bin
from test_torch_eval import DIST_ATOL, _jax_data
from test_torch_mesh import (BATCH, STAGES, Adam64, _free_port, _port_grads,
                             _stage_inputs, np_tree)
from test_torch_train_step import GRAD_RTOL_OF_MAX, KINK_FLIP_REL_L2
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

WORLD = 4
M = 2  # the "model" axis of the 2x2 mesh
GRAD_ATOL = 1e-6
LOSS_RTOL = 1e-6
SCOREMAP_ATOL = 1e-6
COORD3D_ATOL = 1e-6
FLIP_BOUND = 1e-5
SERVE_HW = (64, 96)
SP_BATCH = 2
SP_HW = (64, 64)
SP_BAD_HEIGHTS = (63, 60)  # 63 rows do not split; 60 leave 15 rows a pool
PP_BATCH = 16
PP_N_MICRO = (1, 2, 4)
PP_GRAD_N_MICRO = 2
EP_TOKENS = 64
EP_FACTORS = (4.0, 0.25, 0.1)  # ample; 1 slot an expert (drops); 1 slot
SPAWN_TIMEOUT_S = 300
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
KINK_STAGES = ("posenet", "handsegnet")
TRAINERS = ("train_posenet", "train_handsegnet", "train_lifting",
            "train_joint")
EVAL_CLIS = ("eval2d", "eval2d_gt_cropped", "eval3d", "eval_full")
LOSS_LINE = re.compile(r"^Iteration 0\t Loss \d\.\de[+-]\d\d\t [\d.]+ it/s$")


def _tp_layers():
    return {"conv": j_nn.conv_init(jax.random.PRNGKey(0), 3, 3, 8, 256),
            "fc": j_nn.dense_init(jax.random.PRNGKey(1), 256, 128)}


def _spec(d):
    rng = np.random.default_rng(31)
    stages = {}
    for name, (_, lr, accum) in STAGES.items():
        params, batches = _stage_inputs(name, rng)
        stages[name] = {"params": np_tree(params), "batches": batches,
                        "lr": lr, "accum": accum,
                        "loss": name.split("_")[0]}
    labels = rng.random((SP_BATCH, *SP_HW)) > 0.7
    pp_params = j_posenet.init(jax.random.PRNGKey(0))
    os.makedirs(d / "fit")
    os.makedirs(d / "clis")
    return {
        "tp4": {"params": np_tree(_tp_layers()),
                "x": rng.normal(size=(8, 16, 16, 8)).astype(np.float32)},
        "ms": {"params": {"fc": np_tree(j_nn.dense_init(
            jax.random.PRNGKey(0), 256, 128))},
               "x": rng.normal(size=(8, 256)).astype(np.float32)},
        "stages": stages,
        "layers": {"params": np_tree({
            "conv": j_nn.conv_init(jax.random.PRNGKey(2), 3, 3, 256, 256),
            "fc": j_nn.dense_init(jax.random.PRNGKey(3), 256, 128),
            # a transposed conv's TF kernel is [kh, kw, out, in]: JAX's rule
            # shards its input channels, and the bias (64) stays whole
            "up": {"weights": np.asarray(jax.random.normal(
                jax.random.PRNGKey(4), (4, 4, 64, 256))) * 0.05,
                   "biases": np.full((64,), 1e-4, np.float32)}}),
            "x": rng.normal(size=(2, 256, 8, 8)).astype(np.float32),
            "h": rng.normal(size=(2, 256)).astype(np.float32)},
        "sp": {"params": np_tree(j_handsegnet.init(jax.random.PRNGKey(7))),
               "batch": {"image": rng.normal(0, 0.2, (SP_BATCH, *SP_HW, 3))
                         .astype(np.float32),
                         "hand_mask": np.stack([~labels, labels], -1)
                         .astype(np.float32)},
               "bad_heights": SP_BAD_HEIGHTS},
        "pp": {"params": np_tree(pp_params),
               "image": rng.normal(0, 0.1, (PP_BATCH, 32, 32, 3))
               .astype(np.float32),
               "gt": rng.random((PP_BATCH, 32, 32, 21)).astype(np.float32),
               "vis": (rng.random((PP_BATCH, 21)) > 0.3).astype(np.float32),
               "n_micro": PP_N_MICRO, "grad_n_micro": PP_GRAD_N_MICRO},
        "ep": {"params": np_tree(j_expert.moe_dense_init(
            jax.random.PRNGKey(0), 4, 64, 32)),
               "x": rng.normal(size=(EP_TOKENS, 64)).astype(np.float32),
               "capacity_factors": EP_FACTORS},
        "serve": {"params": weights.random_params(2),
                  "images": rng.integers(0, 256, (3, *SERVE_HW, 3),
                                         dtype=np.uint8),
                  "batch": 2},
        "eval": {"rhd": str(make_rhd_bin(d / "eval.bin", num_records=3)),
                 "posenet_params": np_tree(j_posenet.init(
                     jax.random.PRNGKey(4))),
                 "batch": 2},
        "fit": {"rhd": str(make_rhd_bin(d / "train.bin", num_records=8,
                                        seed=5)),
                "dir": str(d / "fit")},
        "clis": {"rhd": str(make_rhd_bin(d / "cli.bin", num_records=2,
                                         seed=3)),
                 "dir": str(d / "clis")},
    }


class Ranks:
    """The spawned ranks; ``results()`` waits for them once."""

    def __init__(self, d):
        self.spec = _spec(d)
        self.dir = d
        with open(d / "in.pkl", "wb") as f:
            pickle.dump(self.spec, f)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
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


def _jax_tp_steps(name, spec, mesh):
    """JAX's steps of a stage on the 2x2 mesh: per step the loss, the
    gradients of the TP-sharded params at the step's start (microbatches
    averaged, as its step does) and the params after Adam applies them."""
    loss_fn, lr, accum = STAGES[name]
    opt = j_trainer.make_optimizer([lr], [])
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    params = spec["params"]
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(0)
    m = BATCH // accum
    out = []
    with mesh:
        for batch in spec["batches"]:
            sharded = j_mesh_lib.shard_params(mesh, params)
            parts = [value_and_grad(sharded, jax.device_put(
                {k: v[j * m:(j + 1) * m] for k, v in batch.items()},
                j_mesh_lib.batch_sharding(mesh)), key) for j in range(accum)]
            loss = sum(float(l) for l, _ in parts) / accum
            grads = jax.tree_util.tree_map(lambda *g: sum(g) / accum,
                                           *(g for _, g in parts))
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            out.append({"loss": loss,
                        "grads": weights.tree_to_flat(np_tree(grads)),
                        "params": weights.tree_to_flat(np_tree(params))})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The spawned ranks, and JAX's 2x2 steps computed here while they
    run."""
    with module_dir(tmp_path_factory, "parallel") as d:
        spawned = Ranks(d)
        try:
            mesh = j_mesh_lib.make_mesh(2, 2, devices=jax.devices()[:4])
            stages = spawned.spec["stages"]
            spawned.jax_steps = {name: _jax_tp_steps(name, stages[name], mesh)
                                 for name in STAGES}
            spawned.port_grads = {name: _port_grads(name, stages[name])
                                  for name in STAGES}
            yield spawned
        finally:
            spawned.kill()


def _digests_agree(outs):
    assert len({o["digest"] for o in outs}) == 1
    return outs[0]


def _jax_dim_of(spec):
    """The TF-layout dim that a JAX PartitionSpec shards over "model"."""
    return next((i for i, a in enumerate(spec) if a == "model"), None)


def _port_dim(jax_dim, ndim):
    """A TF-layout dim in the port's layout: HWIO's O is OIHW's 0."""
    if jax_dim is None:
        return None
    return 0 if ndim == 4 else jax_dim


def _expected_shapes(tf_tree, model_size):
    """{path: local shape} of the port's tree sharded by JAX's rule."""
    out = {}
    for path, value in weights.tree_to_flat(tf_tree).items():
        keys = tuple(path.split("/"))
        dim = _port_dim(_jax_dim_of(j_mesh_lib._spec_for_param(
            keys, value, model_size)), value.ndim)
        shape = list(np.asarray(value).shape)
        if len(shape) == 4:
            shape = [shape[3], shape[2], shape[0], shape[1]]
        if dim is not None:
            shape[dim] //= model_size
        out[path] = tuple(shape)
    return out


# --- (1) the sharding rule, in this process ---------------------------------


@pytest.mark.parametrize("layout", ["float", "int8", "int8_all"])
@pytest.mark.parametrize("model_size", [2, 4, 8])
def test_spec_for_param_is_jax_rule(layout, model_size):
    """Every leaf of the full cascade tree, and of its int8 trees, shards
    the dim JAX's rule shards, read in the port's layout."""
    tree = JaxCascade().init(jax.random.PRNGKey(0))
    if layout == "int8":
        tree = j_quantize(tree)
    elif layout == "int8_all":
        tree = j_quantize(tree, min_in_chan=0)
    flat = weights.tree_to_flat(np_tree(tree))
    port = weights.tree_to_flat(trainer.tree_map(
        lambda t: t.numpy(), weights.params_from_jax(np_tree(tree), "cpu")))
    sharded = 0
    for path, value in flat.items():
        keys = tuple(path.split("/"))
        want = _port_dim(_jax_dim_of(j_mesh_lib._spec_for_param(
            keys, value, model_size)), value.ndim)
        got = mesh_lib._spec_for_param(keys, port[path], model_size)
        assert got == want, path
        sharded += got is not None
    assert sharded > 40


# --- (2) TP over 1x4 ---------------------------------------------------------


def _tp_loss(p, x):
    h = nn.conv2d_relu(x.permute(0, 3, 1, 2), p["conv"]).mean(dim=(2, 3))
    return torch.mean(torch.square(nn.dense_relu(h, p["fc"])))


def test_tp4_grad_matches_single_device(ranks):
    """A 1x4 mesh (TP over four ranks) gives one process's gradients and
    JAX's 2x4 mesh's; the 4-way channel split happens on every rank."""
    spec = ranks.spec["tp4"]
    outs = [r["tp4"] for r in ranks.results()]
    got = _digests_agree(outs)["full"]
    params = trainer.tree_map(lambda t: t.requires_grad_(True),
                              weights.params_from_jax(spec["params"], "cpu"))
    leaves = trainer.tree_leaves(params)
    g = torch.autograd.grad(_tp_loss(params, torch.from_numpy(spec["x"])),
                            leaves)
    single = {p: weights.params_to_jax({"g": t})["g"]
              for p, t in zip(trainer.tree_paths(params), g)}

    def j_loss(p, x):
        h = jnp.mean(j_nn.conv2d_relu(x, p["conv"]), axis=(1, 2))
        return jnp.mean(j_nn.dense_relu(h, p["fc"]) ** 2)

    mesh = j_mesh_lib.make_mesh(2, 4, devices=jax.devices()[:8])
    with mesh:
        g_jax = jax.jit(jax.grad(j_loss))(
            j_mesh_lib.shard_params(mesh, spec["params"]),
            jax.device_put(spec["x"], j_mesh_lib.batch_sharding(mesh)))
    g_jax = weights.tree_to_flat(np_tree(g_jax))
    for path in single:
        np.testing.assert_allclose(got[path], single[path], rtol=0,
                                   atol=GRAD_ATOL, err_msg=path)
        np.testing.assert_allclose(got[path], g_jax[path], rtol=0,
                                   atol=GRAD_ATOL, err_msg=path)
    for o in outs:
        assert o["shapes"] == {"conv/biases": (64,),
                               "conv/weights": (64, 8, 3, 3),
                               "fc/biases": (32,), "fc/weights": (256, 32)}


def test_sharded_layers_equal_whole_layers(ranks):
    """A conv and a dense layer sharded over "model" (float, int8, QAT) and
    a transposed conv whose input channels shard run as the whole layer
    does on the same input: within 1e-6 of one process's, and of JAX's for
    the float and int8 conv."""
    spec = ranks.spec["layers"]
    outs = [r["layers"] for r in ranks.results()]
    got = _digests_agree(outs)["full"]
    from hand3d_tpu_torch.ops import quant

    whole = weights.params_from_jax(spec["params"], "cpu")
    q = quant.quantize_params_int8({k: whole[k] for k in ("conv", "fc")},
                                   min_in_chan=0)
    x, h = torch.from_numpy(spec["x"]), torch.from_numpy(spec["h"])
    for name, tree in (("float", whole), ("int8", q),
                       ("qat", quant.qat_view(whole))):
        for layer, fn, arg in (("conv", nn.conv2d, x), ("fc", nn.dense, h)):
            want = fn(arg, tree[layer]).numpy()
            np.testing.assert_allclose(got[f"{name}/{layer}"], want, rtol=0,
                                       atol=GRAD_ATOL * max(
                                           1.0, np.abs(want).max()),
                                       err_msg=f"{name}/{layer}")
        assert all(o[f"{name}/shard"] for o in outs)
    np.testing.assert_allclose(
        got["float/up"], nn.conv2d_transpose(x, whole["up"]).numpy(), rtol=0,
        atol=GRAD_ATOL)
    assert outs[0]["up_dims"] == (("weights", 0),)
    j_x = np.transpose(spec["x"], (0, 2, 3, 1))
    for name, tree in (("float", spec["params"]),
                       ("int8", j_quantize(spec["params"], min_in_chan=0))):
        want = np.asarray(j_nn.conv2d(j_x, tree["conv"])).transpose(
            0, 3, 1, 2)
        np.testing.assert_allclose(got[f"{name}/conv"], want, rtol=0,
                                   atol=GRAD_ATOL * max(1.0,
                                                        np.abs(want).max()))


# --- (3) train steps on 2x2 --------------------------------------------------


@pytest.mark.parametrize("name", list(STAGES))
def test_tp_step_matches_jax_mesh_step(ranks, name):
    """The 2x2 train step (DP over "data", TP over "model") against JAX's
    2x2 step, the ranks bit-equal, the local shapes JAX's."""
    spec = ranks.spec["stages"][name]
    want = ranks.jax_steps[name]
    outs = [r["stages"][name] for r in ranks.results()]
    _, lr, _ = STAGES[name]
    before = weights.tree_to_flat(spec["params"])
    kinks = name.split("_")[0] in KINK_STAGES
    single = ranks.port_grads[name]
    expected = _expected_shapes(spec["params"], M)
    assert expected != _expected_shapes(spec["params"], 1)  # TP happened
    for o in outs:
        assert o["shapes"] == expected
    adam = {}
    for t, steps in enumerate(zip(*(o["steps"] for o in outs)), 1):
        assert len({(s["loss"], s["digest"]) for s in steps}) == 1, t
        g, w = steps[0], want[t - 1]
        assert g["loss"] == pytest.approx(w["loss"], rel=LOSS_RTOL), t
        for path, gg in (g["grads"].items() if t == 1 else ()):
            for ref in (single[path], w["grads"][path]):
                if kinks:
                    assert (np.linalg.norm(gg - ref)
                            <= KINK_FLIP_REL_L2 * np.linalg.norm(ref)), path
                else:
                    np.testing.assert_allclose(
                        gg, ref, rtol=0,
                        atol=GRAD_RTOL_OF_MAX * np.abs(ref).max(),
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


# --- (4) multislice ----------------------------------------------------------


def _fc_single_grads(spec):
    params = trainer.tree_map(lambda t: t.requires_grad_(True),
                              weights.params_from_jax(spec["params"], "cpu"))
    loss = torch.mean(torch.square(nn.dense_relu(
        torch.from_numpy(spec["x"]), params["fc"])))
    g = torch.autograd.grad(loss, trainer.tree_leaves(params))
    return {p: t.numpy() for p, t in zip(trainer.tree_paths(params), g)}


@pytest.mark.parametrize("layout,shards,fc_out", [("2x1x2", 2, 64),
                                                   ("2x2x1", 4, 128)])
def test_multislice_grad_matches_single_device(ranks, layout, shards, fc_out):
    """("slice", "data", "model"): the batch splits over slice x data, TP
    stays inside a slice; the gradient is one process's and JAX's."""
    spec = ranks.spec["ms"]
    outs = [r["multislice"][layout] for r in ranks.results()]
    got = _digests_agree(outs)["full"]
    single = _fc_single_grads(spec)

    def j_loss(p, x):
        return jnp.mean(j_nn.dense_relu(x, p["fc"]) ** 2)

    g_jax = weights.tree_to_flat(np_tree(jax.grad(j_loss)(
        spec["params"], spec["x"])))
    for path in single:
        np.testing.assert_allclose(got[path], single[path], rtol=0,
                                   atol=GRAD_ATOL, err_msg=path)
        np.testing.assert_allclose(got[path], g_jax[path], rtol=0,
                                   atol=GRAD_ATOL, err_msg=path)
    for o in outs:
        assert o["batch_shards"] == shards
        assert o["shapes"]["fc/weights"] == (256, fc_out)


# --- (5) spatial partitioning ------------------------------------------------


def test_spatial_partitioning_matches_one_process(ranks):
    """HandSegNet with rows split over "model" (halo exchanges at every
    SAME conv) gives one process's output and, kink-aware, its
    gradients."""
    spec = ranks.spec["sp"]
    got = _digests_agree([r["sp"] for r in ranks.results()])["full"]
    params = trainer.tree_map(lambda t: t.requires_grad_(True),
                              weights.params_from_jax(spec["params"], "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in spec["batch"].items()}
    seg = handsegnet.apply(params, batch["image"])
    np.testing.assert_allclose(got["seg"], seg[0].detach().numpy(), rtol=0,
                               atol=SCOREMAP_ATOL)
    loss = losses.handsegnet_loss(seg, batch["hand_mask"])
    g = torch.autograd.grad(loss, trainer.tree_leaves(params))
    for path, t in zip(trainer.tree_paths(params), g):
        ref = weights.params_to_jax({"g": t})["g"]
        mine = got[f"grad/{path}"]
        err = np.abs(mine - ref).max()
        assert (err <= GRAD_RTOL_OF_MAX * np.abs(ref).max()
                or np.linalg.norm(mine - ref)
                <= KINK_FLIP_REL_L2 * np.linalg.norm(ref)), path


def test_spatial_partitioning_of_a_packed_tree_matches_one_process(ranks):
    """conv1_2 phase-packed and fused with its pool under SP: a one-row halo
    like a 3x3 conv, the fused pool under max_pool_2x2's row rule."""
    spec = ranks.spec["sp"]
    outs = [r["sp"] for r in ranks.results()]
    got = _digests_agree(outs)["full"]
    params = phasepack.phase_pack_params(
        weights.params_from_jax(spec["params"], "cpu"))
    with torch.no_grad():
        seg = handsegnet.apply(params, torch.from_numpy(
            spec["batch"]["image"]))[0]
    np.testing.assert_allclose(got["seg_packed"], seg.numpy(), rtol=0,
                               atol=SCOREMAP_ATOL)
    for o in outs:
        assert o["packed_errors"] == o["errors"]


def test_spatial_partitioning_needs_heights_that_divide(ranks):
    errors = [r["sp"]["errors"] for r in ranks.results()]
    for e in errors:
        assert set(e) == set(SP_BAD_HEIGHTS)
        assert "height 63 does not divide over the 2 ranks" in e[63]
        assert "a 2x2 pool needs an even number of rows a rank" in e[60]


def test_spatial_region_refuses_an_activation_that_lost_its_split():
    """Inside the split region an activation without the row mark (an op
    that dropped it) raises instead of being split a second time; the
    region closes on the error, so the next forward splits afresh."""
    constrain = mesh_lib.spatial_constrainer(mesh_lib.make_mesh())
    x = torch.arange(32.0).reshape(1, 2, 4, 4)
    with pytest.raises(ValueError, match="lost its row split"):
        with spatial.region(constrain):
            constrain(constrain(x) * 1.0)  # the multiply drops the mark
    assert not constrain.open
    with spatial.region(constrain):
        y = constrain(x)
        assert constrain(y) is y
        assert torch.equal(spatial.whole(y), x)
    assert not constrain.open


@pytest.mark.parametrize("op, kernel, dims", [
    (nn.conv2d, (8, 4, 3, 3), (("weights", 1), ("biases", 0))),
    (nn.dense, (4, 8), (("weights", 0), ("biases", 0)))])
def test_sharded_layer_must_split_its_output_channels(op, kernel, dims):
    """A conv or dense layer sharded on another dim than its output
    channels raises; it never runs whole in silence."""
    params = {"weights": torch.zeros(kernel), "biases": torch.zeros(8),
              mesh_lib.SHARD_KEY: mesh_lib.ModelShard(None, 1, 0, 8, dims)}
    x = torch.zeros((1, 4, 8, 8) if len(kernel) == 4 else (1, 4))
    with pytest.raises(ValueError, match="splits its output channels"):
        op(x, params)


# --- (6) GPipe ---------------------------------------------------------------


def _sequential(spec):
    """The port's sequential loss and gradients (TF layout by path)."""
    params = trainer.tree_map(lambda t: t.requires_grad_(True),
                              weights.params_from_jax(spec["params"], "cpu"))
    loss = losses.posenet_scoremap_loss(
        posenet.apply(params, torch.from_numpy(spec["image"])),
        torch.from_numpy(spec["gt"]), torch.from_numpy(spec["vis"]))
    g = torch.autograd.grad(loss, trainer.tree_leaves(params))
    return loss.item(), {p: weights.params_to_jax({"g": t})["g"]
                         for p, t in zip(trainer.tree_paths(params), g)}


def test_pipeline_loss_matches_sequential_at_every_n_micro(ranks):
    spec = ranks.spec["pp"]
    outs = [r["pp"] for r in ranks.results()]
    want, _ = _sequential(spec)
    for o in outs:
        assert set(o["losses"]) == set(PP_N_MICRO)
        for n_micro, loss in o["losses"].items():
            assert loss == pytest.approx(want, rel=LOSS_RTOL), n_micro
        assert o["losses"] == outs[0]["losses"]  # every rank, the global
        assert o["stage_shapes"]["conv_1/weights"] == (1, 128, 149, 7, 7)
    j_params = spec["params"]
    j_loss = j_pipeline.posenet_pipeline_loss(
        j_pipeline.make_pipeline_mesh(2, 2, devices=jax.devices()[:4]),
        PP_GRAD_N_MICRO)
    jl = jax.jit(j_loss)(*j_pipeline.stack_refinement_params(j_params),
                         spec["image"], spec["gt"], spec["vis"])
    assert outs[0]["losses"][PP_GRAD_N_MICRO] == pytest.approx(
        float(jl), rel=1e-5)


def test_pipeline_grads_match_sequential(ranks):
    spec = ranks.spec["pp"]
    got = _digests_agree([r["pp"] for r in ranks.results()])["full"]
    _, want = _sequential(spec)
    assert set(got) == set(want)
    for path, ref in want.items():
        mine = got[path]
        assert (np.abs(mine - ref).max() <= GRAD_RTOL_OF_MAX
                * np.abs(ref).max() or np.linalg.norm(mine - ref)
                <= KINK_FLIP_REL_L2 * np.linalg.norm(ref)), path


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_stack_then_unstack_is_identity(kind):
    tree = np_tree(j_posenet.init(jax.random.PRNGKey(0)))
    if kind == "torch":
        tree = weights.params_from_jax(tree, "cpu")
    trunk, stacked = pipeline.stack_refinement_params(tree)
    assert stacked["conv_1"]["weights"].shape[0] == pipeline.N_STAGES
    assert not set(trunk) & {"conv6_1", "conv7_7"}
    rebuilt = pipeline.unstack_refinement_params(trunk, stacked)
    assert set(rebuilt) == set(tree)
    for k in tree:
        for leaf in tree[k]:
            np.testing.assert_array_equal(np.asarray(rebuilt[k][leaf]),
                                          np.asarray(tree[k][leaf]))
    if kind == "numpy":  # JAX's stacked tree, converted, is the port's
        _, j_stacked = j_pipeline.stack_refinement_params(tree)
        port = weights.params_from_jax(np_tree(j_stacked), "cpu")
        _, mine = pipeline.stack_refinement_params(
            weights.params_from_jax(tree, "cpu"))
        for k in mine:
            for leaf in mine[k]:
                assert torch.equal(port[k][leaf], mine[k][leaf])
        back = weights.params_to_jax(port)
        np.testing.assert_array_equal(back["conv_3"]["weights"],
                                      np.asarray(j_stacked["conv_3"]
                                                 ["weights"]))


# --- (7) the expert-parallel MoE layer ---------------------------------------


def _jax_ep(spec, cf):
    mesh = j_expert.make_expert_mesh(2, 2, devices=jax.devices()[:4])
    p = jax.device_put(spec["params"],
                       j_expert.expert_param_sharding(mesh, spec["params"]))

    def loss(p, x):
        o, a = j_expert.moe_dense_apply(mesh, p, x, capacity_factor=cf)
        return jnp.mean(o ** 2) + 0.01 * a, (o, a)

    (_, (out, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        p, spec["x"])
    return np.asarray(out), float(aux), weights.tree_to_flat(np_tree(g))


@pytest.mark.parametrize("cf", EP_FACTORS)
def test_expert_layer_matches_jax_sharded_layer(ranks, cf):
    """The port's layer on 2x2 equals JAX's ``moe_dense_apply`` on a 2x2
    mesh on the same global tokens: outputs, aux loss and, at the ample
    capacity, the gradients; at capacity 1 tokens are dropped (zero rows)
    and the drop set is each shard's."""
    spec = ranks.spec["ep"]
    outs = [r["ep"] for r in ranks.results()]
    got = _digests_agree(outs)["full"]
    out, aux, g = _jax_ep(spec, cf)
    np.testing.assert_allclose(got[f"out/{cf}"], out, rtol=0, atol=GRAD_ATOL)
    assert abs(float(got[f"aux/{cf}"]) - aux) <= GRAD_ATOL
    rows = np.abs(got[f"out/{cf}"]).sum(axis=1)
    if cf < 1:
        assert (rows == 0).any() and (rows > 0).any()
    else:
        assert (rows > 0).all()
        for path, ref in g.items():
            np.testing.assert_allclose(got[f"grad/{path}"], ref, rtol=0,
                                       atol=GRAD_ATOL, err_msg=path)
            assert np.abs(got[f"grad/{path}"]).max() > 0, path
    for o in outs:
        assert o["expert_slab"] == (2, 64, 32)


def test_expert_reference_matches_jax_and_routes_in_f32():
    params = np_tree(j_expert.moe_dense_init(jax.random.PRNGKey(0), 4, 64,
                                             32))
    x = np.random.default_rng(1).normal(size=(64, 64)).astype(np.float32)
    tp = weights.params_from_jax(params, "cpu")
    for cf in (4.0, 0.1):
        want, want_aux = j_expert.moe_dense_reference(params, x, cf)
        got, aux = expert.moe_dense_reference(tp, torch.from_numpy(x), cf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=GRAD_ATOL)
        assert abs(aux.item() - float(want_aux)) <= GRAD_ATOL
    # 400 bf16 tokens forced onto expert 0: each slot holds one token
    small = weights.params_from_jax(np_tree(j_expert.moe_dense_init(
        jax.random.PRNGKey(0), 4, 16, 8)), "cpu")
    small["gate"]["biases"] = torch.tensor([100.0, 0.0, 0.0, 0.0])
    tokens = torch.randn(400, 16, generator=torch.Generator().manual_seed(1))
    capacity = int(np.ceil(400 * 1.25 / 4))
    dispatch, _, _ = expert._route(small, tokens.to(torch.bfloat16), capacity)
    per_slot = dispatch.to(torch.float32).sum(dim=0)
    assert per_slot.max() <= 1.0
    assert per_slot[0].sum() == capacity and per_slot[1:].sum() == 0
    init = expert.moe_dense_init(np.random.default_rng(0), 4, 64, 32)
    assert init["experts"]["weights"].shape == (4, 64, 32)
    assert init["gate"]["weights"].shape == (64, 4)


# --- (8) the estimator and a harness on 2x2 ----------------------------------


def test_estimator_on_2x2_holds_to_one_process(ranks):
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
        got = results[0]["serve"]["fields"][c]
        parity.check_cascade(
            parity.port_fields(one.params, chunk, side), got,
            parity.port_rerun(one.params, chunk, side),
            scoremap_atol=SCOREMAP_ATOL, coord3d_atol=COORD3D_ATOL,
            flip_bound=FLIP_BOUND)
        fields.append(got)
    fields = {k: np.concatenate([f[k] for f in fields])[:len(images)]
              for k in fields[0]}
    for r in results:
        assert r["serve"]["sharded"]
        for k in ("keypoint_uv21", "keypoint_coord3d", "center",
                  "scale_crop"):
            np.testing.assert_array_equal(r["serve"]["served"][k], fields[k],
                                          err_msg=k)
        for k, v in results[0]["serve"]["served"].items():
            np.testing.assert_array_equal(v, r["serve"]["served"][k])


def test_eval2d_gt_cropped_on_2x2_matches_jax(ranks):
    spec = ranks.spec["eval"]
    results = ranks.results()
    got, g = results[0]["eval"]
    for m, d in (r["eval"] for r in results):
        np.testing.assert_array_equal(d, g)
        assert m.keys() == got.keys()
    rows = []
    base = j_harnesses.EvalUtil

    class Recording(base):
        def feed_batch(self, dists, vis):
            rows.append(np.asarray(dists))
            super().feed_batch(dists, vis)

    j_harnesses.EvalUtil = Recording
    try:
        j_harnesses.eval2d_gt_cropped(spec["posenet_params"],
                                      JaxRHD("evaluation", spec["rhd"]),
                                      spec["batch"])
    finally:
        j_harnesses.EvalUtil = base
    w = np.concatenate(rows)
    from hand3d_tpu_torch.data.rhd import RHDDataset
    from hand3d_tpu_torch.eval import harnesses

    raw = RHDDataset("evaluation", spec["rhd"]).raw_batch([0, 1, 2])
    data = _jax_data(harnesses.GT_CROP_CONFIG, raw)
    sm = np.asarray(jax.jit(j_posenet.apply)(spec["posenet_params"],
                                             data["image_crop"])[-1])
    clear, slack = parity.peak_slack(sm, FLIP_BOUND)
    assert clear.sum() >= 21, clear.sum()
    tol = DIST_ATOL + (np.linalg.norm(slack, axis=-1)
                       / np.asarray(data["crop_scale"])[:, None])
    assert (np.abs(g - w) <= tol)[clear].all(), np.abs(g - w)[clear].max()


# --- (9) fit: snapshots whole, resume on another mesh ------------------------


def test_fit_on_2x2_snapshots_whole_and_resumes_on_4x1(ranks):
    results = ranks.results()
    r0 = results[0]["fit"]
    assert r0["snapshot_equal"] and r0["moments_equal"]
    assert r0["moments_shapes_whole"]
    assert r0["shapes"]["PoseNet2D/conv4_1/weights"] == (256, 256, 3, 3)
    for r in results:
        resumed = r["fit"]["resumed"]
        assert resumed["step"] == 3
        assert resumed["snapshots"] == [3]
    lines = r0["resumed"]["lines"]
    assert lines[0].endswith("snapshot-2.pt at step 2"), lines
    assert any(l.startswith("Iteration 2\t") for l in lines), lines
    assert all(r["fit"]["resumed"]["lines"] == [] for r in results[1:])


# --- (10) the CLIs with --mesh 2x2 -------------------------------------------


@pytest.mark.parametrize("name", TRAINERS)
def test_trainer_cli_on_2x2(ranks, name):
    results = ranks.results()
    lines = results[0]["clis"][name]["lines"]
    assert any(LOSS_LINE.match(l) for l in lines), lines
    for r in results:
        assert r["clis"][name]["sharded"]
    assert all(r["clis"][name]["lines"] == [] for r in results[1:])


@pytest.mark.parametrize("name", EVAL_CLIS)
def test_eval_cli_on_2x2(ranks, name):
    results = ranks.results()
    lines = results[0]["clis"][name]["lines"]
    metrics = [l for l in lines if l.startswith(("Average", "Area"))]
    assert metrics, lines
    for r in results:
        assert [l for l in r["clis"][name]["lines"]
                if l.startswith(("Average", "Area"))] == metrics
    values = [float(v) for l in metrics
              for v in re.findall(r"-?\d+\.\d+", l)]
    assert np.isfinite(values).all()
