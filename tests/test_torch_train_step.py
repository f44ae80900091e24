"""Whole-network gradients and whole train steps of the four trainers against
hand3d_tpu's, on the CPU.

Each stage runs its trainer's fused loss (preprocess + forward) on two
records of the fixture at a small size, from JAX-initialized params. JAX
runs ``fuse_preprocess`` with a key; the port is fed the draws JAX makes
from that key's data half. Tolerances:

- loss: rtol 1e-5 (the features match at tests/test_torch_data.py's
  tolerances, and the networks sum their products in another order);
- gradients: 1e-5 of the tensor's largest |g|, float32 convolutions and
  their transposes summed in another order through the whole network
  (measured: 1.1e-6 to 4.6e-6 for HandSegNet and the lifting variants).
  Stages with PoseNet are an exception. Leaky ReLU and max pool have kinks,
  and PoseNet's random-init activations at a 32 px crop put some
  pre-activations within float32 rounding of a kink (measured: one of
  2.3e-10 among 8192 at conv4_4). Such a site takes the other branch in one
  framework, and every gradient upstream of it moves by up to a few % of
  its largest value (measured: 9.2e-3 for PoseNet, 2.8e-2 for joint, 1.8e-2
  with both fed JAX's features, where the port's float64 gradient sided
  with JAX). Their gradients are held to a relative L2 error of 2e-2 per
  tensor (measured: 4.1e-3 and 4.8e-3), which any wrong layer, transpose
  or loss term exceeds by orders of magnitude;
- one train step: Adam's first update is -lr * u(g) with u(g) =
  g / (|g| + eps) (the bias corrections cancel at step 1), so each side's
  params move by its own gradient's u: the two steps must agree within
  lr * |u(g_port) - u(g_jax)| + 4 float32 ulps of the param + 1e-3 lr.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from hand3d_tpu.cli import train_joint as j_joint
from hand3d_tpu.cli import train_posenet as j_train_posenet
from hand3d_tpu.cli import train_handsegnet as j_train_handsegnet
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.preprocess import preprocess_rhd as j_preprocess_rhd
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.models import handsegnet as j_handsegnet
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.models.poseprior import PosePriorNetwork as JaxPrior
from hand3d_tpu.train import lifting_loss as j_lifting_loss
from hand3d_tpu.train import trainer as j_trainer
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import (train_handsegnet, train_joint,
                                  train_lifting, train_posenet)
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models.poseprior import VARIANTS
from hand3d_tpu_torch.train import trainer

from fixtures import make_rhd_bin
from test_torch_train_data import jax_noise
from torch_threads import torch_threads_per_worker  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_RTOL_OF_MAX = 1e-5
KINK_FLIP_REL_L2 = 2e-2
KINK_FLIP_STAGES = ("posenet", "joint")
KEY = jax.random.PRNGKey(21)
CROP = dict(use_wrist_coord=False, hand_crop=True, coord_uv_noise=True,
            crop_center_noise=True)
LIFT_NOISE = dict(CROP, crop_offset_noise=True, crop_scale_noise=True)


def _jax_lifting_loss(variant):
    net = JaxPrior(variant)

    def loss_fn(params, batch, key):
        out = net.apply(params, batch["scoremap"], batch["hand_side"],
                        train=False, key=key)
        return j_lifting_loss(variant, out, batch)

    return loss_fn


# stage -> (port loss, JAX loss, config, JAX params of PRNGKey(0), lr)
def _stage(name):
    key = jax.random.PRNGKey(0)
    if name == "posenet":
        return (train_posenet.loss_fn, j_train_posenet.loss_fn,
                PreprocessConfig(**CROP, crop_size=32),
                {j_posenet.SCOPE: j_posenet.init(key)}, 1e-4)
    if name == "handsegnet":
        return (train_handsegnet.loss_fn, j_train_handsegnet.loss_fn,
                PreprocessConfig(hue_aug=True, random_crop_to_size=True,
                                 random_crop_size=48),
                {j_handsegnet.SCOPE: j_handsegnet.init(key)}, 1e-5)
    if name == "joint":
        loss, _ = train_joint.make_joint_loss("proposed", 1.0, 1.0)
        j_loss, prior = j_joint.make_joint_loss("proposed", 1.0, 1.0)
        k1, k2 = jax.random.split(key)
        return (loss, j_loss, PreprocessConfig(**LIFT_NOISE, crop_size=32),
                {j_posenet.SCOPE: j_posenet.init(k1), **prior.init(k2)}, 1e-5)
    variant = name.split(":")[1]
    return (train_lifting.make_loss(variant)[0], _jax_lifting_loss(variant),
            PreprocessConfig(**LIFT_NOISE),
            JaxPrior(variant).init(key), 1e-5)


STAGES = ["posenet", "handsegnet", "joint"] + [f"lifting:{v}"
                                                for v in VARIANTS]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    path = str(make_rhd_bin(tmp_path_factory.mktemp("step") / "t.bin",
                            num_records=2, seed=6))
    return (RHDDataset("training", path).raw_batch(np.arange(2)),
            JaxRHD("training", path).raw_batch(np.arange(2)))


@pytest.fixture(scope="module")
def jax_grads(raw):
    """stage -> JAX's (loss, grads) of its fused loss, computed once."""
    cache = {}

    def get(name, j_fused, np_params):
        if name not in cache:
            cache[name] = jax.jit(jax.value_and_grad(j_fused))(
                np_params, raw[1], KEY)
        return cache[name]

    return get


def _both(name, raw):
    """(port loss over raw batches fed JAX's draws, JAX fused loss, port
    params, JAX params, lr)."""
    loss, j_loss, cfg, j_params, lr = _stage(name)
    np_params = jax.tree_util.tree_map(np.asarray, j_params)
    k_data, _ = jax.random.split(KEY)  # as hand3d_tpu's fuse_preprocess
    noise = jax_noise(cfg, raw[1], k_data)

    def port_loss(params, batch, generator):
        return loss(params, preprocess_rhd(cfg, batch, noise), generator)

    j_fused = j_trainer.fuse_preprocess(
        j_loss, j_preprocess_rhd, JaxConfig(**dataclasses.asdict(cfg)))
    return (port_loss, j_fused, weights.params_from_jax(np_params, "cpu"),
            np_params, lr)


def _port_raw(raw):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in raw[0].items()}


def _flat(tree):
    """The leaves of a TF-layout tree in trainer.tree_leaves order."""
    flat = weights.tree_to_flat(tree)
    return [flat[p] for p in sorted(flat)]


def _tf_layout(grad):
    """A port gradient as numpy in the TF layout of its param."""
    return weights.params_to_jax({"g": grad})["g"]


@pytest.mark.parametrize("name", STAGES)
def test_stage_gradients_match_jax(raw, jax_grads, name):
    port_loss, j_fused, params, np_params, _ = _both(name, raw)
    want, want_g = jax_grads(name, j_fused, np_params)
    state = trainer.init_state(params, trainer.make_optimizer([1.0], []))
    got, got_g = trainer.value_and_grad(port_loss, state.params,
                                        _port_raw(raw), None)
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    paths = trainer.tree_paths(state.params)
    assert paths == sorted(weights.tree_to_flat(np_params))
    for path, g, w in zip(paths, got_g, _flat(
            jax.tree_util.tree_map(np.asarray, want_g))):
        g = _tf_layout(g)
        assert g.shape == w.shape, path
        # every layer gets a gradient: for joint, both stages
        assert np.abs(g).max() > 0 and np.abs(w).max() > 0, path
        if name in KINK_FLIP_STAGES:
            assert np.linalg.norm(g - w) <= KINK_FLIP_REL_L2 * \
                np.linalg.norm(w), path
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=GRAD_RTOL_OF_MAX * np.abs(w).max(),
                err_msg=path)
    if name == "joint":
        assert {p.split("/")[0] for p in paths} == {
            "PoseNet2D", "PosePrior", "ViewpointNet"}


def _adam_direction(g):
    """Adam's first update over -lr: the bias-corrected m / (sqrt(v) + eps)
    of step 1 is g / (|g| + eps)."""
    return g / (np.abs(g) + 1e-8)


@pytest.mark.parametrize("name", ["posenet", "handsegnet", "joint",
                                  "lifting:proposed"])
def test_one_train_step_matches_jax(raw, jax_grads, name):
    port_loss, j_fused, params, np_params, lr = _both(name, raw)
    lr_values, lr_steps = [lr, lr / 10], [5]
    j_opt = j_trainer.make_optimizer(lr_values, lr_steps)
    j_step = j_trainer.make_train_step(j_fused, j_opt, donate=False)
    j_state, j_metrics = j_step(j_trainer.init_state(np_params, j_opt),
                                raw[1], KEY)
    _, j_grads = jax_grads(name, j_fused, np_params)

    opt = trainer.make_optimizer(lr_values, lr_steps)
    state = trainer.init_state(params, opt)
    _, grads = trainer.value_and_grad(port_loss, state.params, _port_raw(raw),
                                      None)
    state, metrics = trainer.make_train_step(port_loss, opt)(
        state, _port_raw(raw), (0, 0))
    assert state.step == int(j_state.step) == 1
    assert metrics["loss"].item() == pytest.approx(float(j_metrics["loss"]),
                                                   rel=LOSS_RTOL)
    got = weights.tree_to_flat(weights.params_to_jax(state.params))
    want = weights.tree_to_flat(jax.tree_util.tree_map(np.asarray,
                                                       j_state.params))
    g_port = {p: _tf_layout(g)
              for p, g in zip(trainer.tree_paths(state.params), grads)}
    g_jax = weights.tree_to_flat(jax.tree_util.tree_map(np.asarray, j_grads))
    before = weights.tree_to_flat(np_params)
    for path, w in want.items():
        atol = (lr * np.abs(_adam_direction(g_port[path])
                            - _adam_direction(g_jax[path]))
                + 4 * np.spacing(np.abs(w)) + 1e-3 * lr)
        assert (np.abs(got[path] - w) <= atol).all(), path
        assert (got[path] != before[path]).any(), path  # the step moved it
