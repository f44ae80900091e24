"""The port's losses, LR schedule, Adam and train-step mechanics against
hand3d_tpu's, on the CPU.

Tolerances, each from float32 sums taken in another order:
- loss values: rtol 1e-6 (a handful of reductions);
- gradients of a loss with respect to its inputs: 1e-6 of the tensor's
  largest |g|;
- accumulated against full-batch gradients of the same network: 1e-5 of the
  largest |g| (four microbatch sums added in another order than one batch
  sum; measured 1.1e-6);
- Adam: both sides get the same gradients at every step, so the params
  differ only by the rounding of the update (optax computes the bias
  corrections in float32, torch in float64): atol 4 float32 ulps of 1.
Whole-network gradients and whole train steps are in
tests/test_torch_train_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hand3d_tpu.models.poseprior import LiftingOutput as JaxLiftingOutput
from hand3d_tpu.models.poseprior import PosePriorNetwork as JaxPrior
from hand3d_tpu.train import losses as j_losses
from hand3d_tpu.train.schedule import piecewise_constant as j_piecewise
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.models.poseprior import VARIANTS, LiftingOutput
from hand3d_tpu_torch.models.poseprior import PosePriorNetwork
from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.train import losses, trainer
from hand3d_tpu_torch.train.schedule import piecewise_constant

from torch_threads import torch_threads_per_worker  # noqa: F401

LOSS_RTOL = 1e-6
GRAD_RTOL_OF_MAX = 1e-6
ADAM_ATOL = 4 * 2.0 ** -23
ACCUM_RTOL_OF_MAX = 1e-5


def assert_grads_close(got, want, rtol_of_max=GRAD_RTOL_OF_MAX):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rtol_of_max * np.abs(w).max())


def torch_value_and_grad(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = fn(*ts)
    grads = torch.autograd.grad(loss, ts)
    return loss.item(), [g.numpy() for g in grads]


def test_piecewise_constant_matches_jax():
    steps, values = [3, 7], [1e-4, 1e-5, 1e-6]
    got, want = piecewise_constant(steps, values), j_piecewise(steps, values)
    for s in range(10):
        assert got(s) == pytest.approx(float(want(s)), rel=1e-7), s
    assert [got(s) for s in (2, 3, 6, 7)] == [1e-4, 1e-5, 1e-5, 1e-6]
    with pytest.raises(ValueError, match="one more value"):
        piecewise_constant([1, 2], [1e-4])


def test_posenet_scoremap_loss_matches():
    rng = np.random.default_rng(0)
    preds = [rng.standard_normal((2, 4, 4, 21)).astype(np.float32) * 0.1
             for _ in range(3)]
    gt = rng.random((2, 32, 32, 21), np.float32)
    vis = rng.random((2, 21)) > 0.3
    want, want_g = jax.value_and_grad(
        lambda *p: j_losses.posenet_scoremap_loss(list(p), gt, vis),
        argnums=(0, 1, 2))(*preds)
    got, got_g = torch_value_and_grad(
        lambda *p: losses.posenet_scoremap_loss(list(p), torch.from_numpy(gt),
                                                torch.from_numpy(vis)), *preds)
    assert got == pytest.approx(float(want), rel=LOSS_RTOL)
    assert_grads_close(got_g, want_g)


def test_handsegnet_loss_matches():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    fg = rng.random((2, 8, 8)) > 0.5
    mask = np.stack([~fg, fg], -1).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda x: j_losses.handsegnet_loss([x], mask))(logits)
    got, got_g = torch_value_and_grad(
        lambda x: losses.handsegnet_loss([x], torch.from_numpy(mask)), logits)
    assert got == pytest.approx(float(want), rel=LOSS_RTOL)
    assert_grads_close(got_g, [want_g])


@pytest.mark.parametrize("variant", VARIANTS)
def test_lifting_loss_matches(variant):
    rng = np.random.default_rng(2)
    coord3d = rng.standard_normal((3, 21, 3)).astype(np.float32)
    rot = rng.standard_normal((3, 3, 3)).astype(np.float32)
    batch = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("keypoint_xyz21_normed", (3, 21, 3)),
        ("keypoint_xyz21_local", (3, 21, 3)),
        ("keypoint_xyz21_can", (3, 21, 3)), ("rot_mat", (3, 3, 3)))}
    want, want_g = jax.value_and_grad(
        lambda c, r: j_losses.lifting_loss(
            variant, JaxLiftingOutput(c, c, r), batch),
        argnums=(0, 1), allow_int=True)(coord3d, rot)
    got, got_g = torch_value_and_grad(
        lambda c, r: losses.lifting_loss(
            variant, LiftingOutput(c, c, r),
            {k: torch.from_numpy(v) for k, v in batch.items()}), coord3d, rot) \
        if variant == "proposed" else torch_value_and_grad(
            lambda c: losses.lifting_loss(
                variant, LiftingOutput(c, c, None),
                {k: torch.from_numpy(v) for k, v in batch.items()}), coord3d)
    assert got == pytest.approx(float(want), rel=LOSS_RTOL)
    assert_grads_close(got_g, want_g[:len(got_g)])
    with pytest.raises(ValueError, match="Unknown variant"):
        losses.lifting_loss("nope", LiftingOutput(None, None, None), {})


def _adam_tree(rng):
    return {"A": {"conv": {"weights": rng.standard_normal((3, 3, 2, 4)),
                           "biases": rng.standard_normal(4)},
                  "fc": {"weights": rng.standard_normal((5, 3)),
                         "biases": rng.standard_normal(3)}}}


def test_adam_on_the_schedule_matches_optax_across_boundaries():
    """Six updates with LR boundaries after steps 2 and 4, both sides fed
    the same gradients (some tiny, where Adam's g / (|g| + eps) is not
    sign-like)."""
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                  _adam_tree(rng))
    lr_values, lr_steps = [1e-2, 1e-3, 1e-4], [2, 4]
    opt = optax.adam(j_piecewise(lr_steps, lr_values), b1=0.9, b2=0.999,
                     eps=1e-8)
    j_params, j_state = tree, opt.init(tree)
    state = trainer.init_state(weights.params_from_jax(tree, "cpu"),
                               trainer.make_optimizer(lr_values, lr_steps))
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape)
                       * (1e-8 if step == 1 else 1.0)).astype(np.float32),
            tree)
        updates, j_state = opt.update(grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        port_grads = trainer.tree_leaves(weights.params_from_jax(grads, "cpu"))
        trainer.make_optimizer(lr_values, lr_steps).apply(
            state.opt_state, state.params, port_grads, state.step)
        state = state._replace(step=state.step + 1)
        got = weights.tree_to_flat(weights.params_to_jax(state.params))
        want = weights.tree_to_flat(j_params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=ADAM_ATOL, err_msg=f"{k} @ {step}")
    moved = weights.tree_to_flat(weights.params_to_jax(state.params))
    assert any((moved[k] != weights.tree_to_flat(tree)[k]).all()
               for k in moved)


def _lifting_batch(rng, b):
    return {"scoremap": torch.from_numpy(
                rng.random((b, 32, 32, 21), np.float32)),
            "hand_side": torch.from_numpy(
                np.eye(2, dtype=np.float32)[rng.integers(0, 2, b)]),
            "keypoint_xyz21_can": torch.from_numpy(
                rng.standard_normal((b, 21, 3)).astype(np.float32)),
            "rot_mat": torch.from_numpy(
                rng.standard_normal((b, 3, 3)).astype(np.float32))}


def _lifting_loss(train):
    net = PosePriorNetwork("proposed")

    def loss_fn(params, batch, generator):
        out = net.apply(params, batch["scoremap"], batch["hand_side"],
                        train=train, generator=generator)
        return losses.lifting_loss("proposed", out, batch)

    return loss_fn


class RecordGrads:
    """An optimizer stand-in that keeps the gradients it is given."""

    def init(self, params):
        return None

    def apply(self, opt, params, grads, step):
        self.grads = [g.clone() for g in grads]


def _step_grads(loss_fn, batch, key=(0, 0), **kw):
    params = weights.params_from_jax(
        weights.random_lifting_params("proposed", 4), "cpu")
    rec = RecordGrads()
    state = trainer.init_state(params, rec)
    state, metrics = trainer.make_train_step(loss_fn, rec, **kw)(
        state, batch, key)
    assert state.step == 1
    return metrics["loss"], rec.grads


def test_accumulation_equals_the_full_batch_and_checks_divisibility():
    batch = _lifting_batch(np.random.default_rng(5), 4)
    loss1, full = _step_grads(_lifting_loss(False), batch)
    loss4, accum = _step_grads(_lifting_loss(False), batch, accum_steps=4)
    assert loss4.item() == pytest.approx(loss1.item(), rel=1e-6)
    assert_grads_close([g.numpy() for g in accum], [g.numpy() for g in full],
                       ACCUM_RTOL_OF_MAX)
    with pytest.raises(ValueError, match="not divisible"):
        _step_grads(_lifting_loss(False), batch, accum_steps=3)


def test_remat_gives_equal_gradients_and_draws_equal_masks():
    """Recompute reruns the forward in the backward pass; the generator is
    rewound for it, so the dropout masks are the ones the loss saw."""
    batch = _lifting_batch(np.random.default_rng(6), 2)
    loss, plain = _step_grads(_lifting_loss(True), batch)
    loss_r, remat = _step_grads(_lifting_loss(True), batch, remat=True)
    assert torch.equal(loss, loss_r)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)
    # another key draws other masks
    other, _ = _step_grads(_lifting_loss(True), batch, key=(0, 1))
    assert not torch.equal(loss, other)
    with pytest.raises(NotImplementedError, match="What training left out"):
        trainer.make_train_step(_lifting_loss(True), RecordGrads(),
                                remat="dots_saveable")


def test_lifting_dropout_matches_jax_with_its_masks(monkeypatch):
    """train=True: PosePrior's two keep-0.8 masks, then ViewpointNet's two
    keep-0.75 masks, replayed from JAX's keys."""
    j_net = JaxPrior("proposed")
    j_params = j_net.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    sm = rng.random((2, 32, 32, 21), np.float32)
    hand_side = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    key = jax.random.PRNGKey(8)
    want = j_net.apply(j_params, jnp.asarray(sm), jnp.asarray(hand_side),
                       train=True, key=key)
    kp, kv = jax.random.split(key)
    masks = []
    for k, keep, width in ((kp, 0.8, 512), (kv, 0.75, 256)):
        k0, k1 = jax.random.split(k)
        masks += [np.asarray(jax.random.bernoulli(k0, keep, (2, width))),
                  np.asarray(jax.random.bernoulli(
                      k1, keep, (2, 512 if keep == 0.8 else 128)))]
    replay = iter(masks)
    monkeypatch.setattr(nn, "keep_mask", lambda g, p, shape, device:
                        torch.from_numpy(next(replay)))
    got = PosePriorNetwork("proposed").apply(
        weights.params_from_jax(jax.tree_util.tree_map(np.asarray, j_params),
                                "cpu"),
        torch.from_numpy(sm), torch.from_numpy(hand_side), train=True,
        generator=augment.generator(0))
    assert next(replay, None) is None  # all four masks drawn, in order
    for g, w in ((got.coord3d, want.coord3d), (got.rot_mat, want.rot_mat)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
