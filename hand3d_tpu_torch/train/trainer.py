"""Train-step machinery: Adam on the reference's LR schedule, gradient
accumulation, recompute (counterpart of hand3d_tpu/train/trainer.py).

A param tree is a dict of dicts of leaf tensors that require grad (the
layout of ``weights.params_from_jax``). Where the JAX package's step is a
pure function of its state, this one updates the tree and the Adam moments
in place and returns the state with its step counter advanced.

The step's randomness (augmentation draws of a fused preprocess, dropout
masks) comes from CPU generators named by the step's ``key``, a tuple of
non-negative integers (the loop passes (seed, step)): the same key gives the
same draws on the card and on the CPU.
"""

from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.data.preprocess import draw_noise
from hand3d_tpu_torch.train.schedule import piecewise_constant

# first word of the train step's generators, apart from the input pipeline's
STEP_STREAM = 1


class TrainState(NamedTuple):
    params: dict  # tree of leaf tensors that require grad
    opt_state: Any  # the torch.optim.Adam over the tree's leaves
    step: int  # updates applied so far


def tree_leaves(tree):
    """The tree's tensors in a fixed order (sorted keys, depth first)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def tree_paths(tree, prefix=""):
    """The '/'-joined paths of :func:`tree_leaves`, in its order."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        value = tree[key]
        out.extend(tree_paths(value, path) if isinstance(value, dict)
                   else [path])
    return out


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class ScheduledAdam:
    """Adam with b1 0.9, b2 0.999, eps 1e-8 (tf.train.AdamOptimizer's
    defaults) whose LR follows ``schedule`` at the state's step counter,
    read before each update: the first update uses schedule(0), as
    optax's count starts at 0."""

    def __init__(self, schedule):
        self.schedule = schedule

    def init(self, params):
        return torch.optim.Adam(tree_leaves(params), lr=self.schedule(0),
                                betas=(0.9, 0.999), eps=1e-8)

    def apply(self, opt, params, grads, step):
        """One update of ``params`` (in place) with ``grads``, in the order
        of :func:`tree_leaves`, at step counter ``step``."""
        for group in opt.param_groups:
            group["lr"] = self.schedule(step)
        for leaf, grad in zip(tree_leaves(params), grads):
            leaf.grad = grad
        opt.step()
        opt.zero_grad(set_to_none=True)


def make_optimizer(lr_values, lr_steps):
    """Adam on the reference's multistep LR schedule."""
    return ScheduledAdam(piecewise_constant(lr_steps, lr_values))


def init_state(params, optimizer):
    """A fresh TrainState over a copy of ``params`` (the caller's tree is
    left as it is, as in the JAX package). TF32 goes off first where the
    tree lies on a CUDA device."""
    precision.exact_f32(tree_leaves(params)[0].device)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    return TrainState(params, optimizer.init(params), 0)


def fuse_preprocess(loss_fn, preprocess_fn, cfg):
    """``loss_fn`` over preprocessed features -> a loss over raw record
    batches: the step's generator draws the augmentation noise first, then
    whatever the loss draws (dropout masks).

    Args:
      loss_fn: (params, batch, generator) -> scalar tensor.
      preprocess_fn: data.preprocess.preprocess_rhd or preprocess_stb.
      cfg: the PreprocessConfig.
    """

    def fused(params, raw, generator):
        noise = draw_noise(cfg, raw, generator) if cfg.needs_rng else None
        return loss_fn(params, preprocess_fn(cfg, raw, noise), generator)

    return fused


def value_and_grad(loss_fn, params, batch, generator, remat=False):
    """(loss, grads in :func:`tree_leaves` order) of
    ``loss_fn(params, batch, generator)``.

    ``remat=True`` keeps no activations: ``torch.utils.checkpoint`` runs the
    forward again in the backward pass. The generator is rewound for that
    second forward, so it draws the same noise and masks.
    """
    if remat:
        start = generator.get_state()

        def forward(params, batch):
            generator.set_state(start)
            return loss_fn(params, batch, generator)

        loss = torch.utils.checkpoint.checkpoint(forward, params, batch,
                                                 use_reentrant=False)
    else:
        loss = loss_fn(params, batch, generator)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), grads


def make_train_step(loss_fn, optimizer, remat=False, accum_steps=1):
    """``step(state, batch, key) -> (state, {"loss": tensor})`` for
    ``loss_fn(params, batch, generator) -> scalar``.

    ``remat=True`` recomputes activations in the backward pass instead of
    storing them. The JAX package's named jax.checkpoint policies have no
    counterpart yet (ROADMAP.md 'Still to port', queue 1) and raise.

    ``accum_steps > 1`` splits the batch's leading axis into that many equal
    microbatches, averages their gradients (and losses) and applies ONE
    update; activations live one microbatch at a time. Microbatch j draws
    from its own generator, (key, j). For a loss that is a mean over samples
    this equals the full-batch step; the PoseNet loss normalizes by the
    batch's visibility count, so there it is the mean of microbatch losses.
    """
    if isinstance(remat, str):
        raise NotImplementedError(
            f"remat policy {remat!r}: only boolean remat is ported; the "
            "named recompute policies wait for ROADMAP.md 'Still to port', "
            "queue 1")
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")

    def grads_of(params, batch, key):
        if accum_steps == 1:
            return value_and_grad(
                loss_fn, params, batch,
                augment.generator(STEP_STREAM, *key), remat)
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch axis {n} not divisible by accum_steps "
                             f"{accum_steps}")
        m = n // accum_steps
        loss_sum, grad_sum = None, None
        for j in range(accum_steps):
            micro = {k: v[j * m:(j + 1) * m] for k, v in batch.items()}
            loss, grads = value_and_grad(
                loss_fn, params, micro,
                augment.generator(STEP_STREAM, *key, j), remat)
            if grad_sum is None:
                loss_sum, grad_sum = loss, list(grads)
            else:
                loss_sum = loss_sum + loss
                grad_sum = [a + g for a, g in zip(grad_sum, grads)]
        inv = 1.0 / accum_steps
        return loss_sum * inv, [g * inv for g in grad_sum]

    def step(state, batch, key):
        loss, grads = grads_of(state.params, batch, key)
        optimizer.apply(state.opt_state, state.params, grads, state.step)
        return state._replace(step=state.step + 1), {"loss": loss}

    return step
