"""Train-step machinery: Adam on the reference's LR schedule, gradient
accumulation, recompute policies, and the device-resident multi-step step
(counterpart of hand3d_tpu/train/trainer.py).

A param tree is a dict of dicts of leaf tensors that require grad (the
layout of ``weights.params_from_jax``). Where the JAX package's step is a
pure function of its state, this one updates the tree and the Adam moments
in place and returns the state with its step counter advanced.

The step's randomness (augmentation draws of a fused preprocess, dropout
masks) comes from CPU generators named by the step's ``key``, a tuple of
non-negative integers (the loop passes (seed, step)): the same key gives the
same draws on the card and on the CPU. The resident step takes the same
values from a plan made ahead on the host (``train/draws.py``).

The one-card and resident steps share one core (``_make_step_core``, as in
the JAX package); it and ``DataParallelGrads`` share the microbatch sum
(``_sum_microbatches``, ``_mean``). Every step updates with
``ScheduledAdam.apply``, which reads its LR and bias corrections from the
step counter in the Adam state, on the params' device, so a CUDA graph can
replay it. The two graphed steps share ``_GraphStep``: the tensors a graph
is bound to, its warm-up and capture, and its counted replays.

``make_train_step(mesh=)`` is the data-parallel step: each rank is fed its
rows of the global batch, and the step is the one a single process takes on
that global batch, up to float reassociation (``DataParallelGrads``). On a
mesh with a "model" axis the state is first sharded (``shard_state``) and
gathered whole again for a snapshot (``gather_state``).

The data-parallel step is a CUDA graph where it can be one: params on a
CUDA device, NCCL ranks and no "model" axis (``DataParallelStep``). Each
call then replays one captured step, collectives included, with the draws
of its key planned on the host as the resident step plans them, and
returns its loss as a ``StepLoss``: a copy to pinned host memory under an
event, so that reading one step's loss waits for that step alone and the
step launched after it stays queued on the card. Gloo ranks (several on
one card), the CPU and tensor-parallel meshes take the eager step, as does
a batch of other shapes than the first; they return device tensors.

A step of :func:`make_train_step` is the span ``train.step``
(``utils.profiling``), around the whole call, replay included; the core a
resident step captures holds no span.
"""

import functools
import itertools
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from hand3d_tpu_torch import precision
from hand3d_tpu_torch.data.preprocess import draw_noise
from hand3d_tpu_torch.ops.numerics import device_constant
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train import draws, losses
from hand3d_tpu_torch.train.draws import STEP_STREAM  # noqa: F401
from hand3d_tpu_torch.train.schedule import piecewise_constant
from hand3d_tpu_torch.utils import profiling

B1, B2, EPS = 0.9, 0.999, 1e-8  # tf.train.AdamOptimizer's defaults
WARMUP_STEPS = 2  # eager steps on a throwaway state before a capture


class TrainState(NamedTuple):
    params: dict  # tree of leaf tensors that require grad
    opt_state: Any  # the torch.optim.Adam over the tree's leaves
    step: int  # updates applied so far


def tree_leaves(tree):
    """The tree's tensors in a fixed order (sorted keys, depth first); a
    sharded layer's ModelShard is not a leaf."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(tree_leaves(value))
        elif mesh_lib.is_leaf(value):
            out.append(value)
    return out


def tree_paths(tree, prefix=""):
    """The '/'-joined paths of :func:`tree_leaves`, in its order."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        value = tree[key]
        if isinstance(value, dict):
            out.extend(tree_paths(value, path))
        elif mesh_lib.is_leaf(value):
            out.append(path)
    return out


def tree_unflatten(tree, leaves):
    """``tree`` with its leaves, in :func:`tree_leaves` order, replaced by
    ``leaves`` (gradients, say); a layer's ModelShard is kept, so a sharded
    tree's gradients can be gathered whole (``parallel.gather_params``)."""
    it = iter(leaves)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict)
                else next(it) if mesh_lib.is_leaf(t[k]) else t[k]
                for k in sorted(t)}

    return walk(tree)


def tree_map(fn, tree):
    """``fn`` of every leaf; a layer's ModelShard is kept as it is."""
    return {k: tree_map(fn, v) if isinstance(v, dict)
            else fn(v) if mesh_lib.is_leaf(v) else v
            for k, v in tree.items()}


class ScheduledAdam:
    """Adam with b1 0.9, b2 0.999, eps 1e-8 (tf.train.AdamOptimizer's
    defaults) whose LR follows ``piecewise_constant(steps, values)`` at the
    update count: the first update uses the LR of step 0, as optax's count
    starts at 0.

    The state is a ``torch.optim.Adam``'s (its ``state_dict`` is what
    snapshots hold), but the update is :meth:`apply`: torch's foreach ops
    on the state's tensors, which reads the LR and the bias corrections from
    the state's step counter on the params' device, and never the host.
    """

    def __init__(self, steps, values):
        self.schedule = piecewise_constant(steps, values)
        self.bounds = tuple(float(b) for b in steps)
        self.values = tuple(float(v) for v in values)

    def init(self, params):
        return torch.optim.Adam(tree_leaves(params), lr=self.schedule(0),
                                betas=(B1, B2), eps=EPS)

    @staticmethod
    def prepare(opt, leaves):
        """Adam's state of every leaf, made (zero moments, step 0) where it
        is missing, and its step counter moved onto the leaf's device (a
        snapshot restores it on the CPU)."""
        out = []
        for p in leaves:
            state = opt.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32,
                                            device=p.device)
                state["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            elif state["step"].device != p.device:
                state["step"] = state["step"].to(p.device, torch.float32)
            out.append(state)
        return out

    def lr(self, count):
        """The schedule's LR (float64) at update count ``count`` (a tensor),
        on its device."""
        count = count.to(torch.float64)
        bounds = device_constant(self.bounds, torch.float64, count.device)
        values = device_constant(self.values, torch.float64, count.device)
        return values.index_select(0, (count >= bounds).sum().view(1))[0]

    def apply(self, opt, params, grads, step=None):
        """One update of ``params`` (in place) with ``grads``, in the order
        of :func:`tree_leaves`; returns the LR it took (a float64 tensor on
        the params' device). ``step``, the host's count, only labels the
        param group's ``lr`` (what the state_dict shows); the update takes
        its count from the state."""
        leaves = tree_leaves(params)
        states = self.prepare(opt, leaves)
        steps = [s["step"] for s in states]
        exp_avgs = [s["exp_avg"] for s in states]
        exp_avg_sqs = [s["exp_avg_sq"] for s in states]
        grads = list(grads)
        with torch.no_grad():
            lr = self.lr(steps[0])
            torch._foreach_add_(steps, 1.0)
            count = steps[0].to(torch.float64)
            # torch.optim.Adam's order of operations (single-tensor form),
            # its host floats made float64 tensors
            bias1 = 1.0 - torch.pow(B1, count)
            bias2_sqrt = (1.0 - torch.pow(B2, count)).sqrt()
            neg_step_size = (-(lr / bias1)).to(torch.float32)
            torch._foreach_lerp_(exp_avgs, grads, 1.0 - B1)
            torch._foreach_mul_(exp_avg_sqs, B2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1.0 - B2)
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bias2_sqrt.to(torch.float32))
            torch._foreach_add_(denom, EPS)
            update = torch._foreach_div(exp_avgs, denom)
            torch._foreach_mul_(update, neg_step_size)
            torch._foreach_add_(leaves, update)
        if step is not None:
            self.label(opt, step)
        return lr

    def label(self, opt, step):
        """Set the param group's ``lr`` (what the state_dict shows) to the
        schedule's at the host's count ``step``."""
        for group in opt.param_groups:
            group["lr"] = self.schedule(step)


def make_optimizer(lr_values, lr_steps):
    """Adam on the reference's multistep LR schedule."""
    return ScheduledAdam(lr_steps, lr_values)


def init_state(params, optimizer):
    """A fresh TrainState over a copy of ``params`` (the caller's tree is
    left as it is, as in the JAX package). TF32 goes off first where the
    tree lies on a CUDA device."""
    precision.exact_f32(tree_leaves(params)[0].device)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
    return TrainState(params, optimizer.init(params), 0)


def shard_state(mesh, state):
    """``state`` (whole params and Adam state, as :func:`init_state` makes
    it) with tensor parallelism over ``mesh``'s "model" axis: the params
    this rank's slices (``parallel.mesh.shard_params``) and the Adam
    moments sliced the same way, as the JAX package's ``shard_state``. A
    mesh whose "model" axis is 1 returns ``state``."""
    if mesh_lib.model_size(mesh) == 1:
        return state
    local = mesh_lib.shard_params(mesh, tree_map(
        lambda t: t.detach().clone(), state.params))
    local = tree_map(lambda t: t.requires_grad_(True), local)
    return _state_over(
        state, local,
        lambda k, v, slot: (v if k == "step" else _block(v, slot)).clone(),
        _leaf_shards(local))


def gather_state(mesh, state):
    """The whole TrainState of a sharded one (:func:`shard_state`): params
    and Adam moments all-gathered over "model" (a collective: every rank
    calls it). What a snapshot holds, whatever the mesh."""
    if not mesh_lib.is_sharded(state.params):
        return state
    from hand3d_tpu_torch.parallel import collectives

    whole = tree_map(lambda t: t.requires_grad_(True),
                     mesh_lib.gather_params(mesh, state.params))
    return _state_over(
        state, whole,
        lambda k, v, slot: (v.clone() if k == "step" or slot is None else
                            collectives.all_gather(v, slot[0].group, slot[1])),
        _leaf_shards(state.params))


def _state_over(state, params, moment, slots=None):
    """A TrainState over ``params``, whose leaves stand one for one for those
    of ``state.params``: an Adam with ``state``'s LR, betas and eps, and each
    leaf's moments ``moment(name, tensor, slot)`` of the old leaf's, ``slot``
    its entry of ``slots`` (:func:`_leaf_shards`; None if not given)."""
    opt = state.opt_state
    group = opt.param_groups[0]
    new = torch.optim.Adam(tree_leaves(params), lr=group["lr"],
                           betas=group["betas"], eps=group["eps"])
    pairs = zip(tree_leaves(state.params), tree_leaves(params))
    for (old, leaf), slot in zip(pairs, slots or itertools.repeat(None)):
        moments = opt.state.get(old)
        if moments:
            new.state[leaf] = {k: moment(k, v, slot)
                               for k, v in moments.items()}
    return TrainState(params, new, state.step)


def _leaf_shards(tree):
    """(ModelShard, dim) of each leaf of :func:`tree_leaves`, in its order,
    or None for a replicated leaf."""
    shard = tree.get(mesh_lib.SHARD_KEY)
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(_leaf_shards(value))
        elif mesh_lib.is_leaf(value):
            dim = shard.dim(key) if shard is not None else None
            out.append(None if dim is None else (shard, dim))
    return out


def _block(t, slot):
    if slot is None:
        return t
    shard, dim = slot
    return t.chunk(shard.size, dim)[shard.index]


def fuse_preprocess(loss_fn, preprocess_fn, cfg):
    """``loss_fn`` over preprocessed features -> a loss over raw record
    batches: the step's generator (or draw source) draws the augmentation
    noise first, then whatever the loss draws (dropout masks).

    Args:
      loss_fn: (params, batch, generator) -> scalar tensor.
      preprocess_fn: data.preprocess.preprocess_rhd or preprocess_stb.
      cfg: the PreprocessConfig.
    """

    def fused(params, raw, generator):
        noise = draw_noise(cfg, raw, generator) if cfg.needs_rng else None
        return loss_fn(params, preprocess_fn(cfg, raw, noise), generator)

    return fused


# --- recompute policies ----------------------------------------------------

_ATEN = torch.ops.aten
# dot_general and conv_general_dilated of the JAX package's policies
DOTS = frozenset({_ATEN.convolution.default, _ATEN.mm.default,
                  _ATEN.addmm.default, _ATEN.bmm.default})
# dot_general without batch dimensions: 2-D matmuls, no convolution
DOTS_NO_BATCH = frozenset({_ATEN.mm.default, _ATEN.addmm.default})

# jax.checkpoint_policies name -> what is saved: "all" (no recompute),
# "none" (everything recomputed) or the ops whose outputs are saved
REMAT_POLICIES = {
    "everything_saveable": "all",
    "nothing_saveable": "none",
    "dots_saveable": DOTS,
    "checkpoint_dots": DOTS,
    "dots_with_no_batch_dims_saveable": DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": DOTS_NO_BATCH,
}
# jax.checkpoint_policies entries that are policy factories: used as a
# policy, JAX calls them with a primitive's parameters and raises
REMAT_FACTORIES = ("offload_dot_with_no_batch_dims",
                   "save_and_offload_only_these_names",
                   "save_any_names_but_these",
                   "save_anything_except_these_names",
                   "save_from_both_policies", "save_only_these_names")


def remat_saves(remat):
    """What ``remat`` (False, True or a jax.checkpoint_policies name) keeps
    for the backward pass: "all", "none" or a set of aten ops.

    Raises for the names JAX cannot run as a policy: a factory (it takes
    names or offload targets that no CLI string gives; JAX raises
    TypeError for it) and a name JAX does not have ("unknown remat policy",
    JAX's words).
    """
    if remat is False or remat is None:
        return "all"
    if remat is True:
        return "none"
    if remat in REMAT_FACTORIES:
        raise TypeError(
            f"remat policy {remat!r} is a policy factory: "
            f"{remat}() got an unexpected keyword argument "
            "'dimension_numbers' (as jax.checkpoint raises for it); it "
            "takes arguments that no --remat string can give")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; see "
                         "jax.checkpoint_policies")
    return REMAT_POLICIES[remat]


def _save_ops(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def value_and_grad(loss_fn, params, batch, generator, remat=False):
    """(loss, grads in :func:`tree_leaves` order) of
    ``loss_fn(params, batch, generator)``.

    ``remat`` (see :func:`remat_saves`) recomputes activations in the
    backward pass: ``torch.utils.checkpoint`` runs the forward again, with
    a named policy keeping the outputs of the ops it saves. The generator
    (or draw source) is rewound for that second forward, so it draws the
    same noise and masks.
    """
    saves = remat_saves(remat)
    if saves == "all":
        loss = loss_fn(params, batch, generator)
    else:
        start = generator.get_state()

        def forward(params, batch):
            generator.set_state(start)
            return loss_fn(params, batch, generator)

        kw = {}
        if saves != "none":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts,
                functools.partial(_save_ops, saves))
        # the draws come from the generator or the plan, never from torch's
        # global RNG, so there is no RNG state to keep (and a CUDA graph
        # capture must not read it)
        loss = torch.utils.checkpoint.checkpoint(
            forward, params, batch, use_reentrant=False,
            preserve_rng_state=False, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), grads


# --- the steps ---------------------------------------------------------------


def _check_step_args(remat, accum_steps):
    remat_saves(remat)  # an unknown policy raises here, not at step 0
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")


def _sum_microbatches(accum_steps, grads_of):
    """The sum of ``grads_of(j) -> (loss, grads)`` over the microbatches j in
    turn; a microbatch for which it returns None adds nothing."""
    loss_sum, grad_sum = None, None
    for j in range(accum_steps):
        got = grads_of(j)
        if got is None:
            continue
        loss, grads = got
        if grad_sum is None:
            loss_sum, grad_sum = loss, list(grads)
        else:
            loss_sum = loss_sum + loss
            grad_sum = [a + g for a, g in zip(grad_sum, grads)]
    return loss_sum, grad_sum


def _mean(loss, grads, accum_steps):
    if accum_steps == 1:
        return loss, grads
    inv = 1.0 / accum_steps
    return loss * inv, [g * inv for g in grads]


def _make_step_core(loss_fn, optimizer, remat=False, accum_steps=1):
    """``core(params, opt, batch, sources, step) -> (loss, lr)``: the
    gradients of ``loss_fn`` (source j draws for microbatch j) and one
    update, which returns the LR it took; shared by :func:`make_train_step`
    and :func:`make_resident_train_step`."""
    _check_step_args(remat, accum_steps)

    def core(params, opt, batch, sources, step):
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"batch axis {n} not divisible by accum_steps "
                             f"{accum_steps}")
        m = n // accum_steps

        def grads_of(j):
            micro = {k: v[j * m:(j + 1) * m] for k, v in batch.items()}
            return value_and_grad(loss_fn, params, micro, sources[j], remat)

        loss, grads = _mean(*_sum_microbatches(accum_steps, grads_of),
                            accum_steps)
        return loss, optimizer.apply(opt, params, grads, step)

    return core


def make_train_step(loss_fn, optimizer, remat=False, accum_steps=1,
                    mesh=None):
    """``step(state, batch, key) -> (state, {"loss": tensor})`` for
    ``loss_fn(params, batch, generator) -> scalar``.

    ``remat``: True recomputes activations in the backward pass instead of
    storing them; a jax.checkpoint_policies name picks what is kept
    (:func:`remat_saves`): ``dots_saveable`` keeps the outputs of
    convolutions and matmuls and recomputes the rest.

    ``accum_steps > 1`` splits the batch's leading axis into that many equal
    microbatches, averages their gradients (and losses) and applies ONE
    update; activations live one microbatch at a time. Microbatch j draws
    from its own generator, (key, j). For a loss that is a mean over samples
    this equals the full-batch step; the PoseNet loss normalizes by the
    batch's visibility count, so there it is the mean of microbatch losses.

    ``mesh`` (``parallel.make_mesh`` or ``make_multislice_mesh``): the
    data-parallel step (:class:`DataParallelStep`). ``batch`` is this rank's
    rows of the global batch (``InputPipeline`` shards it), and the
    gradients and loss are the global batch's (``DataParallelGrads``); every
    rank then applies the same update. With a "model" axis the state must be
    sharded (:func:`shard_state`): sharded params keep sharded gradients and
    Adam moments.
    """
    if mesh is not None:
        return DataParallelStep(loss_fn, optimizer, mesh, remat, accum_steps)
    core = _make_step_core(loss_fn, optimizer, remat, accum_steps)

    def step(state, batch, key):
        with profiling.span("train.step"):
            sources = [draws.step_generator(key, j, accum_steps)
                       for j in range(accum_steps)]
            loss, _ = core(state.params, state.opt_state, batch, sources,
                           state.step)
            return state._replace(step=state.step + 1), {"loss": loss}

    return step


class DataParallelGrads:
    """``grads(params, batch, key) -> (loss, grads)`` of the GLOBAL batch on
    ``mesh``, given this rank's rows of it, as GSPMD computes them in the
    JAX package.

    The global batch is the ranks' rows in rank order. Its microbatch j
    (``accum_steps``) is rows ``[j * m, (j + 1) * m)``; a rank runs the rows
    of it that it holds, and skips a microbatch it holds none of. Each
    rank's loss is its share of the global one (``losses.batch_share``):
    a batch-coupled normalizer such as PoseNet's visibility count is
    all-reduced before the division, and a mean over the batch takes the
    rank's share of its rows. A rank that skips a microbatch joins its
    normalizers' all-reduces with zeros, their shapes recorded once by a
    one-row forward. The draws are those of the global microbatch
    (``draws.Rows`` over ``draws.step_generator(key, j, accum_steps)``).
    The ranks' gradients and losses are then summed with ONE all-reduce
    over a flat bucket: every rank holds the same sums, bit for bit, and
    its Adam update is the same.

    On a mesh with a "model" axis (tensor parallelism, params from
    :func:`shard_state`) the ranks of a "model" group hold the same rows
    and compute the same replicated tensors; a sharded layer's gradient is
    the rank's slice. The sum runs over the batch axes only
    (``parallel.mesh.batch_group``): summing over "model" as well would
    count a replicated param's gradient M times. A replicated param's
    gradient is then the first "model" rank's on all of them
    (``agree_over_model``), so the ranks' replicated params stay bit-equal
    where the card's backward convolutions are not deterministic.
    """

    def __init__(self, loss_fn, mesh, remat=False, accum_steps=1):
        _check_step_args(remat, accum_steps)
        self.loss_fn = loss_fn
        self.mesh = mesh
        self.remat = remat
        self.accum_steps = accum_steps
        self.group = mesh_lib.batch_group(mesh)
        self.recorded = None  # the normalizers' shapes, once recorded

    def _record(self, params, batch):
        if self.recorded is None:
            share = losses.BatchShare(self.group, 1, 1, record=True)
            one = {k: v[:1] for k, v in batch.items()}
            with torch.no_grad(), losses.batch_share(share):
                self.loss_fn(params, one, torch.Generator().manual_seed(0))
            self.recorded = share.recorded
        return self.recorded

    def _parts(self, batch):
        """(lo, m, parts): this rank's first row of the global batch, the
        global microbatch's rows, and for each microbatch j the global rows
        ``[a, b)`` of it that this rank holds (none where ``b <= a``)."""
        a_steps = self.accum_steps
        n = next(iter(batch.values())).shape[0]
        total = n * mesh_lib.batch_shard_count(self.mesh)
        lo = mesh_lib.data_index(self.mesh) * n
        if total % a_steps:
            raise ValueError(f"batch axis {total} not divisible by "
                             f"accum_steps {a_steps}")
        m = total // a_steps
        return lo, m, [(max(lo, j * m), min(lo + n, (j + 1) * m))
                       for j in range(a_steps)]

    def draw_calls(self, params, batch):
        """The draws of each global microbatch of a step (``draws.record``,
        at the global microbatch's shapes); none for a microbatch this rank
        holds no row of."""
        lo, m, parts = self._parts(batch)
        micro = [{k: v[a - lo:b - lo] for k, v in batch.items()}
                 if b > a else None for a, b in parts]
        return draws.record(
            self.loss_fn, params, micro,
            lambda j, rec: draws.Rows(rec, m, parts[j][0] - j * m,
                                      parts[j][1] - parts[j][0]))

    def __call__(self, params, batch, key, sources=None):
        """``sources``: each global microbatch's draw source (a planned
        one, ``draws.Planned``); by default the generators of ``key``."""
        a_steps = self.accum_steps
        lo, m, parts = self._parts(batch)
        device = next(iter(batch.values())).device

        def grads_of(j):
            a, b = parts[j]
            share = losses.BatchShare(self.group, b - a, m)
            if b <= a:
                share.join(self._record(params, batch), device)
                return None
            micro = {k: v[a - lo:b - lo] for k, v in batch.items()}
            whole = (draws.step_generator(key, j, a_steps) if sources is None
                     else sources[j])
            source = draws.Rows(whole, m, a - j * m, b - a)

            def shared(p, x, generator):
                share.rewind()  # a recomputed forward reuses the sums
                return self.loss_fn(p, x, generator)

            with losses.batch_share(share):
                return value_and_grad(shared, params, micro, source,
                                      self.remat)

        loss_sum, grad_sum = _sum_microbatches(a_steps, grads_of)
        *grad_sum, loss_sum = mesh_lib.sum_flat(
            [*grad_sum, loss_sum.reshape(1).to(grad_sum[0].dtype)],
            self.mesh)
        loss_sum = loss_sum.reshape(())
        if mesh_lib.model_size(self.mesh) > 1:
            mesh_lib.agree_over_model(
                [g for g, slot in zip(grad_sum, _leaf_shards(params))
                 if slot is None], self.mesh)
        return _mean(loss_sum, grad_sum, a_steps)


def _signature(batch):
    return {k: (tuple(v.shape), v.dtype, v.device) for k, v in batch.items()}


class StepLoss:
    """A step's scalar loss on its way to the host, read with ``float()`` or
    ``.item()``.

    Made right after the step is queued: the loss is copied, non-blocking
    and on the current stream, into a pinned host slot of its own, and an
    event is recorded after the copy. A read waits for that event alone,
    not for the stream, so work queued after the step keeps running. The
    source tensor may be overwritten afterwards (a graph's static loss, by
    the next replay); the reading keeps the value it was made from. On the
    CPU the copy is synchronous and there is no event.
    """

    __slots__ = ("value", "event")

    def __init__(self, loss):
        self.value = torch.empty((), dtype=loss.dtype,
                                 pin_memory=loss.is_cuda)
        self.value.copy_(loss, non_blocking=True)
        self.event = None
        if loss.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(loss.device))

    def done(self):
        """Whether the value has reached the host (never waits)."""
        return self.event is None or self.event.query()

    def item(self):
        if self.event is not None:
            self.event.synchronize()
        return self.value.item()

    def __float__(self):
        return self.item()


class _GraphStep:
    """What the two graphed steps share: the tensors a step is bound to, the
    warm-up and capture of one step (over the subclass's ``device``), and
    its replays, counted under the subclass's ``REPLAYS``."""

    graph = None
    bound = None  # the tensors the step was built over

    def _bind(self, state, data=None):
        """Bind the step to the tensors of ``state`` (and ``data``) at its
        first call, Adam's state made first; ValueError for others later."""
        leaves = tree_leaves(state.params)
        if self.bound is None:
            self.optimizer.prepare(state.opt_state, leaves)
        moments = state.opt_state.state
        tensors = [*leaves, *(data or {}).values(),
                   *(t for p in leaves for t in moments[p].values())]
        if self.bound is None:
            self.bound = tensors
        elif any(a is not b for a, b in zip(tensors, self.bound)):
            what = "state" if data is None else "state and data"
            raise ValueError(f"a {type(self).__name__} is bound to the "
                             f"{what} of its first call")

    def _capture(self, state, body):
        """Warm ``body(params, opt)`` up on a throwaway copy of ``state`` on
        a side stream, then capture one body over ``state``, holding only
        this thread to the capture's rules: the input pipeline's thread and
        NCCL's watchdog may call CUDA meanwhile (the mode sets which threads
        are checked, not what is captured)."""
        throw = _state_over(state, tree_map(
            lambda t: t.detach().clone().requires_grad_(True), state.params),
            lambda k, v, slot: v.clone())
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                body(throw.params, throw.opt_state)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del throw
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            body(state.params, state.opt_state)
        self.graph = graph

    def _replay(self):
        self.graph.replay()
        profiling.count(self.REPLAYS)


class DataParallelStep(_GraphStep):
    """What ``make_train_step(mesh=)`` returns: ``step(state, batch, key)``.

    Where the params lie on a CUDA device, the batch group's backend is
    NCCL and the mesh's "model" axis is 1, the step is one captured CUDA
    graph that each call replays: the fused preprocess and its draws,
    forward, backward, the normalizers' all-reduces, the gradients' flat
    all-reduce and the Adam update. The first call records the step's draws
    (``DataParallelGrads.draw_calls``) and captures the step
    (``_GraphStep``), every rank the same collectives in the same order.
    Before each replay the host makes the step's draws from its ``key``,
    with the calls the generator path makes (``draws.DrawPlan.fill_keys``),
    and sends them in one non-blocking copy; the batch is copied into the
    graph's inputs.
    The values are the generator path's, bit for bit. A replay's call
    returns its loss as a :class:`StepLoss` of its own, whose read waits for
    that step only: a loop that reads step n - 1's loss after launching step
    n keeps step n queued while the host prepares step n + 1. A state whose
    tensors are not those of the first call raises ValueError; a batch of
    other shapes or dtypes than the first runs the eager step.
    ``train.step_graph.replays`` and ``train.step_graph.eager``
    (``utils.profiling``) count the two; ``train.step_graph.in_flight``
    counts the replays launched while the previous replay's loss had not
    yet reached the host, that is behind a step the card was still running.

    Gloo ranks, the CPU and a mesh with a "model" axis (tensor parallelism)
    run the eager step, ``DataParallelGrads`` and the Adam update as they
    come, and return the loss as a device tensor. On the CPU ``load`` and
    ``run`` drive the graph's body eagerly.
    """

    REPLAYS = "train.step_graph.replays"

    def __init__(self, loss_fn, optimizer, mesh, remat=False, accum_steps=1):
        self.grads_of = DataParallelGrads(loss_fn, mesh, remat, accum_steps)
        self.optimizer = optimizer
        self.nccl = (mesh_lib.model_size(mesh) == 1
                     and dist.get_backend(self.grads_of.group) == "nccl")
        self.last = None  # the previous replay's StepLoss

    def __call__(self, state, batch, key):
        with profiling.span("train.step"):
            if self.nccl and tree_leaves(state.params)[0].is_cuda:
                if self.bound is None or self.fits(batch):
                    self.load(state, batch, key)
                    loss = self.run(state)
                    return state._replace(step=state.step + 1), {"loss": loss}
                self._bind(state)
                profiling.count("train.step_graph.eager")
            loss, grads = self.grads_of(state.params, batch, key)
            self.optimizer.apply(state.opt_state, state.params, grads,
                                 state.step)
            return state._replace(step=state.step + 1), {"loss": loss}

    def fits(self, batch):
        """Whether ``batch`` has the shapes and dtypes the step was built
        for."""
        return _signature(batch) == self.signature

    def _build(self, state, batch):
        self.signature = _signature(batch)
        self.device = tree_leaves(state.params)[0].device
        self.inputs = {k: torch.empty_like(v) for k, v in batch.items()}
        self.plan = draws.DrawPlan(self.grads_of.draw_calls(state.params,
                                                            batch))
        self.window = draws.Windows(1, self.plan.width, self.device)
        self.loss = torch.zeros((), dtype=torch.float32, device=self.device)

    def load(self, state, batch, key):
        """The host's half of a step: the batch copied into the step's
        inputs, the draws of ``key`` made and sent (the step is built at
        the first call)."""
        if self.bound is None:
            self._build(state, batch)
        self._bind(state)
        for k, v in batch.items():
            self.inputs[k].copy_(v)
        self.window.send(lambda host: self.plan.fill_keys(host, [key]), 1)

    def body(self, params, opt):
        """One step over the loaded inputs and draws, reading and writing
        only device tensors."""
        loss, grads = self.grads_of(params, self.inputs, None,
                                    self.plan.sources(self.window.dev[0]))
        self.optimizer.apply(opt, params, grads)
        self.loss.copy_(loss)

    def run(self, state):
        """The device's half: the loaded step (on CUDA a replay, after the
        capture at the first call); returns its loss, on CUDA as a
        :class:`StepLoss`. The update's LR comes from the state's step
        counter; ``state.step`` labels the param group's ``lr``."""
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture(state, self.body)
                profiling.count("train.step_graph.in_flight", 0)
            if self.last is not None and not self.last.done():
                profiling.count("train.step_graph.in_flight")
            self._replay()
            self.last = loss = StepLoss(self.loss)
        else:
            self.body(state.params, state.opt_state)
            loss = self.loss.clone()
        self.optimizer.label(state.opt_state, state.step)
        return loss


def make_resident_train_step(loss_fn, optimizer, remat=False, accum_steps=1):
    """Multi-step training over a dataset held on the device:
    ``step(state, data, idx, seed, step0) -> (state, metrics)`` runs
    ``K = len(idx)`` train steps, step ``step0 + r`` on the records
    ``data[idx[r]]`` with the draws of the per-step path's key
    ``(seed, step0 + r)``. ``metrics`` is one float64 device tensor [2, K]:
    each step's loss (row 0) and the LR its update took (row 1).

    ``data`` is the raw record dict with a leading record axis (the whole
    dataset, in its record dtypes); ``idx`` an int array [K, batch] of
    record rows; ``loss_fn`` a fused loss over raw records
    (:func:`fuse_preprocess`). A window's index rows and draws (the plan of
    ``train/draws.py``) go to the device in one copy.

    On a CUDA device the first call captures ONE step into a CUDA graph
    (``_GraphStep``): gather of the batch by the window's index row, the
    draws, forward, backward and the Adam update, all selected by a step
    counter on the device. Each step of a window replays it (counted as
    ``train.resident_step.replays``). A failed capture or replay raises;
    nothing runs eagerly in its place. On the CPU the same step body runs K
    times eagerly: the same values as :func:`make_train_step`, bit for bit.

    The step is bound to the state and data of its first call; the window
    size may shrink (a ragged last window), not grow.
    """
    core = _make_step_core(loss_fn, optimizer, remat, accum_steps)
    return ResidentStep(core, loss_fn, optimizer, accum_steps)


class ResidentStep(_GraphStep):
    """What :func:`make_resident_train_step` returns."""

    REPLAYS = "train.resident_step.replays"

    def __init__(self, core, loss_fn, optimizer, accum_steps):
        self.core = core
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.accum_steps = accum_steps

    def _build(self, state, data, idx):
        k, self.batch = idx.shape
        self.data = data
        self.device = next(iter(data.values())).device
        n = next(iter(data.values())).shape[0]
        if n >= 2 ** 24:
            raise ValueError(f"{n} records: a window row holds record "
                             "indices as float32, exact below 2**24")
        first = {key: v.index_select(0, torch.as_tensor(
            idx[0], dtype=torch.long).to(self.device))
            for key, v in data.items()}
        m = self.batch // self.accum_steps
        micro = [{key: v[j * m:(j + 1) * m] for key, v in first.items()}
                 for j in range(self.accum_steps)]
        self.plan = draws.DrawPlan(draws.record(self.loss_fn, state.params,
                                                micro))
        self.window = draws.Windows(k, self.batch + self.plan.width,
                                    self.device)
        self.counter = torch.zeros((), dtype=torch.long, device=self.device)
        self.metrics = torch.zeros((2, k), dtype=torch.float64,
                                   device=self.device)
        self.slots = torch.arange(k, device=self.device)

    def _body(self, params, opt):
        """One step at window position ``counter``, reading and writing
        only device tensors."""
        row = self.window.dev.index_select(0, self.counter.view(1))[0]
        rows = row[:self.batch].to(torch.long)
        batch = {key: v.index_select(0, rows) for key, v in self.data.items()}
        loss, lr = self.core(params, opt, batch,
                             self.plan.sources(row[self.batch:]), None)
        self.metrics.copy_(torch.where(
            self.slots == self.counter,
            torch.stack([loss.to(torch.float64), lr])[:, None],
            self.metrics))
        self.counter.add_(1)

    def _first_body(self, params, opt):
        if not torch.cuda.is_current_stream_capturing():
            self.counter.zero_()  # each warm-up body at window position 0
        self._body(params, opt)

    def __call__(self, state, data, idx, seed, step0):
        self.load(state, data, idx, seed, step0)
        return self.run(state, len(idx), step0)

    def load(self, state, data, idx, seed, step0):
        """The host's half of a window: its index rows and draws made and
        sent to the device (the step is built at the first call)."""
        idx = np.asarray(idx)
        k = idx.shape[0]
        if self.bound is None:
            self._build(state, data, idx)
        self._bind(state, data)

        def fill(host):
            host[:, :self.batch].copy_(torch.from_numpy(idx))
            self.plan.fill(host[:, self.batch:], seed, range(step0, step0 + k))

        self.window.send(fill, k)

    def run(self, state, k, step0):
        """The device's half: ``k`` steps over the loaded window (on CUDA,
        the capture at the first call, then ``k`` replays)."""
        if self.device.type == "cuda" and self.graph is None:
            self._capture(state, self._first_body)
        self.counter.zero_()
        for _ in range(k):
            if self.graph is not None:
                self._replay()
            else:
                self._body(state.params, state.opt_state)
        self.optimizer.label(state.opt_state, step0 + k - 1)
        return state._replace(step=state.step + k), self.metrics[:, :k].clone()
