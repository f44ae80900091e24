"""GPipe pipeline parallelism (PP) over PoseNet's refinement units
(counterpart of hand3d_tpu/parallel/pipeline.py).

The two refinement units of PoseNet are structurally identical
(concat(scoremap, encoding) -> 5 x 7x7x128 -> 1x1x128 -> 1x1x21), so their
params stack along a leading "stage" axis and each stage's unit lives on the
ranks of its stage of a ("data", "stage") mesh.

The schedule is the JAX package's, per row of the mesh:
  1. the trunk (encoder and first head, ``posenet.apply_trunk``) runs on
     this rank's rows of the batch, which is split over both axes;
  2. an all-gather over "stage" gives every stage its row's queues of
     encodings, scoremaps and ground truth (backward: a reduce-scatter);
  3. ``n_micro + n_stage - 1`` ticks: at tick t stage s runs microbatch
     t - s and hands its scoremap and the pass-through encoding to stage
     s + 1 (``collectives.shift``: backward sends the gradient from s + 1 to
     s); the bubble fraction is (S - 1) / (M + S - 1);
  4. each stage sums its loss numerators; one global denominator.

JAX's ``shard_map`` runs one program on every device: every tick runs the
unit on every stage, and the ticks outside a stage's microbatches are masked
out of the loss. The port does the same, for the same reason: each rank
builds the same autograd graph, so the backward pass makes its collectives
and hand-offs in the same order on every rank.

A rank's loss is its share of the global loss (the numerators it computed
over the global denominator); ``posenet_pipeline_loss`` returns the global
value with the share's gradient, and ``reduce_pipeline_grads`` sums the
shares' gradients: the trunk's over every rank, each stage's unit over its
"data" group. The loss and gradients equal ``train.losses.
posenet_scoremap_loss`` of ``posenet.apply`` on the global batch.
"""

import numpy as np
import torch

from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.parallel import collectives
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.parallel.mesh import DATA_AXIS, REPLICATE
from hand3d_tpu_torch.train import losses

STAGE_AXIS = "stage"
N_STAGES = posenet.NUM_REFINEMENT_UNITS
_N_REFINE_LAYERS = 7


def make_pipeline_mesh(n_data=None, n_stage=N_STAGES):
    """("data", "stage") mesh: data-parallel rows x pipeline stages, stage
    the fastest axis (neighbouring ranks hand off to each other)."""
    world = mesh_lib.process_count()
    if n_data is None:
        n_data = world // n_stage
    assert n_data * n_stage == world, (
        f"pipeline mesh {n_data}x{n_stage} != {world} devices")
    return mesh_lib.device_mesh((n_data, n_stage), (DATA_AXIS, STAGE_AXIS))


def _unit_layer_names(unit):
    """Reference-layout names of refinement unit ``unit`` (conv6_* /
    conv7_*)."""
    return [f"conv{unit + 6}_{i}" for i in range(1, _N_REFINE_LAYERS + 1)]


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def stack_refinement_params(params):
    """Split flat PoseNet params (a torch or numpy tree) into (trunk,
    stage-stacked refinement): ``stacked["conv_i"]`` holds the leaves of
    layer i of both units, [n_stages, ...]. Inverse:
    :func:`unstack_refinement_params`."""
    refine = {n for u in range(N_STAGES) for n in _unit_layer_names(u)}
    trunk = {k: v for k, v in params.items() if k not in refine}
    stacked = {}
    for i in range(1, _N_REFINE_LAYERS + 1):
        units = [params[f"conv{u + 6}_{i}"] for u in range(N_STAGES)]
        stacked[f"conv_{i}"] = {k: _stack([p[k] for p in units])
                                for k in units[0]}
    return trunk, stacked


def unstack_refinement_params(trunk, stacked):
    """Rebuild the flat reference-layout PoseNet param dict."""
    params = dict(trunk)
    for u in range(N_STAGES):
        for i in range(1, _N_REFINE_LAYERS + 1):
            params[f"conv{u + 6}_{i}"] = {
                k: v[u] for k, v in stacked[f"conv_{i}"].items()}
    return params


def refine_param_sharding(mesh, stacked):
    """The placement of every stage-stacked leaf: its leading axis split
    over "stage", replicated over "data"."""
    place = tuple(("shard", 0) if name == STAGE_AXIS else REPLICATE
                  for name in mesh.mesh_dim_names)
    return {k: {leaf: place for leaf in v} for k, v in stacked.items()}


def shard_refinement_params(mesh, stacked):
    """This rank's stage of the stacked tree: leaves [1, ...] (copies)."""
    s = mesh.get_local_rank(STAGE_AXIS)
    return {k: {leaf: t[s:s + 1].detach().clone() for leaf, t in v.items()}
            for k, v in stacked.items()}


def _loss_numerator(pred, gt, vis):
    """``losses.scoremap_numerator`` of an NCHW ``pred``."""
    return losses.scoremap_numerator(pred.permute(0, 2, 3, 1), gt, vis)


def posenet_pipeline_loss(mesh, n_micro, compute_dtype=None):
    """The pipelined PoseNet training loss over ``mesh``.

    Returns ``loss_fn(trunk, stacked, image_crop, scoremap_gt,
    keypoint_vis)``. ``trunk``: the trunk params, whole on every rank;
    ``stacked``: this rank's stage (:func:`shard_refinement_params`); the
    three batch tensors: this rank's rows of the global batch, which splits
    over ("data", "stage") in rank order (the global batch must divide by
    the rank count, and the batch of a mesh row, global / n_data, by
    ``n_micro``). The value is the global loss,
    ``posenet_scoremap_loss(posenet.apply(...))`` on the global batch, on
    every rank; its gradient is this rank's share
    (:func:`reduce_pipeline_grads` sums them).
    """
    n_stage = mesh_lib.axis_size(mesh, STAGE_AXIS)
    assert n_stage == N_STAGES, (
        f"mesh stage axis {n_stage} != {N_STAGES} refinement units")
    stage_group = mesh.get_group(STAGE_AXIS)
    s = mesh.get_local_rank(STAGE_AXIS)
    ticks = n_micro + n_stage - 1

    def loss_fn(trunk, stacked, image_crop, scoremap_gt, keypoint_vis):
        units = [{k: v[0] for k, v in stacked[f"conv_{i}"].items()}
                 for i in range(1, _N_REFINE_LAYERS + 1)]
        vis = keypoint_vis.to(torch.float32)
        encoding, sm0 = posenet.apply_trunk(trunk, image_crop, compute_dtype)
        num = _loss_numerator(sm0, scoremap_gt, vis)
        denom = collectives.all_reduce(vis.sum(), None) + 0.001
        enc_q = collectives.gather_sum(encoding, stage_group)
        sm_q = collectives.gather_sum(sm0, stage_group)
        gt_q = collectives.all_gather(scoremap_gt, stage_group, 0)
        vis_q = collectives.all_gather(vis, stage_group, 0)
        b_row = enc_q.shape[0]
        assert b_row % n_micro == 0, (
            f"per-row batch {b_row} not divisible by n_micro={n_micro}")
        mb = b_row // n_micro
        first = torch.tensor(s == 0, device=encoding.device)
        # the hand-off buffer: (encoding, scoremap) along channels
        buf = torch.zeros_like(torch.cat([enc_q[:mb], sm_q[:mb]], dim=1))
        enc_c = encoding.shape[1]
        for t in range(ticks):
            m = min(max(t - s, 0), n_micro - 1)
            rows = slice(m * mb, (m + 1) * mb)
            in_enc = torch.where(first, enc_q[rows], buf[:, :enc_c])
            in_sm = torch.where(first, sm_q[rows], buf[:, enc_c:])
            sm_new = posenet.apply_refinement_unit(units, in_sm, in_enc,
                                                   compute_dtype)
            active = 0 <= t - s < n_micro
            num = num + _loss_numerator(sm_new, gt_q[rows],
                                        vis_q[rows]) * float(active)
            # to stage s + 1 (the last stage's send drops; the first stage
            # receives zeros it never reads)
            buf = collectives.shift(torch.cat([in_enc, sm_new], dim=1),
                                    stage_group, 1)
        # the global value with the share's gradient; buf's last hand-off
        # joins the graph so every rank runs its backward
        return collectives.global_value(num / denom) + 0.0 * buf.sum()

    return loss_fn


def reduce_pipeline_grads(mesh, trunk_grads, stacked_grads):
    """The shares' gradients summed (new tensors): the trunk's over every
    rank, each stage's unit over its "data" group."""
    data_group = mesh.get_group(DATA_AXIS)
    return ([collectives.all_reduce(g, None) for g in trunk_grads],
            [collectives.all_reduce(g, data_group) for g in stacked_grads])
