"""Expert parallelism (EP): a Switch-style top-1 MoE dense layer
(counterpart of hand3d_tpu/parallel/expert.py).

The reference model family has no mixture-of-experts layer; like the JAX
package, the port ships the layer as a capability of the scale-out layer:

  * tokens split over ("data", "expert") jointly, every rank holding its own
    slice; experts split over "expert", each rank owning
    n_experts / n_expert_ranks of them (``shard_expert_params``);
  * routing is static-shape: top-1 gating, per-expert capacity
    C = ceil(tokens_per_rank * capacity_factor / n_experts), the tokens past
    an expert's capacity dropped (zero output); its bookkeeping (softmax,
    slot cumsum) in float32 whatever the token dtype;
  * dispatch and combine are one-hot products, and the only communication
    is a pair of ``all_to_all_single`` over "expert"
    (``collectives.all_to_all``, whose backward is the reverse exchange);
  * the gate's probability scales the expert output, so routing gets
    gradients; the Switch load-balancing loss is averaged over the shards.

As in the JAX package the capacity is a budget of each rank's token slice,
so the sharded layer equals ``moe_dense_reference`` applied slice by slice.
"""

import math

import numpy as np
import torch

from hand3d_tpu_torch.ops import nn
from hand3d_tpu_torch.parallel import collectives
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.parallel.mesh import DATA_AXIS, REPLICATE

EXPERT_AXIS = "expert"


def make_expert_mesh(n_data=None, n_expert=2):
    """("data", "expert") mesh: data-parallel rows x expert-parallel
    columns."""
    world = mesh_lib.process_count()
    if n_data is None:
        n_data = world // n_expert
    assert n_data * n_expert == world, (
        f"expert mesh {n_data}x{n_expert} != {world} devices")
    return mesh_lib.device_mesh((n_data, n_expert), (DATA_AXIS, EXPERT_AXIS))


def moe_dense_init(rng, n_experts, in_dim, out_dim):
    """Gate and stacked expert params, a TF-layout numpy tree drawn from the
    numpy Generator ``rng``: experts use the op library's xavier / 1e-4
    init (``ops.nn.dense_init``), so a 1-expert MoE starts as a plain dense
    layer. ``weights.params_from_jax`` takes it to the device."""
    gate = nn.dense_init(rng, in_dim, n_experts)
    experts = [nn.dense_init(rng, in_dim, out_dim) for _ in range(n_experts)]
    return {"gate": gate,
            "experts": {k: np.stack([e[k] for e in experts])
                        for k in ("weights", "biases")}}


def _route(params, x, capacity):
    """(dispatch [T, E, C], combine [T, E, C], aux loss) of tokens ``x``
    [T, in]; the bookkeeping in float32 (a bf16 cumsum rounds counts above
    256 and would book two tokens into one slot)."""
    w = params["gate"]["weights"].to(torch.float32)
    b = params["gate"]["biases"].to(torch.float32)
    n_experts = w.shape[-1]
    probs = torch.softmax(x.to(torch.float32) @ w + b, dim=-1)  # [T, E]
    onehot = torch.nn.functional.one_hot(
        torch.argmax(probs, dim=-1), n_experts).to(torch.float32)
    # each token's place in its expert's queue, -1 where not routed
    position = torch.cumsum(onehot, dim=0) * onehot - 1.0
    kept = (position >= 0) & (position < capacity)
    pos = torch.where(kept, position, 0.0).sum(dim=-1).to(torch.long)
    pos_onehot = torch.nn.functional.one_hot(pos, capacity).to(torch.float32)
    dispatch = ((onehot * kept.to(torch.float32))[:, :, None]
                * pos_onehot[:, None, :])
    gate_val = torch.sum(probs * onehot, dim=-1)
    combine = dispatch * gate_val[:, None, None]
    # Switch load balancing: E * sum_e fraction_e * mean_prob_e
    aux = n_experts * torch.sum(onehot.mean(dim=0) * probs.mean(dim=0))
    return dispatch.to(x.dtype), combine.to(x.dtype), aux


def _expert_ffn(experts, xs):
    """xs [E_local, C', in] -> [E_local, C', out] through each expert."""
    w, b = experts["weights"], experts["biases"]
    return torch.relu(torch.einsum("eci,eio->eco", xs, w) + b[:, None, :])


def _capacity(tokens, capacity_factor, n_experts):
    return int(math.ceil(tokens * capacity_factor / n_experts))


def moe_dense_reference(params, x, capacity_factor=1.25):
    """One device, the same routing and capacity math: x [T, in] ->
    ([T, out], aux loss)."""
    n_experts = params["gate"]["weights"].shape[-1]
    capacity = _capacity(x.shape[0], capacity_factor, n_experts)
    dispatch, combine, aux = _route(params, x, capacity)
    expert_in = torch.einsum("tec,ti->eci", dispatch, x)
    expert_out = _expert_ffn(params["experts"], expert_in)
    return torch.einsum("tec,eco->to", combine, expert_out), aux


def expert_param_sharding(mesh, params):
    """The placement of each leaf: experts split along their leading axis
    over "expert", the gate replicated."""
    rep = tuple(REPLICATE for _ in mesh.mesh_dim_names)
    exp = tuple(("shard", 0) if name == EXPERT_AXIS else REPLICATE
                for name in mesh.mesh_dim_names)
    return {"gate": {k: rep for k in params["gate"]},
            "experts": {k: exp for k in params["experts"]}}


def shard_expert_params(mesh, params):
    """This rank's params: the gate whole, its experts' slab [E_local, ...]
    (copies)."""
    n = mesh_lib.axis_size(mesh, EXPERT_AXIS)
    j = mesh.get_local_rank(EXPERT_AXIS)
    return {"gate": dict(params["gate"]),
            "experts": {k: v.detach().chunk(n, 0)[j].clone()
                        for k, v in params["experts"].items()}}


def moe_dense_apply(mesh, params, x, capacity_factor=1.25):
    """The expert-parallel MoE dense layer on ``mesh`` (("data", "expert")).

    ``params``: the gate whole and this rank's expert slab
    (:func:`shard_expert_params`); ``x``: this rank's token slice [t, in]
    (tokens split over both axes in rank order). Returns (this rank's
    [t, out], aux loss): the outputs of ``moe_dense_reference`` on the
    slice, the capacity being the slice's; the aux loss is the mean over
    the shards, its gradient this rank's share of it.
    """
    group = mesh.get_group(EXPERT_AXIS)
    n_dev = mesh_lib.axis_size(mesh, EXPERT_AXIS)
    n_experts = params["gate"]["weights"].shape[-1]
    assert n_experts % n_dev == 0
    capacity = _capacity(x.shape[0], capacity_factor, n_experts)
    dispatch, combine, aux = _route(params, x, capacity)
    expert_in = torch.einsum("tec,ti->eci", dispatch, x)  # [E, C, in]
    # dispatch: expert block j to expert rank j; stack the slabs received
    # for this rank's experts along the capacity axis
    e_local = n_experts // n_dev
    got = collectives.all_to_all(expert_in, group)  # [n_dev * E_local, C, in]
    got = got.reshape(n_dev, e_local, capacity, -1).transpose(0, 1)
    expert_out = _expert_ffn(params["experts"],
                             got.reshape(e_local, n_dev * capacity, -1))
    # combine: each slab back to the rank its tokens came from
    back = expert_out.reshape(e_local, n_dev, capacity, -1).transpose(0, 1)
    back = collectives.all_to_all(back.contiguous(), group)  # [E, C, out]
    out = torch.einsum("tec,eco->to", combine, back.reshape(
        n_experts, capacity, -1))
    shards = mesh_lib.process_count()
    return out, collectives.global_value(aux / shards)


def reduce_expert_grads(mesh, gate_grads, expert_grads):
    """The ranks' gradients summed: the gate's over every rank, each
    expert slab's over its "data" group."""
    data_group = mesh.get_group(DATA_AXIS)
    return ([collectives.all_reduce(g, None) for g in gate_grads],
            [collectives.all_reduce(g, data_group) for g in expert_grads])
