"""The device mesh of the port (counterpart of hand3d_tpu/parallel/mesh.py).

JAX's mesh is a grid of devices: GSPMD shards the batch over its "data" axis
(and "slice", on a multislice mesh) and wide output channels over "model".
PyTorch's idiom is one process per device, so a device of the port's mesh is
a rank with one device: JAX's multi-host case with one device per host. The
mesh is a ``DeviceMesh`` over the ranks in rank order, "model" its fastest
axis. A rank holds rows ``[lo, lo + per)`` of each global batch
(``shard_rows``), the same rows as the other ranks of its "model" group.

Tensor parallelism (TP): ``shard_params`` gives each rank its slices of the
layers that JAX's rule shards (``_spec_for_param``: output channels of at
least ``_MIN_SHARD_DIM``, divisible by the "model" size) and marks each such
layer dict with a ``ModelShard`` under ``SHARD_KEY``; ``ops.nn`` dispatches
on it to a column-parallel layer (``parallel.collectives``: the input's
gradient all-reduced, the output channels all-gathered), so every layer's
input and output are whole on every rank, the layout GSPMD gives JAX's
specs. ``gather_params`` rebuilds the whole tree.

The collectives run on the mesh's groups, whose backend is the one
``init_distributed`` chose: NCCL for CUDA devices, gloo for the CPU, or gloo
for CUDA tensors when several ranks share one card (NCCL refuses two ranks
on one GPU). A step's gradients are summed over the batch axes ("slice" x
"data", ``batch_group``), never over "model": a replicated param's gradient
is whole on each "model" rank already, a sharded one is that rank's slice.
Control decisions (the stop flag of a preempted run, the barrier after a
snapshot) go through a gloo group on the host, so reading them never waits
on the device.
"""

import datetime
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"
# a peer that never arrives fails the group's set-up, or a collective that
# waits for it, after this many seconds instead of hanging
TIMEOUT_S = 300
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# output-channel dims smaller than this stay replicated (sharding tiny layers
# costs more in collectives than it saves), as in the JAX package
_MIN_SHARD_DIM = 128
# the key of a layer dict's ModelShard: how its leaves are sharded
SHARD_KEY = "model_shard"
REPLICATE = "replicate"


class ModelShard(NamedTuple):
    """How a layer dict's leaves are sharded over the "model" group.

    ``dims``: (leaf name, sharded dim) of each sharded leaf; ``width``: the
    whole length of the sharded dim (the layer's output width, for a conv or
    dense layer); ``group``, ``size``, ``index``: the "model" group, its
    size and this rank's place in it.
    """
    group: Any
    size: int
    index: int
    width: int
    dims: tuple

    def dim(self, leaf):
        """The sharded dim of ``leaf``, None where it is replicated."""
        return dict(self.dims).get(leaf)


_control = {}  # the host-side gloo group of the default group, once made


def process_index():
    """This process's rank (0 without torch.distributed)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count():
    """The number of ranks (1 without torch.distributed)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank():
    """The launcher's LOCAL_RANK (torchrun sets it), else 0."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def launched():
    """Whether a launcher such as torchrun started this process: its
    environment names the rank, the world and the coordinator."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, auto=False, backend=None,
                     timeout=TIMEOUT_S):
    """Multi-process bring-up: call once at program start in every process,
    before building a mesh. Returns (rank, world_size).

    Two ways in, as in the JAX package:
      * ``init_distributed(auto=True)`` reads the launcher's environment:
        RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (and LOCAL_RANK for
        the device), as ``torchrun`` sets them; it raises where they are
        missing;
      * explicit ``coordinator_address`` ("host:port"), ``num_processes``
        and ``process_id``.
    With neither it does nothing (one process).

    ``backend``: "nccl" or "gloo"; by default NCCL where CUDA is available
    and each local rank has a card of its own, else gloo (NCCL refuses two
    ranks on one card; torchrun's LOCAL_WORLD_SIZE says how many share the
    host). ``timeout`` (seconds) bounds the set-up and every collective: a
    missing peer fails the run instead of hanging it.
    """
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not (auto or explicit):
        return process_index(), process_count()
    if dist.is_initialized():
        raise RuntimeError("init_distributed should only be called once "
                           "(torch.distributed is already initialized)")
    if auto:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "init_distributed(auto=True) reads the launcher's "
                f"environment (torchrun sets {', '.join(LAUNCHER_ENV)} and "
                f"LOCAL_RANK); missing: {', '.join(missing)}")
        if coordinator_address is None:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id together")
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        backend = ("nccl" if torch.cuda.is_available()
                   and local <= torch.cuda.device_count() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        rank=int(process_id), world_size=int(num_processes),
        timeout=datetime.timedelta(seconds=timeout))
    return process_index(), process_count()


def rank_device(device):
    """The torch device of this rank: "cuda" without an index is the card
    of LOCAL_RANK; an explicit index (two ranks on one card) or the CPU is
    kept. A CUDA device becomes the current one."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
    return device


def device_mesh(shape, names):
    """A ``DeviceMesh`` of ``shape`` over every rank in rank order. In one
    process with no launcher it is a group of one made in the process
    itself, so ``make_mesh()`` and a 1x1 mesh work there."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # the mesh's device type is its collectives' (gloo runs on the host,
    # CUDA tensors included)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type,
                      np.arange(process_count()).reshape(shape),
                      mesh_dim_names=names)
    _control_group()  # made now, at the same point on every rank
    return mesh


def make_mesh(n_data=None, n_model=1):
    """A ``DeviceMesh`` with dims ("data", "model") over the ranks.

    ``n_data`` defaults to all ranks over ``n_model``. The mesh must cover
    every rank, as in the JAX package (``mesh 3x1 != 1 devices``). Ranks
    ``d * n_model ... d * n_model + n_model - 1`` form row ``d``: its "model"
    group, which holds the same batch rows and splits the wide layers.
    """
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"mesh {n_data}x{n_model} != {world} devices")
    return device_mesh((n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def make_multislice_mesh(n_slices, n_data=None, n_model=1):
    """("slice", "data", "model") mesh for multi-slice deployments.

    The axis layout of the JAX package: the batch shards over ("slice",
    "data") (pure data parallelism across slices; the only cross-slice
    traffic is the step's gradient all-reduce) and tensor parallelism
    ("model") never crosses a slice, since a "model" group is ``n_model``
    consecutive ranks of one slice. On one host "slice" is just an axis of
    ranks: the topology is checked structurally (no slower link joins the
    slices here), and the group and collective layout is what transfers to
    a real multi-slice deployment.
    """
    world = process_count()
    if n_data is None:
        n_data = world // (n_slices * n_model)
    assert n_slices * n_data * n_model == world, (
        f"mesh {n_slices}x{n_data}x{n_model} != {world} devices")
    mesh = device_mesh((n_slices, n_data, n_model),
                       (SLICE_AXIS, DATA_AXIS, MODEL_AXIS))
    # the batch group of each "model" index: its ranks of every slice and
    # row; every rank makes every group, in the same order
    ranks = np.arange(world).reshape(n_slices * n_data, n_model)
    for m in range(n_model):
        group = dist.new_group([int(r) for r in ranks[:, m]],
                               timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if process_index() in ranks[:, m]:
            mesh.batch_group = group
    return mesh


def axis_size(mesh, name):
    """The size of ``mesh``'s axis ``name`` (1 where it has none)."""
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def batch_shard_count(mesh):
    """How many ways the mesh splits the batch axis ("data", times "slice"
    on a multislice mesh)."""
    return axis_size(mesh, DATA_AXIS) * axis_size(mesh, SLICE_AXIS)


def data_index(mesh):
    """This rank's batch shard: its place on ("slice", "data")."""
    index = mesh.get_local_rank(DATA_AXIS)
    if SLICE_AXIS in mesh.mesh_dim_names:
        index += mesh.get_local_rank(SLICE_AXIS) * axis_size(mesh, DATA_AXIS)
    return index


def shard_rows(mesh, batch):
    """(lo, per): this rank's rows ``[lo, lo + per)`` of a global batch of
    ``batch`` rows."""
    n = batch_shard_count(mesh)
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over the mesh's "
                         f"{n} batch shards")
    per = batch // n
    return data_index(mesh) * per, per


def batch_group(mesh):
    """The ranks that share this rank's "model" index: the group a step's
    gradients and the batch's normalizers are summed over."""
    if SLICE_AXIS in mesh.mesh_dim_names:
        return mesh.batch_group
    return mesh.get_group(DATA_AXIS)


def model_size(mesh):
    return axis_size(mesh, MODEL_AXIS)


def model_group(mesh):
    return mesh.get_group(MODEL_AXIS)


def batch_sharding(mesh):
    """The placement of a batch: its leading axis split over the batch
    axes, replicated over "model" (one entry a mesh axis)."""
    return tuple(REPLICATE if name == MODEL_AXIS else ("shard", 0)
                 for name in mesh.mesh_dim_names)


def replicate(mesh):
    """The placement of a tensor whole on every rank."""
    return (REPLICATE,) * len(mesh.mesh_dim_names)


def _spec_for_param(path, value, model_size):
    """The dim of ``value`` (a leaf at ``path``, in the port's layout) that
    tensor parallelism shards over "model", or None (replicated).

    JAX's rule (hand3d_tpu/parallel/mesh.py ``_spec_for_param``) read in the
    port's layouts: conv kernels ("weights", "weights_q", OIHW) shard dim 0
    and dense kernels ([in, out]) dim 1, the dim that is last in the TF
    layout, where it has at least ``_MIN_SHARD_DIM`` entries divisible by
    ``model_size``; 1-dim "biases" and "weight_scale" follow the same test;
    everything else is replicated.
    """
    if model_size <= 1:
        return None
    shape = tuple(value.shape)
    if not shape:
        return None
    dim = 0 if len(shape) == 4 else len(shape) - 1
    if shape[dim] < _MIN_SHARD_DIM or shape[dim] % model_size:
        return None
    leaf = path[-1]
    if leaf in ("weights", "weights_q") and len(shape) in (4, 2):
        return dim
    if leaf in ("biases", "weight_scale") and len(shape) == 1:
        return 0
    return None


def is_shard(value):
    return isinstance(value, ModelShard)


def is_leaf(value):
    """Whether ``value`` is a tensor leaf of a param tree (not a subtree,
    not a layer's ModelShard)."""
    return not isinstance(value, (dict, ModelShard))


def param_sharding(mesh, params):
    """The placement of every leaf of ``params`` on ``mesh``: a tuple of one
    entry a mesh axis, ``"replicate"`` or ``("shard", dim)`` over "model"
    where ``_spec_for_param`` shards it."""
    m = model_size(mesh)

    def place(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = place(v, path + (k,))
            elif is_leaf(v):
                dim = _spec_for_param(path + (k,), v, m)
                out[k] = tuple(
                    ("shard", dim) if name == MODEL_AXIS and dim is not None
                    else REPLICATE for name in mesh.mesh_dim_names)
        return out

    return place(params, ())


def shard_params(mesh, params):
    """Each rank's slices of ``params`` (a torch tree) under tensor
    parallelism: a leaf that ``_spec_for_param`` shards becomes this rank's
    block of it (a copy), and its layer dict gains a ``ModelShard`` under
    ``SHARD_KEY``. Other leaves are kept as they are. Layer dicts that
    already carry one are kept, so this is idempotent; a mesh whose "model"
    axis is 1 returns ``params``."""
    m = model_size(mesh)
    if m == 1:
        return params
    group = model_group(mesh)
    index = mesh.get_local_rank(MODEL_AXIS)

    def walk(tree, path):
        if SHARD_KEY in tree:
            return tree
        out, dims, width = {}, [], None
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            dim = _spec_for_param(path + (k,), v, m)
            if dim is None:
                out[k] = v
                continue
            out[k] = v.detach().chunk(m, dim)[index].clone()
            dims.append((k, dim))
            width = width or v.shape[dim]
        if dims:
            out[SHARD_KEY] = ModelShard(group, m, index, width, tuple(dims))
        return out

    return walk(params, ())


def gather_params(mesh, params):
    """The whole tree of a sharded one (``shard_params``): every sharded
    leaf all-gathered over "model", the ModelShards dropped. A collective:
    every rank calls it. Leaves come back detached."""
    from hand3d_tpu_torch.parallel import collectives

    def walk(tree):
        shard = tree.get(SHARD_KEY)
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif isinstance(v, ModelShard):
                continue
            elif shard is not None and shard.dim(k) is not None:
                out[k] = collectives.all_gather(v, shard.group, shard.dim(k))
            else:
                out[k] = v.detach()
        return out

    return walk(params)


def is_sharded(params):
    """Whether any layer dict of ``params`` carries a ModelShard."""
    return any(isinstance(v, ModelShard)
               or (isinstance(v, dict) and is_sharded(v))
               for v in params.values())


def spatial_constrainer(mesh):
    """Spatial partitioning (SP) over "model": see ``parallel.spatial``."""
    from hand3d_tpu_torch.parallel import spatial

    return spatial.RowShards(mesh)


def sum_flat(tensors, mesh):
    """``tensors`` summed over the batch group (``batch_group``) with ONE
    all-reduce of a flat bucket (they share a dtype and device); returned
    in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=batch_group(mesh))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def broadcast_(tensors, src=0, group=None):
    """Overwrite ``tensors`` (in place) on every rank of ``group`` (all
    ranks by default) with rank ``src``'s (a global rank), through one flat
    broadcast."""
    if not tensors:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src, group=group)
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors


def agree_over_model(tensors, mesh):
    """Overwrite ``tensors`` (replicated over "model") with the first rank's
    of this rank's "model" group. Each rank of the group computes a
    replicated tensor itself, and on a card the backward convolutions'
    atomics make the last bits differ between two computations of one sum;
    the ranks must hold the same replicated params, as one device would."""
    group = model_group(mesh)
    return broadcast_(tensors, dist.get_global_rank(group, 0), group)


def gather_rows(tensors, mesh):
    """A dict of per-rank row blocks -> the global rows on every rank, in
    batch-shard order (an all-gather along the leading axis over the batch
    group). Bool tensors travel as uint8."""
    n = batch_shard_count(mesh)
    if n == 1:
        return tensors
    group = batch_group(mesh)
    out = {}
    for key, t in tensors.items():
        send = t.contiguous()
        if send.dtype == torch.bool:
            send = send.to(torch.uint8)
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send, group=group)
        out[key] = torch.cat(parts).to(t.dtype)
    return out


def _control_group():
    """A gloo group over every rank, on the host (the default group itself
    where it is gloo)."""
    if "group" not in _control:
        _control["group"] = (None if dist.get_backend() == "gloo"
                             else dist.new_group(backend="gloo"))
    return _control["group"]


def any_rank(flag):
    """Whether ``flag`` is true on any rank: a host-side agreement."""
    if process_count() == 1:
        return bool(flag)
    value = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(value, op=dist.ReduceOp.MAX, group=_control_group())
    return bool(value.item())


def barrier():
    """Every rank waits here for the others (host side)."""
    if process_count() > 1:
        dist.barrier(group=_control_group())
