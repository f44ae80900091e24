"""The device mesh of the port: data parallelism over torch.distributed ranks
(counterpart of hand3d_tpu/parallel/mesh.py).

JAX's mesh is a grid of devices: GSPMD shards the batch over its "data" axis
and, optionally, wide output channels over "model". PyTorch's idiom is one
process per device, so a device of the port's mesh is a rank with one
device: JAX's multi-host case with one device per host. The batch axis
splits over the ranks in rank order; a rank holds rows ``[lo, lo + per)``
of each global batch (``shard_rows``), and the collectives below (one flat
all-reduce of a train step's gradients, an all-gather of eval and serving
outputs) make every rank's result the global one.

The "model" axis (tensor parallelism), multislice meshes and spatial
partitioning are out of scope for the port: asking for them raises.

The data collectives run on the mesh's "data" group, whose backend is the
one ``init_distributed`` chose: NCCL for CUDA devices, gloo for the CPU, or
gloo for CUDA tensors when several ranks share one card (NCCL refuses two
ranks on one GPU). Control decisions (the stop flag of a preempted run, the
barrier after a snapshot) go through a gloo group on the host, so reading
them never waits on the device.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# a peer that never arrives fails the group's set-up, or a collective that
# waits for it, after this many seconds instead of hanging
TIMEOUT_S = 300
OUT_OF_SCOPE = (
    "out of scope for the port (ROADMAP.md 'Out of scope this round': the "
    "TP and multislice layouts of parallel/mesh.py); the port's mesh is "
    "data-parallel, NxM with M = 1")
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

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


def make_mesh(n_data=None, n_model=1):
    """A ``DeviceMesh`` with dims ("data", "model") over the ranks.

    ``n_data`` defaults to all ranks. The mesh must cover every rank, as in
    the JAX package (``mesh 3x1 != 1 devices``); ``n_model > 1`` raises
    (out of scope). In one process with no launcher, the mesh is a group of
    one made in the process itself, so ``make_mesh()`` and a 1x1 mesh work
    there.
    """
    from torch.distributed.device_mesh import DeviceMesh

    if n_model != 1:
        raise NotImplementedError(
            f"mesh {n_data}x{n_model}: tensor parallelism over "
            f"{MODEL_AXIS!r} is {OUT_OF_SCOPE}")
    world = process_count()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"mesh {n_data}x{n_model} != {world} devices")
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    # the mesh's device type is its collectives' (gloo runs on the host,
    # CUDA tensors included)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type,
                      np.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    _control_group()  # made now, at the same point on every rank
    return mesh


def make_multislice_mesh(n_slices, n_data=None, n_model=1):
    """The JAX package's ("slice", "data", "model") mesh: raises."""
    raise NotImplementedError(f"multislice meshes are {OUT_OF_SCOPE}")


def spatial_constrainer(mesh):
    """The JAX package's spatial partitioning over "model": raises."""
    raise NotImplementedError(f"spatial partitioning is {OUT_OF_SCOPE}")


def param_sharding(mesh, params):
    """The placement of every param of ``params`` on ``mesh``: replicated
    on each rank, a tree of ("replicate", "replicate") over ("data",
    "model"). Tensor parallelism (a "model" axis above 1) raises."""
    if mesh.shape[1] > 1:
        raise NotImplementedError(
            f"tensor-parallel params over {MODEL_AXIS!r} are {OUT_OF_SCOPE}")

    def place(tree):
        return {k: place(v) if isinstance(v, dict)
                else ("replicate", "replicate") for k, v in tree.items()}

    return place(params)


def batch_shard_count(mesh):
    """How many ways the mesh splits the batch axis."""
    return mesh.shape[0]


def data_index(mesh):
    """This rank's coordinate on the "data" axis."""
    return mesh.get_local_rank(DATA_AXIS)


def shard_rows(mesh, batch):
    """(lo, per): this rank's rows ``[lo, lo + per)`` of a global batch of
    ``batch`` rows."""
    n = batch_shard_count(mesh)
    if batch % n:
        raise ValueError(f"batch {batch} does not divide over the mesh's "
                         f"{n} batch shards")
    per = batch // n
    return data_index(mesh) * per, per


def data_group(mesh):
    return mesh.get_group(DATA_AXIS)


def sum_flat(tensors, mesh):
    """``tensors`` summed over the data ranks with ONE all-reduce of a flat
    bucket (they share a dtype and device); returned in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=data_group(mesh))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def broadcast_(tensors, mesh, src=0):
    """Overwrite ``tensors`` (in place) with rank ``src``'s, through one flat
    broadcast."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src, group=data_group(mesh))
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
    return tensors


def gather_rows(tensors, mesh):
    """A dict of per-rank row blocks -> the global rows on every rank, in
    rank order (an all-gather along the leading axis). Bool tensors travel
    as uint8."""
    n = batch_shard_count(mesh)
    if n == 1:
        return tensors
    group = data_group(mesh)
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
