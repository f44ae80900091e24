"""The collectives of the scale-out layer, each with its backward
(counterparts of what GSPMD and ``shard_map`` derive in the JAX package).

JAX differentiates through ``all_gather``, ``psum``, ``ppermute`` and
``all_to_all`` by itself. With one process per device the port writes each
collective as a ``torch.autograd.Function`` together with its transpose:

  * ``copy_to_model``: identity forward, all-reduce of the gradient
    backward (the input of a column-parallel layer);
  * ``gather_channels``: all-gather forward, this rank's slice of the
    gradient backward (the output of a column-parallel layer, and the rows
    of a spatially partitioned block where it ends);
  * ``scatter``: this rank's slice forward, all-gather of the gradient
    backward (the rows of a block where spatial partitioning starts);
  * ``gather_sum``: all-gather forward, reduce-scatter backward (a
    re-layout whose consumers differ by rank: GPipe's stage queues);
  * ``shift``: point-to-point, rank i to rank i + step of a group, zeros
    where no rank sends; backward shifts the gradient back (the halo rows
    of spatial partitioning, GPipe's stage-to-stage hand-off);
  * ``all_to_all``: the expert dispatch and combine; backward is the same
    exchange of the gradient.

A collective whose downstream computation is the same on every rank of the
group (a replicated tensor) has a slice as its transpose; one whose ranks
go on to compute different things (shares of a global loss) has a sum.

Every function works on NCCL and on gloo (ranks that share one card: NCCL
refuses two ranks on one GPU). gloo all-reduces and broadcasts CUDA tensors
itself; for the collectives it has only on the host (all-gather into a
tensor, reduce-scatter, all-to-all, point-to-point) a CUDA tensor goes
through the host.
"""

import torch
import torch.distributed as dist


def _via_host(x, group):
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _staged(fn, x, group, *outs):
    """Run ``fn(x, *outs)`` (a collective writing ``outs``) on the host
    where ``group`` is gloo and ``x`` lies on a card; return ``outs`` on
    ``x``'s device."""
    if not _via_host(x, group):
        fn(x, *outs)
        return outs
    host = [o.cpu() for o in outs]
    fn(x.cpu(), *host)
    return tuple(h.to(x.device) for h in host)


def all_reduce(x, group):
    """The sum of ``x`` over ``group`` (a new tensor)."""
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def global_value(share, group=None):
    """The sum of the ranks' ``share``s over ``group``, whose gradient is
    this rank's ``share``'s alone (``share - share.detach()`` is exactly
    0): each rank reports the global loss and back-propagates its part."""
    return all_reduce(share, group) + (share - share.detach())


def all_gather(x, group, dim):
    """The ranks' ``x`` concatenated along ``dim``, in group rank order."""
    n = dist.get_world_size(group)
    x = x.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    (out,) = _staged(lambda a, o: dist.all_gather_into_tensor(
        o, a, group=group), x, group, out)
    return out.movedim(0, dim)


def reduce_scatter(x, group, dim):
    """This rank's block along ``dim`` of the sum of ``x`` over ``group``."""
    n = dist.get_world_size(group)
    x = x.detach().movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    (out,) = _staged(lambda a, o: dist.reduce_scatter_tensor(
        o, a, group=group), x, group, out)
    return out.movedim(0, dim)


def own_block(x, group, dim):
    """This rank's block of ``x`` along ``dim`` (equal blocks in group rank
    order)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim)[i].contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return own_block(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_block(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


def copy_to_model(x, group):
    """Identity; backward: the gradient all-reduced over ``group``. The
    input of a column-parallel layer, whose ranks each hold a slice of its
    output channels and so a partial gradient of its input."""
    return _CopyToModel.apply(x, group)


def gather_channels(x, group, dim=1):
    """All-gather along ``dim`` over ``group``; backward: this rank's slice
    of the gradient. Its consumers must compute the same on every rank of
    ``group`` (a replicated tensor), so the gradient is whole on each."""
    return _Gather.apply(x, group, dim)


def scatter(x, group, dim):
    """This rank's block of ``x`` along ``dim``; backward: the ranks'
    gradients all-gathered, so a replicated producer of ``x`` gets the
    whole gradient on every rank."""
    return _Scatter.apply(x, group, dim)


def gather_sum(x, group, dim=0):
    """All-gather along ``dim`` over ``group``; backward: reduce-scatter
    (the gradient summed over the ranks, each keeping its block): the
    transpose where the ranks consume the gathered tensor differently."""
    return _GatherSum.apply(x, group, dim)


def _exchange(x, group, to, frm, like):
    """Send ``x`` to group rank ``to`` (None: send nothing) and receive from
    ``frm`` (None: receive nothing) a tensor shaped as ``like``; returns the
    received tensor, or zeros where nothing arrives."""
    out = torch.zeros_like(like)
    host = _via_host(like, group)
    ops, recv = [], out.cpu() if host else out
    if to is not None:
        send = x.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, send.cpu() if host else send,
                              dist.get_global_rank(group, to), group))
    if frm is not None:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if host and frm is not None:
        out = recv.to(like.device)
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step):
        n, i = dist.get_world_size(group), dist.get_rank(group)
        to, frm = i + step, i - step
        to = to if 0 <= to < n else None
        frm = frm if 0 <= frm < n else None
        ctx.group, ctx.route, ctx.shape = group, (to, frm), x.shape
        return _exchange(x, group, to, frm, x)

    @staticmethod
    def backward(ctx, g):
        to, frm = ctx.route
        # the gradient of what arrived goes back to its sender; what this
        # rank sent comes back as its receiver's gradient
        back = g if frm is not None else None
        like = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        got = _exchange(back, ctx.group, frm, to, like)
        return got, None, None


def shift(x, group, step=1):
    """Rank i of ``group`` sends ``x`` to rank i + ``step`` and receives
    rank i - ``step``'s ``x`` (same shape), all at once
    (``dist.batch_isend_irecv``). A rank with no sender gets zeros.
    Backward: each received gradient goes back to its sender."""
    return _Shift.apply(x, group, step)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.detach().contiguous()
        (out,) = _staged(lambda a, o: dist.all_to_all_single(
            o, a, group=group), x, group, torch.empty_like(x))
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        (out,) = _staged(lambda a, o: dist.all_to_all_single(
            o, a, group=ctx.group), g, ctx.group, torch.empty_like(g))
        return out, None


def all_to_all(x, group):
    """Split ``x``'s leading axis into one equal block a rank of ``group``,
    send block j to rank j, and stack the received blocks in rank order
    (``dist.all_to_all_single``); backward: the same exchange of the
    gradient, which sends each block back where it came from."""
    return _AllToAll.apply(x, group)
