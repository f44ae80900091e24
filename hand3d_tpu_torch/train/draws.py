"""Draw plans of the train step: its randomness made ahead on the host.

A train step draws its augmentation noise and dropout masks from CPU
generators named by the step (``step_generator``), through the primitives
of ``data/augment.py`` (``augment.drawn``). Which draws a step makes, and of
what shape, depends only on the batch's shapes and the config, never on its
values. So the sequence is recorded once (``record``), and the draws of K
steps are then made on the host from each step's own generators, in that
order, with the very calls the per-step path makes (``DrawPlan.fill``): the
values are the per-step path's, bit for bit. In the step, a ``Planned``
source stands where the generator stood and returns the device slices of
those values in the same order.

Under a data-parallel mesh a rank holds some rows of a step's global batch.
Its draws are still those of the global batch: a ``Rows`` source draws at
the global batch's shape and hands the rank its rows, so the step does not
depend on the number of ranks.
"""

from typing import Any, Callable, NamedTuple

import torch

from hand3d_tpu_torch.data import augment

# first word of the train step's generators, apart from the input pipeline's
STEP_STREAM = 1


def step_generator(key, j, accum_steps):
    """The generator of microbatch ``j`` of the step named ``key`` (a tuple
    of non-negative integers, (seed, step) in the loop): (key) without
    accumulation, (key, j) with it."""
    if accum_steps == 1:
        return augment.generator(STEP_STREAM, *key)
    return augment.generator(STEP_STREAM, *key, j)


# the argument of each draw primitive that holds the shape of its draw,
# whose leading axis is the batch's
_SHAPE_ARG = {augment.truncated_normal.__wrapped__: 0,
              augment.uniform.__wrapped__: 0,
              augment.randint.__wrapped__: 1,
              augment.keep.__wrapped__: 1}


class Rows:
    """A draw source for rows ``[lo, lo + rows)`` of a batch of ``total``:
    each draw is made at the whole batch's shape, from ``source`` (a
    generator or another draw source), and sliced to those rows."""

    def __init__(self, source, total, lo, rows):
        self.source = source
        self.total = total
        self.lo = lo
        self.rows = rows

    def draw(self, fn, args):
        i = _SHAPE_ARG[fn]
        shape = tuple(args[i])
        if not shape or shape[0] != self.rows:
            raise ValueError(f"draw {fn.__name__}{args}: its leading axis "
                             f"is not the batch's {self.rows} rows")
        whole = args[:i] + ((self.total, *shape[1:]),) + args[i + 1:]
        if isinstance(self.source, torch.Generator):
            out = fn(self.source, *whole)
        else:
            out = self.source.draw(fn, whole)
        return out[self.lo:self.lo + self.rows]

    def get_state(self):
        return self.source.get_state()

    def set_state(self, state):
        self.source.set_state(state)


class Call(NamedTuple):
    """One draw of a step: the primitive, its arguments, what it gave."""
    fn: Callable
    args: tuple
    dtype: Any
    shape: tuple

    @property
    def size(self):
        n = 1
        for d in self.shape:
            n *= d
        return n


class Recorder:
    """A draw source that draws from a CPU generator, as the per-step path
    does, and notes each call. ``get_state`` / ``set_state`` rewind the
    generator and the notes together (a recomputed forward draws again)."""

    def __init__(self, generator):
        self.generator = generator
        self.calls = []

    def draw(self, fn, args):
        out = fn(self.generator, *args)
        self.calls.append(Call(fn, args, out.dtype, tuple(out.shape)))
        return out

    def get_state(self):
        return self.generator.get_state(), len(self.calls)

    def set_state(self, state):
        self.generator.set_state(state[0])
        del self.calls[state[1]:]


class Planned:
    """A draw source over one microbatch's planned values: ``row`` is a
    float32 tensor on the step's device holding them back to back, in
    ``calls``' order. Each draw returns the next slice in the drawn dtype
    (int64 and bool values are exact in float32). A draw that is not the
    planned one raises; ``get_state`` / ``set_state`` rewind."""

    def __init__(self, row, calls):
        self.row = row
        self.calls = calls
        self.pos = 0
        self.offsets = []
        off = 0
        for call in calls:
            self.offsets.append(off)
            off += call.size

    def draw(self, fn, args):
        if self.pos >= len(self.calls):
            raise RuntimeError(f"unplanned draw {fn.__name__}{args}: the "
                               "plan holds fewer draws than the step makes")
        call = self.calls[self.pos]
        if call.fn is not fn or call.args != args:
            raise RuntimeError(
                f"draw {self.pos} is {fn.__name__}{args}, the plan holds "
                f"{call.fn.__name__}{call.args}: the step draws otherwise "
                "than when its plan was recorded")
        off = self.offsets[self.pos]
        self.pos += 1
        return self.row[off:off + call.size].view(call.shape).to(call.dtype)

    def get_state(self):
        return self.pos

    def set_state(self, pos):
        self.pos = pos


def record(loss_fn, params, microbatches):
    """The draw calls of one step, per microbatch: ``loss_fn`` run forward
    (no gradients) on each microbatch with a recording source."""
    calls = []
    with torch.no_grad():
        for micro in microbatches:
            rec = Recorder(torch.Generator().manual_seed(0))
            loss_fn(params, micro, rec)
            calls.append(rec.calls)
    return calls


class DrawPlan:
    """The recorded draws of a step, per microbatch, and their layout in a
    float32 row of ``width`` values: microbatch 0's draws, then 1's, ..."""

    def __init__(self, micro_calls):
        self.micro_calls = micro_calls
        self.spans = []
        off = 0
        for calls in micro_calls:
            n = sum(c.size for c in calls)
            self.spans.append((off, off + n))
            off += n
        self.width = off

    def fill(self, out, seed, steps):
        """Write the draws of ``steps`` (absolute step numbers) into the rows
        of ``out`` [len(steps), width], each from its own generators, by the
        calls the per-step path makes."""
        accum = len(self.micro_calls)
        for r, i in enumerate(steps):
            for j, calls in enumerate(self.micro_calls):
                gen = step_generator((seed, i), j, accum)
                off = self.spans[j][0]
                for call in calls:
                    value = call.fn(gen, *call.args)
                    out[r, off:off + call.size].copy_(value.reshape(-1))
                    off += call.size

    def sources(self, row):
        """One ``Planned`` source per microbatch over a step's ``row``."""
        return [Planned(row[a:b], calls)
                for (a, b), calls in zip(self.spans, self.micro_calls)]


class Windows:
    """Rows of a window of steps, staged on the host and sent to the device
    with one non-blocking copy.

    On a CUDA device two pinned host buffers take turns: before one is
    refilled, the host waits for the event recorded after its last copy,
    so rows still in flight are never overwritten. On the CPU the copy is
    synchronous and the turns are harmless.
    """

    def __init__(self, rows, width, device):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.dev = torch.zeros((rows, width), dtype=torch.float32,
                               device=self.device)
        self.host = [torch.zeros((rows, width), dtype=torch.float32,
                                 pin_memory=pin) for _ in range(2)]
        self.events = [None, None]
        self.turn = 0

    def send(self, fill, k):
        """``fill(host_rows)`` writes the first ``k`` rows; they are then on
        their way to ``self.dev[:k]``, ordered before later work on the
        current stream."""
        if k > self.dev.shape[0]:
            raise ValueError(f"window of {k} steps exceeds the "
                             f"{self.dev.shape[0]} the step was built for")
        b = self.turn
        self.turn ^= 1
        if self.events[b] is not None:
            self.events[b].synchronize()
        host = self.host[b][:k]
        fill(host)
        self.dev[:k].copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self.events[b] = event
