"""The training loop: pipeline -> train step -> snapshots and metrics
(counterpart of hand3d_tpu/train/loop.py).

As in the JAX package: input batches prefetch on a host thread and
preprocess on the device; the LR schedule advances with the step counter;
snapshots keep the Adam state and resume exactly; a watchdog ends a hung
run with exit code 17; SIGTERM / SIGINT save a snapshot and stop.
``steps_per_call > 1`` holds the whole dataset on the device and runs
windows of that many steps (``trainer.make_resident_train_step``: on a CUDA
device, replays of one captured step).

``mesh`` trains data-parallel over the ranks of a ``parallel.make_mesh``:
every rank starts from rank 0's params, is fed its rows of each global batch
and takes the same update. Rank 0 alone writes snapshots and the metrics log
and reports (each write followed by a barrier); a SIGTERM / SIGINT on any
rank stops every rank at the same step, agreed at each step boundary.
"""

import contextlib
import os
import signal
import sys
import threading
import time

import numpy as np

from hand3d_tpu_torch.data.pipeline import epoch_indices, resident_data
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train import checkpoints
from hand3d_tpu_torch.train.trainer import (init_state,
                                            make_resident_train_step,
                                            make_train_step, tree_leaves)

WATCHDOG_EXIT_CODE = 17


class _Watchdog:
    """End the process if no training step completes within ``timeout``.

    A wedged device call blocks the main thread inside native code, where no
    Python exception can reach it, so the only sound recovery is at process
    level: log, flush, and exit with a distinctive code for a supervisor to
    restart with --resume. ``beat()`` marks progress; ``stop()`` disarms it
    when the loop returns, or whatever runs after training (eval, export, a
    second fit) would be killed ``timeout`` seconds later.
    """

    def __init__(self, timeout, progress, log):
        self.timeout = timeout
        self.progress = progress
        self.log = log
        self._last = time.monotonic()
        self._stopped = False
        self._suspended = False
        threading.Thread(target=self._watch, daemon=True,
                         name="step-watchdog").start()

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stopped = True

    @contextlib.contextmanager
    def suspended(self):
        """Pause hang detection for a legitimately long operation (an
        in-training eval pass); the clock restarts when it ends."""
        self._suspended = True
        try:
            yield
        finally:
            self.beat()
            self._suspended = False

    def _watch(self):
        while not self._stopped:
            time.sleep(min(self.timeout / 4.0, 5.0))
            if self._suspended:
                continue
            stale = time.monotonic() - self._last
            if not self._stopped and stale > self.timeout:
                self.log(
                    f"step watchdog: no progress for {stale:.0f}s at "
                    f"iteration {self.progress['iter']} — device hang; "
                    f"exiting {WATCHDOG_EXIT_CODE} so a supervisor can "
                    "restart and --resume from the latest snapshot")
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(WATCHDOG_EXIT_CODE)


def fit(loss_fn, params, optimizer, pipeline, max_iter, *, seed=0,
        show_loss_freq=1000, snapshot_freq=5000, snapshot_dir=None,
        resume=False, step_timeout=None, log=print, metrics_logger=None,
        remat=False, accum_steps=1, eval_fn=None, eval_freq=0,
        snapshot_on_sigterm=True, steps_per_call=1, mesh=None):
    """Train ``params`` with ``loss_fn(params, batch, generator)``.

    Returns the final TrainState (the caller's ``params`` are copied, not
    updated). The reference's loop shape: a loss line every
    ``show_loss_freq`` steps, a snapshot every ``snapshot_freq``, a final
    snapshot at the end. Step i draws from generators keyed (seed, i).

    ``step_timeout``: seconds without a completed step before the watchdog
    ends the process (None: off). ``eval_fn(state, step) -> dict`` runs every
    ``eval_freq`` steps and after the last, with the watchdog suspended; its
    metrics go to ``log`` and the metrics logger. ``snapshot_on_sigterm``: on
    SIGTERM / SIGINT save the state into ``snapshot_dir`` and return, so a
    restart with ``resume`` loses nothing (main thread only).

    ``steps_per_call > 1``: device-resident training. The whole dataset goes
    to the device once, in its record dtypes, and each call runs up to
    ``steps_per_call`` steps (``trainer.make_resident_train_step``) on the
    per-step path's batches and draws. It needs a fused pipeline
    (``yield_raw``). A window is the unit of progress: one read of its
    losses, one watchdog beat; snapshots and evals land on the first window
    boundary at or after each configured step, and every step's loss is
    still reported, with the LR the device took for it.

    ``mesh`` (``parallel.make_mesh``): data-parallel training. The pipeline
    must be sharded over the mesh (``InputPipeline(mesh=...)``); ``--resume``
    reads on every rank, then every rank takes rank 0's params. Snapshots,
    the metrics log and ``log`` are rank 0's; the evals run on every rank
    (``eval_fn`` runs the mesh harness); a stop signal on any rank stops all
    of them at the same step. The watchdog is per rank.
    """
    if steps_per_call > 1:
        if mesh is not None:
            raise ValueError(
                "steps_per_call > 1 does not compose with a mesh yet: the "
                "resident dataset would need per-shard index streams; run "
                "multi-step training single-device")
        if not getattr(pipeline, "yield_raw", False):
            raise ValueError(
                "steps_per_call > 1 requires a fused pipeline "
                "(InputPipeline(..., yield_raw=True)): preprocessing must "
                "run inside the resident step")
    lead = mesh is None or mesh_lib.process_index() == 0
    rank_log = log  # the watchdog's, on every rank
    if mesh is not None:
        want = (mesh_lib.data_index(mesh), mesh_lib.batch_shard_count(mesh))
        if getattr(pipeline, "process_shard", (0, 1)) != want:
            raise ValueError(
                f"the pipeline reads shard {pipeline.process_shard} of each "
                f"epoch, the mesh feeds shard {want}: build it with "
                "InputPipeline(..., mesh=mesh)")
        if not lead:  # rank 0 reports and writes the metrics log
            log, metrics_logger = (lambda *a, **k: None), None
    state = init_state(params, optimizer)
    start_step = 0
    if resume and snapshot_dir:
        latest = checkpoints.latest_snapshot(snapshot_dir)
        if latest:
            state = checkpoints.restore_snapshot(latest, state)
            start_step = state.step
            log(f"Resumed from {latest} at step {start_step}")
    if mesh is not None:  # every rank starts from rank 0's params
        mesh_lib.broadcast_(tree_leaves(state.params), mesh)
    if steps_per_call > 1:
        step_fn = make_resident_train_step(loss_fn, optimizer, remat=remat,
                                           accum_steps=accum_steps)
    else:
        step_fn = make_train_step(loss_fn, optimizer, remat=remat,
                                  accum_steps=accum_steps, mesh=mesh)

    preempt = {"signal": None}
    old_handlers = {}
    if snapshot_on_sigterm and snapshot_dir and (
            threading.current_thread() is threading.main_thread()):

        def on_signal(signum, frame):
            preempt["signal"] = signum
            # the previous handler again, so a SECOND signal acts at once
            # (^C ^C ends a hung save)
            signal.signal(signum, old_handlers[signum])

        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, on_signal)

    progress = {"iter": start_step}
    watchdog = (_Watchdog(step_timeout, progress, rank_log) if step_timeout
                else None)
    loop = _Loop(progress, watchdog, show_loss_freq, snapshot_freq,
                 snapshot_dir, metrics_logger, log, eval_fn, eval_freq,
                 preempt, mesh, lead)
    it = None
    try:
        if steps_per_call > 1:
            return _run_loop_resident(state, step_fn, pipeline, seed,
                                      start_step, max_iter, steps_per_call,
                                      loop)
        # a resumed run restarts the data stream where the interrupted one
        # stopped: the same epoch order and augmentation draws as an
        # uninterrupted run
        if start_step:
            spe = pipeline.steps_per_epoch()
            it = pipeline.iterate(epochs=None, start_epoch=start_step // spe,
                                  skip_steps=start_step % spe)
        else:
            it = pipeline.iterate(epochs=None)
        return _run_loop(state, step_fn, it, seed, start_step, max_iter,
                         loop)
    finally:
        # disarm even on an exception a caller catches
        if watchdog is not None:
            watchdog.stop()
        if it is not None:
            it.close()  # stops the prefetch thread
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)


class _Loop:
    """What both loops share: progress, watchdog, reporting, snapshots,
    evals and the preemption flag."""

    def __init__(self, progress, watchdog, show_loss_freq, snapshot_freq,
                 snapshot_dir, metrics_logger, log, eval_fn, eval_freq,
                 preempt, mesh=None, lead=True):
        self.progress = progress
        self.watchdog = watchdog
        self.show_loss_freq = show_loss_freq
        self.snapshot_freq = snapshot_freq
        self.snapshot_dir = snapshot_dir
        self.metrics_logger = metrics_logger
        self.log = log
        self.eval_fn = eval_fn
        self.eval_freq = eval_freq
        self.preempt = preempt
        self.mesh = mesh
        self.lead = lead  # the rank that writes snapshots
        self.t0 = time.perf_counter()

    def beat(self):
        if self.watchdog is not None:
            self.watchdog.beat()

    def preempted(self, state, i):
        """On a pending SIGTERM / SIGINT: snapshot at ``i`` and say so. Under
        a mesh the ranks agree first (a signal on any rank stops them all
        here): a rank that stopped alone would leave the others blocked in
        a collective."""
        signum = self.preempt["signal"]
        if self.mesh is not None:
            if not mesh_lib.any_rank(signum is not None):
                return False
        elif signum is None:
            return False
        self.log(f"signal {signum if signum is not None else 'on a peer'}: "
                 f"saving snapshot at iteration {i} and stopping")
        self.snapshot(state, i)
        return True

    def report(self, i, loss_v, start_step, **extra):
        rate = (i - start_step + 1) / (time.perf_counter() - self.t0)
        self.log(f"Iteration {i}\t Loss {loss_v:.1e}\t {rate:.1f} it/s")
        sys.stdout.flush()
        if self.metrics_logger is not None:
            self.metrics_logger.log(step=i, loss=loss_v, steps_per_s=rate,
                                    **extra)

    def snapshot(self, state, step):
        if self.snapshot_dir:
            if self.lead:
                checkpoints.save_snapshot(self.snapshot_dir, state, step=step)
            if self.mesh is not None:
                mesh_lib.barrier()

    def run_eval(self, state, step):
        ctx = self.watchdog.suspended() if self.watchdog is not None \
            else contextlib.nullcontext()
        with ctx:
            results = {k: float(v)
                       for k, v in self.eval_fn(state, step).items()}
        line = "  ".join(f"{k} {v:.4g}" for k, v in results.items())
        self.log(f"Eval @ {step}\t {line}")
        if self.metrics_logger is not None:
            self.metrics_logger.log(step=step, **{f"eval_{k}": v
                                                  for k, v in results.items()})

    def finish(self, state, max_iter):
        if self.eval_fn is not None:
            self.run_eval(state, max_iter)
        self.snapshot(state, max_iter)
        return state


def _run_loop_resident(state, step_fn, pipeline, seed, start_step, max_iter,
                       steps_per_call, loop):
    """Windows of up to ``steps_per_call`` steps over the dataset held on
    the device. The index rows are the per-step pipeline's epoch order
    exactly (``epoch_indices`` of seed + epoch), and step i draws from the
    key (seed, i), so the trajectory is the per-step path's."""
    spe = pipeline.steps_per_epoch()
    n = len(pipeline.dataset)
    data = resident_data(pipeline.dataset, pipeline.device)
    nbytes = sum(v.numel() * v.element_size() for v in data.values())
    loop.log(f"resident dataset: {n} records, {nbytes / 1e6:.1f} MB on "
             f"{pipeline.device}, {steps_per_call} steps/call")
    epochs = {}

    def row(i):
        epoch = i // spe
        if epoch not in epochs:
            epochs.clear()  # windows advance monotonically
            epochs[epoch] = epoch_indices(n, pipeline.batch_size, True,
                                          pipeline.seed + epoch)
        return epochs[epoch][i % spe]

    i = start_step
    while i < max_iter:
        if loop.preempted(state, i):
            return state
        loop.progress["iter"] = i
        k = min(steps_per_call, max_iter - i)
        idx = np.stack([row(j) for j in range(i, i + k)])
        state, metrics = step_fn(state, data, idx, seed, i)
        # the window is the unit of progress: reading its losses (and the
        # LRs the device took) waits for every step in it
        losses, lrs = metrics.cpu().numpy()
        loop.beat()
        end = i + k
        finite = np.isfinite(losses)
        if not finite.all():
            bad = i + int(np.argmin(finite))
            loop.snapshot(state, end)
            raise FloatingPointError(
                f"non-finite loss {losses[bad - i]} at iteration {bad}")
        if loop.show_loss_freq:
            for j in range(i, end):
                if j % loop.show_loss_freq == 0:
                    loop.report(j, float(losses[j - i]), start_step,
                                lr=float(lrs[j - i]))
        # snapshots and evals land on the first window boundary at or after
        # each configured step (a state inside a window does not exist
        # here); the end of the run has its own below
        inside = [j for j in range(i, end) if j > 0]
        if end < max_iter:
            if loop.snapshot_dir and loop.snapshot_freq and any(
                    j % loop.snapshot_freq == 0 for j in inside):
                loop.snapshot(state, end)
                loop.log("Saved a snapshot.")
            if loop.eval_fn is not None and loop.eval_freq and any(
                    j % loop.eval_freq == 0 for j in inside):
                loop.run_eval(state, end)
        i = end
    return loop.finish(state, max_iter)


def _run_loop(state, step_fn, it, seed, start_step, max_iter, loop):
    pending_loss = None  # the previous step's loss, fetched one step behind
    for i in range(start_step, max_iter):
        if loop.preempted(state, i):
            return state
        loop.progress["iter"] = i
        batch = next(it)
        state, metrics = step_fn(state, batch, (seed, i))
        # a step counts once its loss is real; fetching the PREVIOUS step's
        # keeps one step in flight, so the host prepares step i + 1 while
        # the device runs step i
        if pending_loss is not None:
            float(pending_loss)
            loop.beat()
        pending_loss = metrics["loss"]

        if loop.show_loss_freq and i % loop.show_loss_freq == 0:
            loss_v = float(metrics["loss"])
            if not (loss_v == loss_v and abs(loss_v) != float("inf")):
                # keep the state for a post-mortem, labelled i + 1: it
                # holds iteration i's update
                loop.snapshot(state, i + 1)
                raise FloatingPointError(
                    f"non-finite loss {loss_v} at iteration {i}")
            loop.report(i, loss_v, start_step)

        if (loop.snapshot_dir and loop.snapshot_freq
                and i % loop.snapshot_freq == 0 and i > 0):
            # labelled i + 1 == state.step, the counter inside
            loop.snapshot(state, i + 1)
            loop.log("Saved a snapshot.")

        if (loop.eval_fn is not None and loop.eval_freq
                and i % loop.eval_freq == 0 and i > 0):
            loop.run_eval(state, i)

    if pending_loss is not None:
        float(pending_loss)  # the last step also completes under the watchdog
        loop.beat()
    return loop.finish(state, max_iter)
