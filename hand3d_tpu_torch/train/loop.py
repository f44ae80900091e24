"""The training loop: pipeline -> train step -> snapshots and metrics
(counterpart of hand3d_tpu/train/loop.py, its per-step path).

As in the JAX package: input batches prefetch on a host thread and
preprocess on the device; the LR schedule advances with the step counter;
snapshots keep the Adam state and resume exactly; a watchdog ends a hung
run with exit code 17; SIGTERM / SIGINT save a snapshot and stop. The
device-resident multi-step path (``steps_per_call > 1``) is not ported.
"""

import contextlib
import os
import signal
import sys
import threading
import time

from hand3d_tpu_torch.train import checkpoints
from hand3d_tpu_torch.train.trainer import init_state, make_train_step

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
        snapshot_on_sigterm=True, steps_per_call=1):
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
    ``steps_per_call > 1`` (device-resident training) is not ported and
    raises.
    """
    if steps_per_call > 1:
        raise NotImplementedError(
            "steps_per_call > 1 (device-resident multi-step training) is "
            "not ported: ROADMAP.md 'Still to port', queue 1")
    state = init_state(params, optimizer)
    start_step = 0
    if resume and snapshot_dir:
        latest = checkpoints.latest_snapshot(snapshot_dir)
        if latest:
            state = checkpoints.restore_snapshot(latest, state)
            start_step = state.step
            log(f"Resumed from {latest} at step {start_step}")
    step_fn = make_train_step(loss_fn, optimizer, remat=remat,
                              accum_steps=accum_steps)

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
    watchdog = _Watchdog(step_timeout, progress, log) if step_timeout else None
    # a resumed run restarts the data stream where the interrupted one
    # stopped: the same epoch order and augmentation draws as an
    # uninterrupted run
    if start_step:
        spe = pipeline.steps_per_epoch()
        it = pipeline.iterate(epochs=None, start_epoch=start_step // spe,
                              skip_steps=start_step % spe)
    else:
        it = pipeline.iterate(epochs=None)
    try:
        return _run_loop(state, step_fn, it, seed, start_step, max_iter,
                         progress, watchdog, show_loss_freq, snapshot_freq,
                         snapshot_dir, metrics_logger, log, eval_fn,
                         eval_freq, preempt)
    finally:
        # disarm even on an exception a caller catches
        if watchdog is not None:
            watchdog.stop()
        it.close()  # stops the prefetch thread
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)


def _run_loop(state, step_fn, it, seed, start_step, max_iter, progress,
              watchdog, show_loss_freq, snapshot_freq, snapshot_dir,
              metrics_logger, log, eval_fn, eval_freq, preempt):
    t0 = time.perf_counter()

    def run_eval(state, step):
        ctx = watchdog.suspended() if watchdog is not None \
            else contextlib.nullcontext()
        with ctx:
            results = {k: float(v) for k, v in eval_fn(state, step).items()}
        line = "  ".join(f"{k} {v:.4g}" for k, v in results.items())
        log(f"Eval @ {step}\t {line}")
        if metrics_logger is not None:
            metrics_logger.log(step=step, **{f"eval_{k}": v
                                             for k, v in results.items()})

    pending_loss = None  # the previous step's loss, fetched one step behind
    for i in range(start_step, max_iter):
        if preempt["signal"] is not None:
            log(f"signal {preempt['signal']}: saving snapshot at "
                f"iteration {i} and stopping")
            if snapshot_dir:
                checkpoints.save_snapshot(snapshot_dir, state, step=i)
            return state
        progress["iter"] = i
        batch = next(it)
        state, metrics = step_fn(state, batch, (seed, i))
        # a step counts once its loss is real; fetching the PREVIOUS step's
        # keeps one step in flight, so the host prepares step i + 1 while
        # the device runs step i
        if pending_loss is not None:
            float(pending_loss)
            if watchdog is not None:
                watchdog.beat()
        pending_loss = metrics["loss"]

        if show_loss_freq and i % show_loss_freq == 0:
            loss_v = float(metrics["loss"])
            if not (loss_v == loss_v and abs(loss_v) != float("inf")):
                # keep the state for a post-mortem, labelled i + 1: it
                # holds iteration i's update
                if snapshot_dir:
                    checkpoints.save_snapshot(snapshot_dir, state, step=i + 1)
                raise FloatingPointError(
                    f"non-finite loss {loss_v} at iteration {i}")
            rate = (i - start_step + 1) / (time.perf_counter() - t0)
            log(f"Iteration {i}\t Loss {loss_v:.1e}\t {rate:.1f} it/s")
            sys.stdout.flush()
            if metrics_logger is not None:
                metrics_logger.log(step=i, loss=loss_v, steps_per_s=rate)

        if snapshot_dir and snapshot_freq and i % snapshot_freq == 0 and i > 0:
            # labelled i + 1 == state.step, the counter inside
            checkpoints.save_snapshot(snapshot_dir, state, step=i + 1)
            log("Saved a snapshot.")

        if eval_fn is not None and eval_freq and i % eval_freq == 0 and i > 0:
            run_eval(state, i)

    if pending_loss is not None:
        float(pending_loss)  # the last step also completes under the watchdog
        if watchdog is not None:
            watchdog.beat()
    if eval_fn is not None:
        run_eval(state, max_iter)
    if snapshot_dir:
        checkpoints.save_snapshot(snapshot_dir, state, step=max_iter)
    return state
