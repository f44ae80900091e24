"""PoseNet training: the job ``cli.train_posenet.setup`` builds, stepped as
``train.loop.fit`` steps it.

The records (the RHD layout) and the PoseNet weights are the seed's,
written into the run's temporary directory and handed to the CLI as
``--data`` and ``--weights``. The benchmark then takes the job's loss,
optimizer and pipeline and makes the calls ``fit`` makes on its two paths,
without its logging and snapshots:

* ``resident`` (``--steps-per-call K``, one card): ``init_state``,
  ``resident_data``, ``make_resident_train_step``; windows of K steps on the
  per-step path's epoch order (``epoch_indices``), each ending in the read of
  its losses;
* ``per_step`` (``--mesh Dx1``, one rank a card): ``init_state``, rank 0's
  params broadcast, ``make_train_step(mesh=)`` on the pipeline's batches,
  each step's loss read one step behind.

Set-up drives the state through its first three steps by those same calls
(on the resident path a first window of 1 step, then one of 2: a window may
shrink below the K it was built for), keeping the Adam state after step 1
and the params after step 3 for the check, and then through
``warmup_steps`` more; on the resident path the first of those is a whole
window of K steps, whose losses the check compares too. The window counts
whole calls.

Parameters: ``path``, ``batch_size`` (a rank's), ``steps_per_call`` (the
resident path's K), ``records``, ``crop_size``, ``warmup_steps``,
``trace_seconds``, ``rate_metric`` (the end-to-end metric the samples per
second are reported as).
"""

import os
import sys
import time

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.reference import posenet_train

CHECK_STEPS = 3


def _argv(run, data, weights):
    prm = run.params
    argv = ["--data", str(data), "--weights", str(weights), "--seed",
            str(run.seed), "--batch-size", str(prm["batch_size"]),
            "--crop-size", str(prm["crop_size"]), "--device", str(
                run.device.type), "--snapshot-dir", str(run.tmp / "snap")]
    if prm["path"] == "resident":
        argv += ["--steps-per-call", str(prm["steps_per_call"])]
    else:
        argv += ["--mesh", f"{run.chips}x1"]
    return argv


def _leaves(state):
    """{name: tensor} of the state's PoseNet params, and their Adam slots."""
    out = {}
    for scope, sub in state.params.items():
        for layer, leaf in sub.items():
            for key, t in leaf.items():
                out[f"{scope}/{layer}/{key}"] = t
    return out


def setup(run):
    from hand3d_tpu_torch.cli import train_posenet

    prm = run.params
    data, weights_path = run.tmp / "records.bin", run.tmp / "weights.npz"
    if run.rank == 0:
        records = inputs.make_records(run.seed, prm["records"], run.device)
        records.tofile(data)
        weights = inputs.make_weights(run.seed, run.device,
                                      scopes=("PoseNet2D",))
        np.savez(weights_path, **{f"PoseNet2D/{layer}/{key}": arr
                                  for layer, leaf in weights["PoseNet2D"]
                                  .items() for key, arr in leaf.items()})
        if run.chips > 1:
            run.children = run.start_ranks()
    else:
        records = weights = None
    job = train_posenet.setup(_argv(run, data, weights_path))
    st = {"job": job, "records": records, "weights": weights,
          "files": (data, weights_path)}
    if prm["path"] == "resident":
        _setup_resident(run, st)
    else:
        _setup_per_step(run, st)
    return st


def _readings(st, state, step):
    """After step 1: each leaf's first gradient, from Adam's first moment
    (exp_avg = (1 - b1) g after one update); after step 3: the params."""
    leaves = _leaves(state)
    if step == 1:
        opt = state.opt_state
        st["grad0"] = {n: float(opt.state[t]["exp_avg"].norm()) / (1 - 0.9)
                       for n, t in leaves.items()}
    if step == CHECK_STEPS:
        st["delta"] = {n: float((t.detach() - st["p0"][n]).norm())
                       for n, t in leaves.items()}


def _setup_resident(run, st):
    from hand3d_tpu_torch.data.pipeline import epoch_indices, resident_data
    from hand3d_tpu_torch.train.trainer import (init_state,
                                                make_resident_train_step)

    job, prm = st["job"], run.params
    opts = job.options
    pipe = job.pipeline
    state = init_state(job.params, job.optimizer)
    st["p0"] = {n: t.detach().clone() for n, t in _leaves(state).items()}
    step_fn = make_resident_train_step(job.loss, job.optimizer,
                                       remat=opts["remat"],
                                       accum_steps=opts["accum_steps"])
    data = resident_data(pipe.dataset, pipe.device)
    spe = pipe.steps_per_epoch()
    n = len(pipe.dataset)
    epochs = {}

    def rows(i, k):
        out = []
        for j in range(i, i + k):
            e = j // spe
            if e not in epochs:
                epochs.clear()
                epochs[e] = epoch_indices(n, pipe.batch_size, True,
                                          pipe.seed + e)
            out.append(epochs[e][j % spe])
        return np.stack(out)

    k = prm["steps_per_call"]
    seed = opts["seed"]
    # the first window: built for K steps, run for 1
    step_fn.load(state, data, rows(0, k), seed, 0)
    state, metrics = step_fn.run(state, 1, 0)
    losses = list(metrics.cpu().numpy()[0])
    _readings(st, state, 1)
    state, metrics = step_fn(state, data, rows(1, 2), seed, 1)
    losses += list(metrics.cpu().numpy()[0])
    _readings(st, state, CHECK_STEPS)
    st["losses"] = losses
    i = CHECK_STEPS
    while i < CHECK_STEPS + prm["warmup_steps"]:
        state, metrics = step_fn(state, data, rows(i, k), seed, i)
        losses = metrics.cpu().numpy()[0]
        if i == CHECK_STEPS:  # a whole window, every position of it
            st["window_losses"] = list(losses)
        i += k
    st.update(state=state, step_fn=step_fn, data=data, rows=rows, i=i,
              seed=seed)


def _window_resident(run, st):
    prm = run.params
    k = prm["steps_per_call"]
    state, step_fn, data, rows = st["state"], st["step_fn"], st["data"], \
        st["rows"]
    done = 0
    t_start = time.perf_counter()
    t_end = t_start

    def one_call():
        nonlocal state, done, t_end
        i = st["i"]
        a = time.perf_counter()
        run.attempted += k
        state, metrics = step_fn(state, data, rows(i, k), st["seed"], i)
        losses = metrics.cpu().numpy()[0]
        t_end = time.perf_counter()
        run.failed += int((~np.isfinite(losses)).sum())
        run.span("train_call", a, t_end)
        st["i"] = i + k
        done += k

    traced_for = prm["trace_seconds"] if run.trace_on else run.seconds
    with trace.traced(run.tmp / "trace.json", run.trace_on) as held:
        while time.perf_counter() - t_start < traced_for:
            one_call()
        run.counters["traced_steps"] = done
    run.trace = held.trace
    while time.perf_counter() - t_start < run.seconds:
        one_call()
    st["state"] = state
    return done, t_end - t_start


def _setup_per_step(run, st):
    from hand3d_tpu_torch.parallel import mesh as mesh_lib
    from hand3d_tpu_torch.train.trainer import (init_state, make_train_step,
                                                shard_state, tree_leaves)

    job, prm = st["job"], run.params
    opts = job.options
    mesh = opts["mesh"]
    state = init_state(job.params, job.optimizer)
    mesh_lib.broadcast_(tree_leaves(state.params))
    state = shard_state(mesh, state)
    st["p0"] = {n: t.detach().clone() for n, t in _leaves(state).items()}
    step_fn = make_train_step(job.loss, job.optimizer, remat=opts["remat"],
                              accum_steps=opts["accum_steps"], mesh=mesh)
    it = job.pipeline.iterate(epochs=None)
    seed = opts["seed"]
    losses = []
    for i in range(CHECK_STEPS):
        state, metrics = step_fn(state, next(it), (seed, i))
        losses.append(float(metrics["loss"]))
        _readings(st, state, i + 1)
    st["losses"] = losses
    i = CHECK_STEPS
    warm = max(2, prm["warmup_steps"])
    pending = None
    for j in range(warm):
        if j == warm // 2:  # time the second half of the warm-up
            float(pending)
            t0, j0 = time.perf_counter(), j
        state, metrics = step_fn(state, next(it), (seed, i))
        if pending is not None:
            float(pending)
        pending = metrics["loss"]
        i += 1
    float(pending)
    per_step = (time.perf_counter() - t0) / (warm - j0)
    # every rank takes rank 0's count of window steps: the ranks step
    # together, so they must stop together
    count = torch.tensor([run.seconds / per_step], device=run.device)
    torch.distributed.broadcast(count, 0)
    st.update(state=state, step_fn=step_fn, it=it, i=i, seed=seed,
              window_steps=max(1, int(round(float(count)))))


def _window_per_step(run, st):
    prm = run.params
    state, step_fn, it = st["state"], st["step_fn"], st["it"]
    n_steps = st["window_steps"]
    traced_steps = n_steps
    if run.trace_on:
        traced_steps = max(1, int(n_steps * prm["trace_seconds"]
                                  / run.seconds))
    done = 0
    pending = None
    t_start = time.perf_counter()

    def steps(count):
        nonlocal state, done, pending
        for _ in range(count):
            i = st["i"]
            run.attempted += 1
            state, metrics = step_fn(state, next(it), (st["seed"], i))
            if pending is not None:
                if not np.isfinite(float(pending)):
                    run.failed += 1
            pending = metrics["loss"]
            st["i"] = i + 1
            done += 1

    with trace.traced(run.tmp / f"trace{run.rank}.json", run.trace_on) \
            as held:
        steps(traced_steps)
        if not np.isfinite(float(pending)):
            run.failed += 1
        pending = None
        run.counters["traced_steps"] = done
    run.trace = held.trace
    steps(n_steps - traced_steps)
    if pending is not None and not np.isfinite(float(pending)):
        run.failed += 1
    t_end = time.perf_counter()
    st["state"] = state
    return done, t_end - t_start


def window(run, st):
    prm = run.params
    if prm["path"] == "resident":
        done, elapsed = _window_resident(run, st)
    else:
        done, elapsed = _window_per_step(run, st)
    samples = done * prm["batch_size"] * run.chips
    run.counters.update(steps=done, window_s=elapsed)
    run.e2e[prm["rate_metric"]] = samples / elapsed
    if run.chips > 1:
        _gather_ranks(run)
    return None


def _gather_ranks(run):
    """Every rank's memory peak and traced busy time, at rank 0."""
    import torch.distributed as dist

    mine = [float(torch.cuda.max_memory_allocated(run.device)),
            run.trace.busy_s if run.trace else 0.0,
            run.trace.window_s if run.trace else 0.0]
    got = [None] * run.chips
    dist.all_gather_object(got, mine)
    run.memory_peak_bytes = max(g[0] for g in got)
    if run.trace:
        run.rank_traces = [(g[1], g[2]) for g in got]


def check(run, st, _):
    prm = run.params
    if prm["path"] == "per_step":
        st["it"].close()
        import torch.distributed as dist

        dist.barrier()
    for key in ("state", "step_fn", "data", "job", "it"):
        st.pop(key, None)
    torch.cuda.empty_cache()
    if prm["path"] == "per_step":
        dist.destroy_process_group()
    if run.rank != 0:
        return
    steps = CHECK_STEPS + len(st.get("window_losses", ()))
    ref = posenet_train.run(st["weights"], st["records"], run.seed,
                            prm["batch_size"], run.chips, steps, run.device,
                            crop_size=prm["crop_size"], delta_at=CHECK_STEPS)
    for path in st["files"]:
        os.remove(path)
    run.judge(compare(st, ref, sys.stderr))


def compare(got, ref, report=None):
    """The training numbers:

    * ``loss_gap``: the first step's loss gap (relative). Steps 2 and 3's
      losses move with the signs Adam gives gradients that are nought to
      rounding, so they are reported, not compared;
    * ``grad_gap``: by the worst leaf, the gap between the program's and the
      reference's norms of the first gradient, over the reference's norm of
      that leaf or of the median leaf, whichever is larger;
    * ``delta_gap``: the same gap for each leaf's change after three steps,
      the median over the leaves. The worst leaf is reported, not compared:
      a small leaf's change moves by 2 LR in each element whose gradient is
      nought to rounding and flips its sign (a bias of 256 reads 1.3e-3 on
      some seeds where every other leaf reads 1e-4). Leaves whose reference
      gradient is under a thousandth of the median leaf's are left out of
      the change (Adam moves them by rounding alone);
    * ``window_loss_gap`` (where ``got`` has ``window_losses``, the losses
      of a whole window of K steps after the third): the largest relative
      loss gap over the window's positions, against the reference's steps
      4 to 3 + K.

    ``report`` (a file) gets each step's loss gap and the three worst leaves
    of each leaf number."""
    checked = len(got["losses"])
    steps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["loss"])]
    g_ref = ref["grad0"]
    g_med = float(np.median(list(g_ref.values())))
    grads = {n: abs(got["grad0"][n] - g) / max(g, g_med)
             for n, g in g_ref.items()}
    d_ref = {n: d for n, d in ref["delta"].items() if g_ref[n] >= 1e-3 * g_med}
    d_med = float(np.median(list(d_ref.values())))
    deltas = {n: abs(got["delta"][n] - d) / max(d, d_med)
              for n, d in d_ref.items()}
    out = {"loss_gap": steps[0], "grad_gap": max(grads.values()),
           "delta_gap": float(np.median(list(deltas.values())))}
    window = [abs(a - b) / abs(b) for a, b in
              zip(got.get("window_losses", ()), ref["loss"][checked:])]
    if window:
        out["window_loss_gap"] = max(window)
    if report is not None:
        print(f"loss gap by step: {steps}", file=report)
        if window:
            print(f"window loss gap by position: {window}", file=report)
        for what, gaps in (("grad", grads), ("delta", deltas)):
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
            print(f"{what} gap, worst leaves: {worst}", file=report)
    return out
