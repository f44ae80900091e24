"""The data-parallel step as a CUDA graph on one card: one NCCL rank, mesh
1x1. Run by tests/test_torch_dp_graph.py:

    python tests/torch_dp_graph_worker.py PORT DATA OUT_DIR

DATA is an RHD .bin file. The process joins an NCCL group of one rank at
127.0.0.1:PORT and builds each train CLI's job with ``--mesh 1x1
--deterministic`` (the test sets CUBLAS_WORKSPACE_CONFIG before CUDA
starts), so that a graphed step and an eager one can be held to each other
bit for bit. The eager step is ``DataParallelGrads`` and the Adam update,
what ``make_train_step(mesh=)`` ran before it became a graph. What it saw
goes to OUT_DIR/result.pkl; the test judges it.
"""

import os
import pickle
import sys

import torch

from hand3d_tpu_torch.cli import (train_handsegnet, train_joint,
                                  train_lifting, train_posenet)
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train import trainer
from hand3d_tpu_torch.utils import profiling

BATCH = 4
GRAPHED_STEPS = 4
BEHIND_STEPS = 6  # graphed steps whose losses are read one step behind
CLIS = {"posenet": (train_posenet, []),
        # the preprocess in the input pipeline: a step that draws nothing
        "posenet_unfused": (train_posenet, ["--no-fused"]),
        "handsegnet": (train_handsegnet, []),
        "lifting": (train_lifting, ["--variant", "proposed"]),
        "joint": (train_joint, ["--variant", "proposed"])}
COUNTERS = ("train.step_graph.replays", "train.step_graph.eager")
IN_FLIGHT = "train.step_graph.in_flight"


def setup(name, data, tmp):
    module, extra = CLIS[name]
    return module.setup([*extra, "--data", data, "--batch-size", str(BATCH),
                         "--mesh", "1x1", "--deterministic",
                         "--snapshot-dir", os.path.join(tmp, name)])


def batches(job, n):
    it = job.pipeline.iterate(epochs=None)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def equal(a, b):
    """Params and Adam moments of two states equal bit for bit."""
    la, lb = trainer.tree_leaves(a.params), trainer.tree_leaves(b.params)
    return all(torch.equal(x, y) for x, y in zip(la, lb)) and all(
        torch.equal(a.opt_state.state[x][k], b.opt_state.state[y][k])
        for x, y in zip(la, lb) for k in ("step", "exp_avg", "exp_avg_sq"))


class Counted:
    """The graph counters' growth since the last ``take``."""

    def __init__(self):
        self.last = profiling.counters()
        self.flights = self.last.get(IN_FLIGHT, 0)

    def take(self):
        now = profiling.counters()
        out = {k: now.get(k, 0) - self.last.get(k, 0) for k in COUNTERS}
        self.last = now
        return out

    def in_flight(self):
        """``train.step_graph.in_flight``'s growth since the last call."""
        now = profiling.counters().get(IN_FLIGHT, 0)
        out, self.flights = now - self.flights, now
        return out


def pair(job):
    """(graphed step, eager step, two equal fresh states)."""
    opt = job.optimizer
    mesh = job.options["mesh"]
    graphed = trainer.make_train_step(job.loss, opt, mesh=mesh)
    grads_of = trainer.DataParallelGrads(job.loss, mesh)

    def eager(state, batch, key):
        loss, grads = grads_of(state.params, batch, key)
        opt.apply(state.opt_state, state.params, grads, state.step)
        return state._replace(step=state.step + 1), {"loss": loss}

    return (graphed, eager, trainer.init_state(job.params, opt),
            trainer.init_state(job.params, opt))


def steps_check(data, tmp):
    """GRAPHED_STEPS graphed steps against eager ones; then a state that is
    not the captured one; then a batch of half the rows."""
    job = setup("posenet", data, tmp)
    step, eager, g, e = pair(job)
    feed = batches(job, GRAPHED_STEPS + 1)
    counted = Counted()
    out = {"graph": [], "eager": []}
    for i in range(GRAPHED_STEPS):
        g, mg = step(g, feed[i], (0, i))
        e, me = eager(e, feed[i], (0, i))
        out["graph"].append(mg["loss"].item())
        out["eager"].append(me["loss"].item())
    out["equal"] = equal(g, e)
    out["counters"] = counted.take()
    out["in_flight"] = counted.in_flight()  # each loss was read at once
    try:
        step(trainer.init_state(job.params, job.optimizer), feed[0], (0, 9))
        out["replaced"] = None
    except ValueError as err:
        out["replaced"] = str(err)
    out["replaced_counters"] = counted.take()
    half = {k: v[:BATCH // 2] for k, v in feed[GRAPHED_STEPS].items()}
    g, mg = step(g, half, (0, GRAPHED_STEPS))
    e, me = eager(e, half, (0, GRAPHED_STEPS))
    out["half"] = {"graph": mg["loss"].item(), "eager": me["loss"].item(),
                   "equal": equal(g, e), "counters": counted.take()}
    g, mg = step(g, feed[0], (0, GRAPHED_STEPS + 1))
    e, me = eager(e, feed[0], (0, GRAPHED_STEPS + 1))
    out["after_half"] = {"graph": mg["loss"].item(),
                         "eager": me["loss"].item(), "equal": equal(g, e),
                         "counters": counted.take()}
    return out


def behind_check(data, tmp):
    """BEHIND_STEPS graphed steps, each loss read after the next step is
    launched (as ``loop._run_loop`` reads it), against as many eager steps;
    every reading is kept and read again at the end."""
    job = setup("posenet", data, tmp)
    step, eager, g, e = pair(job)
    feed = batches(job, BEHIND_STEPS)
    counted = Counted()
    readings, first_reads, pending = [], [], None
    for i in range(BEHIND_STEPS):
        g, mg = step(g, feed[i], (0, i))
        if pending is not None:
            first_reads.append(float(pending))
        pending = mg["loss"]
        readings.append(pending)
    first_reads.append(float(pending))
    out = {"counters": counted.take(), "in_flight": counted.in_flight(),
           "kinds": sorted({type(r).__name__ for r in readings}),
           "first_reads": first_reads,
           "graph": [float(r) for r in readings], "eager": []}
    for i in range(BEHIND_STEPS):
        e, me = eager(e, feed[i], (0, i))
        out["eager"].append(me["loss"].item())
    out["equal"] = equal(g, e)
    return out


def cli_check(name, data, tmp):
    """One graphed step of the CLI's loss against one eager step."""
    job = setup(name, data, tmp)
    step, eager, g, e = pair(job)
    (batch,) = batches(job, 1)
    counted = Counted()
    g, mg = step(g, batch, (0, 0))
    e, me = eager(e, batch, (0, 0))
    return {"graph": mg["loss"].item(), "eager": me["loss"].item(),
            "equal": equal(g, e), "counters": counted.take(),
            "draws": step.plan.width}


def main():
    port, data, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    mesh_lib.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    out = {"device": torch.cuda.get_device_name(0),
           "backend": torch.distributed.get_backend(),
           "steps": steps_check(data, out_dir),
           "behind": behind_check(data, out_dir)}
    out["clis"] = {name: cli_check(name, data, out_dir) for name in CLIS}
    with open(os.path.join(out_dir, "result.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
