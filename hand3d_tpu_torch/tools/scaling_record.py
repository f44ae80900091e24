"""Data-parallel weak scaling of the PoseNet train step over ranks
(counterpart of tools/scaling_record.py).

For n_data = 1, 2, 4 and 8 ranks, each with a per-device batch of
``--per-device-batch`` crops (weak scaling: the global batch grows with
n_data), the tool measures

  * the wall time of the full-width PoseNet train step (forward, backward,
    the gradients summed over the ranks, Adam), one warm-up step and then
    ``--steps`` steps, each ended by ``loss.item()``;
  * the collective schedule of one timed step: every torch.distributed
    collective the ranks call, by op, with its calls and the bytes each rank
    sends (:func:`counted_collectives`). The JAX tool reads the same
    schedule from the compiled HLO.

The ranks are processes, one a device of the mesh, which the tool starts
itself: each calls ``precision.exact_f32``, ``parallel.mesh.init_distributed``
and ``make_mesh(n, 1)``, and takes its rows of the global batch in rank
order. Where they run decides the backend and the ideal, before any rank
starts:

  * on a host with C >= 2 cards, one NCCL rank a card (n_data <= C). Each
    rank has its own card, so the ideal step time is flat:
    ``vs_flat_ideal = step / step(n=1)``;
  * on one card, or with ``--device cpu``, n_data gloo ranks share the
    device (NCCL refuses two ranks on one card). This is the JAX tool's
    virtual mesh, one device time-sliced, whose ideal grows linearly:
    ``vs_linear_ideal = step / (step(n=1) * n_data)``.

A rank that fails, or a group that cannot be set up, fails the tool; no
other backend or device is tried.

The step is the JAX tool's: ``posenet_scoremap_loss`` of PoseNet at full
width (``posenet.init`` over a numpy generator seeded 0), its gradients
from ``train.trainer.DataParallelGrads`` and Adam at 1e-4
(``trainer.make_optimizer``), params broadcast from rank 0 once. The data
(a numpy generator seeded 1): ``image_crop`` N(0, 1) * 0.1, ``scoremap``
U[0, 1), ``keypoint_vis21`` ones, at ``size`` x ``size`` (32, as the JAX
tool; :func:`measure` takes 256, the training crop).

What the step all-reduces: the gradients (``gradient_bytes``, 70,075,388 at
full width) and two f32 scalars (``scalar_bytes``): the count of visible
keypoints, the loss's denominator (``losses.global_sum``), and the loss,
which rides in the gradients' bucket. JAX's step all-reduces four: the same
count and each of the three prediction heads' numerators, from which every
device then forms the loss. At n_data 1 ``DataParallelGrads`` all-reduces
over a group of one rank, and the row says so; the JAX step has no
collective there.

Each row keeps the JAX tool's keys, with ``first_step_s`` (the warm-up
step, which carries cuDNN's algorithm search) in place of ``compile_s``,
and adds ``backend``, ``devices``, ``size`` and ``card``: nvidia-smi's name
and power limit of rank 0's card.

Usage:
  python -m hand3d_tpu_torch.tools.scaling_record [--steps 10]
      [--per-device-batch 2] [--write-doc FILE] [--json-out FILE]
      [--device cuda]
"""

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from hand3d_tpu_torch import precision, weights
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.tools import card
from hand3d_tpu_torch.train import losses, trainer

RANKS = (1, 2, 4, 8)
# f32 bytes the step all-reduces beyond its gradients
SCALAR_BYTES = {"visible_keypoints": 4, "loss": 4}
GROUP_OF_ONE = ("DataParallelGrads all-reduces over a group of one rank; "
                "the JAX step has no collective at n_data 1")
# seconds run_processes waits for its processes; init_distributed's own
# timeout bounds a collective that waits for a missing peer
WAIT_S = 900
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_CODE = ("import sys\n"
             "from hand3d_tpu_torch.tools import scaling_record\n"
             "scaling_record.rank_main(*sys.argv[1:])\n")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "broadcast",
               "batch_isend_irecv")


@contextlib.contextmanager
def counted_collectives():
    """Count the calls and the bytes this rank sends through each
    torch.distributed collective: {op: {"calls", "bytes"}} of the ops
    called inside (the collectives of the port look them up at each
    call)."""
    sent = {}
    base = {n: getattr(dist, n) for n in COLLECTIVES}

    def nbytes(name, args):
        if name == "batch_isend_irecv":
            return sum(op.tensor.numel() * op.tensor.element_size()
                       for op in args[0] if op.op is dist.isend)
        t = args[1] if name in ("all_gather", "all_gather_into_tensor",
                                "reduce_scatter_tensor",
                                "all_to_all_single") else args[0]
        return t.numel() * t.element_size()

    def counting(name):
        def call(*args, **kwargs):
            c = sent.setdefault(name, {"calls": 0, "bytes": 0})
            c["calls"] += 1
            c["bytes"] += nbytes(name, args)
            return base[name](*args, **kwargs)
        return call

    for n in COLLECTIVES:
        setattr(dist, n, counting(n))
    try:
        yield sent
    finally:
        for n in COLLECTIVES:
            setattr(dist, n, base[n])


def placement(n_data, device):
    """(backend, [each rank's device]) of ``n_data`` ranks on ``device``'s
    host: one NCCL rank a card where it has two cards or more, else gloo
    ranks that share the one device."""
    device = precision.exact_f32(device)
    if device.type != "cuda":
        return "gloo", [str(device)] * n_data
    cards = torch.cuda.device_count()
    if cards == 1:
        return "gloo", [f"cuda:{device.index or 0}"] * n_data
    if n_data > cards:
        raise ValueError(f"{n_data} NCCL ranks asked for on {cards} cards")
    return "nccl", [f"cuda:{r}" for r in range(n_data)]


def rank_counts(device):
    """The n_data the CLI measures: every one of :data:`RANKS` on a shared
    device, as many as there are cards under NCCL."""
    device = precision.exact_f32(device)
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        return tuple(n for n in RANKS if n <= torch.cuda.device_count())
    return RANKS


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_processes(commands, envs=None):
    """Start every command at once from the repository root (``envs``:
    each one's environment) and return each one's last stdout line that
    starts with ``{`` as JSON. The first that exits non-zero, or
    :data:`WAIT_S` running out, stops the others and raises."""
    envs = envs or [None] * len(commands)
    outs = [tempfile.TemporaryFile("w+") for _ in commands]
    procs = []
    try:
        for cmd, env, out in zip(commands, envs, outs):
            procs.append(subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=ROOT))
        deadline = time.monotonic() + WAIT_S
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or None not in codes:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(procs)} processes still ran after "
                                   f"{WAIT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out in outs:
            out.seek(0)
            texts.append(out.read())
            out.close()
    if failed:
        r = failed[0]
        raise RuntimeError(f"process {r} of {len(procs)} exited "
                           f"{procs[r].returncode}:\n{texts[r][-4000:]}")
    # library warnings may follow the last JSON line
    return [json.loads([l for l in t.splitlines() if l.startswith("{")][-1])
            for t in texts]


def run_ranks(args_of_rank, devices):
    """:func:`run_processes` of one :func:`rank_main` a device, called with
    ``args_of_rank(r)``; LOCAL_RANK is each rank's card."""
    return run_processes(
        [[sys.executable, "-c", RANK_CODE, *(str(a) for a in args_of_rank(r))]
         for r in range(len(devices))],
        [dict(os.environ, LOCAL_RANK=str(torch.device(d).index or 0))
         for d in devices])


def step_data(global_batch, size):
    """The global batch (numpy, seeded 1) of the JAX tool's step."""
    rng = np.random.default_rng(1)
    return {
        "image_crop": (rng.standard_normal((global_batch, size, size, 3))
                       * 0.1).astype(np.float32),
        "scoremap": rng.random((global_batch, size, size, posenet.NUM_KP),
                               dtype=np.float32),
        "keypoint_vis21": np.ones((global_batch, posenet.NUM_KP),
                                  np.float32),
    }


def loss_fn(params, data, generator):
    preds = posenet.apply(params[posenet.SCOPE], data["image_crop"])
    return losses.posenet_scoremap_loss(preds, data["scoremap"],
                                        data["keypoint_vis21"])


def rank_main(rank, world, port, device, backend, per_device_batch, steps,
              size):
    """One rank of :func:`measure`: one warm-up step, then ``steps`` timed
    steps, the last one's collectives counted. Prints its result as its
    last stdout line."""
    rank, world, steps, size = int(rank), int(world), int(steps), int(size)
    per_device_batch = int(per_device_batch)
    dev = precision.exact_f32(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores, as they share a card
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh_lib.init_distributed(f"127.0.0.1:{port}", world, rank,
                              backend=backend)
    mesh = mesh_lib.make_mesh(world, 1)
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(0))}, dev)
    optimizer = trainer.make_optimizer([1e-4], [])
    state = trainer.init_state(params, optimizer)
    mesh_lib.broadcast_(trainer.tree_leaves(state.params))
    lo, per = mesh_lib.shard_rows(mesh, per_device_batch * world)
    batch = {k: torch.from_numpy(v[lo:lo + per]).to(dev)
             for k, v in step_data(per_device_batch * world, size).items()}
    grads_of = trainer.DataParallelGrads(loss_fn, mesh)

    def step(i):
        nonlocal state
        t0 = time.perf_counter()
        loss, grads = grads_of(state.params, batch, (0, i))
        optimizer.apply(state.opt_state, state.params, grads, state.step)
        state = state._replace(step=state.step + 1)
        value = loss.item()
        return time.perf_counter() - t0, value, grads

    first_s, value, _ = step(0)
    times, values = [], [value]
    for i in range(1, steps + 1):
        if i < steps:
            t, value, grads = step(i)
        else:
            with counted_collectives() as sent:
                t, value, grads = step(i)
        times.append(t)
        values.append(value)
    dist.destroy_process_group()
    print(json.dumps({
        "rank": rank, "first_step_s": first_s, "times_s": times,
        "losses": values, "collectives": sent,
        "gradient_bytes": sum(g.numel() * g.element_size() for g in grads),
        "card": card.label(card.card(dev))}), flush=True)


def measure(n_data, per_device_batch, steps, size=32, device="cuda"):
    """One row: the DP PoseNet step over ``n_data`` ranks at
    ``per_device_batch`` ``size`` x ``size`` crops a rank, median and min
    of ``steps`` timed steps (rank 0's), the collectives of one of them."""
    backend, devices = placement(n_data, device)
    port = _free_port()
    ranks = run_ranks(lambda r: (r, n_data, port, devices[r], backend,
                                 per_device_batch, steps, size), devices)
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        raise RuntimeError(f"the ranks' losses differ: "
                           f"{[r['losses'] for r in ranks]}")
    if any(r["collectives"] != ranks[0]["collectives"] for r in ranks):
        raise RuntimeError("the ranks' collectives differ: "
                           f"{[r['collectives'] for r in ranks]}")
    head = ranks[0]
    times = sorted(head["times_s"])
    med = times[len(times) // 2]  # the JAX tool's median
    batch = per_device_batch * n_data
    row = {
        "n_data": n_data,
        "global_batch": batch,
        "step_ms_median": med * 1e3,
        "step_ms_min": times[0] * 1e3,
        "samples_per_s": batch / med,
        "first_step_s": head["first_step_s"],
        "collectives_per_step": head["collectives"],
        "collective_bytes_per_step": sum(
            c["bytes"] for c in head["collectives"].values()),
        "gradient_bytes": head["gradient_bytes"],
        "scalar_bytes": SCALAR_BYTES,
        "backend": backend,
        "devices": devices,
        "size": size,
        "card": head["card"],
    }
    if n_data == 1 and head["collectives"]:
        row["note"] = GROUP_OF_ONE
    return row


def against_ideal(rows):
    """Add each row's step time over its ideal, from ``rows[0]`` (n_data 1,
    the same size): ``vs_flat_ideal`` for ranks on cards of their own
    (NCCL), ``vs_linear_ideal`` for ranks that share a device (gloo)."""
    base = rows[0]
    if base["n_data"] != 1 or any(r["size"] != base["size"] for r in rows):
        raise ValueError("the rows must start at n_data 1 and share a size")
    for r in rows:
        if r["backend"] == "nccl":
            r["vs_flat_ideal"] = r["step_ms_median"] / base["step_ms_median"]
        else:
            r["vs_linear_ideal"] = r["step_ms_median"] / (
                base["step_ms_median"] * r["n_data"])
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--per-device-batch", type=int, default=2)
    p.add_argument("--write-doc", default=None,
                   help="append the markdown table to this file")
    p.add_argument("--json-out", default=None)
    card.add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    """One JSON row an n_data, then the summary line; returns the
    summary."""
    args = parse_args(argv)
    rows = []
    for n in rank_counts(args.device):
        r = measure(n, args.per_device_batch, args.steps, device=args.device)
        print(json.dumps(r), flush=True)
        rows.append(r)
    against_ideal(rows)
    summary = {"gate": "scaling_record",
               "per_device_batch": args.per_device_batch,
               "steps": args.steps, "rows": rows}
    print(json.dumps(summary), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(summary, f, indent=1)
    if args.write_doc:
        with open(args.write_doc, "a") as f:
            f.write(_markdown(summary))
    return summary


def _markdown(s):
    rows = s["rows"]
    flat = "vs_flat_ideal" in rows[0]
    ideal = "vs_flat_ideal" if flat else "vs_linear_ideal"
    lines = [
        "",
        f"## DP weak scaling of the PoseNet step ({rows[0]['backend']} "
        f"ranks, {rows[0]['card']})",
        "",
        f"Per-device batch {s['per_device_batch']} at "
        f"{rows[0]['size']}x{rows[0]['size']}, full-width PoseNet train step "
        f"(fwd+bwd+Adam), median of {s['steps']} steps after one warm-up "
        "step. " + (
            "Each rank has a card of its own, so the ideal step time is "
            "flat in n_data." if flat else
            "The ranks share one device, so the ideal step time grows "
            "linearly with n_data.") + " The collectives are counted in "
        "one timed step, by op, with the bytes each rank sends.",
        "",
        "| n_data | global batch | step ms (median) | samples/s | "
        f"{ideal.replace('_', ' ')} | collectives/step | "
        "collective MB/step |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        coll = ", ".join(f"{k}×{v['calls']}" for k, v in
                         sorted(r["collectives_per_step"].items())) or "none"
        lines.append(
            f"| {r['n_data']} | {r['global_batch']} | "
            f"{r['step_ms_median']:.1f} | {r['samples_per_s']:.1f} | "
            f"{r[ideal]:.2f} | {coll} | "
            f"{r['collective_bytes_per_step'] / 1e6:.1f} |")
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    main()
