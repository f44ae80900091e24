"""One run of one cell: set-up, a measured window, the correctness check and
the result line (``run.py`` is the command).

A cell is ``workloads/<name>.json``: its configuration (``configs/<config>
.json``), its traffic generator (``traffic/<generator>.py``) with the
traffic's parameters, the chips it takes and the limits of its correctness
numbers. Which metrics a cell reports, and their units, ``BENCHMARK.json``
says (``cell_metrics``); a per-layer metric's reader is
``metrics/<name>.py``. Nothing here names a cell, a configuration or a
metric.

The generator module provides ``setup(run) -> state``,
``window(run, state) -> result`` and ``check(run, state, result)``; the
harness times the set-up, reads the memory peak after the window, and
prints. Under ``chips`` > 1 this process is rank 0: it starts one process a
further card (``--rank``), each runs the same module, and rank 0 alone
prints the result.
"""

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
MANIFEST = BENCH.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "hand3d_tpu")


class Run:
    """What one run knows and records; passed to the generator and to the
    per-layer readers."""

    def __init__(self, name, seed, seconds, trace, rank=0, device=None,
                 overrides=None):
        self.name = name
        self.workload = load_json(BENCH / "workloads" / f"{name}.json")
        self.config = load_json(BENCH / "configs"
                                / f"{self.workload['config']}.json")
        self.params = dict(self.workload["params"], **(overrides or {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace_on = bool(trace)
        self.rank = rank
        self.chips = int(self.params.get("chips", self.workload["chips"]))
        self.device = device
        tmp = Path(os.environ.get("TMPDIR", "/tmp"))
        self.tmp = tmp / "hand3d_benchmark" / name
        self.tmp.mkdir(parents=True, exist_ok=True)
        self.e2e_metrics, self.layer_metrics = cell_metrics(
            load_json(MANIFEST), name)
        self.spans = {}  # name -> [(start, end)] on the host clock
        self.counters = {}
        self.e2e = {}  # end-to-end metric name -> value (setup_s apart)
        self.numbers = {}  # name -> (value, limit)
        self.trace = None  # this rank's trace.Trace
        self.rank_traces = []  # (busy_s, window_s) of every rank
        self.attempted = 0
        self.failed = 0
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.children = []

    def span(self, name, start, end):
        self.spans.setdefault(name, []).append((start, end))

    def judge(self, readings):
        """Hold each reading to the cell's limit for it."""
        for k, v in readings.items():
            self.numbers[k] = (float(v), float(self.workload["limits"][k]))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_metrics(manifest, cell):
    """The end-to-end and per-layer entries of ``manifest`` (BENCHMARK.json)
    that ``cell`` reports: each that lists the cell under ``workloads``, and
    each without such a list (an end-to-end metric of every cell; a
    per-layer metric of every cell that reports the metric it moves)."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return e2e, layer


def load_reader(name):
    """The module ``metrics/<name>.py`` of a per-layer metric."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(args, world):
    """Processes of ranks 1..world-1, the launcher's environment set."""
    port = free_port()
    base = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), LOCAL_WORLD_SIZE=str(world))
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      LOCAL_WORLD_SIZE=str(world))
    procs = []
    for r in range(1, world):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(BENCH / "run.py"), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--rank", str(r)],
            env=env, stdout=subprocess.DEVNULL))
    return procs


def stop_ranks(procs, timeout):
    """Wait for the rank processes; end any that outlive ``timeout``.
    Returns their exit codes."""
    codes = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            codes.append(p.wait(max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def per_layer(run):
    """The cell's per-layer metrics, and the names of those whose reader
    found nothing to read (left out of the metrics, named on standard
    error and in the result line)."""
    out, unread = {}, []
    for m in run.layer_metrics:
        value = load_reader(m["name"]).read(run)
        if value is None:
            unread.append(m["name"])
            print(f"{m['name']}: its reader found nothing to read",
                  file=sys.stderr)
        else:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out, unread


def end_to_end(run):
    """The cell's end-to-end metrics; what the generator measured has to be
    what BENCHMARK.json lists for the cell."""
    listed = {m["name"]: m["unit"] for m in run.e2e_metrics}
    values = dict(run.e2e, setup_s=run.setup_s)
    if set(values) != set(listed):
        raise ValueError(f"{run.name} measured {sorted(values)}; "
                         f"BENCHMARK.json lists {sorted(listed)}")
    return {k: {"value": float(v), "unit": listed[k]}
            for k, v in values.items()}


def execute(run, module):
    """Set-up, window, check: the run's records filled in."""
    import torch

    t0 = run.t0
    state = module.setup(run)
    run.setup_s = time.perf_counter() - t0
    result = module.window(run, state)
    if run.device.type == "cuda":
        run.memory_peak_bytes = max(run.memory_peak_bytes,
                                    torch.cuda.max_memory_allocated(run.device))
    module.check(run, state, result)


def device_info(run):
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}


def main(argv=None, t0=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    t0 = time.perf_counter() if t0 is None else t0

    import torch

    wl = load_json(BENCH / "workloads" / f"{args.workload}.json")
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)
    run = Run(args.workload, args.seed, args.seconds, args.trace, args.rank,
              device)
    run.t0 = t0
    run.args = args
    module = importlib.import_module(f"benchmark.traffic.{wl['generator']}")
    if chips > 1 and args.rank == 0:
        run.start_ranks = lambda: start_ranks(args, chips)
    try:
        execute(run, module)
    finally:
        codes = stop_ranks(run.children, 120.0) if run.children else []
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"rank processes exited with {codes}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"the process holds {', '.join(found)} after the window",
              file=sys.stderr)
        return 4
    return report(run)


def report(run):
    correct = bool(run.numbers) and run.failed == 0 and all(
        v <= lim for v, lim in run.numbers.values())
    unread = []
    if run.trace_on:
        metrics, unread = per_layer(run)
    else:
        metrics = end_to_end(run)
    line = {"correct": correct, "attempted": int(run.attempted),
            "failed": int(run.failed), "metrics": metrics,
            "device": device_info(run)}
    if run.trace_on:
        traces = run.rank_traces or [(run.trace.busy_s, run.trace.window_s)]
        line["device"]["busy_s"] = sum(b for b, _ in traces) / len(traces)
        line["device"]["window_s"] = sum(w for _, w in traces) / len(traces)
        line["breakdown"] = run.trace.breakdown()
        line["unread"] = unread
    line["checked"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in run.numbers.items()}
    line["checked"]["failed"] = {"value": run.failed, "limit": 0}
    for k, c in line["checked"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
