"""NCCL all-reduce kernel time a step in rank 0's trace: the gradient
bucket (70,075,396 bytes a step) and the loss."""

from benchmark.flops import peaks


def read(run):
    if run.trace is None or not run.counters.get("traced_steps"):
        return None
    t = run.trace.kernel_time(peaks.ALL_REDUCE)
    if t <= 0:
        return None
    return 1e3 * t / run.counters["traced_steps"]
