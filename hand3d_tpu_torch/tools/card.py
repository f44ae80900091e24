"""What the measuring tools share: the ``--device`` flag, the card's name
and power limit, and a timer.

``profile_stages``, ``memory_report`` and ``roofline`` report the card's own
numbers, and a card may be set below its maximum power and then run slower
under load, so every time, rate and byte count they print stands beside the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.
"""

import subprocess
import time

import torch

SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader")


def add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device to measure (default cuda; raises when "
                        "there is no card). 'cpu' runs the plain kernel "
                        "twins and times on the host clock.")


def nvidia_smi():
    """nvidia-smi's "NAME, LIMIT" lines, one a card; raises OSError or
    ``subprocess.SubprocessError`` when they cannot be read."""
    return subprocess.run(SMI_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def card(device):
    """{"name", "power_limit"} of ``device``: nvidia-smi's line for a card
    (its own device index), "cpu" and None for the host."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        lines = nvidia_smi().splitlines()
        line = lines[min(index, len(lines) - 1)]
        name, power = (s.strip() for s in line.rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError):
        name, power = torch.cuda.get_device_name(device), "not read"
    return {"name": name, "power_limit": power}


def label(info):
    """``card``'s dict as nvidia-smi prints it: "NAME, LIMIT"."""
    if info["power_limit"] is None:
        return info["name"]
    return f"{info['name']}, {info['power_limit']}"


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, args=(), iters=10, device="cuda", warmup=2):
    """Milliseconds a call of ``fn(*args)`` takes, the mean of ``iters``
    back-to-back calls after ``warmup`` calls.

    On a card, two CUDA events bracket the ``iters`` calls on the current
    stream: they time the device's work from the first kernel's start to
    the last one's end, and a host that launches slower than the device
    runs shows as its own pace. On the CPU, the host clock."""
    device = torch.device(device)
    with torch.inference_mode():
        for _ in range(warmup):
            fn(*args)
        synchronize(device)
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) * 1e3 / iters
