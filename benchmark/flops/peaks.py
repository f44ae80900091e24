"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W): what every roofline and mfu share divides by. A card set
below 700 W reaches less; ``power_limit`` reads the card's limit so that it
is printed beside the shares."""

import json
import re
import subprocess
from pathlib import Path

PEAK_F32 = 67e12  # FLOP/s, float32 outside the tensor cores
PEAK_INT32 = PEAK_F32 / 4  # 64 int32 lanes an SM and clock against 128 f32
PEAK_HBM = 3.35e12  # bytes/s

_KERNELS = json.loads((Path(__file__).with_name("kernels.json")).read_text())
CONV = re.compile("|".join(f"(?:{p})" for p in _KERNELS["conv"]))
FLOOD_FILL = re.compile(_KERNELS["flood_fill"])
DECODE = re.compile(_KERNELS["decode"])
ALL_REDUCE = re.compile(_KERNELS["all_reduce"])


def power_limit():
    """The cards' names and power limits, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
