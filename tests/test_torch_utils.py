"""utils/debug and utils/profiling of the port against hand3d_tpu's, on the
CPU: the same all_finite answer and FloatingPointError text as JAX on the
same trees; a trace file written and a StageTimer report."""

import glob
import json

import jax
import numpy as np
import pytest
import torch

from hand3d_tpu.utils import debug as j_debug
from hand3d_tpu_torch.utils import debug, profiling

from torch_tmp import tmp_path  # noqa: F401


def _trees():
    finite = {"b": [np.ones(2, np.float32), np.arange(3)],
              "a": {"w": np.zeros((2, 2), np.float32)}}
    nan = {"b": [np.ones(2, np.float32), np.array([1.0, np.nan], np.float32)],
           "a": {"w": np.zeros((2, 2), np.float32)}}
    inf_first = {"z": np.array([np.inf], np.float32),
                 "a": {"w": np.array([np.nan], np.float32)}}
    ints = {"k": np.arange(4), "n": None}
    return {"finite": finite, "nan": nan, "inf_first": inf_first,
            "ints": ints}


@pytest.mark.parametrize("case", list(_trees()))
def test_finite_checks_answer_as_jax(case):
    tree = _trees()[case]
    as_torch = jax.tree_util.tree_map(torch.from_numpy, tree)
    want = bool(j_debug.all_finite(tree))
    assert bool(debug.all_finite(tree)) == want
    assert bool(debug.all_finite(as_torch)) == want
    try:
        j_debug.check_finite_pytree(tree, "snap")
        message = None
    except FloatingPointError as e:
        message = str(e)
    for t in (tree, as_torch):
        if message is None:
            assert debug.check_finite_pytree(t, "snap") is t
        else:
            with pytest.raises(FloatingPointError) as e:
                debug.check_finite_pytree(t, "snap")
            assert str(e.value) == message


def test_nan_debugging_turns_on_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "t" / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in a.key for a in prof.key_averages())


def test_stage_timer_reports_each_stage():
    timer = profiling.StageTimer(warmup=1, iters=3, device="cpu")
    calls = []
    t = timer.measure("ones", lambda n: calls.append(torch.ones(n)), 8)
    assert t > 0 and len(calls) == 4 and timer.results == {"ones": t}
    timer.measure("zeros", torch.zeros, 8)
    lines = []
    timer.report(log=lines.append)
    assert [l.split()[0] for l in lines] == (
        sorted(timer.results, key=lambda k: -timer.results[k]) + ["total"])
    assert lines[-1].endswith("ms")
