"""The port's scaling record (hand3d_tpu_torch.tools.scaling_record) against
the JAX tool (tools/scaling_record.py), on the CPU with gloo ranks.

Both tools run the full-width PoseNet train step data-parallel at n_data 2
and count what it all-reduces. The gradients are the same 62 tensors,
70,075,388 bytes. Beyond them each side all-reduces f32 scalars:

- JAX (GSPMD, read from the compiled HLO): four, 16 bytes. The count of
  visible keypoints (the loss's denominator) in an all-reduce of its own,
  and the three prediction heads' numerators (sum of vis * rms error) in
  the gradients' tuple; each device then forms the loss from them.
- The port (``trainer.DataParallelGrads``): two, 8 bytes. The same count
  (``losses.global_sum``), and the loss itself in the gradients' bucket.

So the JAX record's 70,075,404 bytes a step and the port's 70,075,396
differ by two scalars, and the gradient bytes agree exactly.
"""

import contextlib
import io
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from hand3d_tpu_torch.tools import scaling_record

REPO = Path(__file__).resolve().parents[1]
GRADIENT_BYTES = 70_075_388  # the 17,518,847 f32 params of PoseNet
JAX_SCALARS = {"visible_keypoints": 4, "head_1_numerator": 4,
               "head_2_numerator": 4, "head_3_numerator": 4}
PORT_SCALARS = {"visible_keypoints": 4, "loss": 4}
JAX_KEYS = {"n_data", "global_batch", "step_ms_median", "step_ms_min",
            "samples_per_s", "collectives_per_step",
            "collective_bytes_per_step"}
PORT_KEYS = (JAX_KEYS | {"first_step_s", "gradient_bytes", "scalar_bytes",
                         "backend", "devices", "size", "card"})


def root_scaling_record():
    """tools/scaling_record.py as a module."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        return __import__("scaling_record")
    finally:
        sys.path.remove(str(REPO / "tools"))


@pytest.fixture(scope="module")
def rows():
    """The port's rows at n_data 1 and 2 (gloo ranks on the CPU, one step
    at per-device batch 1), measured while the JAX tool's measure(2, 1, 1)
    compiles and runs on the conftest's virtual mesh."""
    with ThreadPoolExecutor(2) as pool:
        port = {n: pool.submit(scaling_record.measure, n, 1, 1,
                               device="cpu") for n in (1, 2)}
        jax_row = root_scaling_record().measure(2, 1, 1)
        return {"port": {n: f.result() for n, f in port.items()},
                "jax": jax_row}


def test_rows_carry_the_jax_keys_and_the_cards(rows):
    for n, row in rows["port"].items():
        assert PORT_KEYS <= set(row), PORT_KEYS - set(row)
        assert row["n_data"] == n and row["global_batch"] == n
        assert row["backend"] == "gloo" and row["devices"] == ["cpu"] * n
        assert row["size"] == 32 and row["card"] == "cpu"
        assert row["step_ms_min"] <= row["step_ms_median"]
        assert row["step_ms_median"] > 0 and row["first_step_s"] > 0
    assert JAX_KEYS <= set(rows["jax"])


def test_gradient_bytes_agree_with_jax_and_every_scalar_is_named(rows):
    port = rows["port"][2]
    assert port["gradient_bytes"] == GRADIENT_BYTES
    assert port["scalar_bytes"] == PORT_SCALARS
    assert port["collectives_per_step"] == {
        "all_reduce": {"calls": 2, "bytes": GRADIENT_BYTES + 8}}
    assert port["collective_bytes_per_step"] == (
        GRADIENT_BYTES + sum(PORT_SCALARS.values()))
    # the JAX record and a live run of the JAX tool: two all-reduces, the
    # same gradients and four scalars
    record = json.loads((REPO / "docs" / "SCALING.json").read_text())
    (recorded,) = [r for r in record["rows"] if r["n_data"] == 2]
    for jax_row in (recorded, rows["jax"]):
        assert jax_row["collectives_per_step"] == {"all-reduce": 2}
        assert jax_row["collective_bytes_per_step"] == (
            GRADIENT_BYTES + sum(JAX_SCALARS.values()))
    assert rows["port"][2]["collectives_per_step"]["all_reduce"]["calls"] \
        == recorded["collectives_per_step"]["all-reduce"]


def test_one_rank_reduces_over_a_group_of_one(rows):
    """The JAX step has no collective at n_data 1; DataParallelGrads still
    all-reduces (a group of one), and the row says so."""
    port = rows["port"][1]
    assert port["note"] == scaling_record.GROUP_OF_ONE
    assert port["collective_bytes_per_step"] == GRADIENT_BYTES + 8
    assert "note" not in rows["port"][2]


def _row(n, ms, backend, size=32):
    return {"n_data": n, "global_batch": 2 * n, "step_ms_median": ms,
            "samples_per_s": 2 * n / ms * 1e3, "backend": backend,
            "size": size, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
            "collectives_per_step": {"all_reduce": {"calls": 2,
                                                    "bytes": 70_075_396}},
            "collective_bytes_per_step": 70_075_396}


def test_ideals_and_markdown():
    shared = scaling_record.against_ideal(
        [_row(1, 10.0, "gloo"), _row(2, 25.0, "gloo"), _row(8, 40.0, "gloo")])
    assert [r["vs_linear_ideal"] for r in shared] == [1.0, 1.25, 0.5]
    assert not any("vs_flat_ideal" in r for r in shared)
    own = scaling_record.against_ideal(
        [_row(1, 10.0, "nccl"), _row(2, 12.5, "nccl"), _row(4, 15.0, "nccl")])
    assert [r["vs_flat_ideal"] for r in own] == [1.0, 1.25, 1.5]
    with pytest.raises(ValueError):
        scaling_record.against_ideal([_row(2, 10.0, "gloo")])
    with pytest.raises(ValueError):
        scaling_record.against_ideal([_row(1, 10.0, "gloo"),
                                      _row(2, 10.0, "gloo", size=256)])
    text = scaling_record._markdown({"per_device_batch": 2, "steps": 10,
                                     "rows": own})
    lines = text.strip().splitlines()
    assert "nccl ranks, NVIDIA H100 80GB HBM3, 700.00 W" in lines[0]
    assert "| vs flat ideal |" in text and "linear" not in text
    assert lines[-1] == ("| 4 | 8 | 15.0 | 533.3 | 1.50 | all_reduce×2 | "
                         "70.1 |")
    assert "| vs linear ideal |" in scaling_record._markdown(
        {"per_device_batch": 2, "steps": 10, "rows": shared})


def test_cli_runs_on_the_card_by_default():
    """Without a card the default --device cuda raises; nothing falls back
    to the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(RuntimeError,
                                                        match="no CUDA"):
        scaling_record.main(["--steps", "1"])
    assert out.getvalue() == ""


def test_a_failed_rank_stops_its_peers_and_fails_the_tool():
    """Rank 1 exits with an error before it joins; rank 0, waiting for it
    in the group's set-up, is stopped at once and the tool raises."""
    port = scaling_record._free_port()
    args = [(0, 2, port, "cpu", "gloo", 1, 1, 32),
            (1, 2, port, "cpu", "gloo", 1, "no steps", 32)]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="process 1 of 2 exited 1"):
        scaling_record.run_ranks(lambda r: args[r], ["cpu", "cpu"])
    assert time.monotonic() - t0 < 60


def test_cli_prints_a_row_an_n_data_then_the_summary(monkeypatch, tmp_path):
    """main() measures every n_data of RANKS on a shared device, prints each
    row as it comes and then the summary, and writes --json-out and
    --write-doc (measure() stubbed: the ranks are tested above)."""
    calls = []

    def measure(n, per_device_batch, steps, device):
        calls.append((n, per_device_batch, steps, device))
        return _row(n, 10.0 * n, "gloo")

    monkeypatch.setattr(scaling_record, "measure", measure)
    doc, js = tmp_path / "doc.md", tmp_path / "rows.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = scaling_record.main([
            "--device", "cpu", "--steps", "3", "--per-device-batch", "2",
            "--write-doc", str(doc), "--json-out", str(js)])
    assert calls == [(n, 2, 3, "cpu") for n in scaling_record.RANKS]
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    assert [l["n_data"] for l in lines[:-1]] == list(scaling_record.RANKS)
    assert lines[-1] == summary == json.loads(js.read_text())
    assert {k: summary[k] for k in ("gate", "per_device_batch", "steps")} \
        == {"gate": "scaling_record", "per_device_batch": 2, "steps": 3}
    assert [r["vs_linear_ideal"] for r in summary["rows"]] == [1.0] * 4
    assert doc.read_text() == scaling_record._markdown(summary)
