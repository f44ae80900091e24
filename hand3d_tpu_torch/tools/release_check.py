"""Run the port's end-of-round checks and write one stamped record
(counterpart of tools/release_check.py).

Steps, each a subprocess with its own timeout, in this order:

  chip_smoke      python3 chip_smoke.py: every path of the port on the card
  overfit         hand3d_tpu_torch.tools.overfit_check: the four trainers
                  learn 16 fixed records (--keep: the snapshots for preset)
  preset          hand3d_tpu_torch.tools.preset_accuracy on those snapshots
  generalization  hand3d_tpu_torch.tools.generalization_check

Each step records its return code, its seconds and the last JSON line of its
standard output (the tools' summaries), and on failure the tails of its
output. The record, ``RESULTS_torch_r{N}.json`` in --out-dir, is stamped with
the git revision and the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
them, and is rewritten after every step, so a run cut short keeps the steps
it finished. ``ok`` is true only when every step of the table ran and
passed; the exit status is 0 when every step this run selected passed.

The JAX tool's TPU steps (bench.py, the multihost test, the multichip dry
run) have no counterpart here.

Usage:
  python -m hand3d_tpu_torch.tools.release_check --round 11
  python -m hand3d_tpu_torch.tools.release_check --round 11 --skip generalization
  python -m hand3d_tpu_torch.tools.release_check --round 11 \
      --steps preset --overfit-dir DIR   # DIR: an overfit_check --keep dir
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from hand3d_tpu_torch.tools import card as card_lib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def log(msg):
    print(f"[release_check] {msg}", file=sys.stderr, flush=True)


def git_rev():
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() or "unknown"  # no .git: a copied checkout


def card():
    """nvidia-smi's name and power limit line, or why there is none."""
    try:
        return card_lib.nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def last_json_line(text):
    for line in reversed((text or "").splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def steps(args, work):
    """The ordered step table: name -> (argv, timeout in seconds)."""
    def tool(name, *flags):
        return [sys.executable, "-m", f"hand3d_tpu_torch.tools.{name}",
                *flags]

    overfit_dir = args.overfit_dir or os.path.join(work, "overfit")
    return {
        "chip_smoke": ([sys.executable, "chip_smoke.py"], 1500),
        "overfit": (tool("overfit_check", "--steps", str(args.overfit_steps),
                         "--keep", overfit_dir), 5400),
        "preset": (tool("preset_accuracy", "--overfit-dir", overfit_dir),
                   1800),
        "generalization": (tool("generalization_check"), 5400),
    }


def run_step(argv, timeout):
    """(returncode or None on timeout, stdout, stderr) of ``argv`` run from
    the repository root; on timeout its whole process group is killed."""
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return None, out, err


def write_record(path, record):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", type=int, required=True)
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--steps", nargs="*", default=None,
                    help="run only these steps (default: all)")
    ap.add_argument("--overfit-steps", type=int, default=600)
    ap.add_argument("--overfit-dir", default=None,
                    help="the overfit step's --keep dir, read by preset "
                         "(default: under --work)")
    ap.add_argument("--work", default=None,
                    help="dir for intermediate files, kept (default: a "
                         "temporary dir, removed at the end)")
    ap.add_argument("--out-dir", default=REPO,
                    help="where RESULTS_torch_r{N}.json is written")
    args = ap.parse_args(argv)
    if args.work:
        return run(args, ap, args.work)
    with tempfile.TemporaryDirectory(prefix="hand3d_release_") as work:
        return run(args, ap, work)


def run(args, ap, work):
    table = steps(args, work)
    selected = args.steps or list(table)
    unknown = [s for s in selected + args.skip if s not in table]
    if unknown:
        ap.error(f"unknown step(s): {unknown}; available: {list(table)}")

    out = os.path.join(args.out_dir, f"RESULTS_torch_r{args.round:02d}.json")
    record = {"round": args.round, "commit": git_rev(), "card": card(),
              "utc": time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime()),
              "ok": False, "partial": True,
              "steps": {name: {"ok": None, "skipped": True}
                        for name in table}}
    ran = {}
    for name, (cmd, timeout) in table.items():
        if name not in selected or name in args.skip:
            log(f"{name}: skipped")
            continue
        log(f"{name}: {' '.join(cmd)} (timeout {timeout} s)")
        t0 = time.time()
        rc, stdout, stderr = run_step(cmd, timeout)
        entry = {"ok": rc == 0, "returncode": rc,
                 "seconds": time.time() - t0,
                 "summary": last_json_line(stdout)}
        if rc is None:
            entry["error"] = f"timeout after {timeout} s"
        if rc != 0:
            entry["stdout_tail"] = (stdout or "")[-1500:]
            entry["stderr_tail"] = (stderr or "")[-1500:]
        record["steps"][name] = entry
        ran[name] = entry["ok"]
        done = [s for s in record["steps"].values() if not s.get("skipped")]
        record["partial"] = len(done) < len(table)
        record["ok"] = not record["partial"] and all(s["ok"] for s in done)
        write_record(out, record)
        log(f"{name}: {'PASS' if entry['ok'] else 'FAIL'} "
            f"({entry['seconds']:.1f} s)")
    if not ran:
        write_record(out, record)
    print(json.dumps({"gate": "release_check", "ok": record["ok"],
                      "partial": record["partial"], "ran_here": ran,
                      "card": record["card"], "out": out}), flush=True)
    return 0 if ran and all(ran.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
