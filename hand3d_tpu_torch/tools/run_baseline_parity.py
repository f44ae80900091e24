"""Reproduce BASELINE.md rows 1-13 in one command (counterpart of
tools/run_baseline_parity.py).

    python -m hand3d_tpu_torch.tools.run_baseline_parity \
        --data-dir DATA --weights-dir WEIGHTS [--retrained-dir SNAPS]

It finds the datasets and the reference's shipped pickles by their canonical
names, converts the pickles (``weights.convert``), runs the port's four
evaluation harnesses with the reference eval scripts' settings on --device
(default cuda: the CUDA kernels), holds every metric to BASELINE.md rows
1-13, prints one JSON line and writes a markdown record (--write-doc).

Row -> weights (from the reference scripts):
  row 1      posenet-rhd-stb.pickle                  (eval2d_gt_cropped.py:65)
  rows 3-5   handsegnet-rhd.pickle + posenet-rhd-stb.pickle   (eval2d.py:78-79)
  rows 7-11  lifting-<variant>.pickle                (eval3d.py:76)
  rows 12-13 handsegnet-rhd.pickle + posenet3d-rhd-stb.pickle (eval_full.py:66-67)
Rows 2/6 (retrained nets) read the newest snapshot under
--retrained-dir/snap_pose (and snap_seg): the port's ``snapshot-<step>.pt``
or the JAX package's ``snapshot-<step>.msgpack``; without them they are
reported as skipped.

Row 12/13's second AUC is the reference's computation, thresholds[8:] of
linspace(0, 50, 20), i.e. from 21.05 mm (eval_full.py:99-101), not its
docstring's "30mm to 50mm".

Exit status 0 when every row that ran passed.
"""

import argparse
import glob
import json
import os
import time

from hand3d_tpu_torch.tools.average_params import snapshots

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# expected values transcribed from BASELINE.md (which cites the reference's
# own docstrings/README); keys name the harness metric they bind to
ROWS = {
    1: {"desc": "eval2d_gt_cropped, shipped weights, RHD-e",
        "expect": {"epe_mean_px": 9.135, "epe_median_px": 5.001,
                   "auc_0_30px": 0.724}},
    2: {"desc": "eval2d_gt_cropped, retrained PoseNet",
        "expect": {"epe_mean_px": 7.630, "epe_median_px": 3.939,
                   "auc_0_30px": 0.771}},
    3: {"desc": "eval2d, shipped, paper setting (wrist, scale_to_size)",
        "expect": {"epe_mean_px": 17.041, "epe_median_px": 5.833,
                   "auc_0_30px": 0.663}},
    4: {"desc": "eval2d, corrected setting (palm kp0)",
        "expect": {"epe_mean_px": 16.561, "epe_median_px": 5.275,
                   "auc_0_30px": 0.679}},
    5: {"desc": "eval2d, corrected setting, 320x320 frame",
        "expect": {"epe_mean_px": 18.741, "epe_median_px": 6.745,
                   "auc_0_30px": 0.635}},
    6: {"desc": "eval2d, retrained HandSegNet+PoseNet",
        "expect": {"epe_mean_px": 15.469, "epe_median_px": 4.374,
                   "auc_0_30px": 0.715}},
    7: {"desc": "eval3d, lifting 'direct', RHD-e",
        "expect": {"epe_median_mm": 20.848}},
    8: {"desc": "eval3d, lifting 'bottleneck', RHD-e",
        "expect": {"epe_median_mm": 21.907}},
    9: {"desc": "eval3d, lifting 'local', RHD-e",
        "expect": {"epe_median_mm": 39.121}},
    10: {"desc": "eval3d, lifting 'local_w_xyz_loss', RHD-e",
         "expect": {"epe_median_mm": 21.950}},
    11: {"desc": "eval3d, lifting 'proposed', RHD-e",
         "expect": {"epe_median_mm": 18.840}},
    12: {"desc": "eval_full, full pipeline, STB-e",
         "expect": {"epe_mean_mm": 12.210, "epe_median_mm": 9.405,
                    "auc_0_50mm": 0.764, "auc_20_50mm": 0.941}},
    13: {"desc": "eval_full, full pipeline, RHD-e",
         "expect": {"epe_mean_mm": 35.606, "epe_median_mm": 28.686,
                    "auc_0_50mm": 0.424, "auc_20_50mm": 0.603}},
}

VARIANT_BY_ROW = {7: "direct", 8: "bottleneck", 9: "local",
                  10: "local_w_xyz_loss", 11: "proposed"}


def _find(directory, *names):
    """The first file found among canonical names, at any depth."""
    for name in names:
        hits = sorted(glob.glob(os.path.join(directory, "**", name),
                                recursive=True))
        if hits:
            return hits[0]
    return None


def _load_pickles(paths, exclude=None):
    from hand3d_tpu_torch.weights.convert import convert_reference_pickles

    return convert_reference_pickles(paths, exclude_var_list=exclude)


def _merge_over(params, tree):
    """Seeded ``params`` with every scope of ``tree`` taken from it."""
    for scope in params:
        if scope in tree:
            params[scope] = tree[scope]
    return params


def tol_ok(metric, got, want, rel):
    """AUC is in [0, 1]: held absolutely at ``rel``; EPE relatively."""
    if "auc" in metric:
        return abs(got - want) <= rel
    return abs(got - want) <= rel * abs(want)


def retrained_tree(retrained_dir, *subdirs):
    """The params of the newest snapshot (.pt or .msgpack) of each
    subdirectory, merged; None when one has none."""
    if retrained_dir is None:
        return None
    from hand3d_tpu_torch.train.checkpoints import load_snapshot_params

    tree = {}
    for sub in subdirs:
        snaps = snapshots(os.path.join(retrained_dir, sub))
        if not snaps:
            return None
        tree.update(load_snapshot_params(snaps[-1][1]))
    return tree


def run_rows(data_dir, weights_dir, rows=None, batch_size=32,
             retrained_dir=None, tolerance_rel=0.02, progress=True,
             device="cuda"):
    """Run the selected BASELINE rows; returns {row: result dict}."""
    from hand3d_tpu_torch import precision
    from hand3d_tpu_torch.cli._common import progress_printer
    from hand3d_tpu_torch.data.rhd import RHDDataset
    from hand3d_tpu_torch.data.stb import STBDataset
    from hand3d_tpu_torch.eval.harnesses import (eval2d_full_image,
                                                 eval2d_gt_cropped,
                                                 eval3d_lifting,
                                                 eval_full_pipeline)
    from hand3d_tpu_torch.weights import random_lifting_params, random_params

    device = precision.exact_f32(device)
    rows = sorted(rows or ROWS)
    rhd_bin = _find(data_dir, "rhd_evaluation.bin")
    stb_bin = _find(data_dir, "stb_evaluation.bin", "stb_eval.bin")
    wf = {
        "handseg": _find(weights_dir, "handsegnet-rhd.pickle"),
        "posenet": _find(weights_dir, "posenet-rhd-stb.pickle"),
        "posenet3d": _find(weights_dir, "posenet3d-rhd-stb.pickle",
                           "posenet3d-rhd-stb-slr-finetuned.pickle"),
        **{f"lifting-{v}": _find(weights_dir, f"lifting-{v}.pickle")
           for v in VARIANT_BY_ROW.values()},
    }

    def skip(row, why):
        return {"row": row, "desc": ROWS[row]["desc"], "skipped": True,
                "reason": why}

    def judge(row, metrics):
        expect = ROWS[row]["expect"]
        got = {k: float(metrics[k]) for k in expect}
        ok = all(tol_ok(k, got[k], expect[k], tolerance_rel) for k in expect)
        return {"row": row, "desc": ROWS[row]["desc"], "skipped": False,
                "ok": ok, "expected": expect, "measured": got}

    def shown(ds):
        return progress_printer(len(ds), batch_size) if progress else None

    results = {}
    for row in rows:
        t0 = time.time()
        if row != 12 and rhd_bin is None:
            results[row] = skip(row, "rhd_evaluation.bin not found")
            continue
        if row == 12 and stb_bin is None:
            results[row] = skip(row, "stb .bin not found")
            continue
        if row in (1, 2):
            if row == 2:
                tree = retrained_tree(retrained_dir, "snap_pose")
                if tree is None:
                    results[row] = skip(
                        row, "retrained snapshot (snap_pose) not provided")
                    continue
            elif wf["posenet"] is None:
                results[row] = skip(row, "posenet-rhd-stb.pickle not found")
                continue
            else:
                tree = _load_pickles(
                    [wf["posenet"]],
                    exclude=["PosePrior", "ViewpointNet", "HandSegNet"])
            ds = RHDDataset("evaluation", path=rhd_bin)
            metrics = eval2d_gt_cropped(tree["PoseNet2D"], ds, batch_size,
                                        progress=shown(ds), device=device)
        elif row in (3, 4, 5, 6):
            if row == 6:
                tree = retrained_tree(retrained_dir, "snap_pose", "snap_seg")
                if tree is None:
                    results[row] = skip(
                        row, "retrained snapshots (snap_seg+snap_pose) "
                             "not provided")
                    continue
            elif wf["handseg"] is None or wf["posenet"] is None:
                results[row] = skip(
                    row, "handsegnet-rhd/posenet-rhd-stb pickle missing")
                continue
            else:
                tree = _load_pickles([wf["handseg"], wf["posenet"]],
                                     exclude=["PosePrior", "ViewpointNet"])
            ds = RHDDataset("evaluation", path=rhd_bin)
            metrics = eval2d_full_image(
                _merge_over(random_params(0), tree), ds, batch_size,
                use_wrist_coord=row in (3, 6), scale_to_size=row != 5,
                progress=shown(ds), device=device)
        elif row in VARIANT_BY_ROW:
            variant = VARIANT_BY_ROW[row]
            pick = wf[f"lifting-{variant}"]
            if pick is None:
                results[row] = skip(row, f"lifting-{variant}.pickle missing")
                continue
            ds = RHDDataset("evaluation", path=rhd_bin)
            metrics = eval3d_lifting(
                variant, _merge_over(random_lifting_params(variant, 0),
                                     _load_pickles([pick])),
                ds, batch_size, progress=shown(ds), device=device)
        else:  # 12, 13
            if wf["handseg"] is None or wf["posenet3d"] is None:
                results[row] = skip(
                    row, "handsegnet-rhd/posenet3d-rhd-stb pickle missing")
                continue
            tree = _load_pickles([wf["handseg"], wf["posenet3d"]])
            ds = (STBDataset("evaluation", path=stb_bin) if row == 12
                  else RHDDataset("evaluation", path=rhd_bin))
            metrics = eval_full_pipeline(
                _merge_over(random_params(0), tree), ds, batch_size,
                progress=shown(ds), device=device)
        results[row] = judge(row, metrics)
        results[row]["seconds"] = round(time.time() - t0, 1)
    return results


def markdown(results, batch_size, tolerance_rel):
    lines = [
        "# BASELINE.md reproduction record",
        "",
        f"Produced by hand3d_tpu_torch.tools.run_baseline_parity (batch "
        f"{batch_size}, tolerance {tolerance_rel:.1%} rel EPE / abs AUC) at "
        f"{time.strftime('%Y-%m-%d %H:%M:%S', time.gmtime())} UTC.",
        "",
        "| Row | Config | Verdict | Expected | Measured |",
        "|---|---|---|---|---|",
    ]
    for row in sorted(results):
        r = results[row]
        if r.get("skipped"):
            lines.append(f"| {row} | {r['desc']} | SKIPPED ({r['reason']}) "
                         "| | |")
            continue
        exp = ", ".join(f"{k}={v}" for k, v in r["expected"].items())
        got = ", ".join(f"{k}={v:.3f}" for k, v in r["measured"].items())
        lines.append(f"| {row} | {r['desc']} | "
                     f"{'PASS' if r['ok'] else 'FAIL'} | {exp} | {got} |")
    lines.append("")
    return "\n".join(lines)


def summarize(results):
    """The JSON line: ok when at least one row ran and every one passed."""
    ran = [r for r in results.values() if not r.get("skipped")]
    return {
        "gate": "baseline_parity",
        "ok": bool(ran) and all(r["ok"] for r in ran),
        "rows_run": [r["row"] for r in ran],
        "rows_skipped": {r["row"]: r["reason"]
                         for r in results.values() if r.get("skipped")},
        "results": {str(k): {kk: vv for kk, vv in v.items() if kk != "desc"}
                    for k, v in results.items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True,
                    help="dir containing rhd_evaluation.bin (+ stb .bin); "
                         "made by hand3d_tpu_torch.tools.create_binary_db / "
                         "create_stb_db")
    ap.add_argument("--weights-dir", required=True,
                    help="dir containing the reference's shipped .pickle "
                         "weight files")
    ap.add_argument("--rows", type=int, nargs="*", default=None)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--retrained-dir", default=None,
                    help="dir with snap_seg/ snap_pose/ snapshots (.pt or "
                         ".msgpack) for rows 2/6")
    ap.add_argument("--tolerance-rel", type=float, default=0.02,
                    help="pass/fail tolerance: relative for EPE, absolute "
                         "for AUC")
    ap.add_argument("--write-doc", default=os.path.join(
        REPO, "docs", "BASELINE_RESULTS_TORCH.md"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda: the CUDA kernels)")
    args = ap.parse_args(argv)

    results = run_rows(args.data_dir, args.weights_dir, rows=args.rows,
                       batch_size=args.batch_size,
                       retrained_dir=args.retrained_dir,
                       tolerance_rel=args.tolerance_rel, device=args.device)
    summary = summarize(results)
    if args.write_doc:
        os.makedirs(os.path.dirname(args.write_doc) or ".", exist_ok=True)
        with open(args.write_doc, "w") as f:
            f.write(markdown(results, args.batch_size, args.tolerance_rel))
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
