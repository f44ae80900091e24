"""Evaluation metrics: EPE / PCK / AUC (a numpy copy of
hand3d_tpu/eval/metrics.py: that package's ``__init__`` imports jax).

Re-implements utils/general.EvalUtil (:522-611) and calc_auc /
get_stb_ref_curves (:654-675): per-keypoint mean/median EPE over visible
samples, PCK over linspace thresholds, trapezoid AUC normalized by the
threshold span, all averaged over keypoints with at least one visible
sample.
"""

import numpy as np

# np.trapezoid is numpy>=2; np.trapz is its numpy-1.x name
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


class EvalUtil:
    def __init__(self, num_kp=21):
        self.num_kp = num_kp
        self._dists = [[] for _ in range(num_kp)]

    def feed_batch(self, dists, vis):
        """Accumulate a batch of per-keypoint distances.

        Args:
          dists: [B, num_kp] euclidean distances (any unit).
          vis: [B, num_kp] bool/float visibility; invisible entries ignored.
        """
        dists = np.asarray(dists)
        vis = np.asarray(vis).astype(bool)
        for k in range(self.num_kp):
            sel = dists[vis[:, k], k]
            if sel.size:
                self._dists[k].append(sel)

    def feed(self, keypoint_gt, keypoint_vis, keypoint_pred):
        """Single-sample API of the reference's EvalUtil.feed (:532)."""
        gt = np.squeeze(np.asarray(keypoint_gt))
        pred = np.squeeze(np.asarray(keypoint_pred))
        vis = np.squeeze(np.asarray(keypoint_vis)).astype(bool)
        dist = np.linalg.norm(gt - pred, axis=-1)
        self.feed_batch(dist[None], vis[None])

    def get_measures(self, val_min, val_max, steps):
        """Returns (mean_epe, median_epe, auc, pck_curve, thresholds)."""
        thresholds = np.linspace(val_min, val_max, steps)
        norm = _trapezoid(np.ones_like(thresholds), thresholds)
        means, medians, aucs, curves = [], [], [], []
        for k in range(self.num_kp):
            if not self._dists[k]:
                continue
            data = np.concatenate(self._dists[k])
            means.append(np.mean(data))
            medians.append(np.median(data))
            pck = np.stack([np.mean(data <= t) for t in thresholds])
            curves.append(pck)
            aucs.append(_trapezoid(pck, thresholds) / norm)
        return (float(np.mean(means)), float(np.mean(medians)),
                float(np.mean(aucs)), np.mean(np.stack(curves), axis=0),
                thresholds)


def calc_auc(x, y):
    """Normalized area under curve (utils/general.py:654-659)."""
    return float(_trapezoid(y, x) / _trapezoid(np.ones_like(y), x))


def get_stb_ref_curves():
    """Published STB baselines (PSO / ICPPSO / CHPR PCK over 20-50 mm) as
    the reference hard-codes them for its Figure 9 (general.py:662-675),
    from Zhang et al., '3D Hand Pose Tracking and Estimation Using Stereo
    Matching', 2016."""
    thresh_mm = np.array([20.0, 25, 30, 35, 40, 45, 50])
    pso = np.array([0.32236842, 0.53947368, 0.67434211, 0.75657895,
                    0.80921053, 0.86513158, 0.89473684])
    icppso = np.array([0.51973684, 0.64473684, 0.71710526, 0.77302632,
                       0.80921053, 0.84868421, 0.86842105])
    chpr = np.array([0.56578947, 0.71710526, 0.82236842, 0.88157895,
                     0.91447368, 0.9375, 0.96052632])
    return [(thresh_mm, v, f"{name} (AUC=%.3f)" % calc_auc(thresh_mm, v))
            for name, v in (("PSO", pso), ("ICPPSO", icppso), ("CHPR", chpr))]
