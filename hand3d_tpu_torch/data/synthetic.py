"""Synthetic RHD .bin files in the reference's record layout, for the
training gates (a numpy copy of tests/fixtures.py's ``make_rhd_bin`` and
``make_rhd_bin_rendered``: that module imports hand3d_tpu.data, which
reaches jax). The same seed writes the same bytes as the fixtures.

  * ``make_rhd_bin``: noise images; keypoints a plausible cloud whose uv is
    the K-projection of xyz. Memorizable, not learnable.
  * ``make_rhd_bin_rendered``: the left hand's skeleton drawn into the image
    (bones as gray strokes, each joint a disk of its own color) over a
    smooth random background. A network trained on one seed's records can
    generalize to another's.
"""

import numpy as np

from hand3d_tpu_torch.data.codec import RHD_IMAGE_SIZE, write_rhd_record

_CAM = np.array([[283.0, 0, 160.0], [0, 283.0, 160.0], [0, 0, 1.0]],
                np.float32)


def make_rhd_bin(path, num_records=4, seed=0, dominant="left"):
    """Noise-image RHD .bin; the part mask makes ``dominant`` the more
    prominent hand."""
    rng = np.random.RandomState(seed)
    h, w = RHD_IMAGE_SIZE
    with open(path, "wb") as f:
        for _ in range(num_records):
            offset = rng.uniform(-0.1, 0.1, size=(1, 3))
            kp_xyz = (rng.randn(42, 3).astype(np.float32) * 0.04
                      + [0, 0, 0.5] + offset).astype(np.float32)
            proj = kp_xyz @ _CAM.T
            kp_uv = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)
            center = np.mean(kp_uv[:21][:, ::-1], axis=0)[::-1]  # (u, v)
            image = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
            parts = np.zeros((h, w), np.uint8)
            # background person pixels = 1, dominant hand blob 40x40
            parts[:50, :50] = 1
            r0, c0 = int(center[1]) - 20, int(center[0]) - 20
            parts[r0:r0 + 40, c0:c0 + 40] = 5 if dominant == "left" else 20
            # a few pixels of the other hand
            parts[0:5, 300:305] = 20 if dominant == "left" else 5
            vis = (rng.rand(42) > 0.2).astype(np.uint8)
            vis[12] = 1  # crop center keypoint always visible
            vis[33] = 1
            write_rhd_record(f, kp_xyz, kp_uv, _CAM, image, parts, vis)
    return path


def _joint_palette():
    """21 distinct joint colors around the HSV wheel, full saturation."""
    out = np.zeros((21, 3))
    for j, hue in enumerate(np.linspace(0.0, 1.0, 21, endpoint=False)):
        k = int(hue * 6) % 6
        fr = hue * 6 - int(hue * 6)
        out[j] = [(1, fr, 0), (1 - fr, 1, 0), (0, 1, fr), (0, 1 - fr, 1),
                  (fr, 0, 1), (1, 0, 1 - fr)][k]
    return (out * 255).astype(np.uint8)


_PALETTE = _joint_palette()

# wrist -> knuckle, then the tip <- ... <- base chains in RHD's tip-first
# order: left-hand joint 4f+1 is finger f's tip, 4f+4 its base
_FINGER_BONES = [(0, 4 * f + 4) for f in range(5)] + [
    (4 * f + s, 4 * f + s + 1) for f in range(5) for s in (1, 2, 3)]


def _random_rotation(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.diag(r))


def _hand_skeleton(rng):
    """A random but plausible 21-joint left hand in camera space (m)."""
    joints = np.zeros((21, 3), np.float32)
    for f in range(5):
        fan = (f - 2) * 0.32 + rng.uniform(-0.08, 0.08)
        base_dir = np.array([np.sin(fan), np.cos(fan), 0.0])
        knuckle = base_dir * rng.uniform(0.065, 0.085)
        d = base_dir.copy()
        seg_len = rng.uniform(0.022, 0.032)
        pos = knuckle.copy()
        chain = [knuckle.copy()]
        for _ in range(3):
            bend = rng.uniform(-0.35, 0.75)
            d = d + np.array([rng.uniform(-0.15, 0.15),
                              rng.uniform(-0.1, 0.1), bend * 0.45])
            d /= np.linalg.norm(d)
            pos = pos + d * seg_len
            chain.append(pos.copy())
        joints[4 * f + 1:4 * f + 5] = np.stack(chain[::-1])  # tip first
    joints = joints @ _random_rotation(rng).T
    root = np.array([rng.uniform(-0.06, 0.06), rng.uniform(-0.06, 0.06),
                     rng.uniform(0.45, 0.62)])
    return (joints + root).astype(np.float32)


def _stamp_disk(image, parts, u, v, radius, color, part_val):
    h, w = parts.shape
    r0, r1 = max(int(v - radius), 0), min(int(v + radius) + 2, h)
    c0, c1 = max(int(u - radius), 0), min(int(u + radius) + 2, w)
    if r0 >= r1 or c0 >= c1:
        return
    yy, xx = np.mgrid[r0:r1, c0:c1]
    mask = (yy - v) ** 2 + (xx - u) ** 2 <= radius ** 2
    image[r0:r1, c0:c1][mask] = color
    parts[r0:r1, c0:c1][mask] = part_val


def _stamp_line(image, parts, uv_a, uv_b, color, part_val):
    n = max(int(float(np.hypot(*(uv_b - uv_a)))), 2)
    for t in np.linspace(0.0, 1.0, n):
        u, v = uv_a + t * (uv_b - uv_a)
        _stamp_disk(image, parts, u, v, 1.5, color, part_val)


def make_rhd_bin_rendered(path, num_records=64, seed=0):
    """RHD .bin whose pixels encode the pose: uv is the exact K-projection
    of a random articulated left hand, drawn into the image. The right hand
    is a far-away cloud that is never drawn; the part mask makes the left
    hand dominant."""
    rng = np.random.RandomState(seed)
    h, w = RHD_IMAGE_SIZE
    bone_color = np.array([90, 90, 90], np.uint8)
    with open(path, "wb") as f:
        for _ in range(num_records):
            kp_left = _hand_skeleton(rng)
            kp_right = (rng.randn(21, 3).astype(np.float32) * 0.04
                        + [0.3, 0.3, 0.8]).astype(np.float32)
            kp_xyz = np.concatenate([kp_left, kp_right], 0)
            proj = kp_xyz @ _CAM.T
            kp_uv = (proj[:, :2] / proj[:, 2:3]).astype(np.float32)

            base = rng.randint(40, 200, (1, 1, 3))
            image = np.clip(base + rng.randn(h, w, 3) * 8, 0,
                            255).astype(np.uint8)
            parts = np.zeros((h, w), np.uint8)
            parts[:40, :40] = 1  # background person pixels
            for a, b in _FINGER_BONES:
                _stamp_line(image, parts, kp_uv[a], kp_uv[b], bone_color, 5)
            for j in range(21):
                _stamp_disk(image, parts, kp_uv[j][0], kp_uv[j][1], 4.0,
                            _PALETTE[j], 5)
            parts[0:4, 300:304] = 20  # a token of the other hand
            vis = np.zeros(42, np.uint8)
            vis[:21] = 1
            vis[33] = 1
            write_rhd_record(f, kp_xyz, kp_uv, _CAM, image, parts, vis)
    return path
