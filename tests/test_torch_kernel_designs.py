"""The decompositions of the port's two CUDA kernels, modelled on the CPU.

``csrc/decode.cu`` and ``csrc/floodfill.cu`` cannot run without a card. The
models below repeat their arithmetic step by step at small sizes: the decode's
overlay order, its running best per thread and its 64-bit key reduction over
row bands; the flood fill's bit words, funnel-shift reach tree, vertical OR
tree, row bands with 10-row halos and OR-ed changed flag. Each model is held
to the plain twin the kernel must equal bit for bit, and to the JAX package
(the Pallas decode in interpret mode on finite inputs, the XLA flood fill;
never the Pallas flood fill, which is wrong near the top and left edges).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.ops import segmentation as j_seg
from hand3d_tpu.ops.pallas.decode import decode_keypoints_upsampled_pallas
from hand3d_tpu_torch.ops import keypoints
from hand3d_tpu_torch.ops import segmentation as seg
from hand3d_tpu_torch.ops.image import _legacy_lin_coeffs
from test_torch_kernels import serpentine

# --- decode: overlay form, per-thread best, 64-bit keys over bands ----------


def _band(band, nb, oh, f):
    """Output rows [r0, r1) of a band and its source rows i (decode.cu)."""
    r0, r1 = band * oh // nb, (band + 1) * oh // nb
    return r0, r1, range(r0 // f, (r1 - 1) // f + 1)


def _order_key(v, p):
    """decode.cu's order_key: uint64 (value as ordered uint32, ~index)."""
    u = (v.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(
        np.uint64)  # -0.0 + 0.0 = +0.0
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    u = np.where(np.isnan(v), np.uint64(0xFFFFFFFF), u)
    return (u << np.uint64(32)) | (~p.astype(np.uint64) & 0xFFFFFFFF)


def overlay_decode(sm, factor, nb):
    """decode.cu's overlay path on [B, h, w, K] float32: per band, each lane
    (column j) of each warp (channel) walks its (i, a, c) in the kernel's
    order with its strict compare; keys meet in a max over lanes and bands.
    Weights are f32(a) / f32(f), as the Pallas kernel takes them; with a
    power-of-two f that is the kernel's exact a * (1 / f)."""
    b, h, w, k = sm.shape
    f = factor
    oh, ow = h * f, w * f
    f32 = torch.tensor(float(f), dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    j = torch.arange(w)
    jh = torch.clamp(j + 1, max=w - 1)
    best = np.zeros((b, k), np.uint64)
    for band in range(nb):
        r0, r1, rows = _band(band, nb, oh, f)
        bv = torch.full((b, w, k), float("-inf"))
        bp = (r0 * ow + f * j)[None, :, None].expand(b, w, k).clone()
        for i in rows:
            top, bot = sm[:, i], sm[:, min(i + 1, h - 1)]  # [B, w, K]
            for a in range(max(r0 - i * f, 0), min(r1 - i * f, f)):
                wr = torch.tensor(float(a), dtype=torch.float32) / f32
                cr = one - wr
                rj = top[:, j] * cr + bot[:, j] * wr
                rjh = top[:, jh] * cr + bot[:, jh] * wr
                base = (i * f + a) * ow + f * j
                for c in range(f):
                    wc = torch.tensor(float(c), dtype=torch.float32) / f32
                    v = rj * (one - wc) + rjh * wc
                    take = ~(v <= bv) & (bv == bv)
                    bv = torch.where(take, v, bv)
                    bp = torch.where(take, (base + c)[None, :, None], bp)
        keys = _order_key(bv.numpy(), bp.numpy()).max(axis=1)  # over lanes
        best = np.maximum(best, keys)  # the atomicMax over bands
    p = (~best & 0xFFFFFFFF).astype(np.int64)
    return torch.from_numpy(np.stack([p // ow, p % ow], -1).astype(np.float32))


def _decode_inputs(shape, rng):
    sm = rng.standard_normal(shape).astype(np.float32)
    b, h, w, k = shape
    sm[0, :, :, 0] = 0.0  # all ties: index 0
    sm[0, 1, 1, 1] = sm[0].max() + 1.0  # exact tie of two peaks, far apart
    sm[0, h - 2, w - 2, 1] = sm[0, 1, 1, 1]
    sm[-1, h - 1, w - 1, 2] = 10.0  # peaks on the clamped last row / col
    sm[-1, 0, w - 1, 3] = 10.0
    sm[-1, h - 1, 0, 4] = 10.0
    return sm


def _special(sm):
    """NaN, +-0 ties and infinities on top of _decode_inputs."""
    sm = sm.copy()
    sm[0, :, :, 5] = -1.0
    sm[0, 2, 3, 5] = -0.0  # -0.0 first, then +0.0: the first index wins
    sm[0, 4, 1, 5] = 0.0
    sm[-1, 3, 2, 6] = np.nan  # NaN above all, first NaN wins
    sm[-1, 1, 5, 6] = np.nan
    sm[-1, :, :, 7] = -np.inf  # all -inf: index 0
    sm[0, sm.shape[1] // 2, sm.shape[2] // 2, 8] = np.inf  # inf * 0 is NaN
    return sm


@pytest.mark.parametrize("shape,factor,nb", [
    ((2, 8, 8, 9), 4, 1), ((2, 8, 8, 9), 4, 5), ((2, 8, 8, 9), 4, 32),
    ((1, 6, 10, 9), 8, 7), ((2, 5, 7, 9), 2, 3)])
def test_overlay_decode_equals_twin(shape, factor, nb):
    sm = _special(_decode_inputs(shape, np.random.default_rng(sum(shape))))
    got = overlay_decode(torch.from_numpy(sm), factor, nb)
    want = keypoints.decode_upsampled_torch(torch.from_numpy(sm), factor)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nb", [1, 4, 16])
def test_overlay_decode_equals_pallas_on_finite_inputs(nb):
    sm = _decode_inputs((2, 8, 8, 21), np.random.default_rng(7))
    want = np.asarray(decode_keypoints_upsampled_pallas(
        jnp.asarray(sm), 4, interpret=True))
    got = overlay_decode(torch.from_numpy(sm), 4, nb).numpy()
    np.testing.assert_array_equal(got, want)


def test_order_key_is_the_argmax_order():
    vals = np.array([np.nan, np.inf, 1.0, 0.0, -0.0, -1.0, -np.inf],
                    np.float32)
    keys = _order_key(vals, np.zeros(7, np.int64))
    assert keys[0] > keys[1] > keys[2] > keys[3] == keys[4] > keys[5] > keys[6]
    ties = _order_key(np.full(3, 2.0, np.float32), np.array([5, 0, 9]))
    assert np.argmax(ties) == 1  # the smallest index wins a tie


def _grid_row(r, f, h):
    """One entry of ops/image.py's float64 grid: (lo, weight) of row r."""
    src = np.float64(r) * (np.float64(h) / np.float64(h * f))
    lo = min(max(int(np.floor(src)), 0), h - 1)
    return lo, np.float32(src - lo)


def test_grid_rows_match_legacy_coeffs():
    for f, h in ((3, 10), (7, 9), (8, 32)):
        lo, _, wt = _legacy_lin_coeffs(h, h * f)
        for r in range(h * f):
            assert _grid_row(r, f, h) == (lo[r], wt[r])


def _table_path_rows(f):
    """The most rows (or columns) of an upsampled map at factor f within the
    table path's size limit (4 h w + 12 (h + w) f bytes, decode.py), at
    w = 1 (or h = 1)."""
    return (232448 - 12 * f) // (4 + 12 * f) * f


def _grid_departs(f):
    """Whether the float64 grid leaves the overlay form (lo = r // f, weight
    f32(r % f) / f32(f)) on some row within the table path's sizes."""
    rows = _table_path_rows(f)
    lo, _, wt = _legacy_lin_coeffs(rows // f, rows)
    r = np.arange(rows)
    return bool((lo != r // f).any()
                or (wt != (r % f).astype(np.float32) / np.float32(f)).any())


def test_overlay_weights_exact_only_for_powers_of_two():
    """With f = 2^k the grid is exact: lo = r // f and weight (r % f) / f at
    every row. For other factors 1/f is inexact in float64: searching every
    factor up to 256 at the table path's largest size, 49 is the first whose
    grid leaves the overlay form (f = 3, 5, 6 and 7 do not, though at f = 7
    the weight departs from row 58,720,257), and no power of two does. So
    decode.cu keeps its table path for the factors that are not powers of
    two."""
    for f in (2, 4, 8, 16):
        for r in list(range(4 * f)) + [2**24 + 3, 2**28 - 1]:
            lo, wt = _grid_row(r, f, h=2**28 // f + 1)
            assert (lo, wt) == (r // f, np.float32(r % f) / np.float32(f))
    r, f = 58_720_257, 7
    lo, wt = _grid_row(r, f, h=r // f + 1)
    assert lo == r // f
    assert wt != np.float32(r % f) / np.float32(f)
    departs = [f for f in range(2, 257) if _grid_departs(f)]
    assert departs[0] == 49
    assert not set(departs) & {2, 4, 8, 16, 32, 64, 128, 256}


def test_overlay_departs_from_twin_at_factor_49():
    """At f = 49 the grid takes destination column 49 from source columns 0
    and 1 at weight 1.0, the overlay form from column 1 alone. With inf at
    column 0, the twin's 0 * inf there is NaN, the argmax; the overlay's
    value is finite, and its argmax is the inf at column 0. The kernel's
    table path follows the grid."""
    f = 49
    lo, hi, wt = _legacy_lin_coeffs(2, 2 * f)
    assert (lo[f], hi[f], wt[f]) == (0, 1, np.float32(1.0))
    sm = np.zeros((1, 2, 2, 1), np.float32)
    sm[0, 0, 0, 0] = np.inf
    want = keypoints.decode_upsampled_torch(torch.from_numpy(sm), f)
    assert want.tolist() == [[[0.0, 49.0]]]
    got = overlay_decode(torch.from_numpy(sm), f, 1)
    assert got.tolist() == [[[0.0, 0.0]]]


# --- flood fill: bit words, reach trees, bands with halos -------------------

HALF, RUN = 10, 8
TAPS = RUN + 2 * HALF
M32 = np.uint64(0xFFFFFFFF)


def _pack(det):
    """[H, W] -> [H, words] uint32, bit j of word c = column 32 c + j."""
    h, w = det.shape
    words = (w + 31) // 32
    bits = np.zeros((h, words * 32), np.uint64)
    bits[:, :w] = det != 0
    shifts = np.arange(32, dtype=np.uint64)
    return (bits.reshape(h, words, 32) << shifts).sum(-1).astype(np.uint32)


def _unpack(bits, w):
    shifts = np.arange(32, dtype=np.uint32)
    px = (bits[..., None] >> shifts) & 1
    return px.reshape(bits.shape[0], -1)[:, :w].astype(np.float32)


def _fsr(lo, hi, s):  # __funnelshift_r
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(s)) & M32).astype(np.uint32)


def _fsl(lo, hi, s):  # __funnelshift_l
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (((v << np.uint64(s)) >> np.uint64(32)) & M32).astype(np.uint32)


def _reach_right(lo, hi):
    for s in (1, 2, 4):
        lo = lo | _fsr(lo, hi, s)
        hi = hi | (hi >> np.uint32(s))
    return lo | _fsr(lo, hi, 3)


def _reach_left(lo, hi):
    for s in (1, 2, 4):
        hi = hi | _fsl(lo, hi, s)
        lo = lo | (lo << np.uint32(s))
    return hi | _fsl(lo, hi, 3)


def banded_flood_fill(det, seed, passes, clusters):
    """floodfill.cu on one [H, W] image: CTA q of `clusters` owns rows
    [q H / C, (q+1) H / C) and keeps obj[cur] with 10-row margins that hold
    its neighbours' nearest 10 rows (the kernel's CTAs store those rows
    there as they write them; zero beyond the image; a cluster of one holds
    no margins and reads zeros past its rows, the same); a pass ORs 21 rows by
    the tree over runs of 8 rows, then +-10 columns by the funnel-shift
    trees, masks with det and writes obj[cur ^ 1] of its own rows; the
    passes stop when no band changed."""
    h, w = det.shape
    bands = [(q * h // clusters, (q + 1) * h // clusters)
             for q in range(clusters)]
    if clusters > 1:
        assert min(r1 - r0 for r0, r1 in bands) >= HALF
    det_bits = _pack(det)
    words = det_bits.shape[1]
    obj = [np.zeros_like(det_bits), np.zeros_like(det_bits)]
    sr, sc = int(seed[0]), int(seed[1])
    if 0 <= sr < h and 0 <= sc < w:
        obj[0][sr, sc >> 5] = np.uint32(1 << (sc & 31))
    cur = 0
    for _ in range(passes):
        changed = []
        for q, (r0, r1) in enumerate(bands):
            nr = r1 - r0
            ext = np.zeros((nr + 2 * HALF + RUN, words), np.uint32)
            ext[HALF:HALF + nr] = obj[cur][r0:r1]
            if q > 0:  # the band above holds at least 10 rows
                ext[:HALF] = obj[cur][r0 - HALF:r0]
            if q + 1 < clusters:
                ext[HALF + nr:2 * HALF + nr] = obj[cur][r1:r1 + HALF]
            vert = np.zeros((nr, words), np.uint32)
            for ra in range(0, nr, RUN):
                x = ext[ra:ra + TAPS].copy()  # rows ra - 10 .. ra + 17
                for i in range(TAPS - 1):
                    x[i] |= x[i + 1]
                for i in range(TAPS - 3):
                    x[i] |= x[i + 2]
                y4 = np.array([x[i] | x[i + 4] for i in range(TAPS - 7)])
                for i in range(RUN):
                    if ra + i < nr:
                        vert[ra + i] = y4[i] | y4[i + 8] | y4[i + 13]
            zero = np.zeros((nr, 1), np.uint32)
            prev = np.concatenate([zero, vert[:, :-1]], 1)
            nxt = np.concatenate([vert[:, 1:], zero], 1)
            grown = ((_reach_right(vert, nxt) | _reach_left(prev, vert))
                     & det_bits[r0:r1])
            changed.append(bool((grown != obj[cur][r0:r1]).any()))
            obj[cur ^ 1][r0:r1] = grown
        cur ^= 1
        if not any(changed):
            break
    return _unpack(obj[cur], w)


def test_reach_trees_are_plus_minus_ten_columns():
    rng = np.random.default_rng(3)
    for _ in range(20):
        row = (rng.random(96) > 0.97).astype(np.float32)
        bits = _pack(row[None])[0]
        zero = np.zeros(1, np.uint32)
        prev = np.concatenate([zero, bits[:-1]])
        nxt = np.concatenate([bits[1:], zero])
        grown = _reach_right(bits, nxt) | _reach_left(prev, bits)
        got = _unpack(grown[None], 96)[0]
        want = np.array([row[max(c - HALF, 0):c + HALF + 1].max()
                         for c in range(96)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("clusters", [1, 3, 8])
def test_banded_passes_reach_exactly_ten(clusters):
    """On an all-foreground map one pass grows the seed into its clipped
    21x21 square and two passes into the 41x41 one, from seeds on the first
    and last rows, the edges and the band boundaries."""
    h, w = 96, 70
    det = np.ones((h, w), np.float32)
    starts = [q * h // clusters for q in range(clusters)]
    seeds = [(0, 0), (h - 1, w - 1), (h // 2, 33)]
    seeds += [(r + d, 40) for r in starts for d in (-1, 0) if 0 <= r + d]
    for sr, sc in seeds:
        for passes, half in ((1, 10), (2, 20)):
            want = np.zeros((h, w), np.float32)
            want[max(sr - half, 0):sr + half + 1,
                 max(sc - half, 0):sc + half + 1] = 1.0
            got = banded_flood_fill(det, (sr, sc), passes, clusters)
            np.testing.assert_array_equal(got, want)


def _flood_cases():
    rng = np.random.default_rng(12)
    cases = []
    for h, w, clusters in ((37, 64, 3), (120, 40, 8), (64, 96, 2),
                           (24, 33, 2), (9, 20, 1), (120, 40, 1)):
        det = (rng.random((h, w)) > 0.55).astype(np.float32)
        cases.append((f"noise_{h}x{w}_c{clusters}", det,
                      (int(rng.integers(h)), int(rng.integers(w))),
                      max(h, w) // 10, clusters))
        blob = np.zeros((h, w), np.float32)
        mid = h // clusters  # the first band boundary
        blob[max(mid - 6, 0):mid + 6, 2:w // 2] = 1.0  # across it
        blob[max(h - 3, 0):, w // 3:] = 1.0  # on the last rows
        cases += [
            (f"band_edge_{h}x{w}_c{clusters}", blob, (mid, 5), 50, clusters),
            (f"row0_{h}x{w}_c{clusters}", det, (0, w - 1), 50, clusters),
            (f"last_row_{h}x{w}_c{clusters}", blob, (h - 1, w - 2), 50,
             clusters),
            (f"outside_{h}x{w}_c{clusters}", det, (h, 0), 5, clusters),
            (f"background_{h}x{w}_c{clusters}", blob, (mid, w - 1), 3,
             clusters),
        ]
    snake = serpentine(120, 40)
    cases.append(("serpentine_cap", snake, (0, 0), 12, 8))
    cases.append(("serpentine_fixed_point", snake, (0, 0), 200, 4))
    return cases


FLOOD_CASES = _flood_cases()


@pytest.mark.parametrize("case", FLOOD_CASES, ids=[c[0] for c in FLOOD_CASES])
def test_banded_flood_fill_equals_twin(case):
    _, det, (sr, sc), passes, clusters = case
    got = banded_flood_fill(det, (sr, sc), passes, clusters)
    want = seg.flood_fill_torch(torch.from_numpy(det[None]),
                                torch.tensor([[sr, sc]], dtype=torch.int32),
                                passes)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_serpentine_needs_more_passes_than_the_cap():
    det = torch.from_numpy(serpentine(120, 40)[None])
    seed = torch.zeros((1, 2), dtype=torch.int32)
    capped = seg.flood_fill_torch(det, seed, 12)
    assert not torch.equal(capped, seg.flood_fill_torch(det, seed, 13))
    assert torch.equal(seg.flood_fill_torch(det, seed, 200),
                       seg.flood_fill_torch(det, seed, 201))


@pytest.mark.parametrize("hw,clusters", [((37, 64), 3), ((120, 40), 8),
                                         ((48, 64), 4)])
def test_banded_flood_fill_equals_xla(hw, clusters):
    """Logits through JAX's single_obj_scoremap(method="xla") against the
    port's foreground and seed through the banded model."""
    rng = np.random.default_rng(hw[0])
    logits = np.zeros((2, *hw, 2), np.float32)
    sign = np.where(rng.random((2, *hw)) > 0.5, 1.0, -1.0)
    logits[..., 1] = sign * (1.0 + rng.random((2, *hw)))
    logits[1, hw[0] // 2, hw[1] // 3, 1] = 9.0  # the seed mid-map
    want = np.asarray(j_seg.single_obj_scoremap(jnp.asarray(logits),
                                                method="xla"))[..., 0]
    _, det, seed = seg.foreground(torch.from_numpy(logits))
    passes = max(hw) // 10
    for i in range(2):
        got = banded_flood_fill(det[i].numpy(), seed[i].tolist(), passes,
                                clusters)
        np.testing.assert_array_equal(got, want[i])
