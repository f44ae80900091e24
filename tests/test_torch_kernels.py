"""The port's CUDA kernels: build, bindings, and kernel-vs-twin checks.

This file imports no jax. The ``gpu`` tests need a CUDA device and skip
without one; on a machine with a card and nvcc run them with
``python -m pytest -p no:cacheprovider --noconftest -m gpu
tests/test_torch_kernels.py`` (tests/conftest.py imports jax). chip_smoke.py
holds the same bindings to their twins at the cascade's shapes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hand3d_tpu_torch.ops import keypoints, segmentation
from hand3d_tpu_torch.ops.kernels import build, decode, floodfill

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_wrappers_reject_cpu_tensors():
    counts = floodfill.launches, decode.launches
    det = torch.zeros((1, 8, 8))
    seed = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        floodfill.flood_fill_cuda(det, seed, 1)
    with pytest.raises(ValueError, match="CUDA"):
        decode.decode_upsampled_cuda(torch.zeros((1, 4, 4, 2)), 2)
    assert (floodfill.launches, decode.launches) == counts


def test_compile_kernel_raises_on_nvcc_failure(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: boom' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom"):
        build.compile_kernel("floodfill", nvcc=str(fake))
    assert list((tmp_path / "build").iterdir()) == []  # no partial library


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first = build.library_path("k")
    assert first == build.library_path("k")
    src.write_text("// v2\n")
    assert build.library_path("k") != first


def test_port_runs_without_jax():
    """The package, its CPU slice and a train step run with jax blocked (the
    card machine has none): every module of the port imports."""
    code = (
        "import sys, numpy as np, torch\n"
        "sys.modules['jax'] = None  # any import of jax raises\n"
        "from hand3d_tpu_torch.serving import HandPoseEstimator\n"
        "from hand3d_tpu_torch.weights import random_params\n"
        "from hand3d_tpu_torch.cli import (eval2d, eval2d_gt_cropped,\n"
        "                                  eval3d, eval_full, train_handsegnet,\n"
        "                                  train_joint, train_lifting,\n"
        "                                  train_posenet)\n"
        "from hand3d_tpu_torch.data import augment, pipeline\n"
        "from hand3d_tpu_torch.train import (checkpoints, loop, losses,\n"
        "                                    schedule, trainer)\n"
        "from hand3d_tpu_torch.utils import logging\n"
        "est = HandPoseEstimator(random_params(0), batch_size=1,\n"
        "                        input_hw=(32, 32), device='cpu')\n"
        "out = est.predict(np.zeros((1, 32, 32, 3), np.uint8))\n"
        "assert out['keypoint_uv21'].shape == (1, 21, 2)\n"
        "assert np.isfinite(out['keypoint_coord3d']).all()\n"
        "opt = trainer.make_optimizer([0.1], [])\n"
        "state = trainer.init_state({'a': {'w': torch.ones(3)}}, opt)\n"
        "state, m = trainer.make_train_step(\n"
        "    lambda p, b, g: (p['a']['w'] * b['x']).sum() ** 2, opt)(\n"
        "    state, {'x': torch.ones(3)}, (0, 0))\n"
        "assert state.step == 1 and m['loss'].item() == 9.0\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        "             if m.split('.')[0] == 'jax' and v is not None))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
             "hand3d_tpu", "zstandard", "tensorstore", "zarr", "numcodecs",
             "orbax")


def test_no_port_module_imports_what_the_card_lacks():
    """No module of the port and no line of chip_smoke.py imports jax,
    flax, msgpack, ml_dtypes, the JAX package or the storage packages of
    Orbax checkpoints (zstandard, tensorstore, zarr, numcodecs, orbax), at
    any depth."""
    import ast

    files = sorted((REPO / "hand3d_tpu_torch").rglob("*.py"))
    assert len(files) > 40
    for path in files + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_weight_readers_and_gates_run_without_jax(tmp_path):
    """With jax, flax, msgpack, ml_dtypes, the JAX package, zstandard,
    tensorstore, zarr, numcodecs and orbax blocked: a reference pickle, a
    TF checkpoint with a bf16 tensor and a msgpack snapshot load, the
    gates' and the dataset and host tools and the writers import, a
    phase-packed tree is made, and the committed JAX-made Orbax checkpoint
    (OCDBT, zstd) restores to its .npz through the port's readers."""
    code = (
        "import pickle, sys, numpy as np\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "from hand3d_tpu_torch.cli import _common, convert_weights\n"
        "from hand3d_tpu_torch.parallel import mesh\n"
        "from hand3d_tpu_torch.utils import debug, profiling\n"
        "from hand3d_tpu_torch.data import synthetic\n"
        "from hand3d_tpu_torch.tools import (\n"
        "    average_params, bench_input, create_binary_db, create_stb_db,\n"
        "    generalization_check, inspect_db, overfit_check,\n"
        "    preset_accuracy, release_check, run_baseline_parity)\n"
        "from hand3d_tpu_torch.ops import phasepack\n"
        "from hand3d_tpu_torch.weights import flax_msgpack, tf_ckpt\n"
        f"d = {str(tmp_path)!r}\n"
        "w = np.arange(6, dtype=np.float32).reshape(2, 3)\n"
        "with open(d + '/p.pickle', 'wb') as f:\n"
        "    pickle.dump({'PoseNet2D/conv1_1/weights:0': w}, f, protocol=2)\n"
        "bits = np.array([0x3f80, 0xc000], np.uint16)\n"
        "v = 'CPM/PoseNet/conv1_1_CPM/'\n"
        "tf_ckpt.write_checkpoint(d + '/ck', {\n"
        "    v + 'weights': w, v + 'biases': bits,\n"
        "    'global_step': np.asarray(3, np.int64)}, bfloat16=(v + 'biases',))\n"
        # {'params': {'PosePrior': {'fc_xyz': {'weights': ndarray}}}} in
        # flax's msgpack encoding (the ndarray as extension type 1)
        "arr = (b'\\x93\\x91\\x02\\xa7float32\\xc4\\x08'"
        " + np.asarray([1.5, -2], np.float32).tobytes())\n"
        "body = (b'\\x81\\xa6params\\x81\\xa9PosePrior\\x81\\xa6fc_xyz'\n"
        "        b'\\x81\\xa7weights\\xc7' + bytes([len(arr)]) + b'\\x01' + arr)\n"
        "open(d + '/snapshot-1.msgpack', 'wb').write(body)\n"
        "t = _common.load_weight_trees([d + '/p.pickle', d + '/ck',\n"
        "                               d + '/snapshot-1.msgpack'])\n"
        "l = t['PoseNet2D']['conv1_1']\n"
        "assert np.array_equal(l['weights'], w), l\n"
        "assert l['biases'].tolist() == [1.0, -2.0], l\n"
        "assert t['PosePrior']['fc_xyz']['weights'].tolist() == [1.5, -2.0]\n"
        "pp = phasepack.phase_pack_params({'conv1_2': {\n"
        "    'weights': np.ones((3, 3, 2, 4), np.float32),\n"
        "    'biases': np.zeros(4, np.float32)}})\n"
        "assert pp['conv1_2']['weights_p2'].shape == (3, 4, 2, 8)\n"
        "from hand3d_tpu_torch import weights\n"
        "from hand3d_tpu_torch.train import checkpoints, trainer\n"
        "from hand3d_tpu_torch.weights import ocdbt, orbax, zstd\n"
        "fx = 'tests/torch_fixtures/orbax_jax/'\n"
        "want = dict(np.load(fx + 'expected.npz'))\n"
        "tree = weights.flat_to_tree({k[7:]: v for k, v in want.items()\n"
        "                             if k.startswith('params/')})\n"
        "tmpl = trainer.init_state(weights.params_from_jax(tree, 'cpu'),\n"
        "                          trainer.make_optimizer([1e-4, 1e-5], [1]))\n"
        "st = checkpoints.restore_orbax(fx + 'checkpoint/2', tmpl)\n"
        "assert st.step == 2\n"
        "got = weights.tree_to_flat(weights.params_to_jax(st.params))\n"
        "nu = weights.tree_to_flat(weights.params_to_jax(\n"
        "    trainer.tree_unflatten(st.params, [st.opt_state.state[p]\n"
        "        ['exp_avg_sq'] for p in trainer.tree_leaves(st.params)])))\n"
        "for k, v in got.items():\n"
        "    assert np.array_equal(v, want['params/' + k]), k\n"
        "    assert np.array_equal(nu[k], want['opt_state/0/nu/' + k]), k\n"
        "print(sorted(m for m, v in sys.modules.items()\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r} and v is not None))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _flood_inputs(b, h, w, rng):
    det = (rng.random((b, h, w)) > 0.55).astype(np.float32)
    det[0] = 0.0  # empty mask
    seed = np.stack([rng.integers(0, h, b), rng.integers(0, w, b)], 1)
    return det, seed.astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(1, 240, 320), (8, 240, 320),
                                   (3, 120, 160), (2, 48, 64), (2, 64, 64)])
def test_flood_fill_kernel_matches_twin(cuda, b, h, w):
    det, seed = _flood_inputs(b, h, w, np.random.default_rng(b * h))
    det_t = torch.from_numpy(det).to(cuda)
    seed_t = torch.from_numpy(seed).to(cuda)
    for passes in (0, 3, max(h, w) // 10):
        got = floodfill.flood_fill_cuda(det_t, seed_t, passes)
        want = segmentation.flood_fill_torch(det_t, seed_t, passes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), passes


@pytest.mark.gpu
@pytest.mark.parametrize("shape,factor", [((4, 32, 32, 21), 8),
                                          ((2, 16, 16, 4), 4),
                                          ((1, 10, 12, 3), 3)])
def test_decode_kernel_matches_twin(cuda, shape, factor):
    sm = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    sm[0, :, :, 0] = 0.0  # all ties
    sm[-1, -1, -1, 1] = 10.0  # edge peak
    sm_t = torch.from_numpy(sm).to(cuda)
    got = decode.decode_upsampled_cuda(sm_t, factor)
    want = keypoints.decode_upsampled_torch(sm_t, factor)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def serpentine(h, w):
    """Lanes of 2 rows, 23 rows apart, joined at alternating ends: a winding
    corridor that needs more passes than max(H, W) // 10."""
    det = np.zeros((h, w), np.float32)
    for i, r in enumerate(range(0, h, 23)):
        det[r:r + 2, :] = 1.0
        c = w - 2 if i % 2 == 0 else 0
        det[r:r + 25, c:c + 2] = 1.0
    return det


def _band_cases(b, h, w, rng):
    """Masks and seeds that stress the cluster bands (clusters of 8 CTAs up
    to B = 15 on an H100, then 4, 2, and one CTA an image from B = 67):
    blobs across every possible band boundary, seeds on row 0, the last row
    and boundaries."""
    det = (rng.random((b, h, w)) > 0.55).astype(np.float32)
    for r in range(10, h, 10):  # every boundary of bands of >= 10 rows
        det[:, r - 3:r + 3, (r * 7) % w] = 1.0
    rows = [0, h - 1] + [q * h // c for c in (2, 3, 4, 8) for q in range(c)]
    seed = np.stack([np.array(rows)[np.arange(b) % len(rows)],
                     rng.integers(0, w, b)], 1).astype(np.int32)
    return det, seed


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,w", [(1, 240, 320), (2, 240, 320),
                                   (5, 240, 320), (40, 240, 320),
                                   (80, 240, 320),
                                   (1, 37, 64), (3, 37, 64), (1, 120, 160),
                                   (7, 120, 160), (1, 9, 20), (2, 240, 322),
                                   (1, 540, 960), (128, 540, 960),
                                   (1, 600, 800), (128, 600, 800)])
def test_flood_fill_kernel_bands_match_twin(cuda, b, h, w):
    det, seed = _band_cases(b, h, w, np.random.default_rng(b + h + w))
    det_t = torch.from_numpy(det).to(cuda)
    seed_t = torch.from_numpy(seed).to(cuda)
    for passes in (1, 2, max(h, w) // 10, 100):
        got = floodfill.flood_fill_cuda(det_t, seed_t, passes)
        want = segmentation.flood_fill_torch(det_t, seed_t, passes)
        torch.cuda.synchronize()
        assert torch.equal(got, want), passes


@pytest.mark.gpu
def test_flood_fill_takes_clusters_at_small_batch_only(cuda):
    size, held = floodfill.cluster_plan(1, 240, 320, cuda)
    assert 1 < size <= 8 and held >= 1
    assert floodfill.cluster_plan(128, 240, 320, cuda) == (1, 0)
    assert floodfill.cluster_plan(1, 19, 320, cuda) == (1, 0)  # bands < 10
    assert floodfill.cluster_plan(1, 37, 64, cuda)[0] == 3
    assert floodfill.cluster_plan(1, 540, 960, cuda)[0] > 1
    assert floodfill.cluster_plan(128, 540, 960, cuda) == (1, 0)


@pytest.mark.parametrize("h,w,fits", [(240, 320, True), (540, 960, True),
                                      (600, 800, True), (645, 960, True),
                                      (646, 960, False), (19370, 32, True),
                                      (19371, 32, False)])
def test_flood_fill_size_limit_is_one_cta_of_bit_maps(h, w, fits):
    """Maps fit while one CTA holds det, the vertical OR and obj as bit
    masks: 12 bytes a row and 32-pixel word, as since the first design."""
    assert floodfill.smem_bytes(h, w) == 12 * h * ((w + 31) // 32)
    assert (floodfill.smem_bytes(h, w) <= build.MAX_SMEM_BYTES) == fits


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 64])
def test_flood_fill_kernel_stops_at_num_passes(cuda, b):
    det = torch.from_numpy(np.repeat(serpentine(240, 320)[None], b, 0))
    det = det.to(cuda)
    seed = torch.zeros((b, 2), dtype=torch.int32, device=cuda)
    capped = floodfill.flood_fill_cuda(det, seed, 32)
    assert torch.equal(capped, segmentation.flood_fill_torch(det, seed, 32))
    assert not torch.equal(capped, floodfill.flood_fill_cuda(det, seed, 33))
    full = floodfill.flood_fill_cuda(det, seed, 1000)
    torch.cuda.synchronize()
    assert torch.equal(full, segmentation.flood_fill_torch(det, seed, 1000))
    assert torch.equal(full, det)  # the corridor is one blob


def _decode_specials(shape, rng):
    sm = rng.standard_normal(shape).astype(np.float32)
    b, h, w, _ = shape
    sm[0, :, :, 0] = 0.0  # all ties
    sm[0, 1, 1, 1] = sm[0, h - 2, w - 3, 1] = sm[0].max() + 1.0  # far tie
    sm[0, :, :, 2] = -1.0  # -0.0 then +0.0: a tie, the first wins
    sm[0, 2, 3, 2] = -0.0
    sm[0, h - 1, 1, 2] = 0.0
    sm[-1, h // 2, 2, 3] = np.nan  # the first NaN wins
    sm[-1, h - 1, w - 1, 3] = np.nan
    sm[-1, :, :, 4] = -np.inf
    sm[-1, h - 1, w - 1, 5] = 10.0  # edge peaks
    sm[-1, 0, w - 1, 6] = 10.0
    return sm


@pytest.mark.gpu
@pytest.mark.parametrize("shape,factor", [((1, 32, 32, 21), 8),
                                          ((128, 32, 32, 21), 8),
                                          ((3, 10, 12, 7), 3),
                                          ((5, 16, 16, 7), 4),
                                          ((2, 9, 40, 33), 2)])
def test_decode_kernel_specials_match_twin(cuda, shape, factor):
    sm_t = torch.from_numpy(
        _decode_specials(shape, np.random.default_rng(shape[0]))).to(cuda)
    got = decode.decode_upsampled_cuda(sm_t, factor)
    want = keypoints.decode_upsampled_torch(sm_t, factor)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_decode_kernel_follows_the_grid_at_factor_49(cuda):
    """At f = 49 the twin's float64 grid takes column 49 from columns 0 and
    1 at weight 1.0, so inf at column 0 makes it NaN: the argmax. The
    overlay form would answer (0, 0); the kernel's table path follows the
    grid."""
    sm = torch.zeros((1, 2, 2, 1), device=cuda)
    sm[0, 0, 0, 0] = float("inf")
    got = decode.decode_upsampled_cuda(sm, 49)
    torch.cuda.synchronize()
    assert got.tolist() == [[[0.0, 49.0]]]
    assert torch.equal(got, keypoints.decode_upsampled_torch(sm, 49))


# --- the registered ops (torch.ops.hand3d.*) -----------------------------------


def _op_inputs(device):
    rng = np.random.default_rng(3)
    det, seed = _flood_inputs(3, 37, 64, rng)
    sm = _decode_specials((2, 16, 16, 7), rng)
    return (torch.from_numpy(det).to(device), torch.from_numpy(seed).to(device),
            torch.from_numpy(sm).to(device))


@pytest.mark.parametrize("op", ["flood_fill", "decode_upsampled"])
def test_registered_op_passes_opcheck_on_the_cpu(op):
    """Schema, fake (shape) implementation, autograd registration and
    tracing with dynamic shapes, as torch.export needs them."""
    det, seed, sm = _op_inputs("cpu")
    args = (det, seed, 4) if op == "flood_fill" else (sm, 4)
    torch.library.opcheck(getattr(torch.ops.hand3d, op).default, args)


def test_registered_ops_take_the_twins_on_the_cpu():
    det, seed, sm = _op_inputs("cpu")
    counts = floodfill.launches, decode.launches
    assert torch.equal(torch.ops.hand3d.flood_fill(det, seed, 4),
                       segmentation.flood_fill_torch(det, seed, 4))
    assert torch.equal(torch.ops.hand3d.decode_upsampled(sm, 4),
                       keypoints.decode_upsampled_torch(sm, 4))
    assert (floodfill.launches, decode.launches) == counts  # no kernel ran


def test_registered_ops_have_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        det = torch.empty((5, 30, 40))
        seed = torch.empty((5, 2), dtype=torch.int32)
        sm = torch.empty((5, 32, 32, 21))
        assert torch.ops.hand3d.flood_fill(det, seed, 3).shape == (5, 30, 40)
        out = torch.ops.hand3d.decode_upsampled(sm, 8)
        assert out.shape == (5, 21, 2) and out.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 128])
def test_registered_ops_launch_the_kernels_on_the_card(cuda, b):
    """op == binding == twin on the card, and the op launches the kernel
    (its count rises by one a call)."""
    rng = np.random.default_rng(b)
    det, seed = _band_cases(b, 240, 320, rng)
    det_t = torch.from_numpy(det).to(cuda)
    seed_t = torch.from_numpy(seed).to(cuda)
    sm_t = torch.from_numpy(_decode_specials((b, 32, 32, 21), rng)).to(cuda)
    before = floodfill.launches, decode.launches
    fill = torch.ops.hand3d.flood_fill(det_t, seed_t, 32)
    dec = torch.ops.hand3d.decode_upsampled(sm_t, 8)
    assert (floodfill.launches, decode.launches) == (before[0] + 1,
                                                     before[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(fill, floodfill.flood_fill_cuda(det_t, seed_t, 32))
    assert torch.equal(fill, segmentation.flood_fill_torch(det_t, seed_t, 32))
    assert torch.equal(dec, decode.decode_upsampled_cuda(sm_t, 8))
    assert torch.equal(dec, keypoints.decode_upsampled_torch(sm_t, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["flood_fill", "decode_upsampled"])
def test_registered_op_passes_opcheck_on_the_card(cuda, op):
    det, seed, sm = _op_inputs(cuda)
    args = (det, seed, 4) if op == "flood_fill" else (sm, 4)
    torch.library.opcheck(getattr(torch.ops.hand3d, op).default, args)


@pytest.mark.gpu
def test_a_failed_launch_raises_through_the_op(cuda):
    """Nothing falls back to the twin: the op raises as the binding does."""
    det = torch.zeros((1, 4000, 4000), device=cuda)  # over the size limit
    seed = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        torch.ops.hand3d.flood_fill(det, seed, 1)
