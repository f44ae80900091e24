"""The port's data path (codec, readers, preprocess) against hand3d_tpu's,
on the CPU.

Records come from tests/fixtures.py (uv is the K-projection of xyz). Every
eval config of preprocess_rhd / preprocess_stb is compared field by field:
integer and boolean fields exactly, float fields at rtol 1e-5 / atol 1e-6
(the geometry sums its products in another order), with exceptions that
come from XLA's rewrites under jit (it reassociates and fuses), not from
the port:

- image_crop: a crop sample position (below 1024 px, where a float32 ulp is
  at most 2**-14) may move by an ulp on each axis, and the fixtures' noise
  images change by up to 1.0 a pixel, so values may differ by 2 * 2**-14
  (measured: the eager JAX crop equals the port's within 6e-8);
- keypoint_uv21 in the crop frame is (u - center) * scale + 128, so a value
  near 0 carries the rounding of terms near 128: atol 2**-15 (2 ulp there);
- scoremap: each keypoint is truncated to an integer pixel first, so a
  coordinate within rounding of an integer may land on the next pixel in
  one framework. Such channels must have a near-integer coordinate; every
  other channel agrees at rtol 1e-5, or below the smallest normal float32
  (XLA flushes denormals to zero);
- keypoint_xyz21_local: the root bone has length 0 (the frame is
  root-relative), so its two angles are atan2 of rounding noise. Under jit
  the JAX root comes out ~1e-7 off zero; the port's is exactly zero. Angles
  are compared where a bone is longer than 1e-5, modulo 2 pi, as the arc
  length they move the bone's end by (atol 1e-5): a short bone turns its
  coordinates' rounding into a larger angle.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hand3d_tpu.data import codec as j_codec
from hand3d_tpu.data import preprocess as j_preprocess
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.data.stb import STBDataset as JaxSTB
from hand3d_tpu_torch.data import codec, preprocess
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset
from hand3d_tpu_torch.eval import harnesses

from fixtures import make_rhd_bin, make_stb_bin
from torch_tmp import module_dir, tmp_path  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
FIELD_ATOL = {"image_crop": 2 * 2.0 ** -14 + ATOL,
              "keypoint_uv21": 2.0 ** -15}
TINY = np.finfo(np.float32).tiny


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    with module_dir(tmp_path_factory, "data") as d:
        left = make_rhd_bin(d / "left.bin", num_records=3, seed=1)
        right = make_rhd_bin(d / "right.bin", num_records=2, seed=2,
                             dominant="right")
        stb = make_stb_bin(d / "stb.bin", num_records=3, seed=3)
        yield {"left": str(left), "right": str(right), "stb": str(stb)}


def test_record_dtypes_match_jax():
    assert codec.RHD_RECORD_DTYPE == j_codec.RHD_RECORD_DTYPE
    assert codec.STB_RECORD_DTYPE == j_codec.STB_RECORD_DTYPE
    assert codec.RHD_RECORD_DTYPE.itemsize == 410520
    assert codec.STB_RECORD_DTYPE.itemsize == 922104
    assert (codec.RHD_IMAGE_SIZE, codec.STB_IMAGE_SIZE) == \
        (j_codec.RHD_IMAGE_SIZE, j_codec.STB_IMAGE_SIZE)


def test_readers_read_fixture_records_identically(bins):
    for port_cls, jax_cls, path in ((RHDDataset, JaxRHD, bins["left"]),
                                    (STBDataset, JaxSTB, bins["stb"])):
        got, want = port_cls("evaluation", path), jax_cls("evaluation", path)
        assert len(got) == len(want) == 3
        idx = [2, 0, 2]
        g, w = got.raw_batch(idx), want.raw_batch(idx)
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_writers_write_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    rhd = dict(kp_xyz=rng.random((42, 3)), kp_uv=rng.random((42, 2)) * 300,
               cam_mat=rng.random((3, 3)),
               image=rng.integers(0, 256, (320, 320, 3)),
               hand_parts=rng.integers(0, 34, (320, 320)),
               kp_vis=rng.integers(0, 2, 42))
    stb = dict(kp_xyz_mm=rng.random((21, 3)) * 600,
               kp_uv=rng.random((21, 2)) * 400, kp_vis=np.ones(21),
               image=rng.integers(0, 256, (480, 640, 3)))
    for name, args, port_w, jax_w in (
            ("rhd", rhd, codec.write_rhd_record, j_codec.write_rhd_record),
            ("stb", stb, codec.write_stb_record, j_codec.write_stb_record)):
        with open(tmp_path / f"{name}_p", "wb") as f:
            port_w(f, **args)
        with open(tmp_path / f"{name}_j", "wb") as f:
            jax_w(f, **args)
        assert (tmp_path / f"{name}_p").read_bytes() == \
            (tmp_path / f"{name}_j").read_bytes()


def test_default_paths_keep_the_count_guard(tmp_path, monkeypatch):
    """The default (official) file must hold the reference's count."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "data" / "bin").mkdir(parents=True)
    make_rhd_bin(tmp_path / "data" / "bin" / "rhd_evaluation.bin",
                 num_records=2)
    with pytest.raises(ValueError, match="expected 2728"):
        RHDDataset("evaluation")
    (tmp_path / "data" / "stb").mkdir()
    make_stb_bin(tmp_path / "data" / "stb" / "stb_eval.bin", num_records=2)
    with pytest.raises(ValueError, match="expected 6000"):
        STBDataset("evaluation")
    with pytest.raises(ValueError, match="not for training"):
        STBDataset("training")


def _rhd_raw(bins):
    """Left- and right-dominant records in one batch."""
    a = RHDDataset("evaluation", bins["left"]).raw_batch([0, 1, 2])
    b = RHDDataset("evaluation", bins["right"]).raw_batch([0, 1])
    return {k: np.concatenate([a[k], b[k]]) for k in a}


RHD_CONFIGS = {
    "gt_crop": harnesses.GT_CROP_CONFIG,
    "from_posenet": harnesses.FROM_POSENET_CONFIG,
    "full_pipeline": harnesses.FULL_PIPELINE_CONFIG,
    "full_image_wrist_scaled": harnesses.full_image_config(True, True),
    "full_image_palm_scaled": harnesses.full_image_config(False, True),
    "full_image_wrist_320": harnesses.full_image_config(True, False),
    "full_image_palm_320": harnesses.full_image_config(False, False),
    "crop_wrist": PreprocessConfig(hand_crop=True, use_wrist_coord=True),
    "default": PreprocessConfig(),
}
STB_CONFIGS = {k: RHD_CONFIGS[k] for k in
               ("gt_crop", "full_pipeline", "crop_wrist", "default")}


def _compare(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "scoremap":
            uv_g = got["keypoint_uv21"].numpy()
            uv_w = np.asarray(want["keypoint_uv21"])
            same = (np.trunc(uv_g) == np.trunc(uv_w)).all(-1)  # [B, K]
            near = np.abs(uv_w - np.round(uv_w)).min(-1) < 1e-4
            assert (same | near).all(), np.argwhere(~(same | near))
            g, w = g.transpose(0, 3, 1, 2)[same], w.transpose(0, 3, 1, 2)[same]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=TINY, err_msg=k)
        elif k == "keypoint_xyz21_local":
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=RTOL,
                                       atol=ATOL)
            bone = w[..., 0] > 1e-5
            arc = np.abs(np.angle(np.exp(1j * (g[..., 1:] - w[..., 1:])))) \
                * w[..., :1]
            assert arc[bone].max() <= 1e-5, arc[bone].max()
            assert bone.sum() >= bone.size - bone.shape[0]  # only the root
        else:
            assert g.dtype == np.float32, k
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       atol=FIELD_ATOL.get(k, ATOL), err_msg=k)


def _run_both(port_fn, jax_fn, cfg, raw):
    got = port_fn(cfg, {k: torch.from_numpy(v) for k, v in raw.items()})
    jax_cfg = JaxConfig(**dataclasses.asdict(cfg))
    want = jax_fn(jax_cfg, {k: jnp.asarray(v) for k, v in raw.items()})
    return got, want


@pytest.mark.parametrize("name", list(RHD_CONFIGS))
def test_preprocess_rhd_matches(bins, name):
    got, want = _run_both(preprocess.preprocess_rhd, j_preprocess.preprocess_rhd,
                          RHD_CONFIGS[name], _rhd_raw(bins))
    _compare(got, want)
    if "hand_side" in got:  # both hand sides are in the batch
        assert got["hand_side"][:, 0].tolist() == [1, 1, 1, 0, 0]


@pytest.mark.parametrize("name", list(STB_CONFIGS))
def test_preprocess_stb_matches(bins, name):
    raw = STBDataset("evaluation", bins["stb"]).raw_batch([0, 1, 2])
    got, want = _run_both(preprocess.preprocess_stb, j_preprocess.preprocess_stb,
                          STB_CONFIGS[name], raw)
    _compare(got, want)


@pytest.mark.parametrize("flag", ["hue_aug", "coord_uv_noise",
                                  "crop_center_noise", "crop_scale_noise",
                                  "crop_offset_noise", "scoremap_dropout",
                                  "random_crop_to_size"])
def test_rng_configs_raise(bins, flag):
    """A config that augments at random raises without its draws
    (tests/test_torch_train_data.py holds it to JAX with them)."""
    cfg = PreprocessConfig(hand_crop=True, **{flag: True})
    raw = {k: torch.from_numpy(v) for k, v in _rhd_raw(bins).items()}
    with pytest.raises(ValueError, match="draw_noise"):
        preprocess.preprocess_rhd(cfg, raw)
    raw = STBDataset("evaluation", bins["stb"]).raw_batch([0])
    with pytest.raises(ValueError, match="draw_noise"):
        preprocess.preprocess_stb(
            cfg, {k: torch.from_numpy(v) for k, v in raw.items()})
