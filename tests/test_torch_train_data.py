"""The port's training data path against hand3d_tpu's, on the CPU:
preprocessing with random augmentation, the epoch order and the input
pipeline.

JAX's preprocess_rhd / preprocess_stb run with a key; the port is fed the
draws JAX makes from that key (``jax_noise`` replays the calls of
hand3d_tpu/data/preprocess.py and augment.py on ``split(key, 6)``). The
features are then compared with the tolerances of tests/test_torch_data.py
(``_compare``), which come from XLA's rewrites under jit, not from the
port. The epoch order and the pipeline's record batches must be JAX's
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand3d_tpu.data import augment as j_augment
from hand3d_tpu.data import pipeline as j_pipeline
from hand3d_tpu.data import preprocess as j_preprocess
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu_torch.data import pipeline, preprocess
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.data.stb import STBDataset

from test_torch_data import _compare, _rhd_raw, bins  # noqa: F401
from torch_threads import torch_threads_per_worker  # noqa: F401

KEY = jax.random.PRNGKey(11)


def jax_noise(cfg, raw, key):
    """The draws JAX's preprocess makes from ``key``, in the port's layout."""
    ks = jax.random.split(key, 6)
    b, kp = raw["kp_xyz"].shape[:2]
    out = {}
    if cfg.coord_uv_noise:
        out["uv"] = j_augment.truncated_normal(ks[0], (b, kp, 2),
                                               cfg.coord_uv_noise_sigma)
    if cfg.hue_aug:
        out["hue"] = jax.random.uniform(ks[1], (b, 1, 1),
                                        minval=-cfg.hue_aug_max,
                                        maxval=cfg.hue_aug_max)
    if cfg.crop_center_noise:
        out["crop_center"] = j_augment.truncated_normal(
            ks[2], (b, 2), cfg.crop_center_noise_sigma)
    if cfg.crop_scale_noise:
        out["crop_scale"] = jax.random.uniform(ks[3], (b,), minval=1.0,
                                               maxval=1.2)
    if cfg.crop_offset_noise:
        out["crop_offset"] = j_augment.truncated_normal(
            ks[4], (b, 2), cfg.crop_offset_noise_sigma)
    if cfg.random_crop_to_size:
        h, w = raw["image"].shape[1:3]
        size = cfg.random_crop_size
        kr, kc = jax.random.split(ks[3])
        out["crop_rows"] = jax.random.randint(kr, (b,), 0, h - size + 1)
        out["crop_cols"] = jax.random.randint(kc, (b,), 0, w - size + 1)
    if cfg.scoremap_dropout:
        out["scoremap_keep"] = jax.random.bernoulli(
            ks[5], cfg.scoremap_dropout_prob, (b, 1, 1, 21))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _run_both(port_fn, jax_fn, cfg, raw):
    noise = jax_noise(cfg, raw, KEY)
    got = port_fn(cfg, {k: torch.from_numpy(v) for k, v in raw.items()},
                  noise)
    want = jax_fn(JaxConfig(**dataclasses.asdict(cfg)),
                  {k: jnp.asarray(v) for k, v in raw.items()}, KEY)
    return got, want


CROP = dict(hand_crop=True, use_wrist_coord=False)
RHD_CONFIGS = {
    **{flag: PreprocessConfig(**CROP, **{flag: True}) for flag in
       ("hue_aug", "coord_uv_noise", "crop_center_noise", "crop_scale_noise",
        "crop_offset_noise", "scoremap_dropout")},
    "random_crop_64": PreprocessConfig(random_crop_to_size=True,
                                       random_crop_size=64),
    # the trainers' configs (cli/train_*.py)
    "posenet_32": PreprocessConfig(**CROP, coord_uv_noise=True,
                                   crop_center_noise=True, crop_size=32),
    "lifting": PreprocessConfig(**CROP, coord_uv_noise=True,
                                crop_center_noise=True, crop_offset_noise=True,
                                crop_scale_noise=True),
    "handsegnet": PreprocessConfig(hue_aug=True, random_crop_to_size=True),
}
STB_NOISE = dict(hand_crop=True, coord_uv_noise=True, crop_center_noise=True,
                 crop_scale_noise=True, crop_offset_noise=True)
STB_CONFIGS = {
    "all_noise_palm": PreprocessConfig(use_wrist_coord=False, hue_aug=True,
                                       **STB_NOISE),
    "all_noise_wrist_dropout": PreprocessConfig(scoremap_dropout=True,
                                                crop_size=64, **STB_NOISE),
}


@pytest.mark.parametrize("name", list(RHD_CONFIGS))
def test_preprocess_rhd_with_noise_matches(bins, name):
    cfg = RHD_CONFIGS[name]
    assert cfg.needs_rng
    got, want = _run_both(preprocess.preprocess_rhd,
                          j_preprocess.preprocess_rhd, cfg, _rhd_raw(bins))
    _compare(got, want)
    if cfg.scoremap_dropout:  # some channels dropped, none scaled
        sm = got["scoremap"].amax((1, 2))
        assert (sm == 0).any() and sm.max() <= 1.0


@pytest.mark.parametrize("name", list(STB_CONFIGS))
def test_preprocess_stb_with_noise_matches(bins, name):
    raw = STBDataset("evaluation", bins["stb"]).raw_batch([0, 1, 2])
    got, want = _run_both(preprocess.preprocess_stb,
                          j_preprocess.preprocess_stb, STB_CONFIGS[name], raw)
    _compare(got, want)


def test_draw_noise_draws_what_the_config_turns_on(bins):
    raw = {k: torch.from_numpy(v) for k, v in _rhd_raw(bins).items()}
    from hand3d_tpu_torch.data import augment

    for name, cfg in RHD_CONFIGS.items():
        noise = preprocess.draw_noise(cfg, raw, augment.generator(0))
        replay = jax_noise(cfg, _rhd_raw(bins), KEY)
        assert set(noise) == set(replay), name
        for k in noise:
            assert noise[k].shape == replay[k].shape, (name, k)
            assert noise[k].is_floating_point() == \
                replay[k].is_floating_point(), (name, k)
    assert preprocess.draw_noise(PreprocessConfig(), raw,
                                 augment.generator(0)) == {}


@pytest.mark.parametrize("n,batch,shuffle,seed,drop,shard", [
    (10, 3, True, 0, True, (0, 1)),
    (10, 3, True, 5, False, (0, 1)),
    (7, 16, False, 0, False, (0, 1)),
    (11, 2, True, 3, True, (1, 3)),
    (64, 8, True, 1, True, (0, 1)),
])
def test_epoch_indices_equal_jax(n, batch, shuffle, seed, drop, shard):
    want = j_pipeline.epoch_indices(n, batch, shuffle, seed, drop, shard)
    got = pipeline.epoch_indices(n, batch, shuffle, seed, drop, shard)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def train_bin(tmp_path_factory):
    from fixtures import make_rhd_bin

    return str(make_rhd_bin(tmp_path_factory.mktemp("train") / "t.bin",
                            num_records=9, seed=4))


def _raw_stream(pipe, n, **kw):
    it = pipe.iterate(**kw)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


@pytest.mark.parametrize("kw", [
    dict(epochs=None),
    dict(epochs=None, start_epoch=1, skip_steps=1),
    dict(epochs=2, start_epoch=3),
])
@pytest.mark.parametrize("batch", [2, 3])
def test_pipeline_yields_the_jax_record_batches(train_bin, kw, batch):
    cfg = PreprocessConfig(**CROP, coord_uv_noise=True)
    mine = pipeline.InputPipeline(RHDDataset("training", train_bin), cfg,
                                  batch, seed=3, yield_raw=True, device="cpu")
    theirs = j_pipeline.InputPipeline(JaxRHD("training", train_bin),
                                      JaxConfig(**dataclasses.asdict(cfg)),
                                      batch, seed=3, yield_raw=True)
    n = 6 if kw["epochs"] is None else 2 * theirs.steps_per_epoch()
    got, want = _raw_stream(mine, n, **kw), _raw_stream(theirs, n, **kw)
    assert mine.steps_per_epoch() == theirs.steps_per_epoch()
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    if kw["epochs"] == 2:  # a finite stream ends
        assert len(list(mine.iterate(**kw))) == n


def test_pipeline_draws_per_epoch_and_step_and_resumes_exactly(train_bin):
    """Preprocessed batches: a resumed stream (start_epoch, skip_steps)
    equals the uninterrupted stream's tail, noise included."""
    cfg = PreprocessConfig(**CROP, coord_uv_noise=True,
                           crop_center_noise=True, crop_size=32)
    pipe = pipeline.InputPipeline(RHDDataset("training", train_bin), cfg, 2,
                                  seed=1, device="cpu")
    assert pipe.steps_per_epoch() == 4
    straight = _raw_stream(pipe, 8)
    again = _raw_stream(pipe, 8)
    resumed = _raw_stream(pipe, 2, start_epoch=1, skip_steps=2)
    for a, b in zip(straight, again):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(straight[6:], resumed):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # each step draws its own noise
    assert not torch.equal(straight[0]["keypoint_uv21"],
                           straight[4]["keypoint_uv21"])


def test_pipeline_raises_the_producer_error_and_checks_sizes(train_bin):
    class Broken(RHDDataset):
        def raw_batch(self, indices):
            raise OSError("disk gone")

    cfg = PreprocessConfig()
    pipe = pipeline.InputPipeline(Broken("training", train_bin), cfg, 2,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="producer") as err:
        next(pipe.iterate())
    assert isinstance(err.value.__cause__, OSError)
    with pytest.raises(ValueError, match="zero batches"):
        pipeline.InputPipeline(RHDDataset("training", train_bin), cfg, 10,
                               device="cpu").steps_per_epoch()
    with pytest.raises(ValueError, match="skip_steps"):
        next(pipeline.InputPipeline(RHDDataset("training", train_bin), cfg,
                                    2, device="cpu").iterate(skip_steps=4))
