"""The port's augmentation (hand3d_tpu_torch/data/augment.py) against
hand3d_tpu's, on the CPU.

jax.random's threefry bits cannot be reproduced in torch, so each apply is
fed JAX's own draws (the same jax.random calls hand3d_tpu/data/augment.py
makes) and compared with the JAX function on the same key: exactly where the
apply only selects or masks, at atol 1e-6 where it does HSV arithmetic (the
same ops in the same order; values lie in [-0.5, 1]). The port's own draws
are checked for their bounds and rates, and for being a function of the
generator's words alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hand3d_tpu.data import augment as j_augment
from hand3d_tpu.ops import nn as j_nn
from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.ops import nn

HSV_ATOL = 1e-6


def _rgb_cases():
    """Random colours plus the branch edges: greys (c == 0), black (v == 0),
    ties of the max channel, pure primaries and secondaries."""
    rng = np.random.default_rng(0)
    rand = rng.random((4, 9, 13, 3), np.float32)
    edges = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                      [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                      [0.7, 0.7, 0.2], [0.2, 0.7, 0.7], [0.7, 0.2, 0.7],
                      [0.3, 0.1, 0.2]], np.float32)
    rand[0, 0, :len(edges)] = edges
    return rand


def test_rgb_to_hsv_matches():
    rgb = _rgb_cases()
    want = np.asarray(j_augment.rgb_to_hsv(jnp.asarray(rgb)))
    got = augment.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)


def test_hsv_to_rgb_matches_including_the_wrapped_sector():
    rng = np.random.default_rng(1)
    hsv = rng.random((4, 9, 11, 3), np.float32)
    hsv[0, 0, :4, 0] = [0.0, 1.0, 0.999999, 1.0 / 6.0]  # sector edges
    want = np.asarray(j_augment.hsv_to_rgb(jnp.asarray(hsv)))
    got = augment.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)
    back = augment.hsv_to_rgb(augment.rgb_to_hsv(torch.from_numpy(
        _rgb_cases()))).numpy()
    np.testing.assert_allclose(back, _rgb_cases(), rtol=0, atol=2e-6)


def test_random_hue_matches_with_jax_draws():
    image = _rgb_cases() - 0.5
    key = jax.random.PRNGKey(3)
    delta = jax.random.uniform(key, (4, 1, 1), minval=-0.1, maxval=0.1)
    want = np.asarray(j_augment.random_hue(key, jnp.asarray(image), 0.1))
    got = augment.random_hue(torch.from_numpy(image),
                             torch.from_numpy(np.asarray(delta))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HSV_ATOL)
    # a negative delta wraps the hue through 0 (floor-mod, never fmod)
    assert (np.asarray(delta) < 0).any()


def test_random_crop_hw_matches_with_jax_draws():
    x = np.random.default_rng(4).random((3, 20, 24, 5), np.float32)
    key = jax.random.PRNGKey(5)
    kr, kc = jax.random.split(key)
    rows = jax.random.randint(kr, (3,), 0, 20 - 8 + 1)
    cols = jax.random.randint(kc, (3,), 0, 24 - 6 + 1)
    want = np.asarray(j_augment.random_crop_hw(key, jnp.asarray(x), (8, 6)))
    got = augment.random_crop_hw(
        torch.from_numpy(x), torch.from_numpy(np.asarray(rows)).long(),
        torch.from_numpy(np.asarray(cols)).long(), (8, 6)).numpy()
    np.testing.assert_array_equal(got, want)


def test_scoremap_channel_dropout_matches_with_jax_draws():
    sm = np.random.default_rng(6).random((3, 8, 8, 21), np.float32)
    key = jax.random.PRNGKey(7)
    keep = jax.random.bernoulli(key, 0.8, (3, 1, 1, 21))
    want = np.asarray(j_augment.scoremap_channel_dropout(
        key, jnp.asarray(sm), 0.8))
    got = augment.scoremap_channel_dropout(
        torch.from_numpy(sm), torch.from_numpy(np.asarray(keep))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spatial", [False, True])
def test_dropout_matches_with_jax_draws(monkeypatch, spatial):
    """Inverted dropout: kept values scaled by 1 / keep_prob, the mask
    drawn over the whole tensor or per (sample, channel)."""
    x = np.random.default_rng(8).standard_normal((3, 4, 5, 6)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(9)
    shape = (3, 1, 1, 6) if spatial else x.shape
    mask = np.asarray(jax.random.bernoulli(key, 0.75, shape))
    j_fn, fn = ((j_nn.spatial_dropout, nn.spatial_dropout) if spatial
                else (j_nn.dropout, nn.dropout))
    want = np.asarray(j_fn(key, jnp.asarray(x), 0.75, True))
    drawn = []

    def replay(generator, keep_prob, shape, device):
        drawn.append(tuple(shape))
        return torch.from_numpy(mask)

    monkeypatch.setattr(nn, "keep_mask", replay)
    got = fn(torch.from_numpy(x), 0.75, True, generator=None).numpy()
    assert drawn == [shape]
    np.testing.assert_array_equal(got, want)
    # off in eval mode and at keep_prob 1: the input itself, nothing drawn
    t = torch.from_numpy(x)
    assert fn(t, 0.75, False) is t and fn(t, 1.0, True) is t
    assert len(drawn) == 1


def test_truncated_normal_draws_stay_within_two_sigma():
    sigma = 2.5
    got = augment.truncated_normal(augment.generator(0), (200_000,),
                                   sigma).numpy()
    want = np.asarray(j_augment.truncated_normal(jax.random.PRNGKey(0),
                                                 (200_000,), sigma))
    for x in (got, want):
        assert np.abs(x).max() <= 2 * sigma
    # N(0, 1) cut at +-2 has std 0.8796; both samplers agree on it
    assert abs(got.std() / sigma - 0.8796) < 0.005
    assert abs(got.std() - want.std()) < 0.01 * sigma
    assert abs(got.mean()) < 0.01 * sigma


def test_hue_crop_and_keep_draws_have_their_bounds_and_rates():
    g = augment.generator(1)
    delta = augment.draw_hue(g, 100_000, 0.1)
    assert delta.shape == (100_000, 1, 1)
    assert delta.min() >= -0.1 and delta.max() < 0.1
    assert abs(float(delta.mean())) < 2e-3
    rows, cols = augment.draw_crop_offsets(g, 10_000, (320, 320), (256, 256))
    for r in (rows, cols):
        assert r.dtype == torch.int64 and r.min() == 0 and r.max() == 64
    keep = augment.draw_channel_keep(g, 5_000, 21, 0.8)
    assert keep.shape == (5_000, 1, 1, 21) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.8) < 5e-3
    mask = nn.keep_mask(g, 0.75, (1000, 512), torch.device("cpu"))
    assert abs(mask.float().mean().item() - 0.75) < 5e-3


def test_draws_are_a_function_of_the_generator_words():
    def draws(*words):
        g = augment.generator(*words)
        return torch.cat([augment.truncated_normal(g, (8,), 1.0),
                          augment.draw_hue(g, 8, 0.1).flatten(),
                          augment.draw_channel_keep(g, 2, 4, 0.5).flatten()])

    assert torch.equal(draws(0, 3, 7), draws(0, 3, 7))
    for other in ((0, 3, 8), (0, 4, 7), (1, 3, 7), (0, 3, 7, 0), (3, 0, 7)):
        assert not torch.equal(draws(0, 3, 7), draws(*other)), other
