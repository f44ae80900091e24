"""Augmentation (counterpart of hand3d_tpu/data/augment.py).

The reference drew with TF's stateful RNG ops (truncated_normal,
random_uniform, random_hue, random_crop, scoremap dropout;
BinaryDbReader.py:160-392), the JAX package with jax.random keys. Here each
augmentation is split in two:

  * a *draw*: a CPU ``torch.Generator`` -> small noise tensors (at most
    [B, 42, 2]), made on the CPU whatever the device, so the card and the CPU
    see the same noise at the same step and a resumed run draws what an
    uninterrupted one drew;
  * an *apply*: deterministic given the draws, on the batch's device.

jax.random's threefry bits cannot be reproduced in torch, so the tests feed
JAX's own draws to the applies.

Every draw goes through one of four primitives marked :func:`drawn`
(``truncated_normal``, ``uniform``, ``randint``, ``keep``). Given a draw
source of ``train/draws.py`` in place of the generator, a primitive hands the
call to the source: the device-resident train step takes its draws, made
ahead on the host from the same generators, out of a device buffer.
"""

import functools

import numpy as np
import torch


def generator(*words):
    """A CPU generator seeded from the non-negative integers ``words`` (for
    example seed, epoch, step) through ``np.random.SeedSequence``. The count
    of words leads, since SeedSequence pads its entropy with zeros: (s, 0)
    and (s,) would otherwise seed alike."""
    hi, lo = np.random.SeedSequence([len(words), *map(int, words)]) \
        .generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(hi) << 32 | int(lo))


# --- draws ---------------------------------------------------------------------


def drawn(fn):
    """Mark ``fn(generator, *args) -> CPU tensor`` as a draw primitive.

    Called with a ``torch.Generator`` it draws. Called with a draw source
    (``train/draws.py``) in the generator's place, it returns
    ``source.draw(fn, args)``: a recording source draws and notes the call,
    a planned source returns the value made ahead for it.
    """

    @functools.wraps(fn)
    def draw(generator, *args):
        if isinstance(generator, torch.Generator):
            return fn(generator, *args)
        return generator.draw(fn, args)

    return draw


@drawn
def truncated_normal(generator, shape, stddev):
    """N(0, stddev) truncated at 2 sigma, like tf.truncated_normal."""
    out = torch.empty(shape)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out * stddev


@drawn
def uniform(generator, shape, minval, maxval):
    """U[minval, maxval)."""
    return minval + (maxval - minval) * torch.rand(shape, generator=generator)


@drawn
def randint(generator, high, shape):
    """Integers uniform over [0, high), int64."""
    return torch.randint(0, high, shape, generator=generator)


@drawn
def keep(generator, keep_prob, shape):
    """Bernoulli(keep_prob) keep mask of ``shape``, bool."""
    return torch.rand(shape, generator=generator) < keep_prob


def draw_hue(generator, batch, max_delta):
    """One hue delta per sample, U[-max_delta, max_delta), [B, 1, 1]."""
    return uniform(generator, (batch, 1, 1), -max_delta, max_delta)


def draw_crop_offsets(generator, batch, hw, crop_hw):
    """Per-sample top-left corners of a random crop, each uniform over the
    valid range: (rows [B], cols [B]) int64."""
    rows = randint(generator, hw[0] - crop_hw[0] + 1, (batch,))
    cols = randint(generator, hw[1] - crop_hw[1] + 1, (batch,))
    return rows, cols


def draw_channel_keep(generator, batch, channels, keep_prob):
    """Bernoulli(keep_prob) keep mask of whole channels, [B, 1, 1, K] bool."""
    return keep(generator, keep_prob, (batch, 1, 1, channels))


# --- applies ---------------------------------------------------------------------


def rgb_to_hsv(rgb):
    """[..., 3] in [0, 1] -> HSV, matching tf.image.rgb_to_hsv."""
    r, g, b = rgb.unbind(-1)
    v = rgb.amax(-1)
    c = v - rgb.amin(-1)
    safe_c = torch.where(c == 0, torch.ones_like(c), c)
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    # floor-mod, as jnp's %: a negative hue wraps to [0, 1)
    h = torch.where(c == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    s = torch.where(v == 0, torch.zeros_like(v),
                    c / torch.where(v == 0, torch.ones_like(v), v))
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv):
    """Inverse of :func:`rgb_to_hsv`."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    # jnp.choose(i % 6, ..., mode="clip")
    sector = torch.remainder(i.to(torch.int32), 6).clamp(0, 5).long()[..., None]

    def choose(*options):
        return torch.stack(options, -1).gather(-1, sector)[..., 0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], -1)


def random_hue(image, delta):
    """Rotate each sample's hue by its ``delta`` [B, 1, 1].

    ``image`` is [B, H, W, 3] mean-subtracted ([-0.5, 0.5]); the rotation
    happens in [0, 1] space, as in the JAX package (the reference fed
    mean-subtracted values to TF's HSV round trip, outside that op's range).
    """
    hsv = rgb_to_hsv(torch.clamp(image + 0.5, 0.0, 1.0))
    h, s, v = hsv.unbind(-1)
    rotated = torch.stack([torch.remainder(h + delta, 1.0), s, v], -1)
    return hsv_to_rgb(rotated) - 0.5


def random_crop_hw(stacked, rows, cols, crop_hw):
    """Per-sample crop of [B, H, W, C] at top-left corners (``rows``,
    ``cols``) [B], like tf.random_crop: [B, ch, cw, C]."""
    ch, cw = crop_hw
    dev = stacked.device
    r = rows.to(dev)[:, None] + torch.arange(ch, device=dev)
    c = cols.to(dev)[:, None] + torch.arange(cw, device=dev)
    b = torch.arange(stacked.shape[0], device=dev)
    return stacked[b[:, None, None], r[:, :, None], c[:, None, :]]


def scoremap_channel_dropout(scoremap, keep):
    """Zero whole keypoint channels of [B, H, W, K] where ``keep`` [B, 1, 1, K]
    is false; survivors stay unscaled. The reference's tf.nn.dropout followed
    by a multiplication by keep_prob (BinaryDbReader.py:362-365) is this
    pure channel mask."""
    return scoremap * keep.to(scoremap.device, scoremap.dtype)
