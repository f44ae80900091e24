"""Rebuild tests/torch_fixtures/orbax_jax/: a checkpoint written by the JAX
package's ``save_orbax`` (OCDBT store, zstd-compressed zarr chunks) and its
leaves as an .npz, which the port's ``restore_orbax`` must reproduce bit for
bit where no JAX, orbax, tensorstore or zstd encoder is installed.

The state is a TrainState of ``make_optimizer([1e-4, 1e-5], [1])`` after two
optax steps, so the LR boundary is crossed and the Adam moments are nonzero.
Its tree holds the real names and shapes of PoseNet2D's conv1_1 and conv1_2
(3x3x64x64, 147 KiB an array: whole 128 KiB zstd blocks, Huffman-coded) and
PosePrior's fc_xyz, with seeded values.

Run from the repository root, on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixture.py
"""

import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "torch_fixtures", "orbax_jax")
CHECKPOINT = os.path.join(OUT, "checkpoint")
EXPECTED = os.path.join(OUT, "expected.npz")
STEP = 2
LR_VALUES, LR_STEPS = [1e-4, 1e-5], [1]
SHAPES = {("PoseNet2D", "conv1_1"): ((3, 3, 3, 64), 64),
          ("PoseNet2D", "conv1_2"): ((3, 3, 64, 64), 64),
          ("PosePrior", "fc_xyz"): ((512, 63), 63)}


def numpy_tree(seed):
    """The seeded TF-layout tree (Xavier-like kernels, small biases)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for (scope, layer), (kshape, nout) in SHAPES.items():
        fan = np.prod(kshape[:-1]) + kshape[-1]
        tree.setdefault(scope, {})[layer] = {
            "weights": rng.normal(0, np.sqrt(2 / fan), kshape).astype(
                np.float32),
            "biases": rng.normal(0, 1e-2, (nout,)).astype(np.float32)}
    return tree


def flat_leaves(state):
    """{'/'-joined path: array} of a JAX TrainState, the .npz's keys
    (``params/...``, ``opt_state/0/mu/...``, ``opt_state/0/count``, ...)."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = []
        for k in path:
            keys.append(str(getattr(k, "key", getattr(k, "name",
                                                      getattr(k, "idx",
                                                              k)))))
        out["/".join(keys)] = np.asarray(leaf)
    return out


def jax_state(tree, seed):
    """The JAX TrainState of ``tree`` (TF layout, numpy) after ``STEP``
    optax steps of seeded gradients."""
    import jax
    import jax.numpy as jnp
    import optax

    from hand3d_tpu.train import trainer

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = trainer.make_optimizer(LR_VALUES, LR_STEPS)
    state = trainer.init_state(params, opt)
    rng = np.random.default_rng(seed)
    for _ in range(STEP):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 1e-2, p.shape).astype(
                np.float32)), state.params)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        state = state._replace(params=optax.apply_updates(state.params,
                                                          updates),
                               opt_state=opt_state, step=state.step + 1)
    return state


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(HERE))
    from hand3d_tpu.train import checkpoints

    state = jax_state(numpy_tree(0), 1)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    path = checkpoints.save_orbax(CHECKPOINT, state)
    np.savez_compressed(EXPECTED, **flat_leaves(state))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(OUT) for f in fs)
    print(f"wrote {path} and {EXPECTED}: {total} bytes")


if __name__ == "__main__":
    main()
