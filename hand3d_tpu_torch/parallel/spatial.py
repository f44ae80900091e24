"""Spatial partitioning (SP): conv activations split by rows over the mesh's
"model" axis (counterpart of hand3d_tpu/parallel/mesh.py
``spatial_constrainer``).

JAX's constrainer is a sharding annotation and GSPMD inserts the halo
exchanges. The port does the work itself. ``RowShards`` is the ``constrain=``
hook of ``models.handsegnet.apply`` and ``models.posenet.apply_trunk``,
applied after each conv block as in the JAX package:

  * the first call splits a whole NCHW activation into contiguous blocks of
    rows, rank i of the "model" group keeping block i (the height must
    divide), and opens the region; later calls see a tensor already split
    and keep it, and an unmarked one while the region is open raises (an
    op that dropped the mark would otherwise be split twice);
  * a split tensor is marked (``rows_of``), and ``ops.nn`` runs each SAME
    conv on it after a halo exchange: ``k // 2`` rows from each neighbour
    (``collectives.shift``), zeros at the image's own top and bottom, so
    the rows equal the whole conv's; a leaky ReLU keeps the mark, a 2x2
    max pool needs an even number of rows a rank;
  * ``whole`` all-gathers the rows where the network leaves the
    constrained region and closes it; the models run the region inside
    ``region``, which closes it on an error too.

Backward, the halo rows' gradients go back to the ranks that sent them and
are added there (``shift``'s transpose); the split all-gathers its gradient
for the replicated layers before it, and the gather keeps this rank's rows of
the gradient of the replicated layers after it. The params stay replicated:
a conv inside the region takes its weights through ``copy_to_model``, whose
backward sums the ranks' gradients of their rows, so every rank of the group
holds the whole, same gradient of every param, as without SP.
"""

import contextlib

import torch

from hand3d_tpu_torch.parallel import collectives
from hand3d_tpu_torch.parallel import mesh as mesh_lib

_MARK = "_hand3d_row_shards"


def rows_of(x):
    """The RowShards that split ``x``, or None for a whole tensor."""
    return getattr(x, _MARK, None)


def mark(x, rows):
    """``x`` marked as split by ``rows`` (where ``rows`` is not None)."""
    if rows is not None:
        setattr(x, _MARK, rows)
    return x


class RowShards:
    """The rows of NCHW activations split over ``mesh``'s "model" group."""

    def __init__(self, mesh):
        self.group = mesh_lib.model_group(mesh)
        self.size = mesh_lib.model_size(mesh)
        self.open = False  # from the split to ``whole``

    def __call__(self, x):
        rows = rows_of(x)
        if rows is self:
            return x
        if rows is not None:
            raise ValueError("activation split by another constrainer")
        if self.open:
            raise ValueError(
                "spatial partitioning: an activation inside the split region "
                "lost its row split (an op between two constrain calls that "
                "does not keep the mark); it would be split a second time")
        if x.shape[2] % self.size:
            raise ValueError(
                f"spatial partitioning: height {x.shape[2]} does not divide "
                f"over the {self.size} ranks of the 'model' axis")
        self.open = True
        return mark(collectives.scatter(x, self.group, 2), self)

    def halo(self, x, k):
        """``x`` (this rank's rows) with ``k // 2`` rows of each neighbour
        above and below, zeros beyond the image."""
        p = k // 2
        if p == 0:
            return x
        if x.shape[2] < p:
            raise ValueError(
                f"spatial partitioning: {x.shape[2]} rows a rank are fewer "
                f"than a {k}x{k} conv's halo of {p}")
        above = collectives.shift(x[:, :, -p:], self.group, 1)
        below = collectives.shift(x[:, :, :p], self.group, -1)
        return torch.cat([above, x, below], dim=2)

    def check_pool(self, x):
        if x.shape[2] % 2:
            raise ValueError(
                f"spatial partitioning: a 2x2 pool needs an even number of "
                f"rows a rank, got {x.shape[2]} (the height does not divide "
                f"over {self.size} ranks down to this pool)")

    def whole(self, x):
        self.open = False
        return collectives.gather_channels(x, self.group, 2)


@contextlib.contextmanager
def region(constrain):
    """The constrained region of a forward pass: a RowShards ``constrain``
    is closed where it ends, on an error too."""
    try:
        yield
    finally:
        if isinstance(constrain, RowShards):
            constrain.open = False


def whole(x):
    """``x`` whole again (all rows on every rank) where it was split."""
    rows = rows_of(x)
    return x if rows is None else rows.whole(x)
