"""Host -> device input pipeline with background prefetch (counterpart of
hand3d_tpu/data/pipeline.py).

A daemon thread slices raw record batches out of the memmap (pinned for an
asynchronous copy when the device is a CUDA device) and pushes them to a
bounded queue; the consumer copies them to the device and, unless it yields
raw records, preprocesses them there. Queue depth 2 overlaps host IO with
device compute. Every epoch is reshuffled, in the JAX package's order
exactly; the augmentation draws come from one CPU generator per (seed,
epoch, step).

Under torch.distributed each process reads its own shard of every epoch
(``process_shard``) and ``batch_size`` is the batch of each process, as in
the JAX package; the global batch of a step is the ranks' batches in rank
order. Its augmentation draws are made for the global batch, and each rank
keeps its rows (``draws.Rows``): the data a step sees does not depend on the
number of ranks.

``use_native=True`` reads a fresh iteration through the C++ record streamer
(``data/native.py``, native/recordio.cpp): its threads pread, shuffle and
assemble the batches, in its own seeded order. A resumed iteration
(``start_epoch`` or ``skip_steps``) takes the threaded path, which follows
the epoch order exactly, as in the JAX package. ``resident_data`` puts a
whole dataset on the device for the resident train step.
"""

import queue
import threading

import numpy as np
import torch

from hand3d_tpu_torch.data import augment
from hand3d_tpu_torch.data.preprocess import (draw_noise, preprocess_rhd,
                                              preprocess_stb)
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.parallel import mesh as mesh_lib
from hand3d_tpu_torch.train.draws import Rows
from hand3d_tpu_torch.utils import profiling

# first word of the pipeline's generators, apart from the train step's
DATA_STREAM = 0
PREFETCH = 2  # host-side queue depth


class _ProducerError:
    """Queue sentinel carrying the producer thread's exception to the
    consumer, which would otherwise block in q.get() forever."""

    def __init__(self, exc):
        self.exc = exc


def epoch_indices(num_samples, batch_size, shuffle, seed, drop_remainder=True,
                  process_shard=(0, 1)):
    """Batched index arrays of one epoch, equal to the JAX package's.

    ``process_shard=(i, n)``: the i-th of n disjoint strided slices of the
    (identically seeded) epoch permutation, each cut to floor(N / n) so all
    processes run the same number of steps an epoch.
    """
    idx = np.arange(num_samples)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    pidx, pcount = process_shard
    if pcount > 1:
        idx = idx[pidx::pcount][: num_samples // pcount]
    if drop_remainder:
        n = (len(idx) // batch_size) * batch_size
        idx = idx[:n]
    else:
        pad = (-len(idx)) % batch_size
        # np.resize tiles idx cyclically, which also covers
        # batch_size > 2 * num_samples
        idx = np.concatenate([idx, np.resize(idx, pad)]) if pad else idx
    return idx.reshape(-1, batch_size)


def host_tensors(raw, device):
    """A raw numpy batch as contiguous host tensors, pinned for an
    asynchronous copy when ``device`` is a CUDA device."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in raw.items()}
    if device.type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def resident_data(dataset, device, chunk=256):
    """The whole dataset on ``device`` in its record dtypes (uint8 images and
    masks stay uint8), one tensor per raw field, copied ``chunk`` records at
    a time so the host holds no second copy of it."""
    n = len(dataset)
    out = None
    for a in range(0, n, chunk):
        raw = dataset.raw_batch(np.arange(a, min(a + chunk, n)))
        if out is None:
            out = {k: torch.empty((n,) + v.shape[1:],
                                  dtype=torch.from_numpy(v[:0]).dtype,
                                  device=device) for k, v in raw.items()}
        for k, v in raw.items():
            out[k][a:a + len(v)].copy_(
                torch.from_numpy(np.ascontiguousarray(v)))
    return out


class InputPipeline:
    """Iterates preprocessed device batches from an RHD/STB dataset.

    Args:
      dataset: RHDDataset or STBDataset.
      cfg: PreprocessConfig (selects derived features and augmentations).
      batch_size: per-step batch of this process.
      seed: shuffle and augmentation seed.
      yield_raw: yield the raw record tensors on the device, for train steps
        that preprocess inside the loss (``train.trainer.fuse_preprocess``).
      use_native: read a fresh iteration through the C++ record streamer
        (``data.native``); raises ``native.NativeUnavailable`` where its
        library cannot be built or opened.
      process_shard: (index, count) of this process's shard of every epoch.
        None takes the rank's batch shard of ``mesh`` (the ranks of one
        "model" group read the same rows), and without a mesh (rank, world
        size) from torch.distributed; with more than one process a ``mesh``
        must then be given (synchronized data-parallel training), as the
        JAX package asks for a sharding.
      mesh: the mesh (``parallel.make_mesh``) the batches feed.
      device: where the batches go.
    """

    def __init__(self, dataset, cfg, batch_size, seed=0, yield_raw=False,
                 use_native=False, process_shard=None, mesh=None, *, device):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.yield_raw = yield_raw
        self.use_native = use_native
        self.device = torch.device(device)
        if process_shard is None and mesh is not None:
            # the ranks of a "model" group read the same rows
            process_shard = (mesh_lib.data_index(mesh),
                             mesh_lib.batch_shard_count(mesh))
        if process_shard is None:
            process_shard = (mesh_lib.process_index(),
                             mesh_lib.process_count())
            if process_shard[1] > 1:
                # per-process shards without a synchronized step would
                # silently train n independent models on 1/n of the data
                raise ValueError(
                    f"{process_shard[1]} torch.distributed processes but no "
                    "``mesh``: pass the data-parallel mesh (global batches, "
                    "synchronized DP training) or an explicit process_shard "
                    "to opt into independent per-process iteration")
        pidx, pcount = process_shard
        if not 0 <= pidx < pcount:
            raise ValueError(f"process_shard {process_shard}")
        self.process_shard = (int(pidx), int(pcount))
        self._preprocess = (preprocess_rhd if isinstance(dataset, RHDDataset)
                            else preprocess_stb)

    def _to_device(self, raw, epoch, step):
        """A host batch copied to the device and emitted."""
        with profiling.span("data.preprocess"):
            raw = {k: v.to(self.device, non_blocking=True)
                   for k, v in raw.items()}
            return self._emit(raw, epoch, step)

    def _emit(self, raw, epoch, step):
        if self.yield_raw:
            return raw
        noise = None
        if self.cfg.needs_rng:
            gen = augment.generator(DATA_STREAM, self.seed, epoch, step)
            pidx, pcount = self.process_shard
            b = self.batch_size
            if pcount > 1:  # the global batch's draws, this shard's rows
                gen = Rows(gen, b * pcount, pidx * b, b)
            noise = draw_noise(self.cfg, raw, gen)
        return self._preprocess(self.cfg, raw, noise)

    def _shard_len(self):
        # every shard is cut to the same length (epoch_indices), so all
        # processes run the same number of steps an epoch
        return len(self.dataset) // self.process_shard[1]

    def steps_per_epoch(self):
        steps = self._shard_len() // self.batch_size
        if steps == 0:
            raise ValueError(
                f"batch_size {self.batch_size} exceeds this process's "
                f"dataset shard ({self._shard_len()} of "
                f"{len(self.dataset)} records): every epoch would yield "
                "zero batches")
        return steps

    def __iter__(self):
        return self.iterate(epochs=1)

    def iterate(self, epochs=None, start_epoch=0, skip_steps=0):
        """Yield feature dicts; ``epochs=None`` iterates forever.

        ``start_epoch`` / ``skip_steps`` resume the stream mid-run: the first
        batch is step ``skip_steps`` of epoch ``start_epoch``, with the
        shuffle order and augmentation draws an uninterrupted run had there.
        """
        spe = self.steps_per_epoch()  # validates the batch size
        if not 0 <= skip_steps < spe:
            raise ValueError(f"skip_steps {skip_steps} outside an epoch of "
                             f"{spe} steps (fold whole epochs into "
                             "start_epoch)")
        if (self.use_native and start_epoch == 0 and skip_steps == 0
                and self.process_shard[1] == 1):
            # the streamer owns its shuffle state and cannot start at a
            # later epoch's order, and its order is unsharded: a resumed or
            # sharded iteration takes the threaded path below, which follows
            # both
            yield from self._iterate_native(epochs, spe)
            return
        q = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                epoch = start_epoch
                while not stop.is_set() and (
                        epochs is None or epoch < start_epoch + epochs):
                    batches = epoch_indices(
                        len(self.dataset), self.batch_size, True,
                        self.seed + epoch, process_shard=self.process_shard)
                    first = skip_steps if epoch == start_epoch else 0
                    for step in range(first, len(batches)):
                        if stop.is_set():
                            return
                        raw = host_tensors(
                            self.dataset.raw_batch(batches[step]),
                            self.device)
                        q.put((epoch, step, raw))
                    epoch += 1
                q.put(None)
            except Exception as e:  # handed to the consumer, which raises
                q.put(_ProducerError(e))

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                with profiling.span("data.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise RuntimeError("input-pipeline producer thread "
                                       "failed") from item.exc
                epoch, step, raw = item
                yield self._to_device(raw, epoch, step)
        finally:
            stop.set()
            # drain, so a producer blocked in q.put sees the stop flag
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def _iterate_native(self, epochs, spe):
        """The C++ streamer's batches; step ``t`` of the stream draws from
        (DATA_STREAM, seed, epoch, step) with (epoch, step) = divmod(t,
        steps per epoch), as the JAX package folds its keys."""
        from hand3d_tpu_torch.data.native import NativeRecordReader

        reader = NativeRecordReader(
            self.dataset.path, self.dataset.records.dtype, self.batch_size,
            shuffle=True, seed=self.seed, queue_capacity=max(2, PREFETCH))
        try:
            reader.reset(-1 if epochs is None else epochs)
            total = 0
            while True:
                with profiling.span("data.wait"):
                    item = reader.next_batch()
                if item is None:
                    return
                raw = host_tensors(self.dataset.raw_from_records(item[0]),
                                   self.device)
                epoch, step = divmod(total, spe)
                total += 1
                yield self._to_device(raw, epoch, step)
        finally:
            reader.close()
