"""The port's C++ record streamer (``hand3d_tpu_torch.data.native``) and
``InputPipeline(use_native=True)`` on the CPU, against hand3d_tpu's streamer
and pipeline on the same file and seed, and against the port's own threaded
path and draws.
"""

import numpy as np
import pytest
import torch

from hand3d_tpu.data import native as j_native
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.pipeline import InputPipeline as JaxPipeline
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu_torch.data import augment, native
from hand3d_tpu_torch.data.codec import RHD_RECORD_DTYPE
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import DATA_STREAM, InputPipeline
from hand3d_tpu_torch.data.preprocess import draw_noise, preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset

from fixtures import make_rhd_bin
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir

CFG = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                       coord_uv_noise=True, crop_center_noise=True,
                       crop_size=32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 7 records at batch 3: 2 steps an epoch, one record dropped
    with module_dir(tmp_path_factory, "native") as d:
        yield str(make_rhd_bin(d / "t.bin", num_records=7, seed=2))


def _batches(reader, n):
    out = []
    for _ in range(n):
        out.append(reader.next_batch())
    reader.close()
    return out


@pytest.mark.parametrize("shuffle,seed", [(True, 3), (True, 4), (False, 0)])
def test_the_reader_equals_jax_reader(data, shuffle, seed):
    kw = dict(batch_size=3, shuffle=shuffle, seed=seed)
    ours = native.NativeRecordReader(data, RHD_RECORD_DTYPE, **kw)
    theirs = j_native.NativeRecordReader(data, RHD_RECORD_DTYPE, **kw)
    assert ours.num_records == theirs.num_records == 7
    for r in (ours, theirs):
        r.reset(epochs=3)
    got, want = _batches(ours, 7), _batches(theirs, 7)
    assert got[-1] is None and want[-1] is None  # 3 epochs of 2 batches
    golden = np.memmap(data, dtype=RHD_RECORD_DTYPE, mode="r")
    for (recs, idx), (j_recs, j_idx) in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(idx, j_idx)
        assert recs.tobytes() == j_recs.tobytes()
        assert recs.tobytes() == golden[idx].tobytes()
    # the library is built into the port's own build directory
    assert native.library_path().startswith(native.BUILD_DIR)


def test_the_native_pipeline_gives_jax_batches_and_the_port_draws(data):
    j_pipe = JaxPipeline(JaxRHD("training", data), JaxConfig(), 3, seed=6,
                         use_native=True, yield_raw=True)
    raw = InputPipeline(RHDDataset("training", data), CFG, 3, seed=6,
                        yield_raw=True, use_native=True, device="cpu")
    feats = InputPipeline(RHDDataset("training", data), CFG, 3, seed=6,
                          use_native=True, device="cpu")
    want = list(j_pipe.iterate(epochs=2))
    got = list(raw.iterate(epochs=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    # step t's draws come from (DATA_STREAM, seed, epoch, step)
    for t, (f, g) in enumerate(zip(feats.iterate(epochs=2), got)):
        gen = augment.generator(DATA_STREAM, 6, *divmod(t, 2))
        expect = preprocess_rhd(CFG, g, draw_noise(CFG, g, gen))
        for k in expect:
            assert torch.equal(f[k], expect[k]), (t, k)


def test_a_resumed_native_iteration_takes_the_threaded_path(data):
    kw = dict(yield_raw=True, device="cpu")
    ds = RHDDataset("training", data)
    a = InputPipeline(ds, CFG, 3, seed=1, use_native=True, **kw)
    b = InputPipeline(ds, CFG, 3, seed=1, **kw)
    for start_epoch, skip in ((1, 0), (0, 1)):
        got = list(a.iterate(epochs=2, start_epoch=start_epoch,
                             skip_steps=skip))
        want = list(b.iterate(epochs=2, start_epoch=start_epoch,
                              skip_steps=skip))
        assert len(got) == len(want) == 4 - skip
        for g, w in zip(got, want):
            assert all(torch.equal(g[k], w[k]) for k in g)


def test_a_missing_source_raises(data, monkeypatch, tmp_path_factory):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", "/nonexistent/recordio.cpp")
    with pytest.raises(native.NativeUnavailable, match="missing source"):
        native.NativeRecordReader(data, RHD_RECORD_DTYPE, batch_size=3)
    pipe = InputPipeline(RHDDataset("training", data), CFG, 3,
                         use_native=True, yield_raw=True, device="cpu")
    with pytest.raises(native.NativeUnavailable):
        next(pipe.iterate(epochs=1))


def test_a_failed_build_raises(data, monkeypatch, tmp_path_factory):
    with module_dir(tmp_path_factory, "badsrc") as d:
        bad = d / "recordio.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "SOURCE", str(bad))
        monkeypatch.setattr(native, "BUILD_DIR", str(d / "_build"))
        with pytest.raises(native.NativeUnavailable, match="build failed"):
            native.load_library()
        assert not any(p.name.endswith(".so")
                       for p in (d / "_build").iterdir())

