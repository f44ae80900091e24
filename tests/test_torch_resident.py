"""Device-resident multi-step training of the port (``fit(steps_per_call=K)``,
``trainer.make_resident_train_step``), its draw plan and the named recompute
policies, on the CPU, against the port's per-step path and hand3d_tpu.

On the CPU the resident step runs its body eagerly, K times a window: the
same float32 operations in the same order as the per-step path, on the same
batches and draws, so the two are held equal bit for bit. JAX's trajectory
cannot share the port's draws (threefry is not reproduced), so it is held
on a config that draws nothing: the index rows exactly, step 0's loss at
LOSS_RTOL and the later losses at TRAJECTORY_LOSS_RTOL (see there).
"""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hand3d_tpu.cli import train_posenet as j_train_posenet
from hand3d_tpu.data.config import PreprocessConfig as JaxConfig
from hand3d_tpu.data.pipeline import InputPipeline as JaxPipeline
from hand3d_tpu.data.preprocess import preprocess_rhd as j_preprocess_rhd
from hand3d_tpu.data.rhd import RHDDataset as JaxRHD
from hand3d_tpu.models import posenet as j_posenet
from hand3d_tpu.train import loop as j_loop
from hand3d_tpu.train import trainer as j_trainer
from hand3d_tpu_torch import weights
from hand3d_tpu_torch.cli import train_joint, train_lifting, train_posenet
from hand3d_tpu_torch.data.config import PreprocessConfig
from hand3d_tpu_torch.data.pipeline import InputPipeline, resident_data
from hand3d_tpu_torch.data.preprocess import preprocess_rhd
from hand3d_tpu_torch.data.rhd import RHDDataset
from hand3d_tpu_torch.models import posenet
from hand3d_tpu_torch.train import checkpoints, draws, loop, trainer
from hand3d_tpu_torch.train.loop import fit

from fixtures import make_rhd_bin
from test_torch_train_loop import assert_states_equal
from torch_threads import torch_threads_per_worker  # noqa: F401
from torch_tmp import module_dir, tmp_path  # noqa: F401

CFG = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                       coord_uv_noise=True, crop_center_noise=True,
                       crop_size=32)
# 4 records at batch 2: 2 steps an epoch. 7 steps at K = 3 are the windows
# 3 + 3 + 1 (a ragged tail), cross two epoch rollovers, and the LR boundary
# at 4 lies inside the second window
LR_VALUES, LR_STEPS = [1e-4, 1e-5], [4]
STEPS, K = 7, 3
FUSED = trainer.fuse_preprocess(train_posenet.loss_fn, preprocess_rhd, CFG)
LOSS_RTOL = 1e-5  # tests/test_torch_train_step.py's, one forward
# JAX vs port after several Adam steps: the two frameworks sum convolutions
# in other orders, and PoseNet's leaky ReLUs and max pools have kinks that
# one side crosses and the other not (tests/test_torch_train_step.py), so
# the params part by ~lr a step in a few elements and the losses by more
# than one forward's rounding (measured: 7.1e-8 at step 0, up to 3.7e-6
# over 7 steps; a wrong batch or LR moves a loss by 1e-2 and more)
TRAJECTORY_LOSS_RTOL = 1e-4


def quiet(*args):
    pass


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    with module_dir(tmp_path_factory, "resident") as d:
        yield str(make_rhd_bin(d / "t.bin", num_records=4, seed=9))


def _params():
    return weights.params_from_jax(
        {posenet.SCOPE: posenet.init(np.random.default_rng(4))}, "cpu")


def _run(data, max_iter, steps_per_call, snapshot_dir=None, loss=FUSED,
         cfg=CFG, params=None, **kw):
    pipeline = InputPipeline(RHDDataset("training", data), cfg, 2, seed=5,
                             yield_raw=True, device="cpu")
    kw.setdefault("show_loss_freq", 0)
    kw.setdefault("snapshot_freq", 0)
    kw.setdefault("log", quiet)
    return fit(loss, params or _params(),
               trainer.make_optimizer(LR_VALUES, LR_STEPS), pipeline,
               max_iter, seed=5, snapshot_dir=snapshot_dir,
               steps_per_call=steps_per_call, **kw)


class Rows:
    """A metrics logger that keeps its rows."""

    def __init__(self):
        self.rows = []

    def log(self, **kw):
        self.rows.append(kw)


def _recording(module, record):
    """Wrap ``module.make_resident_train_step`` so every window's index
    rows land in ``record``."""
    base = module.make_resident_train_step

    def make(*args, **kw):
        step = base(*args, **kw)

        def wrapped(state, data, idx, *rest):
            record.append(np.asarray(idx).copy())
            return step(state, data, idx, *rest)

        wrapped.inner = step
        return wrapped

    return make


@pytest.fixture(scope="module")
def per_step(data):
    rows = Rows()
    state = _run(data, STEPS, 1, show_loss_freq=1, metrics_logger=rows)
    return state, [r["loss"] for r in rows.rows]


def test_resident_equals_the_per_step_path_bitwise(data, per_step,
                                                   monkeypatch):
    windows, rows = [], Rows()
    monkeypatch.setattr(loop, "make_resident_train_step",
                        _recording(loop, windows))
    resident = _run(data, STEPS, K, show_loss_freq=1, metrics_logger=rows)
    assert [len(w) for w in windows] == [3, 3, 1]
    assert_states_equal(resident, per_step[0])
    assert [r["loss"] for r in rows.rows] == per_step[1]
    assert [r["step"] for r in rows.rows] == list(range(STEPS))
    # the LR each update took on the device: the boundary inside a window
    assert [r["lr"] for r in rows.rows] == [1e-4] * 4 + [1e-5] * 3
    assert resident.opt_state.param_groups[0]["lr"] == LR_VALUES[1]


def test_resident_index_rows_and_losses_match_jax(data, monkeypatch):
    """The same run on both sides with a config that draws nothing."""
    kw = dict(use_wrist_coord=False, hand_crop=True, crop_size=32)
    j_params = {j_posenet.SCOPE: j_posenet.init(jax.random.PRNGKey(5))}
    # the port's copy first: JAX's fit donates the params it is given
    params = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_params), "cpu")
    j_rows, j_windows = Rows(), []
    monkeypatch.setattr(j_loop, "make_resident_train_step",
                        _recording(j_loop, j_windows))
    j_cfg = JaxConfig(**kw)
    j_loop.fit(j_trainer.fuse_preprocess(j_train_posenet.loss_fn,
                                         j_preprocess_rhd, j_cfg),
               j_params, j_trainer.make_optimizer(LR_VALUES, LR_STEPS),
               JaxPipeline(JaxRHD("training", data), j_cfg, 2, seed=5,
                           yield_raw=True),
               STEPS, seed=5, show_loss_freq=1, snapshot_freq=0,
               steps_per_call=K, log=quiet, metrics_logger=j_rows)

    cfg = PreprocessConfig(**kw)
    rows, windows = Rows(), []
    monkeypatch.setattr(loop, "make_resident_train_step",
                        _recording(loop, windows))
    _run(data, STEPS, K, cfg=cfg, params=params, show_loss_freq=1,
         metrics_logger=rows,
         loss=trainer.fuse_preprocess(train_posenet.loss_fn, preprocess_rhd,
                                      cfg))
    assert len(windows) == len(j_windows) == 3
    for a, b in zip(windows, j_windows):
        np.testing.assert_array_equal(a, b)
    got = [r["loss"] for r in rows.rows]
    want = [r["loss"] for r in j_rows.rows]
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_LOSS_RTOL)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_the_draw_plan_equals_the_per_step_generators(data, accum_steps):
    """K steps of planned draws give the per-step path's values: the lifting
    loss with dropout on draws the crop noise and four keep masks."""
    loss_fn, net = train_lifting.make_loss("proposed", dropout=True)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_center_noise=True,
                           crop_offset_noise=True, crop_scale_noise=True)
    fused = trainer.fuse_preprocess(loss_fn, preprocess_rhd, cfg)
    params = weights.params_from_jax(weights.random_lifting_params(
        "proposed", 3), "cpu")
    raw = {k: torch.from_numpy(v) for k, v in
           RHDDataset("training", data).raw_batch(np.arange(2)).items()}
    m = 2 // accum_steps
    micro = [{k: v[j * m:(j + 1) * m] for k, v in raw.items()}
             for j in range(accum_steps)]
    plan = draws.DrawPlan(draws.record(fused, params, micro))
    assert [len(c) for c in plan.micro_calls] == [8] * accum_steps
    rows = torch.zeros((4, plan.width))
    plan.fill(rows, 7, range(10, 14))
    with torch.no_grad():
        for r, i in enumerate(range(10, 14)):
            sources = plan.sources(rows[r])
            for j in range(accum_steps):
                gen = draws.step_generator((7, i), j, accum_steps)
                want = fused(params, micro[j], gen)
                assert torch.equal(fused(params, micro[j], sources[j]), want)
                assert sources[j].pos == len(plan.micro_calls[j])
    # another order of draws than the plan's raises
    with pytest.raises(RuntimeError, match="plan holds"):
        fused(params, micro[0],
              draws.Planned(rows[0], plan.micro_calls[0][1:]))


def test_resident_resume_equals_the_straight_run_bitwise(data, per_step,
                                                         tmp_path):
    snaps = str(tmp_path / "r")
    first = _run(data, 3, 2, snaps)
    assert first.step == 3
    resumed = _run(data, STEPS, 2, snaps, resume=True)
    assert_states_equal(resumed, per_step[0])
    # a per-step snapshot resumes on the resident path, and the other way
    # round: both are the straight run again
    for first_k, then_k in ((1, K), (K, 1)):
        snaps = str(tmp_path / f"x{first_k}")
        _run(data, 4, first_k, snaps)
        assert_states_equal(_run(data, STEPS, then_k, snaps, resume=True),
                            per_step[0])


def test_resident_needs_a_fused_pipeline_and_no_mesh(data):
    pipeline = InputPipeline(RHDDataset("training", data), CFG, 2,
                             device="cpu")  # not yield_raw
    with pytest.raises(ValueError, match="yield_raw"):
        fit(train_posenet.loss_fn, _params(),
            trainer.make_optimizer([1e-4], []), pipeline, 2,
            steps_per_call=2, show_loss_freq=0, snapshot_freq=0, log=quiet)
    with pytest.raises(ValueError, match="mesh"):
        _run(data, 2, 2, mesh=object())


def test_the_resident_loop_reports_windows_and_halts_on_nan(data, tmp_path):
    """Evals and snapshots land on the first window boundary at or after
    their step; a non-finite loss halts with a snapshot at the window's end
    that names the step."""
    rows, evals = Rows(), []
    _run(data, STEPS, K, str(tmp_path / "s"), metrics_logger=rows,
         show_loss_freq=2, snapshot_freq=2, eval_freq=4,
         eval_fn=lambda state, step: evals.append(step) or {"x": 1.0})
    assert [r["step"] for r in rows.rows if "loss" in r] == [0, 2, 4, 6]
    assert evals == [6, STEPS]
    assert [s for s, _ in checkpoints.sorted_snapshots(
        str(tmp_path / "s"))] == [STEPS]

    def nan_at_4(params, raw, generator):
        loss = FUSED(params, raw, generator)
        return loss * torch.where(params[posenet.SCOPE]["conv1_1"]["biases"]
                                  [0] > 1.0, float("nan"), 1.0)

    def poisoned():
        p = _params()
        p[posenet.SCOPE]["conv1_1"]["biases"][0] = 2.0
        return p

    with pytest.raises(FloatingPointError, match="at iteration 0"):
        _run(data, STEPS, K, str(tmp_path / "n"), loss=nan_at_4,
             params=poisoned())
    assert [s for s, _ in checkpoints.sorted_snapshots(
        str(tmp_path / "n"))] == [K]


class NoHostReads(TorchDispatchMode):
    """Refuses the ops that read a device value on the host (a scalar, or
    a shape that depends on values), which a captured CUDA graph cannot do."""

    REFUSED = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.masked_select.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.REFUSED:
            raise AssertionError(f"host read in the train step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("stage", ["posenet", "joint", "lifting"])
def test_no_host_read_in_a_resident_step(data, stage):
    if stage == "posenet":
        loss, cfg = train_posenet.loss_fn, CFG
        params = _params()
    else:
        cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                               coord_uv_noise=True, crop_center_noise=True,
                               crop_offset_noise=True, crop_scale_noise=True,
                               crop_size=32)
        if stage == "joint":
            loss, prior = train_joint.make_joint_loss("proposed", 1.0, 1.0,
                                                      dropout=True)
            rng = np.random.default_rng(0)
            params = {posenet.SCOPE: posenet.init(rng), **prior.init(rng)}
        else:
            loss, net = train_lifting.make_loss("proposed", dropout=True)
            params = net.init(np.random.default_rng(0))
        params = weights.params_from_jax(params, "cpu")
    fused = trainer.fuse_preprocess(loss, preprocess_rhd, cfg)
    opt = trainer.make_optimizer([1e-4], [])
    state = trainer.init_state(params, opt)
    step = trainer.make_resident_train_step(fused, opt, remat="dots_saveable")
    raw = resident_data(RHDDataset("training", data), "cpu")
    state, _ = step(state, raw, np.array([[0, 1]]), 0, 0)  # builds the step
    step.load(state, raw, np.array([[2, 3]]), 0, 1)  # host-side draws
    with NoHostReads():
        state, metrics = step.run(state, 1, 1)
    assert state.step == 2 and metrics.shape == (2, 1)


def _grads(loss, params, raw, remat):
    return trainer.value_and_grad(loss, params, raw,
                                  draws.step_generator((3, 0), 0, 1), remat)


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def joint_case(data):
    loss, prior = train_joint.make_joint_loss("proposed", 1.0, 1.0,
                                              dropout=True)
    cfg = PreprocessConfig(use_wrist_coord=False, hand_crop=True,
                           coord_uv_noise=True, crop_size=32)
    rng = np.random.default_rng(1)
    params = weights.params_from_jax(
        {posenet.SCOPE: posenet.init(rng), **prior.init(rng)}, "cpu")
    params = trainer.init_state(params, trainer.make_optimizer([1], [])).params
    raw = {k: torch.from_numpy(v) for k, v in
           RHDDataset("training", data).raw_batch(np.arange(2)).items()}
    fused = trainer.fuse_preprocess(loss, preprocess_rhd, cfg)
    return fused, params, raw, _grads(fused, params, raw, False)


@pytest.mark.parametrize("remat", [True, *trainer.REMAT_POLICIES])
def test_each_remat_policy_gives_the_plain_gradients(joint_case, remat):
    """JAX: tests/test_train_loop.py::test_remat_policy_matches_plain_step.
    On the CPU the recompute repeats the forward's float32 operations, so
    the loss and every gradient are equal bit for bit."""
    fused, params, raw, (loss, grads) = joint_case
    got_loss, got = _grads(fused, params, raw, remat)
    assert torch.equal(got_loss, loss)
    assert all(torch.equal(a, b) for a, b in zip(got, grads))


def test_remat_policies_recompute_what_they_should(joint_case):
    """Convolutions and matmuls dispatched in one forward and backward:
    everything_saveable runs each conv once, nothing_saveable twice,
    dots_saveable once (only elementwise work is recomputed), and the
    no-batch-dims policies recompute the convs but not the 2-D matmuls."""
    fused, params, raw, _ = joint_case
    conv, mm = torch.ops.aten.convolution.default, torch.ops.aten.mm.default
    counts = {}
    for remat in trainer.REMAT_POLICIES:
        with CountOps() as c:
            _grads(fused, params, raw, remat)
        counts[remat] = (c.counts.get(conv, 0), c.counts.get(mm, 0))
    n_conv, n_mm = counts["everything_saveable"]
    assert n_conv > 0 and n_mm > 0
    assert counts["nothing_saveable"][0] == 2 * n_conv
    assert counts["nothing_saveable"][1] > n_mm
    for name in ("dots_saveable", "checkpoint_dots"):
        assert counts[name] == (n_conv, n_mm)
    for name in ("dots_with_no_batch_dims_saveable",
                 "checkpoint_dots_with_no_batch_dims"):
        assert counts[name] == (2 * n_conv, n_mm)


@pytest.mark.parametrize("name", [*trainer.REMAT_FACTORIES, "not_a_policy"])
def test_remat_names_jax_cannot_run_raise(name):
    """JAX asserts 'unknown remat policy' for a name it lacks, and raises
    TypeError when it calls a factory as a policy."""
    names = [n for n in dir(jax.checkpoint_policies) if not n.startswith("_")]
    assert sorted(names) == sorted([*trainer.REMAT_POLICIES,
                                    *trainer.REMAT_FACTORIES])
    error, match = ((TypeError, "unexpected keyword argument")
                    if name in trainer.REMAT_FACTORIES
                    else (ValueError, "unknown remat policy"))
    with pytest.raises(error, match=match):
        trainer.make_train_step(FUSED, trainer.make_optimizer([1e-4], []),
                                remat=name)


def test_device_constants_made_under_inference_mode_serve_training():
    """The resize coefficients and ``device_constant``s are made once per
    device and kept: an eval (inference mode) that makes them first must
    leave tensors a train step can save for its backward pass."""
    from hand3d_tpu_torch.ops import image, numerics

    image._lin_coeffs_on.cache_clear()
    numerics._constant.cache_clear()
    with torch.inference_mode():
        image.resize_bilinear(torch.ones(1, 3, 5, 2), (7, 9))
        numerics.device_constant([1.0, -1.0], torch.float32, "cpu")
    x = torch.ones(1, 3, 5, 2, requires_grad=True)
    y = image.resize_bilinear(x, (7, 9)) * numerics.device_constant(
        [1.0, -1.0], torch.float32, "cpu")
    y.sum().backward()
    assert x.grad.shape == x.shape


def test_device_constants_made_while_tracing_are_not_kept():
    """A constant first made while ``torch.export`` traces is a fake tensor:
    it is not kept, and a later eager call gets a plain tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from hand3d_tpu_torch.ops import image, numerics

    image._lin_coeffs_on.cache_clear()
    numerics._constant.cache_clear()
    with FakeTensorMode():
        image.resize_bilinear(torch.ones(1, 3, 5, 2), (7, 9))
        numerics.device_constant([1.0, -1.0], torch.float32, "cpu")
    y = image.resize_bilinear(torch.ones(1, 3, 5, 2), (7, 9))
    c = numerics.device_constant([1.0, -1.0], torch.float32, "cpu")
    assert type(y) is torch.Tensor and type(c) is torch.Tensor
    np.testing.assert_array_equal(y.numpy(), np.ones((1, 7, 9, 2), np.float32))
    np.testing.assert_array_equal(c.numpy(), [1.0, -1.0])
