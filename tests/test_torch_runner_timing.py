"""The port runner's log fields and trace regions against yanerf_tpu's loops, on the CPU.

  * on the 16x16 scene of the runner tests, the JAX and the port per-step
    train loop and eval loop: every per-step and per-frame line carries the
    same field names in the same order (``iter`` / ``sampler``, ``data``,
    ``inference``, then the stats), and the two times are finite and >= 0;
  * a CPU ``torch.profiler`` trace (``runner.profile_dir``) of the port's
    per-step loop and of its uncaptured fused loop has one
    ``train_step_dispatch`` / ``fused_dispatch_K{n}`` region per dispatch,
    in the order and with the ``n`` of the regions the JAX loop
    annotates; the fused loops are driven with the recording fakes of
    tests/test_torch_fused_step.py;
  * ``annotate`` records nothing without a profiler and a region inside
    one; ``trace(None)`` does nothing, ``trace(dir)`` writes a Chrome trace
    into ``dir``, and ``create_perfetto_link=True`` raises;
  * ``StepTimer`` splits as the JAX package's does;
  * chip_smoke.py's "trace regions" phase on the CPU at a tiny size (the
    CPU regions and the log fields; the device spans need the card).
"""

import contextlib
import json
import logging
import math
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import yanerf_tpu.utils as jax_utils
import yanerf_tpu_torch.utils as port_utils
from test_torch_chip_smoke_capture import NARROW, _count_calls
from test_torch_fused_step import _Loader
from test_torch_train import _write_drive
from yanerf_tpu.datasets import BlenderDataset as JaxBlenderDataset
from yanerf_tpu.datasets import DataLoader as JaxDataLoader
from yanerf_tpu.datasets import create_sampler as jax_create_sampler
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu.runners.vis import RunType as JaxRunType
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch.datasets import BlenderDataset, create_loader, create_sampler
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import RunType, TrainState, apis, create_optimizer, eval_one_epoch, make_train_step
from yanerf_tpu_torch.runners import train_one_epoch
from yanerf_tpu_torch.synth_scene import write_scene
from yanerf_tpu_torch.utils import Config
from yanerf_tpu_torch.utils.profiling import StepTimer, annotate, trace

FIELD = re.compile(r"([A-Za-z_]+): ([^\t]*)")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def _logged(name):
    """The INFO messages of logger ``name`` inside the block."""
    logger, handler = logging.getLogger(name), _Lines()
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield handler.messages
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _lines(messages, header):
    """Each ``{header}: field: value\\t...`` line as a list of (field, value)."""
    return [FIELD.findall(m[len(header) + 2:]) for m in messages if m.startswith(header + ": ")]


def _check_times(lines, names):
    for fields in lines:
        values = dict(fields)
        for name in names:
            assert math.isfinite(float(values[name])) and float(values[name]) >= 0, fields


def _recording_annotate(names):
    @contextlib.contextmanager
    def annotate(name):
        names.append(name)
        yield

    return annotate


def _regions(path, pattern=r"train_step_dispatch|fused_dispatch_K\d+"):
    """The names of a Chrome trace's CPU regions that match ``pattern`` (the optimizer names its own), in order."""
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and re.fullmatch(pattern, e["name"])]
    return [e["name"] for e in sorted(spans, key=lambda e: e["ts"])]


def _jax_loops(cfg_path, runner):
    """The JAX per-step epoch and val eval on the scene; its log messages."""
    cfg = JaxConfig.fromfile(str(cfg_path))
    cfg.merge_from_dict({"pipeline.model.2.use_pallas_train": False})
    pipeline = JAX_PIPELINES.build(cfg.pipeline)
    params = pipeline.init(jax.random.PRNGKey(0))
    tx = jax_optim.create_optimizer(dict(cfg.runner), params)
    state = jax_optim.create_train_state(params, tx)
    loaders = {}
    for split in ("train", "val"):
        ds_cfg = next(d for d in cfg.datasets if d.split == split)
        dataset = JaxBlenderDataset(ds_cfg.base_dir, split, test_skip=1)
        loaders[split] = JaxDataLoader(dataset, jax_create_sampler(dataset, shuffle=split == "train"), batch_size=1,
                                       is_train=split == "train", num_workers=0)
    full = dict(cfg.runner, **runner)
    with _logged("yanerf_tpu.runner") as messages:
        state, _ = jax_apis.train_one_epoch(JaxRunType.TRAIN, full, 0, state, loaders["train"],
                                            jax_apis.make_train_step(pipeline, tx), jax.random.PRNGKey(1))
        jax_apis.eval_one_epoch(JaxRunType.VAL, full, 0, state.params, loaders["val"],
                                jax_apis.make_eval_step(pipeline), jax.random.PRNGKey(2), save_image=False)
    return messages


def _port_loops(cfg_path, runner):
    """The port's per-step epoch and val eval on the scene; its log messages."""
    cfg = Config.fromfile(str(cfg_path))
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device="cpu")
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(cfg.runner, pipeline), step=0)
    loaders = {}
    for split in ("train", "val"):
        ds_cfg = next(d for d in cfg.datasets if d.split == split)
        dataset = BlenderDataset(ds_cfg.base_dir, split, test_skip=1)
        loaders[split] = create_loader(dataset, create_sampler(dataset, shuffle=split == "train", seed=0), 1, 0,
                                       is_train=split == "train")
    full = dict(cfg.runner, **runner)
    with _logged("yanerf_tpu_torch.runner") as messages:
        _, stats = train_one_epoch(RunType.TRAIN, full, 0, state, loaders["train"], make_train_step(pipeline, full, 0))
        eval_one_epoch(RunType.VAL, full, 0, pipeline, loaders["val"], seed=0)
    assert "step_s" in stats
    return messages


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' loops on the 16x16 scene (4 train steps, 2 val frames), every step and frame logged,
    steps 1 and 2 profiled: the messages, the JAX loop's annotated regions, the port's trace."""
    tmp = tmp_path_factory.mktemp("timing")
    cfg_path = _write_drive(tmp)
    runner = dict(print_per_iter=1, val_per_iter=None, output_dir=None, hooks=[], steps_per_call=1,
                  profile_dir=str(tmp / "trace"), profile_start_iter=1, profile_num_iters=2)
    jax_names = []
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_apis, "annotate", _recording_annotate(jax_names))
        patch.setattr(jax.profiler, "start_trace", lambda *a, **kw: None)
        patch.setattr(jax.profiler, "stop_trace", lambda *a, **kw: None)
        jax_messages = _jax_loops(cfg_path, runner)
    return dict(jax=jax_messages, port=_port_loops(cfg_path, runner), jax_names=jax_names,
                trace=tmp / "trace" / "train_trace.json")


def test_per_step_and_per_frame_lines_carry_the_jax_fields_in_its_order(runs):
    for header, n_lines, closing, first in (("train\tEpoch:\t[0]", 4, 0, ["iter", "sampler", "data", "inference"]),
                                            ("val\tEpoch:\t[0]", 2, 1, ["sampler", "data", "inference"])):
        ours, theirs = _lines(runs["port"], header), _lines(runs["jax"], header)
        assert len(ours) == len(theirs) == n_lines + closing  # every step (frame), and eval's closing line
        assert [[k for k, _ in fields] for fields in ours] == [[k for k, _ in fields] for fields in theirs]
        for fields in ours[:n_lines]:
            names = [k for k, _ in fields]
            assert names[:len(first)] == first and "objective" in names
        _check_times(ours[:n_lines], ("data", "inference"))
        _check_times(theirs[:n_lines], ("data", "inference"))
    closing = dict(_lines(runs["port"], "val\tEpoch:\t[0]")[-1])
    assert "data" not in closing and "inference" not in closing and "objective" in closing


def test_the_per_step_trace_has_one_region_per_dispatch_as_the_jax_loop_annotates(runs):
    assert runs["jax_names"] == ["train_step_dispatch"] * 4
    # steps 1 and 2 of 4 profiled: their regions, none of the others'
    assert _regions(runs["trace"]) == ["train_step_dispatch"] * 2


FUSED_CASES = [(10, 3, None), (10, 4, 4), (7, 20, 3), (12, 5, 6), (5, 2, 2)]


@pytest.mark.parametrize("n,k,val_per_iter", FUSED_CASES)
def test_the_fused_trace_has_one_region_per_dispatch_with_the_jax_group_sizes(tmp_path, monkeypatch, n, k,
                                                                              val_per_iter):
    config = dict(steps_per_call=k, val_per_iter=val_per_iter, print_per_iter=4, profile_dir=str(tmp_path / "trace"),
                  profile_start_iter=0, profile_num_iters=n)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda *a, **kw: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda *a, **kw: None)
    jax_names = []
    monkeypatch.setattr(jax_apis, "annotate", _recording_annotate(jax_names))

    def jax_fused(state, arrays, idx, rng):
        return state, {"objective": jnp.zeros(idx.shape, jnp.float32)}

    def jax_vis(state, batch, rng):
        return state, {"objective": jnp.zeros((1,), jnp.float32)}

    jax_apis._train_one_epoch_fused(JaxRunType.TRAIN, config, 0, None, _Loader(n, (jnp.arange(n),)), jax_fused,
                                    jax.random.PRNGKey(0), train_step_vis=jax_vis)
    groups = []

    class Fused:
        seen_group_sizes = set()

        def __call__(self, state, arrays, idx):
            groups.append(len(idx))
            return {"objective": torch.zeros(idx.shape)}

    def vis(state, batch):
        groups.append("vis")
        return {"objective": torch.zeros(1)}

    state = SimpleNamespace(pipeline=SimpleNamespace(device=torch.device("cpu")), step=0)
    apis._train_one_epoch_fused(RunType.TRAIN, config, 0, state, _Loader(n, (torch.arange(n),)), Fused(),
                                train_step_vis=vis)
    fused = [g for g in groups if g != "vis"]
    assert sum(fused) + groups.count("vis") == n and fused
    # the whole epoch profiled: one region per fused dispatch, none around a vis step
    assert _regions(tmp_path / "trace" / "train_trace.json") == jax_names == [f"fused_dispatch_K{g}" for g in fused]


def test_annotate_records_nothing_without_a_profiler_and_a_region_inside_one(tmp_path):
    with annotate("outside"):
        x = 1
    assert x == 1
    with port_utils.profiling.profiler(cuda=False) as prof:
        with annotate("inside"):
            torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert "inside" in names and "outside" not in names
    with annotate("outside_again"):  # after the profiler: nothing is left recording
        pass
    assert "outside_again" not in [e.name for e in prof.events()]


def test_trace_none_does_nothing_a_dir_gets_a_chrome_trace_and_a_perfetto_link_raises(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        torch.ones(2).sum()
    assert list(tmp_path.iterdir()) == []
    with trace(tmp_path / "logs"):
        with annotate("region"):
            torch.ones(3).sum()
    files = list((tmp_path / "logs").glob("*.pt.trace.json"))
    assert len(files) == 1 and _regions(files[0], "region") == ["region"]
    with pytest.raises(NotImplementedError, match="Perfetto link"):
        with trace(tmp_path / "linked", create_perfetto_link=True):
            pass
    assert not (tmp_path / "linked").exists()
    with trace(None, create_perfetto_link=True):  # disabled: the flag has nothing to do, as in the JAX package
        pass


def test_step_timer_splits_as_the_jax_step_timer():
    times = {}
    for name, utils in (("jax", jax_utils), ("port", port_utils)):
        timer = utils.StepTimer()
        assert timer.check("data") >= 0 and timer.check("inference") >= 0
        out = timer.reset()
        assert timer.times == {}
        times[name] = list(out)
    assert times["port"] == times["jax"] == ["data", "inference"]
    assert StepTimer is port_utils.StepTimer


def test_chip_smoke_trace_regions_phase_runs_on_the_cpu(tmp_path, monkeypatch):
    """12 fused steps at 8 per dispatch (the vis step, groups of 3 and of 8, the 8 profiled), 3 per-step
    iterations (steps 1-2 profiled), a tiny flagship on a 16x16 scene of 12 views."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    _count_calls(monkeypatch)
    scene = write_scene(tmp_path / "scene", hw=16, n_train=12, n_val=1, n_test=1, n_spheres=3, seed=1)
    flagship = Config.fromfile(str(chip_smoke.CONFIG))
    flagship.merge_from_dict({
        "pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 256,
        "runner.num_workers_list": [0, 0, 0], **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    flagship.dump(str(tmp_path / "flagship.yml"))
    paths = chip_smoke.trace_regions_phase(torch, K1, K3, "cpu", scene, tmp_path / "trace_regions",
                                           tmp_path / "flagship.yml", fused_steps=12, per_step_steps=3,
                                           fused_profile=(4, 8), per_step_profile=(1, 2))
    assert paths == {"trace_regions_train_fused": {"nerf_mlp_fwd": 12, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 12},
                     "trace_regions_train": {"nerf_mlp_fwd": 3, "nerf_mlp_fwd_pipelined": 0, "nerf_mlp_bwd": 3}}
    fused = json.loads((tmp_path / "trace_regions" / "fused" / "trace" / "train_trace.json").read_text())
    assert _regions(tmp_path / "trace_regions" / "fused" / "trace" / "train_trace.json") == ["fused_dispatch_K8"]
    assert not [e for e in fused["traceEvents"] if e.get("cat") == "gpu_user_annotation"]  # no card, no device span
