"""The port's trace regions inside the train step and the served frame, on the CPU.

  * with no profiler running, ``annotate`` touches no ``record_function``
    and hands back the shared no-op; under one it records, and while
    ``torch.export`` traces it records nothing;
  * a profiled per-step epoch holds, once per step, ``data.batch`` (and
    one more, the fetch that finds the loader's end), ``runner.draws`` and
    ``train_step_dispatch`` around ``runner.forward`` /
    ``runner.backward`` / ``runner.optimizer``; a fused dispatch holds
    one ``data.batch`` and one ``runner.draws`` inside its
    ``fused_dispatch_K{n}``;
  * a profiled ``RenderService.render`` is one ``service.render`` around
    ``pipeline.rays``, one ``pipeline.chunk`` per chunk (each around one
    ``model.<class>`` per implicit function and the renderer's regions,
    siblings of the models'), ``pipeline.collate`` and ``service.fetch``,
    for the proposal and the multipass renderer;
  * the exported frame has the same nodes with and without a profiler, and
    the same as the pipeline with every region taken out.
"""

import contextlib
import math
from collections import Counter

import pytest
import torch

import yanerf_tpu_torch.pipelines.nerf_pipeline as nerf_pipeline
import yanerf_tpu_torch.pipelines.renderer as renderer
import yanerf_tpu_torch.serve as serve
from test_torch_export_loop import PALLAS_CFG
from test_torch_fused_step import HW, RUNNER, _state, _train_loader, proposal_cfg
from yanerf_tpu_torch import export as port_export
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.runners import RunType, make_train_step, make_train_step_fused, train_one_epoch
from yanerf_tpu_torch.utils import Config, profiling
from yanerf_tpu_torch.utils.profiling import annotate

STEP_REGIONS = ("runner.forward", "runner.backward", "runner.optimizer")


def _regions(prof):
    """The trace's named host regions as ``(name, start, end)`` in ns, outer before inner at equal starts."""
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CPU and ev.is_user_annotation()]
    return sorted(events, key=lambda e: (e[1], -e[2]))


def _parent(regions, region):
    """The innermost other region that holds ``region``, or None."""
    holders = [r for r in regions if r is not region and r[1] <= region[1] and region[2] <= r[2]]
    return max(holders, key=lambda r: r[1], default=None)


def _named(regions, name):
    return [r for r in regions if r[0] == name]


def _children(regions, parent):
    return [r for r in regions if _parent(regions, r) is parent]


def _profiled(fn):
    with profiling.profiler(cuda=False) as prof:
        out = fn()
    return out, _regions(prof)


# --- annotate -----------------------------------------------------------------------------------------------


def test_annotate_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert annotate("data.batch") is profiling.NO_SPAN is annotate("model.NeRFMLP")
    with annotate("outer"), annotate("inner"):
        x = torch.ones(2).sum()
    assert float(x) == 2.0


def test_annotate_records_under_a_profiler_and_not_while_compiling(monkeypatch):
    with profiling.profiler(cuda=False) as prof:
        assert annotate("recorded") is not profiling.NO_SPAN
        with annotate("recorded"):
            torch.ones(2).sum()
        monkeypatch.setattr(torch.compiler, "_is_compiling_flag", True)
        assert annotate("compiling") is profiling.NO_SPAN
        monkeypatch.undo()
    assert [r[0] for r in _regions(prof)] == ["recorded"]
    assert annotate("after") is profiling.NO_SPAN


# --- the train step -----------------------------------------------------------------------------------------


def test_per_step_epoch_has_each_region_once_per_step(tmp_path):
    loader = _train_loader(tmp_path, 3, quantize=False)
    runner = dict(RUNNER, steps_per_call=1)
    state = _state(proposal_cfg(), runner)
    step = make_train_step(state.pipeline, runner, seed=5)
    _, regions = _profiled(lambda: train_one_epoch(RunType.TRAIN, runner, 0, state, loader, step))
    n = len(loader)
    dispatches = _named(regions, "train_step_dispatch")
    assert len(dispatches) == n == 3 and state.step == n
    batches = _named(regions, "data.batch")
    assert len(batches) == n + 1  # and the loader's end, found by one more fetch
    assert all(_parent(regions, r) is None for r in batches)
    assert all(b[2] <= d[1] for b, d in zip(batches, dispatches)) and batches[-1][1] >= dispatches[-1][2]
    for dispatch in dispatches:
        inside = Counter(r[0] for r in _children(regions, dispatch))
        assert inside == Counter({"runner.draws": 1, **{name: 1 for name in STEP_REGIONS}}), inside
        forward = next(r for r in _children(regions, dispatch) if r[0] == "runner.forward")
        models = Counter(r[0] for r in regions if r[0].startswith("model.") and _parent(regions, r) is forward)
        assert models == Counter({"model.ProposalMLP": 2, "model.NeRFMLP": 1}), models
    order = [r[0] for r in regions if r[0] in STEP_REGIONS]
    assert order == list(STEP_REGIONS) * n


def test_fused_dispatch_holds_one_batch_upload_and_one_draw_region(tmp_path):
    loader = _train_loader(tmp_path, 6, quantize=True)
    runner = dict(RUNNER, steps_per_call=3)
    state = _state(proposal_cfg(), runner)
    fused = make_train_step_fused(state.pipeline, runner, 5, loader.data_wrapper)
    step = make_train_step(state.pipeline, runner, seed=5)
    _, regions = _profiled(lambda: train_one_epoch(RunType.TRAIN, runner, 0, state, loader, step,
                                                   train_step_fused=fused))
    dispatches = _named(regions, "fused_dispatch_K3")
    assert len(dispatches) == fused.dispatches == 2 and state.step == 6
    assert len(_named(regions, "data.batch")) == len(_named(regions, "runner.draws")) == 2
    assert not _named(regions, "train_step_dispatch")
    for dispatch in dispatches:
        inside = Counter(r[0] for r in _children(regions, dispatch))
        # uncaptured on the CPU: the step runs 3 times; on the card they are the graph's replays
        assert inside == Counter({"data.batch": 1, "runner.draws": 1, **{name: 3 for name in STEP_REGIONS}}), inside


# --- the served frame ---------------------------------------------------------------------------------------


def multipass_cfg():
    """Two NeRF-MLPs, coarse then fine, at the fused-step tests' narrow widths."""
    cfg = proposal_cfg()
    nerf = dict(cfg["model"][2], use_pallas_train=False)
    return dict(cfg, num_passes=2, model=[nerf, nerf], loss_weights={"loss_rgb_mse": 1.0},
                renderer=dict(type="MultipassEmissionAbsorpsionRenderer", n_pts_per_ray_fine_training=4,
                              n_pts_per_ray_fine_evaluation=5, bg_color=[0.0, 0.0, 0.0]))


# per chunk: the models, then the renderer's regions (siblings of the models')
RENDERERS = {
    "proposal": (proposal_cfg, {"model.ProposalMLP": 2, "model.NeRFMLP": 1, "renderer.composite": 3,
                                "renderer.refine": 2, "renderer.losses": 1}),
    "multipass": (multipass_cfg, {"model.NeRFMLP": 2, "renderer.composite": 2, "renderer.refine": 1}),
}


@pytest.mark.parametrize("kind", sorted(RENDERERS))
def test_served_frame_has_one_region_per_layer_and_one_chunk_region_per_chunk(kind):
    make_cfg, per_chunk = RENDERERS[kind]
    cfg = make_cfg()
    pipeline = PIPELINES.build(cfg, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    service = serve.RenderService(pipeline, float(HW), (HW, HW), (1.0, 3.0))
    pose = (serve.orbit_pose(20.0, -30.0, 2.0) @ serve.CAM_CALIBRATION)[:3, :4]
    (rgb, depth), regions = _profiled(lambda: service.render(pose, float(HW)))
    assert rgb.shape == (HW, HW, 3) and depth.shape == (HW, HW)
    n_chunks = math.ceil(HW * HW * cfg["ray_sampler"]["n_pts_per_ray_evaluation"] / cfg["chunk_size_grid"])
    [render] = _named(regions, "service.render")
    assert _parent(regions, render) is None
    inside = [r[0] for r in _children(regions, render)]
    assert inside == ["pipeline.rays"] + ["pipeline.chunk"] * n_chunks + ["pipeline.collate", "service.fetch"]
    assert n_chunks > 1
    for chunk in _named(regions, "pipeline.chunk"):
        assert Counter(r[0] for r in _children(regions, chunk)) == Counter(per_chunk)
    for model in (r for r in regions if r[0].startswith("model.")):
        assert not any(r[0].startswith("renderer.") for r in _children(regions, model))


# --- the exported frame -------------------------------------------------------------------------------------


def _nodes(program):
    return [(node.op, str(node.target)) for node in port_export.graph_nodes(program)]


def test_export_has_the_same_nodes_with_a_profiler_and_with_no_region_at_all(tmp_path, monkeypatch):
    path = tmp_path / "tiny.yml"
    path.write_text(PALLAS_CFG)
    render, (h, w) = port_export.build_render_fn(Config.fromfile(str(path)), device="cpu")
    inputs = port_export.example_inputs(1, w, "cpu")
    plain = _nodes(port_export.trace(render, inputs))
    with profiling.profiler(cuda=False):
        profiled = _nodes(port_export.trace(render, inputs))
    for module in (nerf_pipeline, renderer, serve):  # the pipeline as it was before it had regions
        monkeypatch.setattr(module, "annotate", lambda name: contextlib.nullcontext())
    bare = _nodes(port_export.trace(render, inputs))
    assert plain == profiled == bare
    assert port_export.op_nodes(port_export.trace(render, inputs)) == 1
    assert not any("profiler" in target or "record_function" in target for _, target in plain)
