"""The exported frame keeps the chunk loop (``nerf_pipeline.chunk_map``), as the JAX artifact's ``lax.map`` does.

  * the exported program's nodes (its graph's and the loop body's) and its
    NeRF-MLP operator nodes are the same at 4 chunks (no padding) and at 24
    (padded): one
    ``torch._higher_order_ops.map`` node over the stacked chunk axis, one
    operator node per NeRFMLP in its body;
  * the restored frame equals the direct one (within 1e-6, bits printed),
    and the JAX package's ``scripts/export.py`` render of the same weights
    within 1e-4, at 24 chunks;
  * the eager frame is bit for bit what the Python loop over the chunks
    rendered before (``_loop_render_chunked``, that loop kept here as the
    reference), on the flagship (proposal renderer, K1's plain version
    through the operator), on classic NeRF (two NeRFMLPs, the multipass
    renderer) and with occupancy bounds, each with the same calls of the
    operator per frame;
  * a traced frame refuses a generator.
"""

import importlib.util
import math
import re
from pathlib import Path
from typing import List

import jax
import numpy as np
import pytest
import torch

from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch import export as port_export
from yanerf_tpu_torch.convert import flatten_tree
from yanerf_tpu_torch.ops import occupancy as tocc
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode, RendererOutput
from yanerf_tpu_torch.pipelines import PIPELINES
from yanerf_tpu_torch.pipelines.nerf_pipeline import NeRFPipeline
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
TINY_CFG = re.search(r'TINY_CFG = """(.*?)"""', (REPO / "tests" / "test_export.py").read_text(), re.S).group(1)
PALLAS_CFG = TINY_CFG.replace("      color_dim: 3\n  ray_sampler", "      color_dim: 3\n      use_pallas: true\n  ray_sampler")
NARROW = {"n_layers": 3, "input_skips": [2], "n_hidden_neurons_xyz": 32, "n_hidden_neurons_dir": 16}
SMALL_FRAME = {"pipeline.ray_sampler.image_height": 12, "pipeline.ray_sampler.image_width": 10}


def _loop_render_chunked(self, origins, directions, lengths, xys, bg_color, implicit_functions, evaluation_mode,
                         generator) -> RendererOutput:
    """The chunk loop as a Python loop over ``range(n_chunks)``, one shared generator: the reference frame."""
    batch_size = origins.shape[0]
    spatial = origins.shape[1:-1]
    n_pts = lengths.shape[-1]
    n_rays = math.prod(spatial)
    n_chunks = -(-n_rays * max(n_pts, 1) // self.chunk_size_grid)
    chunk_rays = -(-n_rays // n_chunks)
    n_padded = n_chunks * chunk_rays

    def to_chunks(t):
        if t is None:
            return None
        t = t.reshape(batch_size, n_rays, 1, t.shape[-1])
        if n_padded != n_rays:
            t = torch.cat([t, t[:, -1:].expand(batch_size, n_padded - n_rays, 1, t.shape[-1])], dim=1)
        return t.reshape(batch_size, n_chunks, chunk_rays, 1, t.shape[-1])

    chunks = [to_chunks(t) for t in (origins, directions, lengths, xys, bg_color)]
    outputs = [self.renderer(*(None if t is None else t[:, i] for t in chunks), implicit_functions=implicit_functions,
                             evaluation_mode=evaluation_mode, generator=generator) for i in range(n_chunks)]

    def collate(leaves: List[torch.Tensor]) -> torch.Tensor:
        leaf = torch.cat(leaves, dim=1)
        rest = leaf.shape[3:]
        return leaf.reshape(batch_size, n_padded, *rest)[:, :n_rays].reshape(batch_size, *spatial, *rest)

    def merge(outs):
        return RendererOutput(
            features=collate([o.features for o in outs]), depths=collate([o.depths for o in outs]),
            alpha_masks=collate([o.alpha_masks for o in outs]),
            prev_stage=None if outs[0].prev_stage is None else merge([o.prev_stage for o in outs]),
            aux={k: collate([o.aux[k] for o in outs]) for k in outs[0].aux},
        )

    return merge(outputs)


def _frame_both_ways(cfg, monkeypatch, generator_seed=None):
    """The EVALUATION frame through ``chunk_map`` and through the reference loop, with the operator's calls."""
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device="cpu").eval()
    poses, focals = port_export.example_inputs(1, cfg.pipeline.ray_sampler.image_width, "cpu")
    poses[0, :3, 3] = torch.tensor([0.3, -0.2, 4.0])
    calls = []
    op = K1.nerf_mlp_fwd_op
    monkeypatch.setattr(K1, "nerf_mlp_fwd_op", lambda *a: calls.append(1) or op(*a))
    frames = []
    for loop in (None, _loop_render_chunked):
        if loop is not None:
            monkeypatch.setattr(NeRFPipeline, "_render_chunked", loop)
        calls.clear()
        gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
        with torch.inference_mode():
            preds = pipeline(poses=poses, focal_lengths=focals, evaluation_mode=EvaluationMode.EVALUATION,
                             generator=gen)
        frames.append(({k: v for k, v in preds.items() if k.startswith("rendered_")}, len(calls)))
    monkeypatch.undo()
    return frames


def _flagship_cfg(chunk_size_grid=4096):
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / "lego_proposal.yml"))
    cfg.merge_from_dict({**SMALL_FRAME, "pipeline.chunk_size_grid": chunk_size_grid, "pipeline.model.2.use_pallas": True,
                         **{f"pipeline.model.2.{k}": v for k, v in NARROW.items()},
                         **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2),
                                                                                     ("hidden_dim", 16))}})
    return cfg


def _classic_cfg():
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / "lego.yml"))
    cfg.merge_from_dict({**SMALL_FRAME, "pipeline.chunk_size_grid": 512, "pipeline.model.use_pallas": True,
                         "pipeline.ray_sampler.n_pts_per_ray_evaluation": 16,
                         "pipeline.renderer.n_pts_per_ray_fine_evaluation": 16,
                         **{f"pipeline.model.{k}": v for k, v in NARROW.items()}})
    return cfg


def _occupancy_cfg(tmp_path):
    density = np.zeros((16, 16, 16), np.float32)
    density[5:11, 5:11, 5:11] = 10.0
    tocc.save_occupancy(str(tmp_path / "occ.npz"), tocc.build_occupancy_grid(density, (-1.5, 1.5), threshold=5.0,
                                                                             dilate=1), threshold=5.0)
    cfg = _flagship_cfg()
    cfg.merge_from_dict({"pipeline.ray_sampler.occupancy_grid": str(tmp_path / "occ.npz")})
    return cfg


@pytest.mark.parametrize("path", ["flagship", "classic", "occupancy"])
def test_eager_frame_is_bit_for_bit_the_python_loops(path, tmp_path, monkeypatch):
    cfg = {"flagship": _flagship_cfg, "classic": _classic_cfg}.get(path, lambda: _occupancy_cfg(tmp_path))()
    (mapped, mapped_calls), (looped, looped_calls) = _frame_both_ways(cfg, monkeypatch)
    n_mlps = 2 if path == "classic" else 1
    chunks = -(-12 * 10 * cfg.pipeline.ray_sampler.n_pts_per_ray_evaluation // cfg.pipeline.chunk_size_grid)
    assert chunks > 1 and mapped_calls == looped_calls == n_mlps * chunks
    assert mapped.keys() == looped.keys() and "rendered_images" in mapped
    for key in mapped:
        assert torch.equal(mapped[key], looped[key]), key


def test_eager_frame_with_a_generator_draws_as_the_loop_did(monkeypatch):
    cfg = _flagship_cfg()
    cfg.merge_from_dict({"pipeline.renderer.n_pts_per_ray_final_evaluation": 8})
    # random refinement at eval: the chunks draw from one generator in turn
    pipeline = PIPELINES.build(cfg.pipeline, device="cpu")
    pipeline.renderer._final_cfg[EvaluationMode.EVALUATION] = (8, True)
    monkeypatch.setattr(PIPELINES, "build", lambda *a, **kw: pipeline)
    (mapped, _), (looped, _) = _frame_both_ways(cfg, monkeypatch, generator_seed=5)
    assert all(torch.equal(mapped[k], looped[k]) for k in mapped)


def _export(tmp_path, chunk_size_grid, checkpoint=None):
    path = tmp_path / f"tiny_{chunk_size_grid}.yml"
    path.write_text(PALLAS_CFG.replace("chunk_size_grid: 64", f"chunk_size_grid: {chunk_size_grid}"))
    render, (h, w) = port_export.build_render_fn(Config.fromfile(str(path)), checkpoint, device="cpu")
    inputs = port_export.example_inputs(1, w, "cpu")
    inputs[0][0, :3, 3] = torch.tensor([4.0, 0.3, -0.2])
    return path, render, inputs, port_export.trace(render, inputs)


@pytest.fixture(scope="module")
def at_24_chunks(tmp_path_factory):
    """The tiny config at 24 chunks (``chunk_size_grid`` 16), the JAX package's weights, exported."""
    tmp = tmp_path_factory.mktemp("loop")
    path = tmp / "jax.yml"
    path.write_text(PALLAS_CFG)
    tree = JAX_PIPELINES.build(JaxConfig.fromfile(str(path)).pipeline).init(jax.random.PRNGKey(0))
    npz = tmp / "params.npz"
    np.savez(npz, **flatten_tree(jax.tree_util.tree_map(np.asarray, tree)))
    return tmp, _export(tmp, 16, str(npz))


def test_node_count_and_operator_nodes_do_not_depend_on_the_chunk_count(at_24_chunks, tmp_path):
    many = at_24_chunks[1][3]
    four = _export(tmp_path, 96)[3]  # 8 x 8 rays x 6 points at chunk_size_grid 96: 4 chunks of 16 rays
    assert len(port_export.graph_nodes(four)) == len(port_export.graph_nodes(many))
    assert len(four.graph.nodes) == len(many.graph.nodes)
    assert port_export.op_nodes(four) == port_export.op_nodes(many) == 1
    leading = [n.args[1][0].meta["val"].shape[0] for p in (four, many) for n in p.graph.nodes
               if n.op == "call_function" and "map_impl" in str(n.target)]
    assert leading == [4, 24]


def test_restored_frame_equals_the_direct_one_and_the_jax_export_at_24_chunks(at_24_chunks):
    tmp, (path, render, inputs, program) = at_24_chunks
    direct = render(*inputs)
    torch.export.save(program, tmp / "render.pt2")
    with torch.inference_mode():
        restored = port_export.load_artifact(tmp / "render.pt2")(*inputs)
    assert float((restored - direct).abs().max()) <= 1e-6
    print("restored bit for bit:", torch.equal(restored, direct))

    spec = importlib.util.spec_from_file_location("jax_export_script", REPO / "scripts" / "export.py")
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    jax_render, _ = jax_script.build_render_fn(JaxConfig.fromfile(str(path)), None, seed=0)
    want = np.asarray(jax_render(inputs[0].numpy(), inputs[1].numpy()))
    np.testing.assert_allclose(restored.numpy(), want, rtol=1e-4, atol=1e-4)


def test_a_traced_frame_refuses_a_generator():
    cfg = _flagship_cfg()
    pipeline = PIPELINES.build(cfg.pipeline, device="cpu").eval()
    poses, focals = port_export.example_inputs(1, 10, "cpu")

    class WithGenerator(torch.nn.Module):
        def forward(self, poses, focals):
            return pipeline(poses=poses, focal_lengths=focals, evaluation_mode=EvaluationMode.EVALUATION,
                            generator=torch.Generator().manual_seed(0))["rendered_images"]

    with pytest.raises(Exception, match="draws nothing"):
        torch.export.export(WithGenerator(), (poses, focals))
