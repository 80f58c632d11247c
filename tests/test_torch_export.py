"""The NeRF-MLP operator and the exported renderer of yanerf_tpu_torch (``export.py``), on the CPU.

  * ``yanerf_tpu_torch::nerf_mlp_fwd``, the ``torch.library`` operator every
    K1 / K2 launch goes through: ``torch.library.opcheck`` (schema, fake
    implementation, autograd registration, AOT dispatch) on CPU tensors,
    its output bit for bit the plain version's, and the wrapper, the model's
    eval path and ``FusedNerfMlp`` all calling it;
  * the export: tests/test_export.py's ``TINY_CFG`` with ``use_pallas`` on
    its NeRFMLP, so the operator is in the graph. One operator node per
    chunk, no parameter among the program's inputs, the baked module's
    caches left holding real tensors; the ``.pt2`` written, then loaded in a
    fresh process that imports neither JAX nor the port's config-driven
    modules, reproduces the direct render at 1e-6 and the JAX package's
    ``scripts/export.py`` ``build_render_fn`` render of the same weights at
    1e-4 (float32); the CLI's ``--validate``.
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch import export as port_export
from yanerf_tpu_torch.convert import flatten_tree
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.ops.kernels import fused_mlp
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.utils import Config

REPO = Path(__file__).resolve().parent.parent
TINY_CFG = re.search(r'TINY_CFG = """(.*?)"""', (REPO / "tests" / "test_export.py").read_text(), re.S).group(1)
# the NeRFMLP on the fused kernel: the exported graph records the operator
PALLAS_CFG = TINY_CFG.replace("      color_dim: 3\n  ray_sampler", "      color_dim: 3\n      use_pallas: true\n  ray_sampler")
CHUNKS = 6  # 8 x 8 rays x 6 proposal points at chunk_size_grid 64
MODEL = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
             n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16)


def _packed(compute_dtype="bfloat16", seed=0, **model):
    mlp = MODELS.build(dict(MODEL, compute_dtype=compute_dtype, **model), generator=torch.Generator().manual_seed(seed))
    return mlp, mlp.packed_weights()


def _inputs(n_rays=7, pts_per_ray=5, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n_rays * pts_per_ray, 3, generator=gen) * 3.0 - 1.5, torch.randn(n_rays, 3, generator=gen)


# --- the operator ----------------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype,pipelined,nerf_paper_v1", [
    ("bfloat16", False, False), ("bfloat16", True, False), ("float32", False, False), ("bfloat16", False, True),
])
def test_operator_passes_opcheck_and_equals_the_plain_version(compute_dtype, pipelined, nerf_paper_v1):
    _, packed = _packed(compute_dtype, nerf_paper_v1=nerf_paper_v1)
    points, dirs = _inputs()
    args = (points, dirs, *K1._op_args(packed), 5, pipelined)
    result = torch.library.opcheck(K1.nerf_mlp_fwd_op, args)
    assert all(v == "SUCCESS" for v in result.values()), result
    out = torch.ops.yanerf_tpu_torch.nerf_mlp_fwd(*args)
    assert out.shape == (35, 4) and out.dtype == torch.float32
    assert torch.equal(out, K1.nerf_mlp_fwd_plain(packed, points, dirs, 5))
    assert torch.equal(K1.nerf_mlp_fwd(packed, points, dirs, 5, pipelined=pipelined), out)


def test_operator_is_the_one_binding_of_the_wrapper_the_eval_path_and_the_autograd_function(monkeypatch):
    mlp, packed = _packed("float32")
    points, dirs = _inputs()
    calls = []
    op = K1.nerf_mlp_fwd_op

    def recording(*args):
        calls.append(args)
        return op(*args)

    monkeypatch.setattr(K1, "nerf_mlp_fwd_op", recording)
    K1.nerf_mlp_fwd(packed, points, dirs, 5)
    origins, lengths = torch.zeros(1, 7, 3), torch.linspace(1.0, 3.0, 5).expand(1, 7, 5).contiguous()
    with torch.no_grad():
        mlp(origins, dirs[None], lengths, use_pallas=True)
    out = fused_mlp.fused_nerf_mlp(mlp, points, dirs, 5)
    out.sum().backward()
    assert len(calls) == 3
    assert all(c[2] is mlp.packed_weights().flat and c[-2:] == (5, False) for c in calls)
    # the fake implementation: shapes without data, as a tracer sees them
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = op(mode.from_tensor(points), mode.from_tensor(dirs), mode.from_tensor(packed.flat),
                  mode.from_tensor(packed.biases_flat), *K1._op_args(packed)[2:], 5, False)
    assert fake.shape == (35, 4) and fake.dtype == torch.float32


def test_operator_on_another_device_raises():
    _, packed = _packed()
    points, dirs = _inputs()
    with pytest.raises(ValueError, match="unsupported device"):
        K1.nerf_mlp_fwd(packed, points.to("meta"), dirs.to("meta"), 5)


# --- the export ------------------------------------------------------------------------------------


def _jax_export_script():
    spec = importlib.util.spec_from_file_location("jax_export_script", REPO / "scripts" / "export.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny config's weights from the JAX package (``init(PRNGKey(0))``, as ``build_render_fn`` draws them),
    exported by the port from their ``.npz``."""
    tmp = tmp_path_factory.mktemp("export")
    cfg_path = tmp / "tiny.yml"
    cfg_path.write_text(PALLAS_CFG)
    jax_script = _jax_export_script()
    jax_render, (h, w) = jax_script.build_render_fn(JaxConfig.fromfile(str(cfg_path)), None, seed=0)
    npz = tmp / "params.npz"
    tree = JAX_PIPELINES.build(JaxConfig.fromfile(str(cfg_path)).pipeline).init(jax.random.PRNGKey(0))
    np.savez(npz, **flatten_tree(jax.tree_util.tree_map(np.asarray, tree)))
    render, hw = port_export.build_render_fn(Config.fromfile(str(cfg_path)), str(npz), device="cpu")
    assert hw == (h, w) == (8, 8)
    inputs = port_export.example_inputs(1, w, "cpu")
    inputs[0][0, :3, :3] = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])  # not the identity
    inputs[0][0, :3, 3] = torch.tensor([4.0, 0.3, -0.2])
    direct = render(*inputs)
    program = torch.export.export(render, inputs)
    out = tmp / "render.pt2"
    torch.export.save(program, out)
    want_jax = np.asarray(jax_render(inputs[0].numpy(), inputs[1].numpy()))
    return dict(tmp=tmp, cfg=cfg_path, npz=npz, render=render, inputs=inputs, direct=direct, program=program,
                out=out, jax=want_jax)


def test_exported_graph_holds_one_operator_node_per_chunk_and_no_parameter(exported):
    program = exported["program"]
    assert port_export.op_nodes(program) == CHUNKS
    signature = program.graph_signature
    assert len(signature.parameters) == 0 and len(signature.user_inputs) == 2
    assert {"pipeline.implicit_functions.1.packed_flat", "pipeline.implicit_functions.1.packed_biases"} <= set(
        signature.buffers)
    assert not [b for b in signature.buffers if b.startswith("pipeline.implicit_functions.1.xyz_encoder")], \
        "the baked NeRFMLP holds its packed weights only"
    # the module traced is still a plain module: its caches kept real tensors, its frame is the same
    again = exported["render"](*exported["inputs"])
    assert not isinstance(again, torch._subclasses.fake_tensor.FakeTensor)
    assert torch.equal(again, exported["direct"])


def test_artifact_loaded_in_a_fresh_process_reproduces_the_direct_and_the_jax_render(exported):
    tmp = exported["tmp"]
    np.save(tmp / "poses.npy", exported["inputs"][0].numpy())
    np.save(tmp / "focals.npy", exported["inputs"][1].numpy())
    consumer = f"""
import json, sys
import numpy as np
import torch
from yanerf_tpu_torch.export import load_artifact
render = load_artifact({str(exported['out'])!r})
with torch.inference_mode():
    frame = render(torch.from_numpy(np.load({str(tmp / 'poses.npy')!r})), torch.from_numpy(np.load({str(tmp / 'focals.npy')!r})))
np.save({str(tmp / 'restored.npy')!r}, frame.numpy())
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "yanerf_tpu", "yanerf_tpu_torch"))))
"""
    proc = subprocess.run([sys.executable, "-c", consumer], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in modules if m.split(".")[0] in ("jax", "yanerf_tpu")]
    assert not [m for m in modules if m.split(".")[1:2] in (["pipelines"], ["models"], ["runners"], ["serve"],
                                                            ["datasets"])], modules
    restored = np.load(tmp / "restored.npy")
    assert restored.shape == (1, 8, 8, 3) and float(restored.std()) > 0.0
    np.testing.assert_allclose(restored, exported["direct"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(restored, exported["jax"], rtol=1e-4, atol=1e-4)


def test_export_cli_validates_on_the_cpu(exported, capsys):
    out = exported["tmp"] / "cli.pt2"
    result = port_export.main(["--config", str(exported["cfg"]), "--checkpoint", str(exported["npz"]), "--out",
                               str(out), "--device", "cpu", "--validate"])
    assert out.exists() and result["op_nodes"] == CHUNKS and result["validate_max_abs_err"] < 1e-6
    assert result["nodes"] == len(exported["program"].graph.nodes)
    assert "validate OK" in capsys.readouterr().out


def test_bake_refuses_a_nerf_mlp_off_the_kernel():
    mlp, _ = _packed("float32")
    mlp.use_pallas = False
    with pytest.raises(ValueError, match="fused kernel"):
        mlp.bake_packed_weights()
