"""Export a trained pipeline's renderer as one self-contained file, a ``torch.export`` program.

    python -m yanerf_tpu_torch.export --config configs/nerf/lego_proposal.yml \\
        --checkpoint results/.../ckpts/ckpts_-001 --out lego.pt2 \\
        --cfg_options pipeline.model.2.use_pallas=True [--validate]

    # consumer: needs torch and the port's operator module, nothing else
    from yanerf_tpu_torch.export import load_artifact
    render = load_artifact("lego.pt2")
    images = render(poses, focal_lengths)  # (B, 4, 4), (B, 1) -> (B, H, W, 3)

Counterpart of ``scripts/export.py``: the EVALUATION render of the config's
full grid, weights baked in, traced by ``torch.export.export`` and written
by ``torch.export.save`` as one ``.pt2`` file. The consumer does not need
the config system, the registries or the checkpoint layout. The JAX
artifact embeds its Mosaic kernel; this one names the operator
``yanerf_tpu_torch::nerf_mlp_fwd`` (``ops/kernels/nerf_mlp_fwd.py``), and
:func:`load_artifact` brings it: importing that module registers the
operator, whose CUDA kernel (K1) is built from ``csrc/`` at its first
launch. A NeRFMLP with ``use_pallas`` is recorded as one operator node per
chunk; without it its eager layers are recorded.

The pipeline's parameters are not inputs of the program: every NeRFMLP on
the kernel holds its packed weights as two buffers
(``NeRFMLP.bake_packed_weights``) and every other parameter becomes a
buffer. The chunk loop is a Python loop and is unrolled: a frame of
``n_chunks`` chunks is ``n_chunks`` copies of the chunk's graph.
``--checkpoint`` takes a reference-layout ``.pth``, a checkpoint of the
port's runner or an ``.npz`` of the JAX param tree (``serve.load_pipeline``).
``--device cuda`` (the default) records the CUDA program and raises without
a GPU; ``--device cpu`` records the CPU one (the operator's plain version).
``--validate`` loads the written file and compares its frame with the
direct render, each frame's seconds and K1 launches timed on its second
call. The last line printed is the numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

from .ops.structures import EvaluationMode
from .utils.config import Config, DictAction

OP_NAME = "yanerf_tpu_torch.nerf_mlp_fwd"  # the operator's namespace and name, as a program's node targets print


class RenderFn(nn.Module):
    """``(poses (B, 4, 4), focal_lengths (B, 1)) -> rendered_images (B, H, W, 3)``: the EVALUATION full grid."""

    def __init__(self, pipeline: nn.Module) -> None:
        super().__init__()
        self.pipeline = pipeline

    def forward(self, poses: torch.Tensor, focal_lengths: torch.Tensor) -> torch.Tensor:
        preds = self.pipeline(poses=poses, focal_lengths=focal_lengths, evaluation_mode=EvaluationMode.EVALUATION)
        return preds["rendered_images"]


def bake(pipeline: nn.Module) -> nn.Module:
    """Turn ``pipeline``'s parameters into buffers, in place: the packed weights of each NeRFMLP on the kernel,
    every other parameter as it is."""
    from .models.nerf_mlp import NeRFMLP

    for module in pipeline.modules():
        if isinstance(module, NeRFMLP) and module.use_pallas and module.input_xyz and module.latent_dim == 0:
            module.bake_packed_weights()
    for module in pipeline.modules():
        for name, param in list(module._parameters.items()):
            if param is not None:
                del module._parameters[name]
                module.register_buffer(name, param.detach())
    return pipeline


def build_render_fn(config, checkpoint: Optional[str] = None, seed: int = 0,
                    device: Union[str, torch.device] = "cuda") -> Tuple[RenderFn, Tuple[int, int]]:
    """The render module of ``config`` (weights from ``checkpoint`` or drawn from ``seed``) and its ``(H, W)``.

    The module is baked (:func:`bake`) and in eval mode.
    """
    from .serve import load_pipeline

    pipeline = load_pipeline(config, checkpoint, device, seed)
    rs = config.pipeline.ray_sampler
    return RenderFn(bake(pipeline)).eval(), (rs.image_height, rs.image_width)


def example_inputs(batch: int, width: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A camera 4 units down the z axis looking at the origin, focal length ``width``: the inputs to trace with."""
    poses = torch.eye(4, dtype=torch.float32).repeat(batch, 1, 1)
    poses[:, 2, 3] = 4.0
    focals = torch.full((batch, 1), float(width), dtype=torch.float32)
    return poses.to(device), focals.to(device)


def op_nodes(program: torch.export.ExportedProgram) -> int:
    """How many nodes of ``program``'s graph call the NeRF-MLP operator."""
    return sum(1 for node in program.graph.nodes if node.op == "call_function" and str(node.target).startswith(OP_NAME))


def load_artifact(path: Union[str, Path]) -> nn.Module:
    """The render module of an exported ``.pt2`` file, ready to call.

    Imports the operator's module first (``torch.export.load`` resolves
    the program's nodes by operator name) and turns TF32 off for float32
    matrix products, the port's setting (a program does not record it).
    Needs torch and the port's ``ops.kernels`` modules, nothing of the
    config system.
    """
    from .ops.kernels import nerf_mlp_fwd  # noqa: F401  (registers yanerf_tpu_torch::nerf_mlp_fwd)

    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.export.load(str(path)).module()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--out", default="render.pt2")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0, help="seed of the random weights when no checkpoint")
    parser.add_argument("--validate", action="store_true", help="load the file and compare it with the direct render")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(argv)

    config = Config.fromfile(args.config)
    if args.cfg_options:
        config.merge_from_dict(args.cfg_options)
    render, (h, w) = build_render_fn(config, args.checkpoint, args.seed, args.device)
    inputs = example_inputs(args.batch, w, args.device)
    t0 = time.perf_counter()
    program = torch.export.export(render, inputs)
    export_s = time.perf_counter() - t0
    torch.export.save(program, args.out)
    size_mb = Path(args.out).stat().st_size / 1e6
    result = dict(out=args.out, export_s=export_s, nodes=len(program.graph.nodes), op_nodes=op_nodes(program),
                  mb=size_mb, out_shape=[args.batch, h, w, 3])
    print(f"exported {args.out}: {size_mb:.2f} MB, {result['nodes']} graph nodes ({result['op_nodes']} NeRF-MLP "
          f"operator nodes), {export_s:.1f} s, out_shape=({args.batch}, {h}, {w}, 3)")
    if args.validate:
        from .ops.kernels import nerf_mlp_fwd

        t0 = time.perf_counter()
        restored = load_artifact(args.out)
        result["load_s"] = time.perf_counter() - t0
        with torch.inference_mode():
            frames = {}
            for name, fn in (("direct", render), ("restored", restored), ("direct", render), ("restored", restored)):
                launches = nerf_mlp_fwd.launches
                t0 = time.perf_counter()
                frames[name] = fn(*inputs).cpu()  # the second of each pair is timed, as a served frame ends
                result[f"{name}_frame_s"] = time.perf_counter() - t0
                result[f"{name}_k1_launches"] = nerf_mlp_fwd.launches - launches
        err = float((frames["restored"] - frames["direct"]).abs().max())
        if not err < 1e-6:
            raise SystemExit(f"the loaded program's frame differs from the direct render: {err}")
        result.update(validate_max_abs_err=err, validate_bit_equal=bool(torch.equal(frames["restored"],
                                                                                    frames["direct"])))
        print(f"validate OK: max |restored - direct| = {err:.2e}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
