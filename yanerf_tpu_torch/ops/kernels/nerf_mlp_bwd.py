"""Fused NeRF-MLP backward: the CUDA kernel's wrapper and its plain version.

Replaces ``yanerf_tpu/ops/pallas/nerf_mlp_bwd.py::_nerf_mlp_bwd_kernel``
(reached through ``nerf_mlp_backward_pallas``): the weight and bias
gradients of the fused forward (``nerf_mlp_fwd.py``) given the points, the
per-ray directions and the cotangents of its ``(N, 1 + C)`` output. The
kernel is ``csrc/nerf_mlp_bwd.cu``; its header says what bounds it on the
card (operations) and what the design does about the gradients that cannot
stay resident and the activations that do not fit on chip.

* ``nerf_mlp_bwd_plain`` repeats K3's arithmetic in plain PyTorch: bf16
  operands with float32 accumulation, the bias added in float32, the
  sigmoid's cotangent rounded to bf16, every ``g @ W^T`` rounded to bf16,
  ReLU masks taken on the bf16 activations, ``dW = a^T g`` and
  ``db = sum(g)`` in float32. It runs with TF32 off.
* ``nerf_mlp_bwd`` launches the kernel for CUDA tensors and takes the plain
  version only for CPU tensors. It never falls back on the card.
* ``launches`` counts the kernel's launches (one per call: the three
  kernels of ``csrc/nerf_mlp_bwd.cu`` run as one launch of K3), each
  launch of a replayed CUDA graph too (``launch_count.py``). Under capture
  the stashes and partial sums are allocations of the graph's pool, so a
  replay finds them at the addresses its tensor maps were encoded for.
* ``weight_grad_jobs`` is the plan of the kernel's weight-gradient pass,
  made here and handed to the kernel; ``layer_check`` runs one layer of the
  first pass's building blocks (the card tests hold it to a plain product).

Both return the gradients in the packed layout of ``pack_weights``:
``(grad_flat, grad_biases_flat)``, float32 buffers with the offsets of
``PackedNerfMlp.flat`` / ``biases_flat``; ``grad_views`` cuts them into
one tensor per packed weight and bias. The rows of the packed padding get
exactly zero.
"""

from __future__ import annotations

import ctypes
import sys
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import launch_count
from ._build import CudaLibrary
from .nerf_mlp_fwd import (
    PackedNerfMlp,
    _check_cuda_inputs,
    embed_padded,
    no_tf32,
)

# kernel launches since import (or since a caller reset it)
launches = 0

STEP = 64  # points per step of the weight-gradient pass


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.nerf_mlp_bwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check = lib.nerf_mlp_bwd_layer_check
    check.argtypes = [ctypes.c_void_p] * 5
    check.restype = ctypes.c_int


LIBRARY = CudaLibrary("nerf_mlp_bwd.cu", _bind)
build, build_report, load = LIBRARY.build, LIBRARY.build_report, LIBRARY.load


def grad_views(packed: PackedNerfMlp, grad_flat: torch.Tensor, grad_biases_flat: torch.Tensor):
    """``(weight grads, bias grads)``: one view per packed tensor, in kernel order and packed shapes."""
    ws = [grad_flat[o : o + w.numel()].view(w.shape) for w, o in zip(packed.weights, packed.w_offsets)]
    bs = [grad_biases_flat[o : o + b.numel()] for b, o in zip(packed.biases, packed.b_offsets)]
    return ws, bs


def nerf_mlp_bwd_plain(
    packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3.

    Args:
        points: ``(N, 3)`` float32, ``pts_per_ray`` consecutive points per ray.
        dirs: ``(N / pts_per_ray, 3)`` float32 unnormalized ray directions.
        g: ``(N, 1 + color_dim)`` float32 cotangent of the fused forward's
            output (density | rgb).

    Returns:
        ``(grad_flat, grad_biases_flat)`` float32, in the packed layout.
    """
    cd = packed.compute_dtype
    h = packed.hidden
    w, b = packed.weights, packed.biases
    nl = packed.n_layers

    def mm(a, wt):
        return a.float() @ wt.float()

    def gmm_t(gr, wt):
        return (gr.float() @ wt.float().t()).to(cd)

    def relu_mask(gr, act):
        return gr * (act.float() > 0).to(gr.dtype)

    dws: List[torch.Tensor] = [None] * len(w)
    dbs: List[torch.Tensor] = [None] * len(b)

    def acc_dw(i, a, gr):
        dws[i] = a.float().t() @ gr.float()
        dbs[i] = gr.float().sum(dim=0)

    with no_tf32():
        emb = embed_padded(points, packed.n_freq_xyz, packed.append_xyz, packed.k_xyz).to(cd)
        d = dirs.repeat_interleave(pts_per_ray, dim=0)
        norm = torch.sqrt(torch.clamp(torch.sum(d * d, dim=-1, keepdim=True), min=1e-24))
        demb = embed_padded(d / norm, packed.n_freq_dir, packed.append_dir, packed.k_dir).to(cd)

        # recompute the forward, keeping every layer's input and output
        inputs, outputs = [], []
        y = emb
        for li in range(nl):
            x = torch.cat([y, emb], dim=-1) if (li in packed.input_skips and li > 0) else y
            inputs.append(x)
            y = F.relu(mm(x, w[li]) + b[li]).to(cd)
            outputs.append(y)
        features = y
        l_int, l_den, l_c0 = nl, nl + 1, nl + 2
        inter = (mm(features, w[l_int]) + b[l_int]).to(cd)
        act = F.relu(mm(inter, w[l_c0][:h]) + mm(demb, w[l_c0][h:]) + b[l_c0]).to(cd)
        extra_inputs = []
        for e in range(packed.n_extra_color):
            extra_inputs.append(act)
            act = F.relu(mm(act, w[l_c0 + 1 + e]) + b[l_c0 + 1 + e]).to(cd)
        l_last = l_c0 + 1 + packed.n_extra_color
        color = torch.sigmoid(mm(act, w[l_last]) + b[l_last])

        # backward
        g_density = g[:, :1].to(cd)
        gz = (g[:, 1:] * color * (1.0 - color)).to(cd)
        acc_dw(l_last, act, gz)
        gc = gmm_t(gz, w[l_last])
        for back in range(packed.n_extra_color - 1, -1, -1):
            mask_src = extra_inputs[back + 1] if back + 1 < len(extra_inputs) else act
            gc = relu_mask(gc, mask_src)
            acc_dw(l_c0 + 1 + back, extra_inputs[back], gc)
            gc = gmm_t(gc, w[l_c0 + 1 + back])
        gc = relu_mask(gc, extra_inputs[0] if packed.n_extra_color > 0 else act)
        acc_dw(l_c0, torch.cat([inter, demb], dim=-1), gc)
        g_inter = gmm_t(gc, w[l_c0][:h])
        acc_dw(l_int, features, g_inter)
        acc_dw(l_den, features, g_density)
        g_back = gmm_t(g_inter, w[l_int]) + gmm_t(g_density, w[l_den])
        for li in range(nl - 1, -1, -1):
            g_back = relu_mask(g_back, outputs[li])
            acc_dw(li, inputs[li], g_back)
            if li > 0:
                g_back = gmm_t(g_back, w[li])[:, : outputs[li - 1].shape[-1]]

    grad_flat = torch.zeros(packed.flat.shape, dtype=torch.float32, device=points.device)
    grad_biases = torch.zeros(packed.biases_flat.shape, dtype=torch.float32, device=points.device)
    gw, gb = grad_views(packed, grad_flat, grad_biases)
    for view, dw in zip(gw, dws):
        view.copy_(dw)
    for view, db in zip(gb, dbs):
        view.copy_(db)
    return grad_flat, grad_biases


def stash_widths(n_layers: int, n_extra_color: int = 0) -> Tuple[int, int]:
    """Per-point widths (bf16 elements) of the kernel's activation and cotangent stashes.

    Activations: xyz embedding (64) | the xyz layers' outputs (256 each) |
    intermediate (256) | direction embedding (32) and the heads' cotangents
    (density, then the color head's C), one block of 64 | the color layers'
    outputs (128 each). Cotangents of the layer outputs: xyz layers (256
    each) | intermediate (256) | color layers (128 each). Both are multiples
    of 64: the stashes are column-blocked, ``(width // 64, n_points, 64)``,
    so that a box of 64 points x 64 columns is contiguous. Must match
    ``csrc/nerf_mlp_bwd.cu``.
    """
    return 64 + 256 * (n_layers + 1) + 64 + 128 * (n_extra_color + 1), 256 * (n_layers + 1) + 128 * (n_extra_color + 1)


def _stash_inputs(packed: PackedNerfMlp) -> List[Tuple[List[Tuple[int, int]], int, int, int, int, int]]:
    """Per tensor in kernel order: its input rows as activation-stash segments ``(column, rows)``,
    then its cotangent's (stash, block column, product width, column shift, gradient width);
    stash 0 is the cotangent stash, 1 the activation stash (the heads' block)."""
    nl, ne, h, hd = packed.n_layers, packed.n_extra_color, packed.hidden, packed.hidden_dir
    a_y = [64 + h * li for li in range(nl + 1)]  # the last one is the intermediate
    a_demb = a_y[nl] + h  # the dir embedding, then the heads at column 32 of the block
    a_cact = [a_demb + 64 + hd * e for e in range(ne + 1)]
    g_inter = h * nl
    g_c = [g_inter + h + hd * e for e in range(ne + 1)]
    out = []
    for li in range(nl):
        segs = [(0, packed.k_xyz)] if li == 0 else [(a_y[li - 1], h)]
        if li > 0 and li in packed.input_skips:
            segs.append((0, packed.k_xyz))
        out.append((segs, 0, h * li, 256, 0, h))
    out.append(([(a_y[nl - 1], h)], 0, g_inter, 256, 0, h))  # intermediate
    out.append(([(a_y[nl - 1], h)], 1, a_demb, 64, 32, 1))  # density
    out.append(([(a_y[nl], h), (a_demb, packed.k_dir)], 0, g_c[0], 128, 0, hd))  # first color layer
    for e in range(ne):
        out.append(([(a_cact[e], hd)], 0, g_c[e + 1], 128, 0, hd))
    out.append(([(a_cact[ne], hd)], 1, a_demb, 64, 33, packed.color_dim))  # color head
    return out


def weight_grad_jobs(packed: PackedNerfMlp) -> List[Tuple[int, ...]]:
    """The plan of the weight-gradient pass, one tuple per job (per slice of the points):

    ``(tensor, row0, a_col0, rows0, a_col1, rows1, g_stash, g_col, n_mma, shift, n_out, bias)``:
    rows ``row0 ..`` of the tensor's dW, ``rows0`` of them from the
    activation stash at column ``a_col0`` (the first consumer warp group)
    and ``rows1`` from ``a_col1`` (the second, from ``row0 + 64``), times the
    columns ``g_col .. + n_mma`` of stash ``g_stash`` (0: cotangents, 1:
    activations), of which columns ``shift .. + n_out`` are the gradient's;
    with ``bias``, the job also sums those columns into db. A tensor's jobs
    are adjacent.
    """
    jobs = []
    for i, (segs, g_stash, g_col, n_mma, shift, n_out) in enumerate(_stash_inputs(packed)):
        blocks = [(col + r, min(64, rows - r)) for col, rows in segs for r in range(0, rows, 64)]
        for rb in range(0, len(blocks), 2):
            (a0, r0), (a1, r1) = blocks[rb], blocks[rb + 1] if rb + 1 < len(blocks) else (0, 0)
            jobs.append((i, 64 * rb, a0, r0, a1, r1, g_stash, g_col, n_mma, shift, n_out, int(rb == 0)))
    return jobs


def _check_bwd_inputs(packed: PackedNerfMlp, points, dirs, pts_per_ray: int, g: torch.Tensor) -> None:
    _check_cuda_inputs(packed, points, dirs, pts_per_ray)  # the maxima of K1 are K3's
    if (
        g.dtype != torch.float32
        or tuple(g.shape) != (points.shape[0], 1 + packed.color_dim)
        or not g.is_contiguous()
        or g.device != points.device
    ):
        raise ValueError(f"g must be a contiguous float32 ({points.shape[0]}, {1 + packed.color_dim}) tensor on {points.device}")


def nerf_mlp_bwd(
    packed: PackedNerfMlp, points: torch.Tensor, dirs: torch.Tensor, pts_per_ray: int, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight and bias gradients of the fused forward; see :func:`nerf_mlp_bwd_plain`.

    CPU tensors go through the plain version; CUDA tensors launch the kernel
    or raise.
    """
    if points.device.type == "cpu":
        return nerf_mlp_bwd_plain(packed, points, dirs, pts_per_ray, g)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    _check_bwd_inputs(packed, points, dirs, pts_per_ray, g)
    n = points.shape[0]
    lda, ldg = stash_widths(packed.n_layers, packed.n_extra_color)
    device = points.device
    jobs = weight_grad_jobs(packed)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_split = max(1, min(-(-n // STEP), sms // len(jobs)))
    w_total, b_total = packed.flat.numel(), packed.biases_flat.numel()
    stash_a = torch.empty((lda // 64, n, 64), dtype=torch.bfloat16, device=device)
    stash_g = torch.empty((ldg // 64, n, 64), dtype=torch.bfloat16, device=device)
    partials = torch.zeros((n_split, w_total + b_total), dtype=torch.float32, device=device)
    out = torch.zeros(w_total + b_total, dtype=torch.float32, device=device)
    w_off, b_off, w_rows = packed.launch_tables
    plan = (ctypes.c_longlong * (len(jobs) * len(jobs[0])))(*(f for job in jobs for f in job))
    skip_mask = sum(1 << s for s in packed.input_skips if 0 < s < packed.n_layers)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = LIBRARY.library().nerf_mlp_bwd_bf16(
            points.data_ptr(), dirs.data_ptr(), g.data_ptr(),
            packed.flat.data_ptr(), packed.biases_flat.data_ptr(),
            ctypes.addressof(w_off), ctypes.addressof(b_off), ctypes.addressof(w_rows),
            stash_a.data_ptr(), stash_g.data_ptr(),
            partials.data_ptr(), out.data_ptr(), ctypes.addressof(plan),
            len(packed.w_offsets), n, pts_per_ray, packed.n_layers, skip_mask,
            packed.n_freq_xyz, int(packed.append_xyz), packed.n_freq_dir, int(packed.append_dir),
            packed.n_extra_color, packed.color_dim, lda, ldg, w_total, b_total, n_split, len(jobs), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nerf_mlp_bwd kernel launch failed with CUDA error {rc}")
    launch_count.count(sys.modules[__name__], "launches")
    return out[:w_total], out[w_total:]


def layer_check(a: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(bf16(a @ w), bf16(that @ w^T))`` through the first pass's ring, wgmma descriptors, epilogues
    and TMA stores, for ``a`` (128, 256) and ``w`` (256, 256) bf16 on the card."""
    if a.shape != (128, 256) or w.shape != (256, 256) or a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("layer_check takes a (128, 256) and w (256, 256) bfloat16")
    if a.device.type != "cuda" or w.device != a.device or not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("layer_check takes contiguous CUDA tensors")
    y, z = (torch.empty((4, 128, 64), dtype=a.dtype, device=a.device) for _ in range(2))  # column-blocked
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = LIBRARY.library().nerf_mlp_bwd_layer_check(a.data_ptr(), w.data_ptr(), y.data_ptr(), z.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nerf_mlp_bwd_layer_check failed with CUDA error {rc}")
    return y.permute(1, 0, 2).reshape(128, 256), z.permute(1, 0, 2).reshape(128, 256)


def flops_per_point(packed: PackedNerfMlp) -> int:
    """Operations (2 per multiply-add) per point of K3, counted at the model's own widths.

    The recomputed forward, the weight-gradient products (the same shapes),
    and the input-gradient products ``g @ W^T``: none for layer 0, the whole
    skip weight (as K3 computes it before slicing), and only the hidden rows
    of the first color layer.
    """
    h, hd = packed.hidden, packed.hidden_dir
    kx = 3 * (2 * packed.n_freq_xyz + int(packed.append_xyz))
    kd = 3 * (2 * packed.n_freq_dir + int(packed.append_dir))
    n_skips = len([s for s in packed.input_skips if 0 < s < packed.n_layers])
    fwd = (
        kx * h
        + (packed.n_layers - 1) * h * h
        + n_skips * kx * h
        + h * (h + 1)
        + (h + kd) * hd
        + packed.n_extra_color * hd * hd
        + hd * packed.color_dim
    )
    input_grads = fwd - kx * h - kd * hd
    return 2 * (2 * fwd + input_grads)


def io_bytes(packed: PackedNerfMlp, n_points: int, n_rays: int) -> int:
    """Bytes K3 must move at the least: points, directions and cotangents in, weights in, gradients out."""
    weights = packed.flat.numel() * packed.flat.element_size() + packed.biases_flat.numel() * 4
    grads = (packed.flat.numel() + packed.biases_flat.numel()) * 4
    return n_points * 3 * 4 + n_rays * 3 * 4 + n_points * (1 + packed.color_dim) * 4 + weights + grads
