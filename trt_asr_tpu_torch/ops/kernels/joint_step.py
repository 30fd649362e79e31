"""Fused TDT joint decode step: the CUDA kernel ``csrc/joint_step.cu`` and
its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/joint_step_kernel.py:
joint_step_pallas_prepadded`` (the TPU's lane padding is not needed: only
the real V columns are computed). The bound on the H100 is memory: one read
of W_out [640, 8198] (21 MB f32, 5.2 MB int8) per call, for all rows.
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.quant import is_low_precision, round_bf16, scaled_matmul


def joint_step_plain(e, g, wp, bp, wo, bo, *, ths: int, ndur: int,
                     blank_id: int, blank_penalty: float = 0.0):
    """The kernel's function in plain PyTorch, with its rounding points.
    e [rows, J] f32 (encoder projection incl. bias), g [rows, P] f32;
    wp [P, J], wo [J, V] float or QuantTensor; bp [J], bo [V].
    Returns (tok [rows] int32, dur_idx [rows] int32 relative to ths,
    logits [rows, V] f32 before the blank penalty)."""
    rnd = round_bf16 if is_low_precision(wo) else (lambda t: t)
    h = e + scaled_matmul(rnd(g), wp) + bp
    h = rnd(torch.relu(h))
    logits = scaled_matmul(h, wo) + bo
    tok_logits = logits[:, :ths]
    if blank_penalty:
        tok_logits = tok_logits.clone()
        tok_logits[:, blank_id] -= blank_penalty
    tok = torch.argmax(tok_logits, dim=1).to(torch.int32)
    dur = torch.argmax(logits[:, ths:ths + ndur], dim=1).to(torch.int32)
    return tok, dur, logits


def joint_step(e, g, wp, bp, wo, bo, *, ths: int, ndur: int, blank_id: int,
               blank_penalty: float = 0.0):
    """Fused joint step; same arguments and results as
    :func:`joint_step_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if e.device.type == "cpu":
        return joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur,
                                blank_id=blank_id, blank_penalty=blank_penalty)
    rows, j = e.shape
    p = g.shape[1]
    wp_t, sp, wtype = kb.weight_parts(wp)
    wo_t, so, wtype_o = kb.weight_parts(wo)
    if wtype != wtype_o:
        raise ValueError("joint_step: pred and out weights must share one storage type")
    v = wo_t.shape[1]
    if wp_t.shape != (p, j) or wo_t.shape[0] != j or g.shape[0] != rows:
        raise ValueError("joint_step: shape mismatch")
    if any(t.dtype != torch.float32 for t in (e, g, bp, bo)):
        raise TypeError("joint_step: e, g and biases must be f32")
    kb.require_cuda("joint_step", e, g, bp, bo, wp_t, wo_t,
                    *[s for s in (sp, so) if s is not None])
    lib = kb.load("joint_step")
    dev = e.device
    ntiles = (v + 31) // 32
    h = torch.empty((rows, j), dtype=torch.float32, device=dev)
    logits = torch.empty((rows, v), dtype=torch.float32, device=dev)
    tv = torch.empty((rows, ntiles), dtype=torch.float32, device=dev)
    dv = torch.empty_like(tv)
    ti = torch.empty((rows, ntiles), dtype=torch.int32, device=dev)
    di = torch.empty_like(ti)
    ks_pred, ks_out = kb.gemm_splits(p), kb.gemm_splits(j)
    part = torch.empty((max(ks_pred * j, ks_out * v) * rows,), dtype=torch.float32, device=dev)
    tok = torch.empty((rows,), dtype=torch.int32, device=dev)
    dur = torch.empty_like(tok)
    rc = lib.joint_step_launch(
        e.data_ptr(), g.data_ptr(), rows, p, j, v, wp_t.data_ptr(), kb.ptr(sp),
        bp.data_ptr(), wo_t.data_ptr(), kb.ptr(so), bo.data_ptr(), wtype,
        ths, ndur, blank_id, float(blank_penalty), ks_pred, ks_out, h.data_ptr(),
        logits.data_ptr(), part.data_ptr(), tv.data_ptr(), ti.data_ptr(), dv.data_ptr(),
        di.data_ptr(), tok.data_ptr(), dur.data_ptr(), kb.stream_ptr(dev))
    kb.check(lib, rc, "joint_step")
    joint_step.launches += 1
    return tok, dur, logits


joint_step.launches = 0
