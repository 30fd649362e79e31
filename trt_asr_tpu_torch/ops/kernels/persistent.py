"""What the launch plans and weight packers of the persistent kernels
(``csrc/persistent.cuh``: one cooperative launch, one block an SM, each
block owning a slice of every product) share: their constants, a block's
column slices, the SM count of the card, and the int8 weight layout of the
tensor-core products.
"""

from __future__ import annotations

import functools

import torch

from trt_asr_tpu_torch.ops.quant import QuantTensor

TAIL_WARPS = 16              # csrc/persistent.cuh TL_WARPS
TAIL_ROWS = 8                # rows of a product pass (TL_MR)
TAIL_GROUP = 8               # columns of a weight group (TL_GW)
TAIL_KSTEP = 16              # K of an mma step (TL_KS)
SMEM_PER_BLOCK = 232_448     # the H100's opt-in shared memory a block


def align16(n: int) -> int:
    return (n + 15) // 16 * 16


def pad_k(k: int) -> int:
    return -(-k // TAIL_KSTEP) * TAIL_KSTEP


def column_slices(d: int, sms: int) -> tuple[int, int]:
    """(columns a block, blocks) of a persistent int8 kernel: the fewest
    8-column groups a block that cover D with at most ``sms`` blocks, one
    an SM."""
    cols = TAIL_GROUP * -(-(d // TAIL_GROUP) // sms)
    return cols, -(-d // cols)


def weight_kind(what: str, *ws) -> str:
    """``int8``, ``f32`` or ``bf16``: the storage type the weights ``ws`` of
    a persistent kernel share (ValueError naming ``what`` otherwise)."""
    kinds = {"int8" if isinstance(w, QuantTensor) else
             {torch.float32: "f32", torch.bfloat16: "bf16"}.get(w.dtype, str(w.dtype))
             for w in ws}
    if len(kinds) != 1 or not kinds <= {"int8", "f32", "bf16"}:
        raise ValueError(f"{what} must share one storage type (f32, bf16 or int8)")
    return kinds.pop()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pack_tail_weight(q: torch.Tensor, cols: int, blocks: int, glu: bool = False):
    """The int8 matrix q [K, N] as the fused tail's blocks read it: block b's
    ``cols`` columns b * cols .. contiguous, 8 columns a group, each group
    as [Kp / 16][8 columns][16 rows] (the mma's B operand, a column's 16
    rows of a step adjacent; K padded to Kp, a multiple of 16, and columns
    past N with zeros): [blocks, cols / 8, Kp / 16, 8, 16]. With ``glu``
    (pw1, N = 2D) each block's groups of columns n in [0, D) come first,
    then those of their gates n + D: [blocks, 2 cols / 8, Kp / 16, 8, 16]."""
    k, n = q.shape
    kp, g = pad_k(k), TAIL_GROUP
    halves = (q[:, : n // 2], q[:, n // 2:]) if glu else (q,)
    packed = []
    for w in halves:
        p = w.new_zeros((kp, blocks * cols))
        p[:k, : w.shape[1]] = w
        packed.append(p.view(kp // TAIL_KSTEP, TAIL_KSTEP, blocks, cols // g, g)
                      .permute(2, 3, 0, 4, 1))
    return torch.cat(packed, dim=1).contiguous()


def pack_columns(v: torch.Tensor, cols: int, blocks: int) -> torch.Tensor:
    """[rows, N] f32 (or [N]) -> [blocks, rows * cols]: block b's columns
    b * cols .. of each row, zero past N."""
    v = v.reshape(-1, v.shape[-1]).float()
    p = v.new_zeros((v.shape[0], blocks * cols))
    p[:, : v.shape[1]] = v
    return p.view(v.shape[0], blocks, cols).permute(1, 0, 2).reshape(blocks, -1)
