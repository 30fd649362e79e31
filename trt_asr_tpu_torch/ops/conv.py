"""Convolution primitives: depthwise 1-D (conformer conv module) and the
dw_striding 2-D subsampling stack.

Public functions keep the JAX package's channels-last layouts (NWC / NHWC
activations, WIO / HWIO weights); the switch to PyTorch's channels-first
convolutions happens inside each function.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from trt_asr_tpu_torch.ops.common import matmul

Padding = Union[str, Sequence[Tuple[int, int]]]


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """x [B, T, D], w [K, D] -> VALID depthwise conv, [B, T-K+1, D]."""
    k, d = w.shape
    out = F.conv1d(x.transpose(1, 2), w.t().unsqueeze(1).to(x.dtype), groups=d)
    out = out.transpose(1, 2)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _explicit_padding(padding: Padding, h_in: int, w_in: int, kh: int, kw: int,
                      stride: Tuple[int, int]):
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        sh, sw = stride
        out_h, out_w = -(-h_in // sh), -(-w_in // sw)
        pad_h = max((out_h - 1) * sh + kh - h_in, 0)
        pad_w = max((out_w - 1) * sw + kw - w_in, 0)
        return (pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2)
    (ph0, ph1), (pw0, pw1) = padding
    return (ph0, ph1), (pw0, pw1)


def _conv2d_nchw(x: torch.Tensor, w_hwio: torch.Tensor, bias, stride, padding,
                 groups: int) -> torch.Tensor:
    """x [B, C, H, W] with an HWIO weight -> [B, Cout, H', W']."""
    kh, kw = w_hwio.shape[:2]
    (ph0, ph1), (pw0, pw1) = _explicit_padding(padding, x.shape[2], x.shape[3],
                                               kh, kw, stride)
    x = F.pad(x, (pw0, pw1, ph0, ph1))
    out = F.conv2d(x, w_hwio.permute(3, 2, 0, 1).to(x.dtype), stride=stride,
                   groups=groups)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None]
    return out


def conv2d(x: torch.Tensor, w: torch.Tensor, bias=None,
           stride: Tuple[int, int] = (1, 1), padding: Padding = "SAME",
           groups: int = 1) -> torch.Tensor:
    """x [B, H, W, Cin], w [kh, kw, Cin/groups, Cout] -> [B, H', W', Cout]."""
    out = _conv2d_nchw(x.permute(0, 3, 1, 2), w, bias, stride, padding, groups)
    return out.permute(0, 2, 3, 1)


def subsampled_length(length, stages: int):
    """Length transform of the dw_striding stack: per stage k=3, s=2, pad=1
    => floor((n - 1)/2) + 1, applied `stages` times. Works on ints and on
    integer tensors."""
    for _ in range(stages):
        length = (length - 1) // 2 + 1
    return length


def dw_striding_subsample(params: Dict, x: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fast Conformer dw_striding pre-encode, x [B, T, F] -> [B, T/8, d_model].

    Conv2d(1->C, 3x3, s2, p1) + ReLU, then (stride_stages-1) x
    [depthwise Conv2d(C, 3x3, s2, p1, groups=C); pointwise Conv2d(C->C, 1x1);
    ReLU], then Linear(C * ceil(F/8) -> d_model). ``lengths`` [B]
    (optional) zeroes the padded tail before stage 1 and after every stage.
    """
    b, t, _ = x.shape
    pad = [(1, 1), (1, 1)]

    def mask_tail(h, lens):
        keep = torch.arange(h.shape[2], device=h.device)[None, :] < lens[:, None]
        return torch.where(keep[:, None, :, None], h, torch.zeros((), dtype=h.dtype,
                                                                  device=h.device))

    h = x[:, None]                                            # [B, 1, T, F]
    if lengths is not None:
        h = mask_tail(h, lengths)
    h = torch.relu(_conv2d_nchw(h, params["conv_in"]["w"], params["conv_in"].get("b"),
                                (2, 2), pad, 1))
    if lengths is not None:
        lengths = (lengths - 1) // 2 + 1
        h = mask_tail(h, lengths)
    for st in params["stages"]:
        c = st["dw_w"].shape[-1]
        h = _conv2d_nchw(h, st["dw_w"], st.get("dw_b"), (2, 2), pad, c)
        h = torch.relu(_conv2d_nchw(h, st["pw_w"], st.get("pw_b"), (1, 1), "VALID", 1))
        if lengths is not None:
            lengths = (lengths - 1) // 2 + 1
            h = mask_tail(h, lengths)
    bsz, c_out, t_out, f_out = h.shape
    # torch flattening order: [B, T, C, F] then flatten (C, F)
    h = h.permute(0, 2, 1, 3).reshape(bsz, t_out, c_out * f_out)
    out = matmul(h, params["out"]["w"])
    if params["out"].get("b") is not None:
        out = out + params["out"]["b"].to(out.dtype)
    return out
