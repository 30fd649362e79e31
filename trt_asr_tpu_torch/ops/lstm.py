"""Multi-layer LSTM step with torch-compatible semantics: gate order
(i, f, g, o), separate input/hidden biases, weights stored [in, 4*hidden]."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from trt_asr_tpu_torch.ops.common import matmul


def lstm_cell(p: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, In], h/c [B, P] -> (h', c')."""
    gates = matmul(x, p["wi"]) + matmul(h, p["wh"]) + p["bi"] + p["bh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One time step through all layers. x [B, In]; h, c [layers, B, P].
    Returns (top-layer output [B, P], h', c')."""
    hs, cs = [], []
    inp = x
    for li, p in enumerate(layers):
        h_new, c_new = lstm_cell(p, inp, h[li], c[li])
        hs.append(h_new)
        cs.append(c_new)
        inp = h_new
    return inp, torch.stack(hs), torch.stack(cs)
