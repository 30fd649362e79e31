"""Multi-layer LSTM with torch-compatible semantics: gate order (i, f, g,
o), separate input/hidden biases, weights stored [in, 4*hidden]. One step
(the decode's) and a sequence (training's: a loop over the step)."""

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


def lstm_sequence(layers: List[Dict[str, torch.Tensor]], xs: torch.Tensor,
                  h: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xs [B, U, In] -> (outputs [B, U, P], h', c'): :func:`lstm_step` over
    U, the JAX package's ``lax.scan``."""
    outs = []
    for u in range(xs.shape[1]):
        out, h, c = lstm_step(layers, xs[:, u], h, c)
        outs.append(out)
    if not outs:
        return xs.new_zeros((xs.shape[0], 0, h.shape[-1])), h, c
    return torch.stack(outs, dim=1), h, c
