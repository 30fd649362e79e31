"""Device mesh and sharding rules, as the JAX package's ``parallel/mesh.py``
names them, over torch devices.

Mesh axes: ``dp`` (data parallel: the batch of streams or utterances) and
``tp`` (tensor parallel: attention heads, FFN hidden, predictor and joint
hidden). The spec table (:func:`_tp_spec_for`) and the drop of axes that do
not divide a leaf (:func:`param_shardings`) are the same functions of a
leaf's path and shape as JAX's.

The port runs on one card. A mesh of one device places every tree on that
device, so an engine or a batch given such a mesh runs exactly as with
``mesh=None``. A mesh of more than one device can be described (its specs
computed) but not placed: :meth:`Mesh.device`, and so :func:`shard_params`
and :func:`shard_batch`, raise ``NotImplementedError`` for it (ROADMAP Queue 1 item 10:
real dp/tp across cards waits for a machine and a cell with more than one
card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.ops.quant import QuantTensor

MULTI_DEVICE = ("a mesh of {n} devices is not supported: the port runs on one card "
                "(ROADMAP Queue 1 item 10)")


class PartitionSpec(tuple):
    """Per-axis mesh-axis names of one array (None: replicated), as JAX's."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


@dataclass(frozen=True)
class Mesh:
    """``devices``: an object array [dp, tp] of torch devices."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("dp", "tp")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self) -> torch.device:
        """The one device a tree is placed on; raises for a larger mesh."""
        if self.size != 1:
            raise NotImplementedError(MULTI_DEVICE.format(n=self.size))
        return self.devices.flat[0]


@dataclass(frozen=True)
class NamedSharding:
    mesh: Mesh
    spec: PartitionSpec


def _canonical(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def same_device(a, b) -> bool:
    return _canonical(a) == _canonical(b)


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A [dp, tp] mesh over ``devices`` (default: every CUDA device; without
    one, pass ``devices=[torch.device("cpu")]``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')]")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    if dp is None:
        dp = n // tp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != devices({n})"
    arr = np.empty(n, dtype=object)
    arr[:] = [_canonical(d) for d in devices]
    return Mesh(arr.reshape(dp, tp))


def _tp_spec_for(path: str, ndim: int) -> P:
    """Partition spec for one stacked-layer parameter. Layer-stacked arrays
    lead with [L]; the matmul's contraction-free axis is sharded over tp."""
    # encoder stacked layers [L, ...]
    if path.endswith(("att_wq", "att_wk", "att_wv", "att_wpos")):
        return P(None, None, "tp")      # [L, D, D] -> heads/columns sharded
    if path.endswith("att_wo"):
        return P(None, "tp", None)      # [L, D, D] -> rows sharded (psum after)
    if path.endswith(("att_bias_u", "att_bias_v")):
        return P(None, "tp", None)      # [L, H, dh]
    if path.endswith(("ff1_w1", "ff2_w1")):
        return P(None, None, "tp")      # [L, D, E]
    if path.endswith(("ff1_w2", "ff2_w2")):
        return P(None, "tp", None)      # [L, E, D]
    if path.endswith("conv_pw1"):
        return P(None, None, "tp")      # [L, D, 2D]
    if path.endswith("conv_pw2"):
        return P(None, "tp", None)
    # predictor / joint
    if path.endswith(("lstm/wi", "lstm/wh")) or "/lstm/" in path and path.endswith(("wi", "wh")):
        return P(None, "tp")            # [P, 4P] column sharded
    if path.endswith(("joint/enc/w", "joint/pred/w")):
        return P(None, "tp")
    if path.endswith("joint/out/w"):
        return P("tp", None)
    if path.endswith("pre_encode/out/w"):
        return P(None, "tp") if ndim == 2 else P()
    return P()  # replicate everything else (norms, biases, convs, embed)


def _leaf_shape(node) -> tuple:
    return tuple((node.q if isinstance(node, QuantTensor) else node).shape)


def param_shardings(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """NamedSharding tree matching the parameter tree (an int8 leaf takes
    the spec of its int8 values)."""
    sizes = mesh.shape

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}" if path else k, v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, QuantTensor):
            return [walk(f"{path}/{i}", v) for i, v in enumerate(node)]
        shape = _leaf_shape(node)
        spec = _tp_spec_for(path, len(shape))
        # drop specs that don't divide evenly (tiny test configs)
        fixed = [None if ax is not None and shape[dim] % sizes[ax] != 0 else ax
                 for dim, ax in enumerate(spec)]
        return NamedSharding(mesh, P(*fixed))

    return walk("", params)


def _to(x, device):
    """``x`` on ``device``; a leaf already there is returned as it is (an
    int8 leaf keeps the bf16 copy the model attached to it)."""
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(x), device=device)
    if same_device((x.q if isinstance(x, QuantTensor) else x).device, device):
        return x
    if isinstance(x, QuantTensor):
        return QuantTensor(x.q.to(device), x.s.to(device))
    return x.to(device)


def _map(fn, tree, sh=None):
    """Apply ``fn(leaf, sharding)`` over a tree of dicts, lists and named
    tuples (``sh`` a tree of the same structure, or one sharding)."""
    pick = (lambda s, k: s[k]) if isinstance(sh, (dict, list, tuple)) else (lambda s, k: s)
    if isinstance(tree, dict):
        return {k: _map(fn, v, pick(sh, k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") and not isinstance(tree, QuantTensor):
        return type(tree)(*(_map(fn, v, pick(sh, i)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, QuantTensor):
        return [_map(fn, v, pick(sh, i)) for i, v in enumerate(tree)]
    return fn(tree, sh)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The tree placed by :func:`param_shardings`: on a one-device mesh,
    that device (a leaf already there is kept as it is)."""
    return _map(lambda x, s: _to(x, s.mesh.device()), params, param_shardings(params, mesh))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading batch axis over dp; replicate the rest."""
    return NamedSharding(mesh, P(*(["dp"] + [None] * (ndim - 1))))


def shard_batch(tree, mesh: Mesh):
    return _map(lambda x, _: _to(x, mesh.device()), tree)


def encoder_state_shardings(mesh: Mesh):
    """EncoderState arrays are [L, B, ...] (batch axis 1); cache_len [B]."""
    from trt_asr_tpu_torch.models.parakeet.encoder import EncoderState

    ns = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return EncoderState(
        att_cache=ns(None, "dp", None, None),
        time_cache=ns(None, "dp", None, None),
        kv_cache=ns(None, "dp", None, None),
        cache_len=ns("dp"),
        cursor=ns("dp"),
    )


def decode_state_shardings(mesh: Mesh):
    """DecodeState: g [B, P]; h/c [R, B, P]; y_id/time_carry [B]."""
    from trt_asr_tpu_torch.decode.tdt_greedy import DecodeState

    ns = lambda *spec: NamedSharding(mesh, P(*spec))  # noqa: E731
    return DecodeState(
        g=ns("dp", None), h=ns(None, "dp", None), c=ns(None, "dp", None),
        y_id=ns("dp"), time_carry=ns("dp"),
    )
