"""The PyTorch port's hand-written CUDA kernels against their plain PyTorch
versions on a CUDA device: the fused attention block, the fused joint step,
the fused log-mel, the fused FFN, the fused conv module and the fused conv
+ FFN2 + out-LN tail, with f32, bf16 and int8 weights where the kernel
takes them; the offline rel-shift and flash-attention kernels in f32 and
bf16; the bf16 x bf16 route of ``ops.common.matmul``; the wrappers
raise, and do not fall back, on inputs the kernels do
not take; the gate_r3 streaming session and offline transcription with the
kernels on, and two clients of the serving daemon with the joint kernel,
against the same runs on the CPU.

Every test here needs the card and skips without one. This file imports
nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerances: attention block, FFN and conv module 1e-4 (f32) and 2e-3 (bf16
operands: an f32 value that differs in its last bit can round to a
neighbouring bf16 value);
joint logits 1e-4 with tokens and durations exact; log-mel 1e-3 absolute
(log of sums that reach ~1e4, summed in another order); rel shift 1e-5 (f32)
and, in bf16 (tensor-core sums), one bf16 ulp of the plain version floored
near zero at twice the f32 sums' own error, at most 1e-4 of the values past
one ulp, and at most 5e-5 of the values differing from the plain version
fed tensor-core sums; flash
attention atol 2e-5 / rtol 1e-4 (f32) and, in bf16, 1.5e-3 against the
plain version (its f32-einsum sums of q . k round otherwise than the
tensor cores', and one f32 ulp of a score can flip p's bf16 rounding at a
key: 7.8e-4 read on the H100 at the offline shapes, against 2.5e-3 for
the plain version with p unrounded) and 1e-4 against the plain version fed
the tensor cores' sums (it rounds p at the same keys; the plain version
with p unrounded lies farther); ``ops.common.matmul`` of bf16 by bf16 (the
tensor cores) one bf16 ulp of the f32 product, the ulp floored near zero at
twice the f32 product's own error; session and transcript tokens exact."""

import ctypes
import math

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, require_cuda, synth_audio, tensor_core_qk

from trt_asr_tpu_torch.config import RuntimeConfig
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state, prime_decode_state
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels.att_block import att_block, att_block_plain, pack_att_block
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_chain,
                                                      conv_block_plain, conv_ffn_ln,
                                                      conv_ffn_ln_plain, pack_conv_block,
                                                      pack_conv_ffn_ln)
from trt_asr_tpu_torch.ops.kernels.ffn import (fused_ffn, fused_ffn_chain, fused_ffn_plain,
                                               pack_ffn)
from trt_asr_tpu_torch.ops.kernels.flash_att import (copy_widths, flash_bias_attention,
                                                     flash_bias_attention_plain)
from trt_asr_tpu_torch.ops.kernels.joint_step import (joint_step, joint_step_chain,
                                                      joint_step_plain, pack_joint_step)
from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain, pack_logmel_basis
from trt_asr_tpu_torch.ops.kernels.rel_shift import (rel_pos_bias_shifted,
                                                     rel_pos_bias_shifted_plain, rel_shift)
from trt_asr_tpu_torch.ops import quant
from trt_asr_tpu_torch.ops.quant import QuantTensor, quantize_tensor
from trt_asr_tpu_torch.streaming.session import StreamingSession

WEIGHTS = ["f32", "bf16", "int8"]


def as_weight(w: torch.Tensor, kind: str):
    if kind == "int8":
        return quantize_tensor(w)
    return w.to(torch.bfloat16) if kind == "bf16" else w


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of the CUDA driver API."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def graph_port_kernels(graph) -> list:
    """The port's kernels in a captured CUDA graph (``keep_graph=True``):
    the (mangled) function name of each kernel node in namespace ``port``,
    read through the CUDA driver API. No CUPTI: torch.profiler traces of
    one call came back empty after the first one or two traces of a process
    on the H100 (CUPTI torn down after each trace or not)."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        assert rc == 0, f"{what}: CUresult {rc}"

    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:                       # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        prm, name = _KernelNodeParams(), ctypes.c_char_p()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(prm)),
              "cuGraphKernelNodeGetParams")
        if prm.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(prm.func)), "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(prm.kern)),
                  "cuKernelGetName")
        names.append(name.value.decode())
    return [k for k in names if k.startswith("_ZN4port")]


def assert_one_graph_replayable_launch(call, kernel: str) -> None:
    """``call()`` is one launch of the port's kernel ``kernel`` and of no
    other of the port's kernels, read from a CUDA graph that captures it;
    each of two replays equals the direct call bit for bit (over outputs
    filled with NaN, or -1 for integers, first)."""
    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    want = as_tuple(call())
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = as_tuple(call())
    kernels = graph_port_kernels(graph)
    assert len(kernels) == 1 and kernel in kernels[0], kernels
    graph.instantiate()
    for _ in range(2):
        for o in out:
            o.fill_(float("nan") if o.is_floating_point() else -1)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(out, want))


# (D, H, C, Tq) of the attention block: the card-test width, gate_r3 and Tq
# 13; with int8 or f32 weights also the full width (bf16's is held at
# 1/sqrt(D) weights in test_att_block_takes_bf16_biases_and_cache: at this
# test's 2.4/sqrt(D) one rounding flip moves the full-width y past 2e-3)
PERSISTENT_ATT_SHAPES = [(64, 4, 32, 8), (64, 4, 64, 8), (64, 4, 32, 13), (1024, 8, 256, 8),
                         (1024, 8, 256, 13)]
ATT_SHAPES = {"f32": PERSISTENT_ATT_SHAPES, "bf16": PERSISTENT_ATT_SHAPES[:3],
              "int8": PERSISTENT_ATT_SHAPES}


def att_inputs(dev, seed, d, h, c, tq, kind, wsc=None):
    """``wsc``: the weights' scale (by default min(0.3, 2.4 / sqrt(D)))."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    x, ln_g, ln_b = r(tq, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1)
    wsc = min(0.3, 2.4 / math.sqrt(d)) if wsc is None else wsc
    ws = [as_weight(r(d, d, sc=wsc), kind) for _ in range(4)]
    return (x, ln_g, ln_b, *ws, r(h, d // h), r(h, d // h), r(2 * tq + c - 1, d), r(c, 2 * d))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_att_block_kernel_matches_plain(kind):
    """Each weight type (one cooperative launch a call) at the card-test
    width, gate_r3's and Tq 13; int8 and f32 also at the full width; with a
    partly filled ring, an empty one, the cursor at the ring's wrap and
    valid_tq below Tq. The weights packed once beforehand (``packed``, as
    the model passes them) give the same bits as those packed by the
    call."""
    dev = require_cuda()
    for i, (d, h, c, tq) in enumerate(ATT_SHAPES[kind]):
        args = att_inputs(dev, 5 + i, d, h, c, tq, kind)
        packed = pack_att_block(*args[3:7])
        for cursor, cache_len, valid_tq in [(7, 19, 6), (0, 0, 6), (5, c, min(tq, 8)),
                                            (c - 1, c, 1), (c - 3, c // 2, tq - 2)]:
            meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32, device=dev)
            before = att_block.launches
            got = att_block(*args, meta, n_heads=h)
            assert att_block.launches == before + 1
            want = att_block_plain(*args, meta, n_heads=h)
            again = att_block(*args, meta, n_heads=h, packed=packed)
            torch.cuda.synchronize()
            atol = 1e-4 if kind == "f32" else 2e-3
            for g, w, a in zip(got, want, again):
                torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)
                assert torch.equal(a, g)
        assert math.isfinite(float(got[0].sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("d,h,c,tq", [(64, 4, 32, 8), (1024, 8, 256, 8)])
def test_att_block_takes_bf16_biases_and_cache(kind, cache, d, h, c, tq):
    """The weights of ``cast_params_for_compute`` (bf16 biases; with
    ``kind`` int8, quantized after the cast: the fast arm) over an f32 or a
    bf16 kv cache (a bf16 encoder state): the bf16 kernel
    (``csrc/att_block_bf16.cu``, its weights packed once and at the call,
    the same bits) reads a bf16 cache as stored, the int8 kernel an f32
    copy made at the call (counted in ``as_f32.widened_bytes``); the
    biases' f32 copies are kept once (``keep_f32_copy``), so none is made
    at a call. The weights' scale is
    1/sqrt(D), as phase 2 of ``chip_smoke.py`` draws them: at 2.4/sqrt(D)
    the products amplify, and 3e-7 of noise in x moves the plain version's
    y by 0.035 at the full width (one rounding of u flipped), past any
    tolerance that sees the rounding points; at 1/sqrt(D) by 5e-4."""
    dev = require_cuda()
    args = list(att_inputs(dev, 17, d, h, c, tq, kind, wsc=1 / math.sqrt(d)))
    args[7], args[8] = args[7].to(torch.bfloat16), args[8].to(torch.bfloat16)
    for bias in args[7:9]:
        quant.keep_f32_copy(bias)
    if cache == "bf16":
        args[10] = args[10].to(torch.bfloat16)
    meta = torch.tensor([c - 3, c // 2, tq - 2], dtype=torch.int32, device=dev)
    n0, b0 = quant.as_f32.widened, quant.as_f32.widened_bytes
    before = att_block.launches
    got = att_block(*args, meta, n_heads=h)
    assert att_block.launches == before + 1
    widened = quant.as_f32.widened - n0, quant.as_f32.widened_bytes - b0
    want = att_block_plain(*args, meta, n_heads=h)
    again = att_block(*args, meta, n_heads=h, packed=pack_att_block(*args[3:7]))
    torch.cuda.synchronize()
    for g, w, a in zip(got, want, again):
        torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-4)
        assert torch.equal(a, g)
    cast = cache == "bf16" and kind == "int8"
    assert widened == (int(cast), c * 2 * d * 6 if cast else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_joint_step_takes_bf16_biases(kind):
    """bf16 joint biases (with int8 weights: bf16, then int8), at 8 and 48
    rows (the engine's B rows), through the persistent bf16 or int8 kernel,
    its weights packed at the call and once beforehand (the same bits)."""
    dev = require_cuda()
    p, j, vocab, ndur = 32, 48, 64, 5
    v = vocab + 1 + ndur
    for rows in (8, 48):
        r = randn(dev, rows)
        wp, wo = as_weight(r(p, j, sc=0.3), kind), as_weight(r(j, v, sc=0.3), kind)
        bp, bo = r(j, sc=0.1).to(torch.bfloat16), r(v, sc=0.1).to(torch.bfloat16)
        args = (r(rows, j), r(rows, p, sc=0.5), wp, bp, wo, bo)
        kw = dict(ths=vocab + 1, ndur=ndur, blank_id=vocab, blank_penalty=0.7)
        got = joint_step(*args, **kw)
        tok_p, dur_p, lg_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[2], lg_p, atol=1e-4, rtol=1e-4)
        assert torch.equal(got[0], tok_p) and torch.equal(got[1], dur_p)
        again = joint_step(*args, **kw, packed=pack_joint_step(wp, bp, wo, bo))
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_conv_block_takes_bf16_taps_and_time_cache(kind, cache):
    """bf16 taps (their f32 copy kept once) and an f32 or bf16 time cache:
    the bf16 kernel (``csrc/conv_block_bf16.cu``) reads a bf16 cache as
    stored, the int8 kernel an f32 copy made at the call; at the card-test
    width and the full width, the constants packed at the call and once
    beforehand giving the same bits."""
    dev = require_cuda()
    for tq, valid, d in ((8, 6, 64), (8, 6, 1024)):
        args = list(conv_inputs(dev, 3 + d, tq, valid, d, kind))
        args[4] = args[4].to(torch.bfloat16)
        quant.keep_f32_copy(args[4])
        if cache == "bf16":
            args[10] = args[10].to(torch.bfloat16)
        n0 = quant.as_f32.widened
        got = conv_block(*args)
        want = conv_block_plain(*args)
        again = conv_block(*args, packed=pack_conv_block(*args[3:10]))
        torch.cuda.synchronize()
        for g, w, a in zip(got, want, again):
            torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-4)
            assert torch.equal(a, g)
        assert quant.as_f32.widened - n0 == 2 * int(cache == "bf16" and kind == "int8")


@pytest.mark.cuda
def test_bf16_ffn_chain_at_the_full_width():
    """The FFN with bf16 weights at the session's shapes, 8 rows of the
    full width, f32 LayerNorm parameters: the bf16 kernel
    (``csrc/ffn_bf16.cu``, its weights packed at the call and once, the
    same bits) and the chain it replaced (``csrc/ffn.cu``, on no path now,
    kept for ``chip_smoke.py`` to time), each within 2e-3 of the plain
    version."""
    dev = require_cuda()
    r = randn(dev, 44)
    d, e = 1024, 4096
    args = (r(8, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1),
            r(d, e, sc=d ** -0.5).to(torch.bfloat16), r(e, d, sc=e ** -0.5).to(torch.bfloat16))
    before = fused_ffn.launches
    got = fused_ffn(*args)
    assert fused_ffn.launches == before + 1
    again = fused_ffn(*args, packed=pack_ffn(*args[3:]))
    chain = fused_ffn_chain(*args)
    want = fused_ffn_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    for y in (got, chain):
        torch.testing.assert_close(y, want, atol=2e-3, rtol=1e-4)


@pytest.mark.cuda
def test_bf16_joint_and_conv_at_the_full_width():
    """The bf16 joint step (8 and 48 rows: a chunk, the engine's B rows) and
    conv module (a steady chunk, over an f32 and a bf16 time cache) at the
    full width with bf16 weights at 1/sqrt(K), as ``chip_smoke.py`` phase 2
    draws them: each persistent kernel (``csrc/joint_step_bf16.cu``,
    ``csrc/conv_block_bf16.cu``; one launch a call, its weights packed once
    and at the call, the same bits) and the chain it replaced
    (``csrc/joint_step.cu``, ``csrc/conv_block.cu``, on no path now, kept
    for ``chip_smoke.py`` to time) within 1e-3 of the plain version (the
    tensor cores' f32 sums run in another order; one flipped bf16 rounding
    moves an output by ~3e-4); the joint's tokens and durations equal
    wherever the plain version's top-2 margin exceeds twice that."""
    dev = require_cuda()
    r = randn(dev, 45)
    bf = torch.bfloat16
    p, j, v, ths, ndur = 640, 640, 8198, 8193, 5
    wp, wo = r(p, j, sc=p ** -0.5).to(bf), r(j, v, sc=j ** -0.5).to(bf)
    bp, bo = r(j, sc=0.1).to(bf), r(v, sc=0.1).to(bf)
    quant.keep_f32_copy(bp)
    quant.keep_f32_copy(bo)
    packed = pack_joint_step(wp, bp, wo, bo)
    kw = dict(ths=ths, ndur=ndur, blank_id=ths - 1, blank_penalty=0.5)
    for rows in (8, 48):
        args = (r(rows, j, sc=1.0), r(rows, p, sc=0.5), wp, bp, wo, bo)
        before = joint_step.launches
        got = joint_step(*args, **kw, packed=packed)
        assert joint_step.launches == before + 1
        again = joint_step(*args, **kw)
        want = joint_step_plain(*args, **kw)
        chain = joint_step_chain(*args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(again, got))
        for lg in (got[2], chain[2]):
            torch.testing.assert_close(lg, want[2], atol=1e-3, rtol=0)
        tl = want[2][:, :ths].clone()
        tl[:, ths - 1] -= 0.5
        for a, b, lg in ((got[0], want[0], tl), (got[1], want[1], want[2][:, ths:])):
            top2 = torch.topk(lg, 2, dim=1).values
            assert bool(((a == b) | ((top2[:, 0] - top2[:, 1]) <= 2e-3)).all())
    d = 1024
    for cache in (torch.float32, bf):
        args = list(conv_inputs(dev, 46, 8, 6, d, "bf16"))
        args[4] = args[4].to(bf)
        quant.keep_f32_copy(args[4])
        args[10] = args[10].to(cache)
        packed = pack_conv_block(*args[3:10])
        n0, before = quant.as_f32.widened, conv_block.launches
        got = conv_block(*args, packed=packed)
        assert conv_block.launches == before + 1
        again = conv_block(*args)
        want = conv_block_plain(*args)
        chain = conv_block_chain(*args)
        torch.cuda.synchronize()
        assert quant.as_f32.widened == n0                 # the bf16 cache read as stored
        for g, w, a, c in zip(got, want, again, chain):
            assert torch.equal(a, g)
            torch.testing.assert_close(g, w, atol=1e-3, rtol=0)
            torch.testing.assert_close(c, w, atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_bf16_joint_is_one_graph_replayable_launch():
    """The bf16 joint step at the full width is one cooperative launch a
    call and no kernel of the three-launch chain (``csrc/joint_step.cu``)
    runs; a CUDA graph captures it, and the replay equals the direct call
    bit for bit."""
    dev = require_cuda()
    r = randn(dev, 47)
    bf = torch.bfloat16
    p, j, v = 640, 640, 8198
    wargs = (r(p, j, sc=p ** -0.5).to(bf), r(j, sc=0.1), r(j, v, sc=j ** -0.5).to(bf),
             r(v, sc=0.1))
    packed = pack_joint_step(*wargs)
    e, g = r(8, j, sc=1.0), r(8, p, sc=0.5)
    call = lambda: joint_step(e, g, *wargs, ths=8193, ndur=5, blank_id=8192,  # noqa: E731
                              blank_penalty=0.5, packed=packed)
    assert_one_graph_replayable_launch(call, "joint_step_bf16_kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kernel", [("int8", "att_block_q8_kernel"),
                                         ("f32", "att_block_f32_kernel"),
                                         ("bf16", "att_block_bf16_kernel")])
def test_att_block_is_one_graph_replayable_launch(kind, kernel):
    """The int8, the f32 and the bf16 kernel are each one cooperative launch
    a call, which a CUDA graph captures: the replay equals the direct call
    bit for bit (the kernels add in a fixed order)."""
    dev = require_cuda()
    d, h, c, tq = 1024, 8, 256, 8
    args = att_inputs(dev, 9, d, h, c, tq, kind)
    meta = torch.tensor([100, c, 6], dtype=torch.int32, device=dev)
    packed = pack_att_block(*args[3:7])
    call = lambda: att_block(*args, meta, n_heads=h, packed=packed)  # noqa: E731
    assert_one_graph_replayable_launch(call, kernel)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_joint_step_kernel_matches_plain(kind):
    """Each weight type at the card-test width, at rows 1, 8, 16, 37 and 128
    (the gate admits B*T <= 128), each one cooperative launch a call
    (``csrc/joint_step_q8.cu``, ``csrc/joint_step_bf16.cu``,
    ``csrc/joint_step_f32.cu``), also packed once beforehand (``packed``, as
    the model passes them), giving the same bits."""
    dev = require_cuda()
    p, j, vocab, ndur = 32, 48, 64, 5
    ths = vocab + 1
    v = ths + ndur
    for rows in (1, 8, 16, 37, 128):              # one and several 8-row passes
        rng = np.random.default_rng(rows)
        r = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
            (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
        wp, wo = as_weight(r(p, j, sc=0.3), kind), as_weight(r(j, v, sc=0.3), kind)
        args = (r(rows, j), r(rows, p, sc=0.5), wp, r(j, sc=0.1), wo, r(v, sc=0.1))
        kw = dict(ths=ths, ndur=ndur, blank_id=vocab, blank_penalty=0.7)
        before = joint_step.launches
        tok, dur, lg = joint_step(*args, **kw)
        assert joint_step.launches == before + 1
        tok_p, dur_p, lg_p = joint_step_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(lg, lg_p, atol=1e-4, rtol=1e-4)
        assert torch.equal(tok, tok_p) and torch.equal(dur, dur_p)
        packed = pack_joint_step(wp, args[3], wo, args[5])
        for a, b in zip(joint_step(*args, **kw, packed=packed), (tok, dur, lg)):
            assert torch.equal(a, b)


def joint_tie_inputs(dev, rows, kind, p=8, j=16, v=24):
    """Zero activations and weights, so the logits are the biases: token
    columns 3 and 11 tie (blocks 0 and 1 of the int8 kernel, 8 columns a
    block at this width), the blank column 12 lies 1 above them before the
    penalty, and duration columns 14 and 16 (ths 13, a head cut between
    blocks 1 and 2) tie."""
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    bo = z(v)
    bo[[3, 11]] = 1.0
    bo[12] = 2.0
    bo[[14, 16]] = 3.0
    return (z(rows, j), z(rows, p), as_weight(z(p, j), kind), z(j), as_weight(z(j, v), kind), bo)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_joint_step_kernel_tie_picks_first_index(kind):
    """Ties pick the smaller index, also across the int8 kernel's blocks,
    and the penalty moves the blank column alone, at rows 1, 8, 16 and
    128."""
    dev = require_cuda()
    j, v, ths = 16, 12, 8
    e = torch.zeros((2, j), device=dev)
    g = torch.zeros((2, 4), device=dev)
    wp = as_weight(torch.zeros((4, j), device=dev), kind)
    wo = as_weight(torch.zeros((j, v), device=dev), kind)
    bo = torch.zeros(v, device=dev)
    bo[[2, 5]] = 1.0                              # token tie between 2 and 5
    bo[[ths + 1, ths + 3]] = 2.0                  # duration tie between 1 and 3
    tok, dur, _ = joint_step(e, g, wp, torch.zeros(j, device=dev), wo, bo,
                             ths=ths, ndur=v - ths, blank_id=ths - 1)
    assert tok.tolist() == [2, 2] and dur.tolist() == [1, 1]
    for rows in (1, 8, 16, 128):
        args = joint_tie_inputs(dev, rows, kind)
        for penalty, want in ((1.5, 3), (0.5, 12)):
            tok, dur, lg = joint_step(*args, ths=13, ndur=5, blank_id=12, blank_penalty=penalty)
            assert tok.tolist() == [want] * rows and dur.tolist() == [1] * rows
            assert torch.equal(lg, args[5].expand(rows, -1))      # logits before the penalty


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 50, 51, 53, 300])
def test_logmel_kernel_matches_plain(frames):
    """One launch a call at T 1, a 0.5 s push (50), a frame tile cut short
    (51, 53) and a flush-sized T (300); the bases packed once by the
    frontend give the same bits as bases packed at the call."""
    dev = require_cuda()
    fe = LogMelFrontend(FrontendSpec(n_mels=128), use_kernel=True, device=dev)
    x = torch.as_tensor(
        (np.random.default_rng(frames).standard_normal((frames, 400)) * 0.3).astype(np.float32),
        device=dev)
    args = (x, fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
    before = logmel.launches
    got = logmel(*args, packed=fe._basis)
    assert logmel.launches == before + 1
    torch.testing.assert_close(got, logmel_plain(*args), atol=1e-3, rtol=1e-5)
    assert torch.equal(logmel(*args), got)
    assert torch.equal(fe._basis, pack_logmel_basis(fe._wcos, fe._wsin))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["joint_step_f32_kernel", "logmel_kernel"])
def test_joint_f32_and_logmel_are_one_graph_replayable_launch(kernel):
    """The f32 joint step and the log-mel kernel are each one launch a call
    (the joint's a cooperative one), which a CUDA graph captures: the
    replay equals the direct call bit for bit (both add in a fixed order;
    the log-mel tickets return to zero after every launch)."""
    dev = require_cuda()
    rng = np.random.default_rng(11)
    r = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    if kernel == "logmel_kernel":
        fe = LogMelFrontend(FrontendSpec(n_mels=128), use_kernel=True, device=dev)
        args = (r(50, 400, sc=0.3), fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
        call = lambda: (logmel(*args, packed=fe._basis),)  # noqa: E731
    else:
        p, j, v = 640, 640, 8198
        wargs = (r(p, j, sc=p ** -0.5), r(j, sc=0.1), r(j, v, sc=j ** -0.5), r(v, sc=0.1))
        packed = pack_joint_step(*wargs)
        e, g = r(8, j), r(8, p, sc=0.5)
        call = lambda: joint_step(e, g, *wargs, ths=8193, ndur=5, blank_id=8192,  # noqa: E731
                                  blank_penalty=0.5, packed=packed)
    assert_one_graph_replayable_launch(call, kernel)


@pytest.mark.cuda
def test_gate_r3_session_with_kernels_matches_cpu():
    dev = require_cuda()
    rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True)
    gpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev)
    gpu.frontend = LogMelFrontend(FrontendSpec(n_mels=gpu.cfg.feat_in), use_kernel=True,
                                  device=dev)
    cpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")
    audio = synth_audio(seed=21, words=6)
    counts = (att_block.launches, joint_step.launches, logmel.launches)
    sessions = []
    for model in (gpu, cpu):
        sess = StreamingSession(model, model.runtime)
        for i in range(0, len(audio), 8000):
            sess.push_audio(audio[i:i + 8000])
        sess.finalize()
        sessions.append(sess)
    after = (att_block.launches, joint_step.launches, logmel.launches)
    assert all(a > b for a, b in zip(after, counts))
    assert sessions[0].tokens == sessions[1].tokens
    assert len(sessions[0].tokens) > 0


def randn(dev, seed):
    rng = np.random.default_rng(seed)
    return lambda *s, sc=0.3: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)


# (x's shape, D, E) of the FFN: the card-test widths, a ragged expansion
# slice (E 200), two passes of 8 rows (13); with int8 or f32 weights (the
# persistent kernels) also one row, 16 rows and the full width (D 1024, E
# 4096: 128 blocks), where a steady chunk's 8 rows of int8 are held at
# chip_smoke.py phase 2's 1e-4
FFN_SHAPES = [((8,), 64, 128), ((1, 6), 64, 128), ((13,), 96, 200)]
PERSISTENT_FFN_SHAPES = FFN_SHAPES + [((1,), 96, 200), ((2, 8), 64, 256), ((8,), 1024, 4096),
                                      ((13,), 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_ffn_kernel_matches_plain(kind):
    """Each weight type (one cooperative launch a call): the weights packed
    once beforehand (``packed``, as the model passes them) give the same
    bits as those packed by the call. bf16 at the full width is held in
    test_bf16_ffn_chain_at_the_full_width."""
    dev = require_cuda()
    for shape, d, e in PERSISTENT_FFN_SHAPES[:5] if kind == "bf16" else PERSISTENT_FFN_SHAPES:
        r = randn(dev, d + len(shape))
        x, g, b = r(*shape, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1)
        w1, w2 = as_weight(r(d, e, sc=d ** -0.5), kind), as_weight(r(e, d, sc=e ** -0.5), kind)
        before = fused_ffn.launches
        got = fused_ffn(x, g, b, w1, w2, 0.5)
        assert fused_ffn.launches == before + 1
        want = fused_ffn_plain(x, g, b, w1, w2, 0.5)
        torch.cuda.synchronize()
        atol = 1e-4 if kind == "f32" else 2e-3
        if shape == (8,) and d == 1024:
            atol = 1e-4
        torch.testing.assert_close(got, want, atol=atol, rtol=1e-4)
        again = fused_ffn(x, g, b, w1, w2, 0.5, packed=pack_ffn(w1, w2))
        torch.cuda.synchronize()
        assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kernel", [("int8", "ffn_q8_kernel"), ("f32", "ffn_f32_kernel"),
                                         ("bf16", "ffn_bf16_kernel")])
def test_ffn_is_one_graph_replayable_launch(kind, kernel):
    """With int8, f32 or bf16 weights an FFN call is one cooperative launch
    and no kernel of the five-launch chain (``csrc/ffn.cu``) runs; a CUDA
    graph captures it, and the replay equals the direct call bit for bit
    (the kernels add in a fixed order)."""
    dev = require_cuda()
    d, e = 1024, 4096
    r = randn(dev, 17)
    x, g, b = r(8, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1)
    w1, w2 = as_weight(r(d, e, sc=d ** -0.5), kind), as_weight(r(e, d, sc=e ** -0.5), kind)
    packed = pack_ffn(w1, w2)
    call = lambda: fused_ffn(x, g, b, w1, w2, 0.5, packed=packed)  # noqa: E731
    assert_one_graph_replayable_launch(call, kernel)


def conv_inputs(dev, seed, tq, valid, d, kind):
    r = randn(dev, seed)
    kk = 9
    return (r(tq, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1),
            as_weight(r(d, 2 * d, sc=d ** -0.5), kind), r(kk, d),
            1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, sc=0.1), r(d).abs() * 0.5 + 0.8,
            as_weight(r(d, d, sc=d ** -0.5), kind), r((kk - 1) // 2, d, sc=1.0),
            (torch.arange(tq, device=dev) < valid).float()[:, None])


# (Tq, valid steps, D) of the conv module: the card-test widths, one row, a
# steady chunk and two passes of 8 rows at the full width
CONV_SHAPES = [(8, 6, 64), (6, 6, 64), (3, 1, 64), (8, 6, 96), (1, 1, 1024), (8, 6, 1024),
               (13, 11, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", WEIGHTS)
def test_conv_block_kernel_matches_plain(kind):
    """With each weight type (one cooperative launch a call) the constants
    packed once beforehand (``packed``, as the model passes them) give the
    same bits as those packed by the call."""
    dev = require_cuda()
    for tq, valid, d in CONV_SHAPES:
        args = conv_inputs(dev, tq + d, tq, valid, d, kind)
        before = conv_block.launches
        got = conv_block(*args)
        assert conv_block.launches == before + 1
        want = conv_block_plain(*args)
        torch.cuda.synchronize()
        atol = 1e-4 if kind == "f32" else 2e-3
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)
        assert float(got[1][valid:].abs().sum()) == 0.0
        again = conv_block(*args, packed=pack_conv_block(*args[3:10]))
        torch.cuda.synchronize()
        assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kernel", [("int8", "conv_block_q8_kernel"),
                                         ("f32", "conv_block_f32_kernel"),
                                         ("bf16", "conv_block_bf16_kernel")])
def test_conv_block_is_one_graph_replayable_launch(kind, kernel):
    """With int8, f32 and bf16 weights a conv module call is one cooperative
    launch and no kernel of the five-launch chain (``csrc/conv_block.cu``)
    runs; a CUDA graph captures it, and the replay equals the direct call
    bit for bit (the kernels add in a fixed order)."""
    dev = require_cuda()
    args = conv_inputs(dev, 19, 8, 6, 1024, kind)
    packed = pack_conv_block(*args[3:10])
    call = lambda: conv_block(*args, packed=packed)  # noqa: E731
    assert_one_graph_replayable_launch(call, kernel)


@pytest.mark.cuda
def test_conv_ffn_ln_kernel_matches_plain():
    """Card-test widths, a ragged W1 slice (D 96, E 200: 12 blocks of 24
    columns, the last three past E), one row, the full width (D 1024,
    E 4096: 128 blocks, the main path's steady chunk), and Tq 13 (two
    passes of 8 rows: x's rows copied again, the barriers' parities
    toggled). The constants packed once beforehand (``packed``, as the
    model passes them) give the same bits as those packed by the call."""
    dev = require_cuda()
    for tq, valid, d, e in [(8, 6, 64, 128), (5, 5, 96, 200), (1, 1, 64, 128),
                            (8, 6, 1024, 4096), (13, 11, 96, 200), (13, 11, 1024, 4096)]:
        r = randn(dev, 7 * tq)
        conv = conv_inputs(dev, tq, tq, valid, d, "int8")
        tail = (1.0 + r(d, sc=0.2), r(d, sc=0.1), quantize_tensor(r(d, e, sc=d ** -0.5)),
                quantize_tensor(r(e, d, sc=e ** -0.5)), 1.0 + r(d, sc=0.2), r(d, sc=0.1))
        before = conv_ffn_ln.launches
        got = conv_ffn_ln(*conv, *tail)
        assert conv_ffn_ln.launches == before + 1
        want = conv_ffn_ln_plain(*conv, *tail)
        packed = pack_conv_ffn_ln(*conv[3:10], *tail[2:4])
        again = conv_ffn_ln(*conv, *tail, packed=packed)
        torch.cuda.synchronize()
        for g, w, a in zip(got, want, again):
            torch.testing.assert_close(g, w, atol=2e-3, rtol=1e-4)
            assert torch.equal(a, g)
        assert float(got[1][valid:].abs().sum()) == 0.0      # padded steps: c = 0


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back():
    """A CUDA input the kernels do not take raises: no wrapper retries on
    its plain version."""
    dev = require_cuda()
    r = randn(dev, 3)
    x = r(64, 8, sc=1.0).t()                      # [8, 64], not contiguous
    g, b = 1.0 + r(64, sc=0.2), r(64, sc=0.1)
    before = fused_ffn.launches
    with pytest.raises(ValueError, match="contiguous"):
        fused_ffn(x, g, b, r(64, 128), r(128, 64))
    x = r(8, 64, sc=1.0)
    with pytest.raises(ValueError, match="a multiple of 8"):          # D 60, int8
        fused_ffn(r(8, 60), g[:60].contiguous(), b[:60].contiguous(),
                  quantize_tensor(r(60, 128)), quantize_tensor(r(128, 60)))
    fw = (r(64, 128), r(128, 64))
    for wrong in (pack_ffn(*fw, sms=2),                               # another card's slices
                  pack_ffn(*[quantize_tensor(w) for w in fw])):       # int8's layout
        with pytest.raises(ValueError, match="do not fit the launch plan"):
            fused_ffn(x, g, b, *fw, packed=wrong)
    with pytest.raises(ValueError, match="do not fit the launch plan"):    # f32's layout
        fused_ffn(x, g, b, *[w.bfloat16() for w in fw], packed=pack_ffn(*fw))
    with pytest.raises(ValueError, match="one storage type"):
        fused_ffn(x, g, b, fw[0].bfloat16(), fw[1])
    assert fused_ffn.launches == before
    conv = list(conv_inputs(dev, 4, 8, 6, 64, "f32"))
    conv[10] = r(64, 4).t()                       # time cache, not contiguous
    before = conv_block.launches
    with pytest.raises(ValueError, match="contiguous"):
        conv_block(*conv)
    for kind in ("int8", "f32"):
        with pytest.raises(ValueError, match="a multiple of 8"):     # D 60
            conv_block(*conv_inputs(dev, 4, 8, 6, 60, kind))
        conv = conv_inputs(dev, 4, 8, 6, 64, kind)
        with pytest.raises(ValueError, match="do not fit the launch plan"):
            conv_block(*conv, packed=pack_conv_block(*conv[3:10], sms=4))   # another card's
    conv = conv_inputs(dev, 4, 8, 6, 64, "f32")
    with pytest.raises(ValueError, match="do not fit the launch plan"):       # int8's layout
        conv_block(*conv, packed=pack_conv_block(*conv_inputs(dev, 4, 8, 6, 64, "int8")[3:10]))
    bconv = conv_inputs(dev, 4, 8, 6, 64, "bf16")
    for wrong in (pack_conv_block(*conv[3:10]),                              # f32's layout
                  pack_conv_block(*conv_inputs(dev, 4, 8, 6, 64, "int8")[3:10]),   # int8's
                  pack_conv_block(*bconv[3:10], sms=4)):                   # another card's
        with pytest.raises(ValueError, match="do not fit the launch plan"):
            conv_block(*bconv, packed=wrong)
    with pytest.raises(ValueError, match="one storage type"):
        conv_block(*bconv[:9], conv[9], *bconv[10:])
    assert conv_block.launches == before
    conv = conv_inputs(dev, 5, 8, 6, 64, "f32")
    tail = (g, b, r(64, 128), r(128, 64), g, b)
    with pytest.raises(TypeError, match="int8"):
        conv_ffn_ln(*conv, *tail)
    conv = conv_inputs(dev, 6, 8, 6, 64, "int8")
    tail = (g, b, quantize_tensor(r(64, 100)), quantize_tensor(r(100, 64)), g, b)
    before = conv_ffn_ln.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_ffn_ln(*conv, *tail)                 # E = 100: the kernel's groups are 8 wide
    tail = (g, b, quantize_tensor(r(64, 128)), quantize_tensor(r(128, 64)), g, b)
    packed = pack_conv_ffn_ln(*conv[3:10], *tail[2:4], sms=4)     # 4 blocks of 16 columns
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        conv_ffn_ln(*conv, *tail, packed=packed)
    assert conv_ffn_ln.launches == before
    att = att_inputs(dev, 7, 48, 4, 32, 8, "int8")             # head dim 12
    meta = torch.tensor([3, 10, 6], dtype=torch.int32, device=dev)
    before = att_block.launches
    with pytest.raises(ValueError, match="head dim of 16"):
        att_block(*att, meta, n_heads=4)
    att = att_inputs(dev, 8, 64, 4, 32, 8, "int8")
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        att_block(*att, meta, n_heads=4, packed=pack_att_block(*att[3:7], sms=4))
    with pytest.raises(ValueError, match="head dim of 16"):
        att_block(*att_inputs(dev, 7, 48, 4, 32, 8, "f32"), meta, n_heads=4)
    att = att_inputs(dev, 8, 64, 4, 32, 8, "f32")
    for wrong in (pack_att_block(*att[3:7], sms=4),                  # another card's slices
                  pack_att_block(*[quantize_tensor(w) for w in att[3:7]])):   # int8's layout
        with pytest.raises(ValueError, match="do not fit the launch plan"):
            att_block(*att, meta, n_heads=4, packed=wrong)
    batt = att_inputs(dev, 8, 64, 4, 32, 8, "bf16")
    for wrong in (pack_att_block(*batt[3:7], sms=4), pack_att_block(*att[3:7])):   # f32's
        with pytest.raises(ValueError, match="do not fit the launch plan"):
            att_block(*batt, meta, n_heads=4, packed=wrong)
    with pytest.raises(ValueError, match="one storage type"):
        att_block(*batt[:6], att[6], *batt[7:], meta, n_heads=4)
    assert att_block.launches == before
    before = joint_step.launches
    jargs = (r(8, 16), r(8, 6), quantize_tensor(r(6, 16)), r(16), quantize_tensor(r(16, 40)),
             r(40))
    with pytest.raises(ValueError, match="P a multiple of 4"):
        joint_step(*jargs, ths=33, ndur=5, blank_id=32)
    jargs = (r(8, 16), r(8, 8), quantize_tensor(r(8, 16)), r(16), quantize_tensor(r(16, 40)),
             r(40))
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        joint_step(*jargs, ths=33, ndur=5, blank_id=32,
                   packed=pack_joint_step(*jargs[2:], sms=2))      # another card's slices
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        joint_step(*jargs[:2], r(8, 16), jargs[3], r(16, 40), jargs[5], ths=33, ndur=5,
                   blank_id=32, packed=pack_joint_step(*jargs[2:]))     # int8's layout
    with pytest.raises(ValueError, match="do not fit the launch plan"):     # int8's layout
        joint_step(*jargs[:2], r(8, 16).bfloat16(), jargs[3], r(16, 40).bfloat16(), jargs[5],
                   ths=33, ndur=5, blank_id=32, packed=pack_joint_step(*jargs[2:]))
    with pytest.raises(ValueError, match="one storage type"):
        joint_step(*jargs[:2], r(8, 16).bfloat16(), jargs[3], r(16, 40), jargs[5], ths=33,
                   ndur=5, blank_id=32)
    assert joint_step.launches == before
    fe = LogMelFrontend(FrontendSpec(n_mels=128), device=dev)
    margs = (r(8, 400), fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)
    before = logmel.launches
    with pytest.raises(ValueError, match="pack_logmel_basis"):
        logmel(*margs, packed=pack_logmel_basis(fe._wcos, fe._wsin)[..., :16].contiguous())
    assert logmel.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["bf16", "split"])
def test_q8_matmul_on_the_tensor_cores_matches_cpu(monkeypatch, policy):
    """The card's int8 product (bf16 operands on the tensor cores, f32
    sums) against the CPU path (the f32 product of the same operands) at
    1e-5 of the largest value: the same exact products summed in another
    order. 2-D and 3-D activations; a weight with its bf16 copy reads the
    same bits as one widened at the call, which the counter counts."""
    dev = require_cuda()
    monkeypatch.setattr(quant, "_Q8_ACT", policy)
    rng = np.random.default_rng(11)
    w = quantize_tensor(torch.as_tensor(rng.standard_normal((640, 4096)).astype(np.float32)))
    for shape in ((8, 640), (2, 7, 640)):
        a = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        want = quant.q8_matmul(a, w)
        wd = QuantTensor(w.q.to(dev), w.s.to(dev))
        before = quant.q8_matmul.widened
        got = quant.q8_matmul(a.to(dev), wd)
        assert quant.q8_matmul.widened == before + 1
        quant.keep_bf16_copy(wd.q)
        again = quant.q8_matmul(a.to(dev), wd)
        assert quant.q8_matmul.widened == before + 1
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == torch.float32
        assert torch.equal(got, again)
        err = float((got.cpu() - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-5, err


@pytest.mark.cuda
def test_int8_model_keeps_bf16_copies_and_widens_nothing():
    """An int8 model on the card keeps a bf16 copy of every int8 weight
    (each layer's view a view of it), and a session and an offline
    transcription with it widen no weight at a call."""
    dev = require_cuda()
    rt = RuntimeConfig(quant="all", use_pallas_att=True, use_pallas_joint=True)
    model = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev)
    for lp in model.layers:
        for w in lp.values():
            if isinstance(w, QuantTensor):
                assert torch.equal(quant.bf16_copy(w.q).float(), w.q.float())
    assert model.joint_packed is not None and model.joint_packed.dtype == torch.uint8
    before = quant.q8_matmul.widened
    sess = StreamingSession(model, rt)
    audio = synth_audio(seed=23, words=4)
    for i in range(0, len(audio), 8000):
        sess.push_audio(audio[i:i + 8000])
    sess.finalize()
    model.transcribe_offline(audio)
    torch.cuda.synchronize()
    assert quant.q8_matmul.widened == before
    assert len(sess.tokens) > 0


@pytest.mark.cuda
def test_f32_model_packs_the_joint_once():
    """An f32 model on the card with the joint kernel on packs the joint's
    f32 weights once (``csrc/joint_step_f32.cu``'s layout), a model with
    the bf16 weights of ``cast_params_for_compute`` its bf16 weights
    (``csrc/joint_step_bf16.cu``'s), and its layers' conv modules with the
    conv kernel on; without the kernels nothing is packed."""
    dev = require_cuda()
    rt = RuntimeConfig(use_pallas_joint=True, use_pallas_conv=True)
    for wdt, packed_dtype in ((None, torch.float32), (torch.bfloat16, torch.uint8)):
        model = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev, weights_dtype=wdt)
        jp = model.params["joint"]
        assert torch.equal(model.joint_packed, pack_joint_step(
            jp["pred"]["w"], jp["pred"]["b"], jp["out"]["w"], jp["out"]["b"]))
        assert model.joint_packed.dtype == packed_dtype
        assert all("conv_block_packed" in lp for lp in model.layers)
    assert ParakeetTDT.from_model_dir(GATE_R3, device=dev).joint_packed is None


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp (8 significant bits) of each value of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def tensor_core_shifted_bias(q_v: torch.Tensor, pos: torch.Tensor, tkv: int) -> torch.Tensor:
    """The plain rel-shift fed tensor-core sums: q_v . pos [B, H, Tq, R] for
    bf16 q_v [B, Tq, H, dh] and pos [R, H, dh] summed by a bf16 tensor-core
    product with f32 output (cuBLAS ``bmm``), shifted and rounded once."""
    b, tq, h, dh = q_v.shape
    r = pos.shape[0]
    qh = q_v.transpose(1, 2).reshape(b * h, tq, dh)
    ph = pos.permute(1, 2, 0).expand(b, h, dh, r).reshape(b * h, dh, r)
    pd = torch.bmm(qh, ph, out_dtype=torch.float32).view(b, h, tq, r)
    return rel_shift(pd, tkv).to(q_v.dtype)


def assert_rel_shift_bf16_close(got, q_v, pos, tkv):
    """The bf16 kernel sums on the tensor cores, in another order than the
    plain version's f32 einsum. Against the plain version: one bf16 ulp,
    floored near zero at twice the f32 sums' distance from the f64 sums
    (there one ulp is below the f32 sums' own error), with at most 1e-4 of
    the values past one ulp (4.3e-6 read on the H100 at B 8, T 368).
    Against the plain version fed tensor-core sums: the same bound, and at
    most 5e-5 of the values differ at all (2.0e-5 and 2.4e-5 read at B 2
    and 8, T 368, where 7.9e-5 differ from the plain version). Each count
    may exceed its share by four, so that a small shape's one or two such
    values, at those rates, do not fail it."""
    p = pos.to(q_v.dtype)
    want = rel_pos_bias_shifted_plain(q_v, p, tkv=tkv).float()
    f32 = rel_shift(torch.einsum("bthd,rhd->bhtr", q_v.float(), p.float()), tkv)
    f64 = rel_shift(torch.einsum("bthd,rhd->bhtr", q_v.double(), p.double()), tkv)
    floor = 2 * float((f32.double() - f64).abs().max())
    g = got.float()
    diff, ulp = (g - want).abs(), bf16_ulp(want)
    assert bool((diff <= ulp.clamp_min(floor)).all()), (
        f"max |diff| past max(ulp, {floor:.3g}): {float((diff - ulp.clamp_min(floor)).max()):.3g}")
    past = int((diff > ulp).sum())
    assert past <= 1e-4 * diff.numel() + 4, f"{past} of {diff.numel()} values past one bf16 ulp"
    tc = tensor_core_shifted_bias(q_v, p, tkv).float()
    dtc = (g - tc).abs()
    assert bool((dtc <= bf16_ulp(torch.maximum(g.abs(), tc.abs())).clamp_min(floor)).all())
    differ = int((dtc > 0).sum())
    assert differ <= 5e-5 * dtc.numel() + 4, (
        f"{differ} of {dtc.numel()} values differ from the tensor-core sums")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rel_shift_kernel_matches_plain(dtype):
    """Both types on four shapes, among them Tq and tkv a multiple of the
    64-row tile and of the 64-position chunk (384; bf16 also 128 with R
    exact). bf16 (tensor cores,
    64-row tiles walking the band in 64-position chunks) also at its edges:
    T across the row tile (1, 63, 65, 130, 368), tkv below and above Tq, R
    exactly Tq + tkv - 1 and longer, dh 16 to 128 (20: not a multiple of 16,
    8-byte copies), every store width of bd's rows (tkv a multiple of 8, of
    4, of 2, odd: 16, 8, 4 and 2 bytes) and B H = 64."""
    dev = require_cuda()
    cases = [(1, 57, 57, 2, 32, 3), (2, 130, 130, 2, 64, 3), (1, 40, 70, 3, 16, 3),
             (2, 384, 384, 8, 128, 3)]
    if dtype == torch.bfloat16:
        cases += [(1, 1, 1, 2, 32, 0), (3, 63, 63, 2, 32, 2), (2, 65, 65, 2, 64, 0),
                  (2, 130, 130, 4, 16, 3), (8, 368, 368, 8, 128, 0), (1, 40, 70, 3, 20, 0),
                  (1, 70, 40, 3, 64, 5), (2, 57, 60, 2, 32, 0), (1, 129, 131, 2, 128, 1),
                  (2, 67, 68, 2, 20, 0), (1, 66, 36, 2, 16, 0), (1, 128, 128, 2, 64, 0)]
    widths = set()
    for b, tq, tkv, h, dh, extra in cases:
        r = randn(dev, tq + dh)
        q_v = r(b, tq, h, dh, sc=1.0).to(dtype)
        pos = r(tq + tkv - 1 + extra, h, dh, sc=1.0)       # R exact or longer; cast inside
        before = rel_pos_bias_shifted.launches
        got = rel_pos_bias_shifted(q_v, pos, tkv=tkv)
        assert rel_pos_bias_shifted.launches == before + 1
        want = rel_pos_bias_shifted_plain(q_v, pos, tkv=tkv)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (b, h, tq, tkv)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert_rel_shift_bf16_close(got, q_v, pos, tkv)
            widths.add(2 * min(8, tkv & -tkv))            # bytes of a row's store
    if dtype == torch.bfloat16:
        assert widths == {16, 8, 4, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_att_kernel_matches_plain(dtype):
    """Mixed lengths with a zero-length row; bd both as the plain shift's
    strided view and contiguous. The kernels' edges: T across their 64-row
    query tiles, 64-key f32 K/V tiles and 128-key blocks (1, 63, 64, 65,
    129; 300, not a multiple of 64, over three key blocks), dh 20 (not a
    multiple of 16: zero-filled in bf16) and 16 to 128, and every copy width
    of the bf16 kernel's rows (q/k/v 16 and 8 bytes; bd 16, 8, 4 and 2:
    contiguous rows of 68, 66 and 65 keys are 8-, 4- and 2-byte aligned)."""
    dev = require_cuda()
    widths = set()
    for b, t, h, dh, lens in [(3, 37, 2, 64, [37, 29, 0]), (2, 130, 4, 16, [130, 101]),
                              (2, 384, 8, 128, [384, 0]), (2, 1, 2, 32, [1, 0]),
                              (3, 63, 2, 32, [63, 17, 0]), (2, 64, 2, 128, [64, 0]),
                              (2, 65, 2, 32, [65, 0]), (2, 129, 2, 64, [129, 0]),
                              (2, 66, 1, 20, [66, 0]), (2, 68, 2, 20, [50, 0]),
                              (2, 300, 4, 128, [300, 177])]:
        r = randn(dev, t + dh)
        q, k, v = (r(b, t, h, dh, sc=1.0).to(dtype) for _ in range(3))
        bd = rel_pos_bias_shifted_plain(r(b, t, h, dh, sc=0.3).to(dtype),
                                        r(2 * t - 1, h, dh, sc=1.0), tkv=t)
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lens, device=dev)[:, None]
        for bias in (bd, bd.contiguous()):
            if dtype == torch.bfloat16:
                widths.add(copy_widths(q, k, v, bias))
            before = flash_bias_attention.launches
            got = flash_bias_attention(q, k, v, bias, mask)
            assert flash_bias_attention.launches == before + 1
            want = flash_bias_attention_plain(q, k, v, bias, mask)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(got).all())
            if dtype == torch.float32:
                torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
                continue
            torch.testing.assert_close(got, want, atol=1.5e-3, rtol=0.0)
            atol = 1e-4
            same_sums = flash_bias_attention_plain(q, k, v, bias, mask,
                                                   qk=tensor_core_qk(q, k))
            torch.testing.assert_close(got, same_sums, atol=atol, rtol=0.0)
            if t > 1:
                # p left unrounded (the operands widened to f32) lies past
                # the tolerance on every shape's rows with a valid key (at
                # T = 1 a row's one p is exactly 1)
                unrounded = flash_bias_attention_plain(q.float(), k.float(), v.float(),
                                                       bias.float(), mask)
                has_key = mask.any(dim=1)
                assert float((got - unrounded)[has_key].abs().max()) > atol
    if dtype == torch.bfloat16:
        assert {w for w, _ in widths} == {16, 8} and {w for _, w in widths} == {16, 8, 4, 2}


@pytest.mark.cuda
def test_bf16_matmul_runs_on_the_tensor_cores_within_one_ulp():
    """ops.common.matmul of bf16 activations and bf16 weights (the bf16
    weights configuration) at the offline batch's FFN shape: a bf16 result
    within one bf16 ulp of the f32 product rounded once to bf16 (the same
    products, summed in another order). Near zero one bf16 ulp is smaller
    than the f32 sums' own error, so the ulp there is floored at twice the
    f32 product's distance from the exact (f64) product; at most 1e-4 of
    the values may need that floor."""
    from trt_asr_tpu_torch.ops.common import matmul

    dev = require_cuda()
    r = randn(dev, 77)
    a, w = r(8 * 368, 1024, sc=1.0).to(torch.bfloat16), r(1024, 4096, sc=0.03).to(torch.bfloat16)
    got = matmul(a, w)
    assert got.dtype == torch.bfloat16 and got.shape == (8 * 368, 4096)
    f32 = a.float() @ w.float()
    floor = 2 * float((f32.double() - a.double() @ w.double()).abs().max())
    want = f32.to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    diff = (got.float() - want).abs()
    assert bool((diff <= ulp.clamp_min(floor)).all()), (
        f"max |diff| past max(ulp, {floor:.3g}): {float((diff - ulp.clamp_min(floor)).max()):.3g}")
    share = float((diff > ulp).float().mean())
    assert share <= 1e-4, f"{share:.3g} of the values lie past one bf16 ulp"


@pytest.mark.cuda
def test_offline_wrappers_raise_instead_of_falling_back():
    dev = require_cuda()
    r = randn(dev, 9)
    q = r(2, 20, 2, 16)
    mask = torch.ones((2, 20), dtype=torch.bool, device=dev)
    bd = r(2, 2, 20, 20)
    with pytest.raises(ValueError, match="strided"):
        flash_bias_attention(q, q, q, bd.transpose(2, 3), mask)
    with pytest.raises(TypeError, match="bool"):
        flash_bias_attention(q, q, q, bd, mask.float())
    shifted = r(q.numel() + 1)[1:].view(q.shape)       # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="aligned"):
        flash_bias_attention(shifted, q, q, bd, mask)
    with pytest.raises(ValueError, match="contiguous"):
        rel_pos_bias_shifted(r(2, 2, 20, 16).transpose(1, 2), r(39, 2, 16), tkv=20)
    with pytest.raises(ValueError, match="does not fit"):
        rel_pos_bias_shifted(q, r(30, 2, 16), tkv=20)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(quant="none", use_pallas_ffn=True, use_pallas_conv=True),
    dict(quant="all", use_pallas_ffn=True, use_pallas_conv=True),   # fused conv+FFN2+LN
    dict(quant="all", use_pallas_conv=True),                        # conv_block[int8]
    dict(quant="all", use_pallas_ffn=True),                         # both FFNs, ffn[int8]
])
def test_gate_r3_session_with_every_kernel_matches_cpu(flags):
    dev = require_cuda()
    rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True, **flags)
    gpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev)
    cpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device="cpu")
    audio = synth_audio(seed=22, words=6)
    kernels = [fused_ffn, conv_block, conv_ffn_ln]
    sessions, counts = [], []
    for model in (gpu, cpu):
        before = [k.launches for k in kernels]
        sess = StreamingSession(model, rt)
        for i in range(0, len(audio), 8000):
            sess.push_audio(audio[i:i + 8000])
        sess.finalize()
        sessions.append(sess)
        counts.append([k.launches - n for k, n in zip(kernels, before)])
    ffn, conv = flags.get("use_pallas_ffn", False), flags.get("use_pallas_conv", False)
    tail = flags["quant"] == "all" and ffn and conv
    assert (counts[0][0] > 0) == ffn
    assert (counts[0][1] > 0) == (conv and not tail) and (counts[0][2] > 0) == tail
    assert all(("conv_ffn_ln_packed" in lp) == tail for lp in gpu.layers)
    # the conv module alone, int8 or f32, runs on its constants packed once
    assert all(("conv_block_packed" in lp) == (conv and not tail) for lp in gpu.layers)
    assert not any("conv_block_packed" in lp for lp in cpu.layers)
    # each FFN that the FFN kernel runs is packed once (FFN2 not in the tail)
    assert all(("ff1_packed" in lp) == ffn and ("ff2_packed" in lp) == (ffn and not tail)
               for lp in gpu.layers)
    assert not any("ff1_packed" in lp or "ff2_packed" in lp for lp in cpu.layers)
    assert not any("conv_ffn_ln_packed" in lp for lp in cpu.layers)
    assert all("att_block_packed" in lp for lp in gpu.layers)    # int8 or f32: use_pallas_att
    assert not any("att_block_packed" in lp for lp in cpu.layers)
    assert counts[1] == [0, 0, 0]
    assert sessions[0].tokens == sessions[1].tokens
    assert len(sessions[0].tokens) > 0


def offline_tokens(model, audios, dtype):
    """offline_encode (flash on, padded tails masked) + batched greedy decode
    with the joint kernel flag, as the offline bench path runs them."""
    x, lens = model.batch_features(audios)
    enc, enc_len = offline_encode(model.params, model.cfg, x,
                                  torch.as_tensor(lens, device=model.device),
                                  compute_dtype=dtype, use_flash_att=True, mask_pad_subsample=True)
    dec = prime_decode_state(model.params, model.cfg,
                             init_decode_state(model.cfg, len(audios), device=model.device),
                             model.prompt_ids)
    toks, n, _ = tdt_greedy_decode_batch(
        model.params, model.cfg, enc.float(), enc_len, dec,
        max_tokens=model.cfg.max_symbols_per_timestep * enc.shape[1], use_pallas_joint=True)
    return [toks[i, :int(n[i])].tolist() for i in range(len(audios))]


@pytest.mark.cuda
def test_gate_r3_offline_with_kernels_matches_cpu():
    """24-word utterances (T >= 128): transcribe_batch and f32 with the flash
    kernel are token-exact with the CPU path; bf16 launches the shift and
    flash kernels once a layer (bf16 tokens are compared with the CPU beside
    the bf16 noise floor in chip_smoke.py: they are not exact)."""
    dev = require_cuda()
    gpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device=dev)
    cpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")
    audios = [synth_audio(seed=s, words=24) for s in (31, 32)]
    assert gpu.transcribe_batch(audios) == cpu.transcribe_batch(audios)
    n_layers = gpu.cfg.num_layers
    for dtype, shifts in ((torch.float32, 0), (torch.bfloat16, n_layers)):
        before = (rel_pos_bias_shifted.launches, flash_bias_attention.launches)
        got = offline_tokens(gpu, audios, dtype)
        assert (rel_pos_bias_shifted.launches - before[0],
                flash_bias_attention.launches - before[1]) == (shifts, n_layers)
        assert all(got)
        if dtype == torch.float32:
            assert got == offline_tokens(cpu, audios, dtype)


@pytest.mark.cuda
def test_gate_r3_daemon_with_joint_kernel_matches_cpu_engine():
    """Two gate_r3 clients served at once by the port's daemon on the card,
    joint kernel on, started without the warm-up (the stepper loads the
    kernel at its first step): each client's tokens equal the CPU engine's
    on the same audio, and the joint kernel launched."""
    import threading

    from trt_asr_tpu_torch.serve import AsrServer, transcribe
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine

    dev = require_cuda()
    rt = RuntimeConfig(use_pallas_joint=True)
    gpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device=dev)
    cpu = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device="cpu")
    audios = [synth_audio(seed=24, words=5), synth_audio(seed=25, words=7)]
    before = joint_step.launches
    srv = AsrServer(gpu, batch_size=4, runtime=rt).start(warmup=False)
    got = {}
    try:
        threads = [threading.Thread(target=lambda k=k: got.update(
            {k: transcribe(*srv.addr, audios[k], chunk_samples=8000, timeout_s=120)}))
            for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads), "a client did not finish"
    finally:
        srv.stop()
    assert joint_step.launches > before
    eng = BatchStreamingEngine(cpu, batch_size=4, runtime=rt)
    for k, audio in enumerate(audios):
        sid = eng.open_stream()
        eng.push_audio(sid, audio)
        eng.finalize_stream(sid)
        eng.run_until_drained()
        assert got[k]["tokens"] == list(eng._tokens[sid]) and got[k]["tokens"]
        eng.close_stream(sid)
