"""Launch plan, weight packing and work split of the bf16 joint-step kernel
of the PyTorch port (``ops/kernels/joint_step.py``;
``csrc/joint_step_bf16.cu`` runs the int8 kernel's body,
``csrc/joint_core.cuh``, on bf16 slices and checks the same shared-memory
layout at launch): one cooperative launch whose blocks must all be
resident, at most one an SM, each owning a run of 8-column groups of W_out
and a few columns of W_pred, its bf16 slices (no scales) and f32 biases
whole in shared memory, copied from a packed copy in which its slice is
contiguous. A plain-torch replay of the kernel's split, reading the packed
bf16 slices (h by block columns, K in runs of 64 added in order; logits by
block groups, K in the runs of the warps that share a group, added in
order; each block's (max, first index) of its token and duration columns,
merged in block order), is held to ``joint_step_plain``: h within one bf16
ulp (the sums run in another order), the logits of the replay's h at 1e-5
(f32 sums of exact bf16 products in another order), the tokens and
durations equal to the first argmax of the replay's own logits, and where
h equals the plain version's, the logits at 1e-4 and the tokens and
durations equal to the plain version's; crafted ties across block
boundaries (a duration head cut between two blocks among them) exact. The
replay is held the same way to the JAX package's ``joint_step_pallas`` in
interpret mode with the bf16 weights and biases of
``cast_params_for_compute``. The kernel itself is held against its plain
version on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``
phase 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trt_asr_tpu.ops.pallas.joint_step_kernel import joint_step_pallas
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels.joint_step import (JointPlan, check_packed_joint, joint_step,
                                                      joint_step_bf16_plan, joint_step_plain,
                                                      joint_step_q8_plan, pack_joint,
                                                      pack_joint_step)
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.quant import quantize_tensor, round_bf16

H100_SMS = 132
bf16 = torch.bfloat16
# (P, J, V): the card tests' width, tiny (ModelConfig.tiny), gate_r3, full
# width (ModelConfig())
WIDTHS = [(32, 48, 70), (32, 32, 70), (32, 64, 1126), (640, 640, 8198)]


def test_plan_at_full_width_is_one_resident_wave():
    """The int8 plan's 129 blocks of 8 groups and 5 hidden columns, with
    bf16 slices (twice int8's 24.5 KB) and no scales: 154,552 B, one block
    an SM, where the int8 kernel's 110,664 B hold two."""
    plan = joint_step_bf16_plan(8, 640, 640, 8198, H100_SMS)
    assert (plan.blocks, plan.groups, plan.hcols) == (129, 8, 5)
    weights = (5 * 640 + 8 * 8 * 640) * 2 + 32 + 64 * 4    # bf16 slices; b_pred, b_out
    staging = 8 * 644 * 4 + 8 * (640 + 16) * 2 + 8 * 64 * 4   # g's rows, h's; a pass's logits
    sums = 16 * 8 * 64 * 4                                  # per-warp sums
    assert plan.smem == weights + staging + sums + 3 * 8 == 154_552
    q8 = joint_step_q8_plan(8, 640, 640, 8198, H100_SMS)
    assert plan._replace(smem=0) == q8._replace(smem=0)
    assert plan.smem <= SMEM_PER_BLOCK and 2 * (plan.smem + 1024) > 228 * 1024
    assert 2 * (q8.smem + 1024) <= 228 * 1024
    assert joint_step_bf16_plan(128, 640, 640, 8198, H100_SMS)._replace(scratch=0) == \
        plan._replace(scratch=0)


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, 16, 4])
def test_plan_covers_every_column_once(p, j, v, sms):
    try:
        plan = joint_step_bf16_plan(8, p, j, v, sms)
    except ValueError:                            # a wide vocabulary on a few SMs: a block's
        assert v > 1000 and sms <= 16             # groups and their sums do not fit
        return
    groups = -(-v // 8)
    assert plan.blocks <= sms and plan.smem <= SMEM_PER_BLOCK
    owned = [list(range(b * plan.groups, min(groups, (b + 1) * plan.groups)))
             for b in range(plan.blocks)]
    assert all(owned) and sum(owned, []) == list(range(groups))
    hidden = [n for b in range(plan.blocks) for n in range(b * plan.hcols, (b + 1) * plan.hcols)
              if n < j]
    assert hidden == list(range(j))


@pytest.mark.parametrize("rows,p,j,v,sms,match", [
    (8, 30, 48, 70, 132, "P a multiple of 4"),
    (8, 32, 44, 70, 132, "J one of 8"),
    (0, 32, 48, 70, 132, "rows >= 1"),
    (8, 640, 640, 8198, 64, "exceeds"),           # 17 groups a block: 170 KB of bf16 slices
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(rows, p, j, v, sms, match):
    with pytest.raises(ValueError, match=match):
        joint_step_bf16_plan(rows, p, j, v, sms)


def bf16_joint(p, j, v, seed):
    """bf16 weights and biases, as ``cast_params_for_compute`` leaves them."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    return (r(p, j, sc=p ** -0.5).to(bf16), r(j, sc=0.1).to(bf16),
            r(j, v, sc=j ** -0.5).to(bf16), r(v, sc=0.1).to(bf16))


def unpack(packed, plan: JointPlan, p, j, v):
    """The matrices and biases of a packed bf16 joint (the inverse of
    ``pack_joint`` without scales), and the padding it holds, which must be
    zero."""
    pp, jp = -(-p // 16) * 16, -(-j // 16) * 16
    hc, cols, nb = plan.hcols, plan.groups * 8, plan.blocks
    o_bp = hc * pp * 2
    o_wo = o_bp + -(-4 * hc // 16) * 16
    o_bo = o_wo + cols * jp * 2
    assert packed.shape == (nb, o_bo + cols * 4)
    wp = packed[:, :o_bp].contiguous().view(bf16).reshape(nb, hc, pp).permute(2, 0, 1)
    wp = wp.reshape(pp, nb * hc)
    bpb = packed[:, o_bp:o_wo].contiguous().view(torch.float32)
    wo = packed[:, o_wo:o_bo].contiguous().view(bf16).reshape(nb, plan.groups, jp // 16, 8, 16)
    wo = wo.permute(2, 4, 0, 1, 3).reshape(jp, nb * cols)
    bo = packed[:, o_bo:].contiguous().view(torch.float32).reshape(-1)
    parts = dict(wp=wp[:p, :j], bp=bpb[:, :hc].reshape(-1)[:j], wo=wo[:j, :v], bo=bo[:v])
    pads = [wp[p:], wp[:, j:], bpb[:, hc:], bpb[:, :hc].reshape(-1)[j:], wo[j:], wo[:, v:],
            bo[v:]]
    return parts, pads


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, "few"])
def test_packed_blob_reads_back_into_the_matrices(p, j, v, sms):
    sms = (96 if v > 1000 else 5) if sms == "few" else sms
    wp, bp, wo, bo = bf16_joint(p, j, v, seed=p + v + sms)
    plan = joint_step_bf16_plan(8, p, j, v, sms)
    packed = pack_joint_step(wp, bp, wo, bo, sms=sms)
    assert packed.dtype == torch.uint8 and packed.is_contiguous()
    check_packed_joint(packed, plan, p, j, "bf16")
    parts, pads = unpack(packed, plan, p, j, v)
    for name, want in (("wp", wp), ("wo", wo), ("bp", bp.float()), ("bo", bo.float())):
        assert torch.equal(parts[name], want), name
    assert all(not x.any() for x in pads)
    for rows in (1, 13, 48, 128):                  # one packing serves every call
        check_packed_joint(packed, joint_step_bf16_plan(rows, p, j, v, sms), p, j, "bf16")


@pytest.mark.parametrize("change", ["sms", "width", "int8_layout", "f32_layout", "int8_plan"])
def test_check_packed_joint_refuses_another_layout(change):
    wp, bp, wo, bo = bf16_joint(32, 48, 70, seed=4)
    plan, kind = joint_step_bf16_plan(8, 32, 48, 70, H100_SMS), "bf16"
    packed = pack_joint_step(wp, bp, wo, bo, sms=H100_SMS)
    if change == "sms":
        packed = pack_joint_step(wp, bp, wo, bo, sms=4)
    elif change == "width":
        packed = pack_joint_step(*bf16_joint(32, 56, 70, seed=4), sms=H100_SMS)
    elif change == "int8_layout":
        packed = pack_joint_step(quantize_tensor(wp.float()), bp, quantize_tensor(wo.float()), bo,
                                 sms=H100_SMS)
    elif change == "f32_layout":
        packed = pack_joint_step(wp.float(), bp, wo.float(), bo, sms=H100_SMS)
    else:                                        # the bf16 copy read with the int8 layout
        plan, kind = joint_step_q8_plan(8, 32, 48, 70, H100_SMS), "int8"
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        check_packed_joint(packed, plan, 32, 48, kind)


def test_pack_joint_matches_pack_joint_step():
    wp, bp, wo, bo = bf16_joint(32, 64, 1126, seed=9)
    plan = joint_step_bf16_plan(1, 32, 64, 1126, 16)
    assert torch.equal(pack_joint(wp, None, bp.float(), wo, None, bo.float(), plan),
                       pack_joint_step(wp, bp, wo, bo, sms=16))


def out_runs(h, w, groups):
    """h @ w (one block's groups) as joint_product sums it: K in the runs of
    the warps that share a group (16 / groups runs, or one from 16 groups
    on), whole mma steps each, the runs added in order."""
    k = h.shape[1]
    steps = -(-k // 16)
    kparts = 16 // groups if groups < 16 else 1
    per = -(-steps // kparts)
    out = torch.zeros(h.shape[0], w.shape[1])
    for s0 in range(0, steps, per):
        ks = slice(16 * s0, min(k, 16 * (s0 + per)))
        out = out + h[:, ks] @ w[ks].float()
    return out


def replay(e, g, packed, plan, p, j, v, ths, ndur, blank, penalty, rounded=True):
    """The kernel's work split in plain torch on the packed bf16 slices:
    (h, logits, tok, dur). ``rounded=False`` skips the bf16 rounding points
    of g and h."""
    rnd = round_bf16 if rounded else (lambda t: t)
    parts, _ = unpack(packed, plan, p, j, v)
    rows, cols = e.shape[0], plan.groups * 8
    a = rnd(g)
    h = torch.zeros(rows, j)
    for b in range(plan.blocks):                          # (1) the block's hidden columns
        for n in range(b * plan.hcols, min(j, (b + 1) * plan.hcols)):
            acc = torch.zeros(rows)
            for k0 in range(0, p, 64):                    # runs of 64 rows of K, in order
                acc = acc + a[:, k0:k0 + 64] @ parts["wp"][k0:k0 + 64, n].float()
            h[:, n] = rnd(torch.relu(e[:, n] + acc + parts["bp"][n]))
    logits = torch.zeros(rows, v)
    pairs = []                                            # (2) each block's argmax pairs
    for b in range(plan.blocks):
        c0, c1 = b * cols, min(v, (b + 1) * cols)
        logits[:, c0:c1] = out_runs(h, parts["wo"][:, c0:c1], plan.groups) + parts["bo"][c0:c1]
        tok = logits[:, c0:min(c1, ths)].clone()
        if c0 <= blank < c1:
            tok[:, blank - c0] -= penalty
        dur = logits[:, max(c0, ths):min(c1, ths + ndur)]
        pairs.append([(float(tok[r].max()), c0 + int(tok[r].argmax())) if tok.shape[1]
                      else (-np.inf, 2 ** 31 - 1) for r in range(rows)]
                     + [(float(dur[r].max()), max(c0, ths) + int(dur[r].argmax())) if dur.shape[1]
                        else (-np.inf, 2 ** 31 - 1) for r in range(rows)])
    best = pairs[0]                                       # (3) merged in block order
    for blk in pairs[1:]:
        best = [o if o[0] > m[0] or (o[0] == m[0] and o[1] < m[1]) else m
                for m, o in zip(best, blk)]
    tok = torch.tensor([i for _, i in best[:rows]], dtype=torch.int32)
    dur = torch.tensor([i - ths for _, i in best[rows:]], dtype=torch.int32)
    return h, logits, tok, dur


def check_replay(h, logits, tok, dur, want, h_plain, ths, ndur, blank, penalty):
    """The replay against a reference's (tok, dur, logits) with h_plain its
    h: h within one bf16 ulp, the logits of the replay's own h, its argmaxes,
    and, where h equals h_plain (True is returned; at this file's seeds it
    does everywhere), the reference's logits at 1e-4 and its tokens and
    durations."""
    ulp = torch.exp2(torch.floor(torch.log2(h_plain.abs().clamp_min(1e-30))) - 7)
    assert bool(((h - h_plain).abs() <= ulp).all())
    tl = logits[:, :ths].clone()
    tl[:, blank] -= penalty
    assert torch.equal(tok, tl.argmax(1).to(torch.int32))
    assert torch.equal(dur, logits[:, ths:ths + ndur].argmax(1).to(torch.int32))
    if torch.equal(h, h_plain):
        torch.testing.assert_close(logits, want[2], atol=1e-4, rtol=1e-4)
        assert torch.equal(tok, want[0]) and torch.equal(dur, want[1])
        return True
    return False


# (P, J, V, ths, sms): the card-test width on the H100's SMs and on 4 (a
# duration head 62..66 across blocks 7 and 8 of 8 columns, 46..50 across
# blocks 1 and 2 of 24), tiny, gate_r3, a P of three runs of 64
REPLAY = [(32, 48, 70, 62, H100_SMS), (32, 48, 70, 46, 4), (32, 32, 70, 65, H100_SMS),
          (32, 64, 1126, 1121, H100_SMS), (136, 48, 70, 62, 6)]


def inputs(rows, p, j, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return r(rows, j), r(rows, p, sc=0.5)


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY)
@pytest.mark.parametrize("rows", [1, 8, 13])
def test_replay_of_the_kernels_split_matches_plain(p, j, v, ths, sms, rows):
    e, g = (torch.as_tensor(a) for a in inputs(rows, p, j, p + v + rows))
    wp, bp, wo, bo = bf16_joint(p, j, v, seed=ths + sms)
    ndur, blank = 5, ths - 1
    plan = joint_step_bf16_plan(rows, p, j, v, sms)
    packed = pack_joint_step(wp, bp, wo, bo, sms=sms)
    h, logits, tok, dur = replay(e, g, packed, plan, p, j, v, ths, ndur, blank, 0.7)
    h_plain = round_bf16(torch.relu(e + round_bf16(g) @ wp.float() + bp.float()))
    torch.testing.assert_close(logits, h @ wo.float() + bo.float(), atol=1e-5, rtol=1e-5)
    want = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                            blank_penalty=0.7)
    assert check_replay(h, logits, tok, dur, want, h_plain, ths, ndur, blank, 0.7)


def test_replay_sees_the_rounding_points():
    """The logits' 1e-4 tells the replay from one without the bf16 rounding
    points of g and h."""
    p, j, v, ths = 32, 64, 1126, 1121
    e, g = (torch.as_tensor(a) for a in inputs(8, p, j, 3))
    wp, bp, wo, bo = bf16_joint(p, j, v, seed=3)
    plan = joint_step_bf16_plan(8, p, j, v, H100_SMS)
    packed = pack_joint_step(wp, bp, wo, bo, sms=H100_SMS)
    got = replay(e, g, packed, plan, p, j, v, ths, 5, ths - 1, 0.0)[1]
    unrounded = replay(e, g, packed, plan, p, j, v, ths, 5, ths - 1, 0.0, rounded=False)[1]
    assert float((got - unrounded).abs().max()) > 10 * 1e-4


@pytest.mark.parametrize("p,j,v,ths", [(32, 48, 70, 65), (32, 64, 1126, 1121)])
@pytest.mark.parametrize("rows", [1, 8, 13])
@pytest.mark.parametrize("penalty", [0.0, 1.5])
def test_replay_matches_pallas_interpret(p, j, v, ths, rows, penalty):
    """The card tests' width and gate_r3's (P 32, J 64, V 1126) with the
    bf16 weights and biases of ``cast_params_for_compute``."""
    ndur, blank = v - ths, ths - 1
    e, g = inputs(rows, p, j, rows + v)
    wp, bp, wo, bo = bf16_joint(p, j, v, seed=rows + p)
    jb = lambda w: jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    jtok, jdur, jlogits = joint_step_pallas(jnp.asarray(e), jnp.asarray(g), jb(wp), jb(bp),
                                            jb(wo), jb(bo), ths=ths, ndur=ndur, blank_id=blank,
                                            blank_penalty=penalty, interpret=True)
    want = tuple(torch.as_tensor(np.array(x)) for x in (jtok, jdur, jlogits))
    e, g = torch.as_tensor(e), torch.as_tensor(g)
    plan = joint_step_bf16_plan(rows, p, j, v, H100_SMS)
    h, logits, tok, dur = replay(e, g, pack_joint_step(wp, bp, wo, bo, sms=H100_SMS), plan, p, j,
                                 v, ths, ndur, blank, penalty)
    h_plain = round_bf16(torch.relu(e + round_bf16(g) @ wp.float() + bp.float()))
    assert check_replay(h, logits, tok, dur, want, h_plain, ths, ndur, blank, penalty)


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY[:2])
def test_replay_breaks_ties_across_blocks_to_the_first_index(p, j, v, ths, sms):
    """Two token columns in neighbouring blocks and two duration columns on
    either side of a block boundary tie exactly (zero weights: the logits
    are the biases); the blank column alone takes the penalty."""
    rows, ndur, blank = 4, 5, ths - 1
    plan = joint_step_bf16_plan(rows, p, j, v, sms)
    cols = plan.groups * 8
    wp, bp, wo, bo = bf16_joint(p, j, v, seed=6)
    edge = cols * ((ths + 2) // cols)                     # a block boundary inside the head
    t0, t1 = cols - 1, cols                               # the token tie, blocks 0 and 1
    d0, d1 = (edge - 1, edge) if ths < edge < ths + ndur else (ths + 1, ths + 3)
    wo = wo.clone()
    wo[:, [t0, t1, d0, d1, blank]] = 0
    bo = bo.clone()
    bo[[t0, t1]] = 50.0
    bo[[d0, d1]] = 40.0
    bo[blank] = 50.5
    e, g = torch.zeros(rows, j), torch.zeros(rows, p)
    packed = pack_joint_step(wp, bp, wo, bo, sms=sms)
    for penalty, want in ((1.0, t0), (0.25, blank)):
        _, _, tok, dur = replay(e, g, packed, plan, p, j, v, ths, ndur, blank, penalty)
        assert tok.tolist() == [want] * rows and dur.tolist() == [d0 - ths] * rows
        plain = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                                 blank_penalty=penalty)
        assert torch.equal(plain[0], tok) and torch.equal(plain[1], dur)
    assert ths < edge < ths + ndur                        # the head is cut between two blocks


def test_wrapper_ignores_packed_weights_on_cpu():
    wp, bp, wo, bo = bf16_joint(32, 48, 70, seed=7)
    e, g = (torch.as_tensor(a) for a in inputs(8, 32, 48, 8))
    kw = dict(ths=65, ndur=5, blank_id=64, blank_penalty=0.5)
    before = joint_step.launches
    got = joint_step(e, g, wp, bp, wo, bo, **kw, packed=pack_joint_step(wp, bp, wo, bo, sms=4))
    for a, b in zip(got, joint_step_plain(e, g, wp, bp, wo, bo, **kw)):
        assert torch.equal(a, b)
    assert joint_step.launches == before


def test_model_packs_the_bf16_joint_on_the_card_only():
    """The weights of ``cast_params_for_compute`` with the joint kernel on:
    on the CPU nothing is packed (the wrapper runs its plain version); the
    card tests hold the model's packed copy (``test_torch_kernels_cuda.py``)."""
    rt = RuntimeConfig(use_pallas_joint=True)
    model = ParakeetTDT.random(ModelConfig.tiny(), seed=1, runtime=rt, device="cpu")
    assert model.joint_packed is None
    cast = ParakeetTDT(model.cfg, model.params, model.tokenizer, runtime=rt, device="cpu",
                       weights_dtype=bf16)
    assert cast.params["joint"]["out"]["w"].dtype == bf16 and cast.joint_packed is None
