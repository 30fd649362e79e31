"""Launch plan, weight packing and work split of the int8 joint-step kernel
of the PyTorch port (``ops/kernels/joint_step.py``;
``csrc/joint_step_q8.cu`` checks the same shared-memory layout at launch):
one cooperative launch whose blocks must all be resident, at most one an
SM, each owning a run of 8-column groups of W_out and a few columns of
W_pred, with its weights in shared memory, copied from a packed copy in
which its slice is contiguous. A plain-torch replay of the kernel's split
(h by block columns, K in runs of 64 added in order; logits by block
groups; each block's (max, first index) of its token and duration columns,
merged in block order) is held to ``joint_step_plain``: h within one bf16
ulp (the sums run in another order), the logits of the replay's h at 1e-5
(f32 sums in another order), the tokens and durations equal to the first
argmax of the replay's own logits, and crafted ties across block
boundaries (a duration head cut between two blocks among them) exact. The
kernel itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.quant import keep_bf16_copies
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.kernels.joint_step import (JointPlan, check_packed_joint, joint_step,
                                                      joint_step_bf16_plan, joint_step_plain,
                                                      joint_step_q8_plan, pack_joint,
                                                      pack_joint_step)
from trt_asr_tpu_torch.ops.quant import QuantTensor, quantize_tensor, round_bf16

H100_SMS = 132
# (P, J, V): the card tests' width, tiny (ModelConfig.tiny), gate_r3, full
# width (ModelConfig())
WIDTHS = [(32, 48, 70), (32, 32, 70), (32, 64, 1126), (640, 640, 8198)]


def test_plan_at_full_width_is_one_resident_wave():
    plan = joint_step_q8_plan(8, 640, 640, 8198, H100_SMS)
    assert (plan.blocks, plan.groups, plan.hcols) == (129, 8, 5)
    weights = 5 * 640 + 48 + 8 * 8 * 640 + 2 * 64 * 4     # W_pred's columns; W_out's groups
    staging = 8 * 644 * 4 + 8 * (640 + 16) * 2 + 8 * 64 * 4   # g's rows, h's; a pass's logits
    sums = 16 * 8 * 64 * 4                                  # per-warp sums
    assert plan.smem == weights + staging + sums + 3 * 8 == 110_664
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 16 + 8 * 640 * 2 + 8 * 129 * 16
    assert joint_step_q8_plan(128, 640, 640, 8198, H100_SMS)._replace(scratch=0) == \
        plan._replace(scratch=0)


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, 16, 4, 1])
def test_plan_covers_every_column_once(p, j, v, sms):
    try:
        plan = joint_step_q8_plan(8, p, j, v, sms)
    except ValueError:                            # a wide vocabulary on a few SMs: a block's
        assert v > 1000 and sms <= 16             # groups and their sums do not fit
        return
    groups = -(-v // 8)
    assert plan.blocks <= sms
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
    (8, 640, 640, 8198, 1, "exceeds"),
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(rows, p, j, v, sms, match):
    with pytest.raises(ValueError, match=match):
        joint_step_q8_plan(rows, p, j, v, sms)


def int8_joint(p, j, v, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    return (quantize_tensor(r(p, j, sc=p ** -0.5)), r(j, sc=0.1),
            quantize_tensor(r(j, v, sc=j ** -0.5)), r(v, sc=0.1))


def unpack(packed, plan: JointPlan, p, j, v):
    """The matrices, scales and biases of a packed joint (the inverse of
    ``pack_joint``), and the padding it holds, which must be zero."""
    pp, jp = -(-p // 16) * 16, -(-j // 16) * 16
    hc, cols = plan.hcols, plan.groups * 8
    o_sp = hc * pp
    o_wo = o_sp + -(-8 * hc // 16) * 16
    o_so = o_wo + cols * jp
    blob = packed.numpy()
    wp = blob[:, :o_sp].view(np.int8).reshape(plan.blocks, hc, pp).transpose(2, 0, 1)
    wp = wp.reshape(pp, plan.blocks * hc)
    spb = blob[:, o_sp:o_wo].copy().view(np.float32)
    wo = blob[:, o_wo:o_so].view(np.int8).reshape(plan.blocks, plan.groups, jp // 16, 8, 16)
    wo = wo.transpose(2, 4, 0, 1, 3).reshape(jp, plan.blocks * cols)
    sob = blob[:, o_so:].copy().view(np.float32)
    parts = dict(wp=wp[:p, :j], sp=spb[:, :hc].reshape(-1)[:j], bp=spb[:, hc:2 * hc].reshape(-1)[:j],
                 wo=wo[:j, :v], so=sob[:, :cols].reshape(-1)[:v],
                 bo=sob[:, cols:].reshape(-1)[:v])
    pads = [wp[p:], wp[:, j:], spb[:, 2 * hc:], spb[:, :hc].reshape(-1)[j:],
            wo[j:], wo[:, v:], sob[:, :cols].reshape(-1)[v:]]
    return parts, pads


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, "few"])
def test_packed_blob_reads_back_into_the_matrices(p, j, v, sms):
    sms = (96 if v > 1000 else 5) if sms == "few" else sms
    wp, bp, wo, bo = int8_joint(p, j, v, seed=p + v + sms)
    plan = joint_step_q8_plan(8, p, j, v, sms)
    packed = pack_joint_step(wp, bp, wo, bo, sms=sms)
    assert packed.dtype == torch.uint8 and packed.is_contiguous()
    check_packed_joint(packed, plan, p, j)
    parts, pads = unpack(packed, plan, p, j, v)
    np.testing.assert_array_equal(parts["wp"], wp.q.numpy())
    np.testing.assert_array_equal(parts["wo"], wo.q.numpy())
    for name, want in (("sp", wp.s), ("bp", bp), ("so", wo.s), ("bo", bo)):
        np.testing.assert_array_equal(parts[name], want.reshape(-1).numpy())
    assert all(not np.any(x) for x in pads)


def test_packing_fits_every_rows_count():
    """One packing serves every call: the layout does not depend on rows."""
    wp, bp, wo, bo = int8_joint(32, 64, 1126, seed=3)
    packed = pack_joint_step(wp, bp, wo, bo, sms=H100_SMS)
    for rows in (1, 8, 16, 37, 128):
        check_packed_joint(packed, joint_step_q8_plan(rows, 32, 64, 1126, H100_SMS), 32, 64)


@pytest.mark.parametrize("change", ["sms", "width", "dtype"])
def test_check_packed_joint_refuses_another_layout(change):
    wp, bp, wo, bo = int8_joint(32, 48, 70, seed=4)
    plan = joint_step_q8_plan(8, 32, 48, 70, H100_SMS)
    if change == "sms":
        packed = pack_joint_step(wp, bp, wo, bo, sms=4)
    elif change == "width":
        packed = pack_joint_step(*int8_joint(32, 56, 70, seed=4), sms=H100_SMS)
    else:
        packed = pack_joint_step(wp, bp, wo, bo, sms=H100_SMS).view(torch.int8)
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        check_packed_joint(packed, plan, 32, 48)


def test_pack_joint_step_takes_int8_weights_only():
    """pack_joint_step packs int8, bf16 and f32 weights, each into its own
    layout (int8 and bf16 uint8 of their own widths, f32 f32), and refuses a
    pair of two storage types."""
    wp, bp, wo, bo = int8_joint(32, 48, 70, seed=5)
    q8 = pack_joint_step(wp, bp, wo, bo, sms=H100_SMS)
    fwp, fwo = wp.q.float() * wp.s, wo.q.float() * wo.s
    assert pack_joint_step(fwp, bp, fwo, bo, sms=H100_SMS).dtype == torch.float32
    b16 = pack_joint_step(fwp.bfloat16(), bp, fwo.bfloat16(), bo, sms=H100_SMS)
    assert q8.dtype == b16.dtype == torch.uint8 and q8.shape != b16.shape
    check_packed_joint(b16, joint_step_bf16_plan(8, 32, 48, 70, H100_SMS), 32, 48, "bf16")
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        check_packed_joint(b16, joint_step_q8_plan(8, 32, 48, 70, H100_SMS), 32, 48)
    with pytest.raises(ValueError, match="one storage type"):
        pack_joint_step(fwp, bp, wo, bo, sms=H100_SMS)
    with pytest.raises(ValueError, match="one storage type"):
        pack_joint_step(wp, bp, wo.q.float(), bo, sms=H100_SMS)
    with pytest.raises(ValueError, match="one storage type"):
        pack_joint_step(fwp.bfloat16(), bp, fwo, bo, sms=H100_SMS)


def replay(e, g, wp, bp, wo, bo, ths, ndur, blank, penalty, plan):
    """The kernel's work split in plain torch: (h, logits, tok, dur)."""
    rows, (p, j), v = e.shape[0], wp.q.shape, wo.q.shape[1]
    cols = plan.groups * 8
    a = round_bf16(g)
    h = torch.zeros(rows, j)
    for b in range(plan.blocks):                          # (1) the block's hidden columns
        for n in range(b * plan.hcols, min(j, (b + 1) * plan.hcols)):
            acc = torch.zeros(rows)
            for k0 in range(0, p, 64):                    # runs of 64 rows of K, in order
                acc = acc + a[:, k0:k0 + 64] @ wp.q[k0:k0 + 64, n].float()
            h[:, n] = round_bf16(torch.relu(e[:, n] + acc * wp.s[0, n] + bp[n]))
    logits = torch.zeros(rows, v)
    pairs = []                                            # (2) each block's argmax pairs
    for b in range(plan.blocks):
        c0, c1 = b * cols, min(v, (b + 1) * cols)
        logits[:, c0:c1] = (h @ wo.q[:, c0:c1].float()) * wo.s[0, c0:c1] + bo[c0:c1]
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


# (P, J, V, ths, sms): the card-test width on the H100's SMs and on 4 (a
# duration head 62..66 across blocks 7 and 8 of 8 columns, 46..50 across
# blocks 1 and 2 of 24), tiny, gate_r3
REPLAY = [(32, 48, 70, 62, H100_SMS), (32, 48, 70, 46, 4), (32, 32, 70, 65, H100_SMS),
          (32, 64, 1126, 1121, H100_SMS), (136, 48, 70, 62, 6)]


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY)
@pytest.mark.parametrize("rows", [1, 8, 13])
def test_replay_of_the_kernels_split_matches_plain(p, j, v, ths, sms, rows):
    rng = np.random.default_rng(p + v + rows)
    r = lambda *s, sc=1.0: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    wp, bp, wo, bo = int8_joint(p, j, v, seed=ths + sms)
    e, g = r(rows, j), r(rows, p, sc=0.5)
    ndur, blank = 5, ths - 1
    plan = joint_step_q8_plan(rows, p, j, v, sms)
    h, logits, tok, dur = replay(e, g, wp, bp, wo, bo, ths, ndur, blank, 0.7, plan)
    # the plain version's h, and one bf16 ulp of it
    h_plain = round_bf16(torch.relu(e + (round_bf16(g) @ wp.q.float()) * wp.s.reshape(-1) + bp))
    ulp = torch.exp2(torch.floor(torch.log2(h_plain.abs().clamp_min(1e-30))) - 7)
    assert bool(((h - h_plain).abs() <= ulp).all())
    torch.testing.assert_close(logits, (h @ wo.q.float()) * wo.s.reshape(-1) + bo,
                               atol=1e-5, rtol=1e-5)
    tl = logits[:, :ths].clone()
    tl[:, blank] -= 0.7
    assert torch.equal(tok, tl.argmax(1).to(torch.int32))
    assert torch.equal(dur, logits[:, ths:ths + ndur].argmax(1).to(torch.int32))
    if torch.equal(h, h_plain):
        want = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                                blank_penalty=0.7)
        assert torch.equal(tok, want[0]) and torch.equal(dur, want[1])


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY)
def test_replay_breaks_ties_across_blocks_to_the_first_index(p, j, v, ths, sms):
    """Two token columns in neighbouring blocks and two duration columns on
    either side of a block boundary tie exactly (zero weights: the logits
    are the biases); the blank column alone takes the penalty."""
    rows, ndur, blank = 4, 5, ths - 1
    plan = joint_step_q8_plan(rows, p, j, v, sms)
    cols = plan.groups * 8
    wp, bp, wo, bo = int8_joint(p, j, v, seed=6)
    edge = cols * ((ths + 2) // cols)                     # a block boundary inside the head
    t0, t1 = cols - 1, cols                               # the token tie, blocks 0 and 1
    d0, d1 = (edge - 1, edge) if ths < edge < ths + ndur else (ths + 1, ths + 3)
    q = wo.q.clone()
    q[:, [t0, t1, d0, d1, blank]] = 0
    bo = bo.clone()
    bo[[t0, t1]] = 50.0
    bo[[d0, d1]] = 40.0
    bo[blank] = 50.5
    wo = QuantTensor(q, wo.s)
    e, g = torch.zeros(rows, j), torch.zeros(rows, p)
    for penalty, want in ((1.0, t0), (0.25, blank)):
        _, logits, tok, dur = replay(e, g, wp, bp, wo, bo, ths, ndur, blank, penalty, plan)
        assert tok.tolist() == [want] * rows and dur.tolist() == [d0 - ths] * rows
        plain = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                                 blank_penalty=penalty)
        assert torch.equal(plain[0], tok) and torch.equal(plain[1], dur)
    if sms == 4 or (ths, sms) == (62, H100_SMS):
        assert ths < edge < ths + ndur                    # the head is cut between two blocks


def test_wrapper_ignores_packed_weights_on_cpu():
    wp, bp, wo, bo = int8_joint(32, 48, 70, seed=7)
    rng = np.random.default_rng(8)
    e = torch.as_tensor(rng.standard_normal((8, 48)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((8, 32)).astype(np.float32))
    kw = dict(ths=65, ndur=5, blank_id=64, blank_penalty=0.5)
    before = joint_step.launches
    got = joint_step(e, g, wp, bp, wo, bo, **kw, packed=pack_joint_step(wp, bp, wo, bo, sms=4))
    for a, b in zip(got, joint_step_plain(e, g, wp, bp, wo, bo, **kw)):
        assert torch.equal(a, b)
    assert joint_step.launches == before


def test_model_packs_the_joint_and_keeps_copies_on_the_card_only():
    rt = RuntimeConfig(quant="all", use_pallas_joint=True)
    model = ParakeetTDT.random(ModelConfig.tiny(), seed=1, runtime=rt, device="cpu")
    assert model.joint_packed is None and model.bf16_copy_bytes == 0
    assert keep_bf16_copies(model.params) == 0


def test_pack_joint_matches_pack_joint_step():
    wp, bp, wo, bo = int8_joint(32, 64, 1126, seed=9)
    plan = joint_step_q8_plan(1, 32, 64, 1126, 16)
    assert torch.equal(pack_joint(wp.q, wp.s, bp, wo.q, wo.s, bo, plan),
                       pack_joint_step(wp, bp, wo, bo, sms=16))
