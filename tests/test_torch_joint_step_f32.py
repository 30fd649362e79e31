"""Launch plan, weight packing and work split of the f32 joint-step kernel
of the PyTorch port (``ops/kernels/joint_step.py``;
``csrc/joint_step_f32.cu`` checks the same shared-memory layout at launch):
one cooperative launch whose blocks must all be resident, at most one an
SM, each owning a run of 8-column groups of W_out and a few columns of
W_pred, its whole f32 slice in shared memory, copied from a packed copy in
which the slice is contiguous. A plain-torch replay of the kernel's split
(h by block columns, K in runs of 64 added in order; the logits by block
groups, K cut into 16 ranges, one a warp, added in order; each block's
(max, first index) of its token and duration columns, merged in block
order) is held to ``joint_step_plain``: h and the logits at 1e-5 (f32 sums
in another order), the tokens and durations equal to the first argmax of
the replay's own logits and, where the margins are clear, to the plain
version's; crafted ties across block boundaries (a duration head cut
between two blocks among them) exact. The kernel itself is held against
its plain version on the card (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.kernels.joint_step import (JointPlan, check_packed_joint,
                                                      joint_step,
                                                      joint_step_f32_plan, joint_step_plain,
                                                      pack_joint_f32, pack_joint_step)

H100_SMS = 132
# (P, J, V): the card tests' width, tiny (ModelConfig.tiny), gate_r3, full
# width (ModelConfig())
WIDTHS = [(32, 48, 70), (32, 32, 70), (32, 64, 1126), (640, 640, 8198)]


def test_plan_at_full_width_is_one_resident_wave():
    plan = joint_step_f32_plan(8, 640, 640, 8198, H100_SMS)
    assert (plan.blocks, plan.groups, plan.hcols) == (129, 8, 5)
    slice_ = 4 * (5 * 640 + 8 + 64 + 640 * 64)            # W_pred's columns, biases, W_out's
    staging = 8 * 644 * 4                                 # g's rows, then h's
    sums = 16 * 8 * 64 * 4                                # each warp's sums, 8 rows x 64 columns
    bars = (3 + 16) * 8                                   # W_pred, g, W_out's half; a late warp's
    assert plan.smem == slice_ + staging + sums + bars == 230_456
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 16 + 8 * 640 * 4 + 8 * 129 * 16
    assert joint_step_f32_plan(128, 640, 640, 8198, H100_SMS)._replace(scratch=0) == \
        plan._replace(scratch=0)


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, 16, 4, 1])
def test_plan_covers_every_column_once(p, j, v, sms):
    groups = -(-v // 8)
    try:
        plan = joint_step_f32_plan(8, p, j, v, sms)
    except ValueError:                            # a block would take more than 8 groups
        assert -(-groups // sms) > 8
        return
    assert plan.blocks <= sms and plan.smem <= SMEM_PER_BLOCK and plan.groups <= 8
    owned = [list(range(b * plan.groups, min(groups, (b + 1) * plan.groups)))
             for b in range(plan.blocks)]
    assert all(owned) and sum(owned, []) == list(range(groups))
    hidden = [n for b in range(plan.blocks) for n in range(b * plan.hcols, (b + 1) * plan.hcols)
              if n < j]
    assert hidden == list(range(j))
    # every float4 step of K lies in exactly one warp's range
    steps = j // 4
    per = -(-steps // 16)
    covered = [s for w in range(16) for s in range(min(steps, w * per), min(steps, w * per + per))]
    assert covered == list(range(steps))


@pytest.mark.parametrize("rows,p,j,v,sms,match", [
    (8, 30, 48, 70, 132, "P a multiple of 4"),
    (8, 32, 44, 70, 132, "J one of 8"),
    (0, 32, 48, 70, 132, "rows >= 1"),
    (8, 640, 1024, 8198, 132, "exceeds"),
    (8, 32, 48, 1126, 16, "at most 8"),
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(rows, p, j, v, sms, match):
    with pytest.raises(ValueError, match=match):
        joint_step_f32_plan(rows, p, j, v, sms)


def f32_joint(p, j, v, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    return r(p, j, sc=p ** -0.5), r(j, sc=0.1), r(j, v, sc=j ** -0.5), r(v, sc=0.1)


def unpack(packed, plan: JointPlan, p, j, v):
    """The matrices and biases of a packed f32 joint (the inverse of
    ``pack_joint_f32``), and the padding it holds, which must be zero."""
    hc, cols, blocks = plan.hcols, plan.groups * 8, plan.blocks
    o_bp = hc * p
    o_bo = o_bp + -(-hc // 4) * 4
    o_wo = o_bo + cols
    blob = packed.numpy()
    wp = blob[:, :o_bp].reshape(blocks, hc, p).transpose(2, 0, 1).reshape(p, blocks * hc)
    bp = blob[:, o_bp:o_bp + hc].reshape(-1)
    bo = blob[:, o_bo:o_wo].reshape(-1)
    wo = blob[:, o_wo:].reshape(blocks, j // 4, cols, 4).transpose(1, 3, 0, 2)
    wo = wo.reshape(j, blocks * cols)
    parts = dict(wp=wp[:, :j], bp=bp[:j], wo=wo[:, :v], bo=bo[:v])
    pads = [wp[:, j:], bp[j:], blob[:, o_bp + hc:o_bo], bo[v:], wo[:, v:]]
    return parts, pads


@pytest.mark.parametrize("p,j,v", WIDTHS)
@pytest.mark.parametrize("sms", [H100_SMS, "few"])
def test_packed_blob_reads_back_into_the_matrices(p, j, v, sms):
    sms = {70: 5, 1126: 112, 8198: 130}[v] if sms == "few" else sms   # 130: 129 blocks, 8 groups
    wp, bp, wo, bo = f32_joint(p, j, v, seed=p + v + sms)
    plan = joint_step_f32_plan(8, p, j, v, sms)
    packed = pack_joint_step(wp, bp, wo, bo, sms=sms)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    check_packed_joint(packed, plan, p, j, "f32")
    parts, pads = unpack(packed, plan, p, j, v)
    for name, want in (("wp", wp), ("bp", bp), ("wo", wo), ("bo", bo)):
        np.testing.assert_array_equal(parts[name], want.numpy())
    assert all(not np.any(x) for x in pads)


@pytest.mark.parametrize("change", ["sms", "width", "int8"])
def test_check_packed_joint_refuses_another_layout(change):
    from trt_asr_tpu_torch.ops.quant import quantize_tensor

    wp, bp, wo, bo = f32_joint(32, 48, 70, seed=4)
    plan = joint_step_f32_plan(8, 32, 48, 70, H100_SMS)
    if change == "sms":
        packed = pack_joint_step(wp, bp, wo, bo, sms=4)
    elif change == "width":
        packed = pack_joint_step(*f32_joint(32, 56, 70, seed=4), sms=H100_SMS)
    else:
        packed = pack_joint_step(quantize_tensor(wp), bp, quantize_tensor(wo), bo, sms=H100_SMS)
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        check_packed_joint(packed, plan, 32, 48, "f32")


def replay(e, g, wp, bp, wo, bo, ths, ndur, blank, penalty, plan):
    """The f32 kernel's work split in plain torch: (h, logits, tok, dur)."""
    rows, (p, j), v = e.shape[0], wp.shape, wo.shape[1]
    cols, steps = plan.groups * 8, j // 4
    h = torch.zeros(rows, j)
    for b in range(plan.blocks):                          # (1) the block's hidden columns
        for n in range(b * plan.hcols, min(j, (b + 1) * plan.hcols)):
            acc = torch.zeros(rows)
            for k0 in range(0, p, 64):                    # runs of 64 rows of K, in order
                acc = acc + g[:, k0:k0 + 64] @ wp[k0:k0 + 64, n]
            h[:, n] = torch.relu((e[:, n] + acc) + bp[n])
    # (2) the logits: K cut into 16 ranges, one a warp, added in order
    per = -(-steps // 16)
    total = torch.zeros(rows, v)
    for w in range(16):
        s0, s1 = min(steps, w * per), min(steps, w * per + per)
        total = total + h[:, 4 * s0:4 * s1] @ wo[4 * s0:4 * s1]
    logits = total + bo
    pairs = []                                            # each block's argmax pairs
    for b in range(plan.blocks):
        c0, c1 = b * cols, min(v, (b + 1) * cols)
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
# blocks 1 and 2 of 24), tiny, gate_r3, and a J of 8 one-step K ranges (8 more empty)
REPLAY = [(32, 48, 70, 62, H100_SMS), (32, 48, 70, 46, 4), (32, 32, 70, 65, H100_SMS),
          (32, 64, 1126, 1121, H100_SMS), (136, 48, 70, 62, 6), (8, 32, 40, 33, 5)]


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY)
@pytest.mark.parametrize("rows", [1, 8, 13])
def test_replay_of_the_kernels_split_matches_plain(p, j, v, ths, sms, rows):
    rng = np.random.default_rng(p + v + rows)
    r = lambda *s, sc=1.0: torch.as_tensor((rng.standard_normal(s) * sc).astype(np.float32))  # noqa: E731
    wp, bp, wo, bo = f32_joint(p, j, v, seed=ths + sms)
    e, g = r(rows, j), r(rows, p, sc=0.5)
    ndur, blank = 5, ths - 1
    plan = joint_step_f32_plan(rows, p, j, v, sms)
    h, logits, tok, dur = replay(e, g, wp, bp, wo, bo, ths, ndur, blank, 0.7, plan)
    want = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                            blank_penalty=0.7)
    torch.testing.assert_close(h, torch.relu(e + g @ wp + bp), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits, want[2], atol=1e-5, rtol=1e-5)
    tl = logits[:, :ths].clone()
    tl[:, blank] -= 0.7
    assert torch.equal(tok, tl.argmax(1).to(torch.int32))
    assert torch.equal(dur, logits[:, ths:ths + ndur].argmax(1).to(torch.int32))
    # where the plain version's top two lie apart, the picks are the same
    for a, b, lg in ((tok, want[0], tl), (dur, want[1], want[2][:, ths:ths + ndur])):
        top2 = torch.topk(lg, 2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-4
        assert bool(((a == b) | ~clear).all())


@pytest.mark.parametrize("p,j,v,ths,sms", REPLAY)
def test_replay_breaks_ties_across_blocks_to_the_first_index(p, j, v, ths, sms):
    """Two token columns in neighbouring blocks and two duration columns on
    either side of a block boundary tie exactly (zero weights: the logits
    are the biases); the blank column alone takes the penalty."""
    rows, ndur, blank = 4, 5, ths - 1
    plan = joint_step_f32_plan(rows, p, j, v, sms)
    cols = plan.groups * 8
    wp, bp, wo, bo = f32_joint(p, j, v, seed=6)
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
    for penalty, want in ((1.0, t0), (0.25, blank)):
        _, logits, tok, dur = replay(e, g, wp, bp, wo, bo, ths, ndur, blank, penalty, plan)
        assert tok.tolist() == [want] * rows and dur.tolist() == [d0 - ths] * rows
        plain = joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur, blank_id=blank,
                                 blank_penalty=penalty)
        assert torch.equal(plain[0], tok) and torch.equal(plain[1], dur)
    if sms == 4 or (ths, sms) == (62, H100_SMS):
        assert ths < edge < ths + ndur                    # the head is cut between two blocks


def test_wrapper_ignores_packed_weights_on_cpu():
    wp, bp, wo, bo = f32_joint(32, 48, 70, seed=7)
    rng = np.random.default_rng(8)
    e = torch.as_tensor(rng.standard_normal((8, 48)).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal((8, 32)).astype(np.float32))
    kw = dict(ths=65, ndur=5, blank_id=64, blank_penalty=0.5)
    before = joint_step.launches
    got = joint_step(e, g, wp, bp, wo, bo, **kw, packed=pack_joint_step(wp, bp, wo, bo, sms=4))
    for a, b in zip(got, joint_step_plain(e, g, wp, bp, wo, bo, **kw)):
        assert torch.equal(a, b)
    assert joint_step.launches == before


def test_model_packs_the_f32_joint_on_the_card_only():
    rt = RuntimeConfig(use_pallas_joint=True)
    model = ParakeetTDT.random(ModelConfig.tiny(), seed=1, runtime=rt, device="cpu")
    assert model.joint_packed is None


def test_pack_joint_f32_matches_pack_joint_step():
    wp, bp, wo, bo = f32_joint(32, 64, 1126, seed=9)
    plan = joint_step_f32_plan(1, 32, 64, 1126, 20)
    assert torch.equal(pack_joint_f32(wp, bp, wo, bo, plan),
                       pack_joint_step(wp, bp, wo, bo, sms=20))
