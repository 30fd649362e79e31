"""Host time of one call of the fused int8 tail's wrapper (``conv_ffn_ln``),
of the attention block's with int8 and with f32 weights (``att_block``), of
the joint step's with int8 weights (``joint_step``; and, where the package
has it, its three-launch route ``joint_step_chain``) and of the conv
module's with int8 and with f32 weights (``conv_block``), at the main
path's full-width shapes (a steady chunk: Tq 8 with 6 valid steps, D 1024,
E 4096, a 9-tap conv, H 8, a full ring of 256, int8 weights unless named;
the joint at 8 rows, P = J = 640, V 8198), for the port package of the
directory it is run from. To compare two trees on one card, run it in each
in turn:

    cd TREE && python3 PATH/TO/host_enqueue.py

Each wrapper is called 20 times between device syncs, 400 calls after a
warm-up; the host clock around each call (its Python checks, scratch
allocations and launches) gives the median and quartiles in us. Where the
package packs the tail's constants, the attention weights or the joint's
beforehand (``pack_conv_ffn_ln``, ``pack_att_block``; f32 attention weights
where it has ``att_block_f32_plan``; ``pack_joint_step``;
``pack_conv_block``), they are packed once, as the model does, and passed
to every call.
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.getcwd())      # the package of the tree it is run from

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("host_enqueue: no CUDA device", file=sys.stderr)
        return 1
    from trt_asr_tpu_torch.ops.kernels import att_block as ab
    from trt_asr_tpu_torch.ops.kernels import conv_block as cb
    from trt_asr_tpu_torch.ops.kernels import joint_step as js
    from trt_asr_tpu_torch.ops.quant import quantize_tensor

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    t = lambda *s, sc=1.0: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(s) * sc).astype(np.float32), device=dev)
    d, e, kk, tq = 1024, 4096, 9, 8
    conv = (t(tq, d), 1.0 + t(d, sc=0.1), t(d, sc=0.1), quantize_tensor(t(d, 2 * d, sc=d ** -0.5)),
            t(kk, d, sc=kk ** -0.5), 1.0 + t(d, sc=0.1), t(d, sc=0.1), t(d, sc=0.1),
            1.0 + t(d, sc=0.1).abs(), quantize_tensor(t(d, d, sc=d ** -0.5)),
            t((kk - 1) // 2, d), (torch.arange(tq, device=dev) < 6).float()[:, None])
    tail = (1.0 + t(d, sc=0.1), t(d, sc=0.1), quantize_tensor(t(d, e, sc=d ** -0.5)),
            quantize_tensor(t(e, d, sc=e ** -0.5)), 1.0 + t(d, sc=0.1), t(d, sc=0.1))
    kw = {}
    if hasattr(cb, "pack_conv_ffn_ln"):
        kw["packed"] = cb.pack_conv_ffn_ln(*conv[3:10], *tail[2:4])
    h, c = 8, 256
    att = (t(tq, d), 1.0 + t(d, sc=0.1), t(d, sc=0.1),
           *[quantize_tensor(t(d, d, sc=d ** -0.5)) for _ in range(4)], t(h, d // h, sc=0.3),
           t(h, d // h, sc=0.3), t(2 * tq + c - 1, d), t(c, 2 * d),
           torch.tensor([100, c, 6], dtype=torch.int32, device=dev))
    att_kw = {"packed": ab.pack_att_block(*att[3:7])} if hasattr(ab, "pack_att_block") else {}
    att_f32 = (*att[:3], *[t(d, d, sc=d ** -0.5) for _ in range(4)], *att[7:])
    f32_kw = ({"packed": ab.pack_att_block(*att_f32[3:7])}
              if hasattr(ab, "att_block_f32_plan") else {})
    p, j, v = 640, 640, 8198
    joint = (t(tq, j), t(tq, p, sc=0.5), quantize_tensor(t(p, j, sc=p ** -0.5)), t(j, sc=0.1),
             quantize_tensor(t(j, v, sc=j ** -0.5)), t(v, sc=0.1))
    jkw = dict(ths=8193, ndur=5, blank_id=8192, blank_penalty=0.5)
    joint_kw = ({"packed": js.pack_joint_step(*joint[2:])}
                if hasattr(js, "pack_joint_step") else {})
    conv_f32 = (*conv[:3], t(d, 2 * d, sc=d ** -0.5), *conv[4:9], t(d, d, sc=d ** -0.5),
                *conv[10:])
    conv_kw = {arm: {"packed": cb.pack_conv_block(*args[3:10])}
               if hasattr(cb, "pack_conv_block") else {}
               for arm, args in (("int8", conv), ("f32", conv_f32))}
    calls = {"conv_ffn_ln": lambda: cb.conv_ffn_ln(*conv, *tail, **kw),
             "att_block": lambda: ab.att_block(*att, n_heads=h, **att_kw),
             "att_block[f32]": lambda: ab.att_block(*att_f32, n_heads=h, **f32_kw),
             "joint_step[int8]": lambda: js.joint_step(*joint, **jkw, **joint_kw),
             "conv_block[int8]": lambda: cb.conv_block(*conv, **conv_kw["int8"]),
             "conv_block[f32]": lambda: cb.conv_block(*conv_f32, **conv_kw["f32"])}
    if hasattr(js, "joint_step_chain"):
        calls["joint_step[int8] three launches"] = lambda: js.joint_step_chain(*joint, **jkw)
    for name, fn in calls.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        us = []
        for _ in range(20):
            for _ in range(20):
                t0 = time.perf_counter()
                fn()
                us.append((time.perf_counter() - t0) * 1e6)
            torch.cuda.synchronize()
        q1, med, q3 = np.percentile(us, [25, 50, 75])
        print(f"{name}: host {med:.1f} us a call (quartiles {q1:.1f} .. {q3:.1f}), "
              f"{len(us)} calls", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
