"""Train a token n-gram LM for shallow fusion from a text corpus, as
``tools/ngram_lm_fit.py`` does.

Tokenizes each line with the model's own vocab (greedy longest-match, the
training pipeline's labels) and fits a stupid-backoff n-gram LM
(``decode/ngram_lm.py``); the JSON equals the JAX tool's byte for byte:

    python -m trt_asr_tpu_torch.tools.ngram_lm_fit corpus.txt --model-dir m \\
        --out lm.json [--order 3] [--alpha 0.4] [--device cpu]

Use it: ``python -m trt_asr_tpu_torch.cli a.wav --model-dir m --beam 4
--lm lm.json --lm-weight 0.3``. The fit runs on the host; the device flags
follow the tools' rule (``tools/__init__.py``), so that without a card a run
that does not ask for the CPU raises here too.
"""

from __future__ import annotations

import argparse
import os

from trt_asr_tpu_torch.tools import add_device_args, tool_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trt_asr_tpu_torch.tools.ngram_lm_fit",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("corpus", help="text file, one sentence per line")
    ap.add_argument("--model-dir", help="model dir providing vocab.txt")
    ap.add_argument("--vocab", default="", help="or a bare vocab.txt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--order", type=int, default=3)
    ap.add_argument("--alpha", type=float, default=0.4)
    add_device_args(ap)
    args = ap.parse_args(argv)
    tool_device(args)

    from trt_asr_tpu_torch.decode.ngram_lm import fit_from_text
    from trt_asr_tpu_torch.tokenizer import Tokenizer

    if args.vocab:
        vocab_path = args.vocab
    elif args.model_dir:
        vocab_path = os.path.join(args.model_dir, "vocab.txt")
    else:
        ap.error("provide --model-dir or --vocab")
    tok = Tokenizer.from_file(vocab_path)
    with open(args.corpus) as f:
        lines = f.readlines()
    lm = fit_from_text(lines, tok, order=args.order, alpha=args.alpha)
    lm.save(args.out)
    print(f"fit order-{args.order} LM over {len(lines)} lines "
          f"({len(lm.counts)} contexts, vocab {lm.vocab_size}) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
