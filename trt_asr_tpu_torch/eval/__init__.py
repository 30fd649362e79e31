"""Evaluation of the port: manifests, WER scoring, the eval suite
(``eval/suite.py``), the synthetic spoken-words task (``eval/synthetic.py``)
and its WER gate (``eval/gate.py``)."""

from trt_asr_tpu_torch.eval.wer import normalize_text, score_corpus, score_pair  # noqa: F401
