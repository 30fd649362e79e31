"""The port's manifest data feed (``trt_asr_tpu_torch/train/data.py`` over
``trt_asr_tpu_torch/eval/manifest.py``) against the JAX package's: the
same manifests, and over 2 rounds the same batches in the same order
(labels, lengths and shapes exactly; the log-mel features within the
frontend's parity tolerance, 2e-5 absolute plus 5e-5 relative, as
tests/test_torch_frontend.py holds them, and 1e-3 absolute once
normalized per feature, that noise over a feature's std); the batches feed the port's
train step."""

import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.eval import manifest as j_manifest
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.train.data import batches_from_manifest as j_batches
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.eval import manifest
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.tokenizer import Tokenizer
from trt_asr_tpu_torch.train.data import batches_from_manifest

pytestmark = pytest.mark.usefixtures("one_torch_thread")


# log-mel values: the frontend's parity tolerance; per-feature normalized
# ones: that noise divided by a feature's std over an utterance (down to
# 0.030 on these tones: 2e-5 / 0.030 = 6.7e-4; reading 7.9e-5)
ATOL = {"none": 2e-5, "per_feature": 1e-3}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_train_data.py's five utterances, written by the port, and
    the port's model with the JAX package's beside it."""
    from trt_asr_tpu_torch.io.wav import save_wav

    model = ParakeetTDT.random(ModelConfig.tiny(), seed=5, device="cpu")
    root = tmp_path_factory.mktemp("train_ds")
    rng = np.random.default_rng(0)
    ctrl = [i for i, tok in enumerate(model.tokenizer.vocab) if Tokenizer.is_control(tok)]
    for k in range(5):
        n = 16000 + 4000 * k
        tt = np.arange(n)
        save_wav(str(root / f"u{k}.wav"),
                 (0.3 * np.sin(2 * np.pi * (250 + 30 * k) * tt / 16000)
                  + 0.05 * rng.standard_normal(n)).astype(np.float32))
        ids = [int(i) for i in rng.integers(0, len(model.tokenizer.vocab), 6) if i not in ctrl]
        (root / f"u{k}.txt").write_text(model.tokenizer.decode(ids))
    man = root / "m.tsv"
    manifest.write_manifest(str(man), manifest.scan_wav_tree(str(root)), with_sha=True)
    j_man = root / "j.tsv"
    j_manifest.write_manifest(str(j_man), j_manifest.scan_wav_tree(str(root)), with_sha=True)
    return model, str(man), str(j_man), JModel.random(JConfig.tiny(), seed=5)


def test_manifest_equals_jax(dataset):
    _, man, j_man, _ = dataset
    with open(man) as f, open(j_man) as g:
        assert f.read() == g.read()
    got = manifest.read_manifest(man, verify_sha=True)
    want = j_manifest.read_manifest(man, verify_sha=True)
    assert [vars(e) for e in got] == [vars(e) for e in want]
    assert len(got) == 5 and all(e.sha256 and e.duration_sec > 0 for e in got)


@pytest.mark.parametrize("norm", ["none", "per_feature"])
def test_batches_equal_jax_over_two_rounds(dataset, norm):
    model, man, _, jmodel = dataset
    kw = dict(batch_size=2, rounds=2, seed=3, feature_norm=norm, bucket_multiple=64)
    got = list(batches_from_manifest(man, model, **kw))
    want = list(j_batches(man, jmodel, **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip((g.feat_len, g.labels, g.label_len), (w.feat_len, w.labels, w.label_len)):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert g.feats.shape == np.asarray(w.feats).shape and g.feats.dtype == np.float32
        np.testing.assert_allclose(g.feats, np.asarray(w.feats), atol=ATOL[norm], rtol=5e-5)
        for k in range(g.feats.shape[0]):
            assert not g.feats[k, g.feat_len[k]:].any()


def test_batches_feed_the_train_step(dataset):
    from trt_asr_tpu_torch.train import make_optimizer, make_train_step

    model, man, _, _ = dataset
    batch = next(iter(batches_from_manifest(man, model, batch_size=2, feature_norm="none",
                                            bucket_multiple=64)))
    seen = {model.tokenizer.decode(batch.labels[k, :batch.label_len[k]])
            for k in range(batch.labels.shape[0])}
    assert seen <= {e.transcript for e in manifest.read_manifest(man)}
    tx, _ = make_optimizer(1e-4, schedule="constant")
    init_opt, step = make_train_step(model.cfg, optimizer=tx)
    _, _, m = step(model.params, init_opt(model.params), batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert not any(v.requires_grad for v in model.params["joint"]["out"].values())
    assert torch.isfinite(m["loss"])
