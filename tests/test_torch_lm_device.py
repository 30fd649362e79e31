"""The device LM tables of the PyTorch port (``decode/lm_device.py``)
against the JAX package's: the same NGramLM (fitted from seeded token
sequences) and the same biasing trie (gate_r3's tokenizer) compile into
tables equal to JAX's element for element (the two int32 Horner codes, the
tokens, the f32 values and the unigram), and ``lm_scores`` lies within
1e-5 of JAX's scores and of the host ``lm_fn``, over every backoff depth,
BOS-padded short prefixes and out-of-vocab candidates. The int32 overflow
check and the refusals are JAX's."""

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, one_torch_thread  # noqa: F401

from trt_asr_tpu.decode import lm_device as jlm
from trt_asr_tpu.decode.biasing import make_biasing_lm as j_make_biasing
from trt_asr_tpu.decode.ngram_lm import NGramLM as JNGram
from trt_asr_tpu.tokenizer import Tokenizer as JTokenizer
from trt_asr_tpu_torch.decode import lm_device as plm
from trt_asr_tpu_torch.decode.biasing import make_biasing_lm
from trt_asr_tpu_torch.decode.ngram_lm import NGramLM
from trt_asr_tpu_torch.tokenizer import Tokenizer

PHRASES = ["baba daba", "gaba haba faba", "faba", "qqq xyz"]   # the last encodes to nothing

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _seqs(seed, vocab=40, n_seq=30):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=r.integers(1, 12)).tolist() for _ in range(n_seq)]


def _tokenizers():
    vocab = f"{GATE_R3}/vocab.txt"
    return (Tokenizer.from_file(vocab, blank_id=1120),
            JTokenizer.from_file(vocab, blank_id=1120))


def assert_tables_equal(got, want):
    (p_spec, p_tab), (j_spec, j_tab) = got, want
    assert tuple(p_spec) == tuple(j_spec)
    assert len(p_tab.levels) == len(j_tab.levels)
    for p_lev, j_lev in zip(p_tab.levels, j_tab.levels):
        for a, b in zip(p_lev, j_lev):
            assert a.dtype == torch.int32 or a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(p_tab.uni.numpy(), np.asarray(j_tab.uni))
    assert p_tab.uni_floor.numpy() == np.asarray(j_tab.uni_floor)


def _queries(seed, vocab, n=40, width=6, token_cap=32):
    r = np.random.default_rng(seed)
    buf = np.full((n, token_cap), -1, np.int32)
    n_tok = r.integers(0, 9, size=n).astype(np.int32)
    for i, m in enumerate(n_tok):
        buf[i, :m] = r.integers(0, vocab, size=m)
    cands = r.integers(0, vocab + 3, size=(n, width)).astype(np.int32)   # a few out of vocab
    return buf, n_tok, cands


def _check_scores(p_compiled, j_compiled, host_fn, vocab, seed):
    buf, n_tok, cands = _queries(seed, vocab)
    got = plm.lm_scores(*p_compiled, torch.as_tensor(buf), torch.as_tensor(n_tok),
                        torch.as_tensor(cands)).numpy()
    want = np.asarray(jlm.lm_scores(*j_compiled, buf, n_tok, cands))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = [[host_fn(buf[i, :n_tok[i]].tolist(), int(c)) for c in cands[i]]
            for i in range(len(n_tok))]
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,order", [(0, 2), (1, 3), (2, 4)])
def test_ngram_tables_and_scores_match_jax(seed, order):
    seqs = _seqs(seed)
    lm, jl = NGramLM.fit(seqs, order=order, vocab_size=40), JNGram.fit(seqs, order=order,
                                                                        vocab_size=40)
    got, want = plm.ngram_to_device(lm), jlm.ngram_to_device(jl)
    assert_tables_equal(got, want)
    _check_scores(got, want, lm.score, 40, 100 + seed)


def test_ngram_trained_contexts_score_the_deepest_level():
    """Contexts straight from the training data (the high-count path a
    random query mix may miss) score as the host's backoff does."""
    lm = NGramLM.fit(_seqs(7), order=3, vocab_size=40)
    spec, tables = plm.ngram_to_device(lm)
    checked = 0
    for ctx, counter in list(lm.counts.items())[:40]:
        if len(ctx) != 2 or any(t < 0 for t in ctx):
            continue
        toks = list(counter)[:3]
        buf = torch.full((1, 8), -1, dtype=torch.int32)
        buf[0, :2] = torch.tensor(ctx)
        got = plm.lm_scores(spec, tables, buf, torch.tensor([2]), torch.tensor([toks]))[0]
        np.testing.assert_allclose(got.numpy(), [lm.score(list(ctx), t) for t in toks],
                                   rtol=0, atol=1e-5)
        checked += 1
    assert checked > 5


def test_biasing_tables_and_scores_match_jax():
    tok, jtok = _tokenizers()
    bias, jbias = make_biasing_lm(PHRASES, tok), j_make_biasing(PHRASES, jtok)
    got, want = plm.biasing_to_device(bias), jlm.biasing_to_device(jbias)
    assert_tables_equal(got, want)
    # queries that walk the phrases (a matched prefix, then its continuation)
    phrase_ids = [tok.encode(p) for p in PHRASES[:3]]
    assert all(phrase_ids) and not tok.encode(PHRASES[3])
    buf = np.full((len(phrase_ids) * 2, 32), -1, np.int32)
    n_tok = np.zeros(len(buf), np.int32)
    cands = np.zeros((len(buf), 3), np.int32)
    for i, ids in enumerate(phrase_ids):
        buf[2 * i, :len(ids) - 1] = ids[:-1]
        n_tok[2 * i] = len(ids) - 1
        cands[2 * i] = [ids[-1], ids[0], 5]
        buf[2 * i + 1, :2] = [7, ids[0]]
        n_tok[2 * i + 1] = 2
        cands[2 * i + 1] = [ids[min(1, len(ids) - 1)], 9, ids[0]]
    got_s = plm.lm_scores(*got, torch.as_tensor(buf), torch.as_tensor(n_tok),
                          torch.as_tensor(cands)).numpy()
    np.testing.assert_allclose(got_s, np.asarray(jlm.lm_scores(*want, buf, n_tok, cands)),
                               rtol=0, atol=1e-5)
    host = [[bias(buf[i, :n_tok[i]].tolist(), int(c)) for c in cands[i]] for i in range(len(buf))]
    np.testing.assert_allclose(got_s, host, rtol=0, atol=1e-5)
    assert (got_s == bias.bonus).any() and (got_s == 0.0).any()
    _check_scores(got, want, bias, 1120, 5)


def test_overflow_check_and_refusals_match_jax():
    """The Horner codes' int32 bound, an LM with a token past its vocab, and
    an arbitrary callable: the same outcome as JAX's."""
    big = NGramLM.fit([[1, 2, 3, 4, 5, 6]], order=7, vocab_size=5000)
    jbig = JNGram.fit([[1, 2, 3, 4, 5, 6]], order=7, vocab_size=5000)
    for fn, lm in ((plm.ngram_to_device, big), (jlm.ngram_to_device, jbig)):
        with pytest.raises(ValueError, match="overflows the int32 Horner code"):
            fn(lm)
    bad = NGramLM.fit([[1, 2, 30]], order=2, vocab_size=10)
    with pytest.raises(ValueError, match="trained token id 30 >= vocab_size 10"):
        plm.ngram_to_device(bad)
    assert plm.to_device(lambda p, t: 0.0) is None and jlm.to_device(lambda p, t: 0.0) is None
    assert plm.to_device(NGramLM.fit(_seqs(1), vocab_size=40))[0].mode == "backoff"
