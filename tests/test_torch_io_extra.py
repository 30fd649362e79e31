"""The PyTorch port's audio and subtitle helpers (``io/wav.py``
``load_raw_pcm_f32``, ``io/resample.py``, ``io/subtitles.py``) against the
JAX package's on the same inputs, made with numpy from a seed. Both sides
are host numpy code doing the same arithmetic, so every comparison is
exact: arrays bit for bit, subtitle text byte for byte."""

import numpy as np
import pytest

from trt_asr_tpu.io import resample as jresample
from trt_asr_tpu.io import subtitles as jsubs
from trt_asr_tpu.io import wav as jwav
from trt_asr_tpu_torch.io import resample as presample
from trt_asr_tpu_torch.io import subtitles as psubs
from trt_asr_tpu_torch.io import wav as pwav


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * (300 + 40 * seed) * t / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_load_raw_pcm_f32_matches_jax(tmp_path):
    path = tmp_path / "a.f32"
    _signal(12345, 1).astype("<f4").tofile(path)
    got, want = pwav.load_raw_pcm_f32(str(path)), jwav.load_raw_pcm_f32(str(path))
    assert got.dtype == want.dtype == np.dtype("<f4")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sr_in,sr_out,n", [(8000, 16000, 8000), (44100, 16000, 44100),
                                            (48000, 16000, 70001), (22050, 16000, 0)])
def test_resample_matches_jax(sr_in, sr_out, n):
    x = _signal(n, sr_in % 7)
    got, want = presample.resample(x, sr_in, sr_out), jresample.resample(x, sr_in, sr_out)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [8000, 44100])
def test_load_audio_matches_jax(tmp_path, rate):
    path = str(tmp_path / f"a{rate}.wav")
    pwav.save_wav(path, _signal(rate, 3), rate=rate)
    got, want = presample.load_audio(path), jresample.load_audio(path)
    assert got.shape == want.shape == (16000,)
    np.testing.assert_array_equal(got, want)


def _words(seed, n=40):
    """Word records with gaps, long words and long spans, so that every
    rule that closes a cue fires."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.choice([0.05, 0.3, 1.2]))
        d = float(rng.uniform(0.1, 0.9))
        out.append({"word": "w" * int(rng.integers(1, 12)) + str(i),
                    "start_s": round(t, 2), "end_s": round(t + d, 2)})
        t += d
    return out


@pytest.mark.parametrize("kw", [{}, dict(max_chars=16, max_dur_s=2.0, gap_s=0.25),
                                dict(offset_s=3599.5)])
def test_pack_cues_and_formats_match_jax(kw):
    words = _words(5)
    got, want = psubs.pack_cues(words, **kw), jsubs.pack_cues(words, **kw)
    assert got == want and len(got) > 3
    assert psubs.format_srt(got) == jsubs.format_srt(want)
    assert psubs.format_vtt(got) == jsubs.format_vtt(want)
    assert psubs.format_srt([]) == jsubs.format_srt([])
    assert psubs.format_vtt([]) == jsubs.format_vtt([])


def test_cues_from_segments_match_jax():
    segments = [{"text": "a", "start_s": 1.25, "words": _words(6, 7)},
                {"text": "", "start_s": 9.5},
                {"text": "b", "start_s": 3661.0, "words": _words(7, 9)}]
    got = psubs.cues_from_segments(segments, max_chars=20)
    want = jsubs.cues_from_segments(segments, max_chars=20)
    assert got == want
    assert psubs.format_srt(got) == jsubs.format_srt(want)
    assert psubs.format_vtt(got) == jsubs.format_vtt(want)
