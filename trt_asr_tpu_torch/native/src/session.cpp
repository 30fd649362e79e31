// C ABI implementation: the native session shell.
//
// Owns: backend selection (mock vs embedded-Python torch), layout conversion
// ([C,T] bins-major ABI parity push vs [T,C] v2 push), native feature
// extraction for the audio push path, event string lifetime, debug context.
// The reference analog is the ParakeetSession C ABI layer
// (cpp/src/parakeet_trt.cpp:1700-3876) minus the device hot path, which
// lives behind the Backend seam here.
#include "trt_asr_tpu.h"

#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "backend.h"
#include "logmel.h"

struct ParakeetSession {
    std::unique_ptr<trt_asr::Backend> backend;
    trt_asr::LogMelExtractor mel;
    std::string info;
    std::string debug_ctx;
    // event string storage (valid until next poll — ABI contract)
    std::string ev_text, ev_err;
    // timestamp TSV storage (valid until next trt_asr_word_timestamps call)
    std::string ts_tsv;
    // stable-text storage (valid until next trt_asr_stable_text call)
    std::string stable_txt;
    bool finalized = false;
};

extern "C" {

ParakeetSession* parakeet_create_session(const ParakeetConfig* config) {
    if (!config) return nullptr;
    auto* s = new ParakeetSession();
    const char* env_backend = std::getenv("TRT_ASR_BACKEND");
    const bool mock = config->use_mock ||
                      (env_backend && std::string(env_backend) == "mock");
    s->backend.reset(mock ? trt_asr::make_mock_backend()
                          : trt_asr::make_python_backend());
    std::string err;
    const std::string model_dir = config->model_dir ? config->model_dir : "";
    if (!s->backend->init(model_dir, err)) {
        std::fprintf(stderr, "trt_asr_tpu: backend init failed: %s\n", err.c_str());
        delete s;
        return nullptr;
    }
    s->info = std::string("trt-asr-tpu 0.1 ") + s->backend->info();
    s->backend->reset_utterance();
    return s;
}

void parakeet_destroy_session(ParakeetSession* s) { delete s; }

void parakeet_reset_utterance(ParakeetSession* s) {
    if (!s) return;
    s->finalized = false;
    s->backend->reset_utterance();
}

int parakeet_push_features(ParakeetSession* s, const float* features,
                           size_t num_frames) {
    if (!s || !features) return -1;
    // ABI parity layout: bins-major [C, T] -> transpose to frames-major
    const int c = s->backend->n_mels();
    std::vector<float> tc(num_frames * static_cast<size_t>(c));
    for (size_t t = 0; t < num_frames; ++t)
        for (int m = 0; m < c; ++m)
            tc[t * static_cast<size_t>(c) + static_cast<size_t>(m)] =
                features[static_cast<size_t>(m) * num_frames + t];
    std::string err;
    if (!s->backend->push_features(tc.data(), num_frames, err)) {
        std::fprintf(stderr, "trt_asr_tpu: %s [%s]\n", err.c_str(),
                     s->debug_ctx.c_str());
        return -2;
    }
    return 0;
}

int trt_asr_push_features_tc(ParakeetSession* s, const float* features,
                             size_t num_frames) {
    if (!s || !features) return -1;
    std::string err;
    if (!s->backend->push_features(features, num_frames, err)) {
        std::fprintf(stderr, "trt_asr_tpu: %s [%s]\n", err.c_str(),
                     s->debug_ctx.c_str());
        return -2;
    }
    return 0;
}

namespace {

// IEEE 754 binary16 -> binary32 (reference fp16_to_f32,
// parakeet_trt.cpp:1037-1053)
float f16_to_f32(uint16_t h) {
    const uint32_t sign = (static_cast<uint32_t>(h) & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;  // signed zero
        } else {
            // subnormal: normalize
            exp = 127 - 15 + 1;
            while ((mant & 0x400u) == 0) {
                mant <<= 1;
                --exp;
            }
            mant &= 0x3FFu;
            bits = sign | (exp << 23) | (mant << 13);
        }
    } else if (exp == 0x1Fu) {
        bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

}  // namespace

int trt_asr_push_features_tc_f16(ParakeetSession* s, const uint16_t* features_f16,
                                 size_t num_frames) {
    if (!s || !features_f16) return -1;
    const int c = s->backend->n_mels();
    std::vector<float> f32(num_frames * static_cast<size_t>(c));
    for (size_t i = 0; i < f32.size(); ++i) f32[i] = f16_to_f32(features_f16[i]);
    return trt_asr_push_features_tc(s, f32.data(), num_frames);
}

int trt_asr_push_audio(ParakeetSession* s, const float* samples,
                       size_t num_samples) {
    if (!s || !samples) return -1;
    const auto feats = s->mel.compute(samples, num_samples);
    const int frames = s->mel.num_frames(num_samples);
    if (frames <= 0) return 0;
    return trt_asr_push_features_tc(s, feats.data(), static_cast<size_t>(frames));
}

int trt_asr_finalize(ParakeetSession* s) {
    if (!s) return -1;
    if (s->finalized) return 0;
    std::string err;
    if (!s->backend->finalize(err)) {
        std::fprintf(stderr, "trt_asr_tpu: %s\n", err.c_str());
        return -2;
    }
    s->finalized = true;
    return 0;
}

void parakeet_set_debug_context(ParakeetSession* s, const char* id,
                                uint64_t utt_seq, uint64_t audio_chunk_idx,
                                uint64_t feature_idx) {
    if (!s) return;
    s->debug_ctx = std::string(id ? id : "") + " utt=" + std::to_string(utt_seq) +
                   " chunk=" + std::to_string(audio_chunk_idx) +
                   " feat=" + std::to_string(feature_idx);
}

bool parakeet_poll_event(ParakeetSession* s, ParakeetEvent* event) {
    if (!s || !event) return false;
    trt_asr::BackendEvent ev;
    if (!s->backend->poll(ev)) return false;
    s->ev_text = ev.text;
    s->ev_err = ev.error;
    event->type = static_cast<ParakeetEventType>(ev.type);
    event->segment_id = ev.segment_id;
    event->text = s->ev_text.c_str();
    event->error_message = s->ev_err.c_str();
    return true;
}

const char* trt_asr_runtime_info(ParakeetSession* s) {
    return s ? s->info.c_str() : "";
}

int trt_asr_n_mels(ParakeetSession* s) {
    return s && s->backend ? s->backend->n_mels() : 0;
}

const char* trt_asr_word_timestamps(ParakeetSession* s) {
    if (!s || !s->backend) return "";
    s->ts_tsv = s->backend->word_timestamps_tsv();
    return s->ts_tsv.c_str();
}

const char* trt_asr_stable_text(ParakeetSession* s) {
    if (!s || !s->backend) return "";
    s->stable_txt = s->backend->stable_text();
    return s->stable_txt.c_str();
}

}  // extern "C"
