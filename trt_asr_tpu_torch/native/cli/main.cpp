// Native CLI / replay harness over the C ABI — the equivalent of the
// reference's Rust CLI (rust/cli/src/main.rs:187-543): WAV / raw-f32 PCM /
// feature replay input, --stream-sim chunked push with real-time pacing,
// per-feature normalization computed over the WHOLE utterance then applied
// per chunk, Partial/Final/Transcript stdout protocol.
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

#include "../include/trt_asr_tpu.h"
#include "../src/logmel.h"

namespace {

bool load_wav_16k_mono(const std::string& path, std::vector<float>& out) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return false;
    char riff[4], wave[4];
    uint32_t riff_size = 0;
    f.read(riff, 4);
    f.read(reinterpret_cast<char*>(&riff_size), 4);
    f.read(wave, 4);
    if (std::strncmp(riff, "RIFF", 4) != 0 || std::strncmp(wave, "WAVE", 4) != 0)
        return false;
    uint16_t fmt = 1, channels = 1, bits = 16;
    uint32_t rate = 16000;
    while (f) {
        char id[4];
        uint32_t size = 0;
        if (!f.read(id, 4) || !f.read(reinterpret_cast<char*>(&size), 4)) break;
        if (std::strncmp(id, "fmt ", 4) == 0) {
            std::vector<char> buf(size);
            f.read(buf.data(), size);
            fmt = *reinterpret_cast<uint16_t*>(&buf[0]);
            channels = *reinterpret_cast<uint16_t*>(&buf[2]);
            rate = *reinterpret_cast<uint32_t*>(&buf[4]);
            bits = *reinterpret_cast<uint16_t*>(&buf[14]);
        } else if (std::strncmp(id, "data", 4) == 0) {
            if (rate != 16000) {
                std::fprintf(stderr, "error: sample rate %u != 16000\n", rate);
                return false;
            }
            std::vector<char> buf(size);
            f.read(buf.data(), size);
            const size_t n = size / (bits / 8) / channels;
            out.resize(n);
            if (fmt == 1 && bits == 16) {
                const int16_t* p = reinterpret_cast<const int16_t*>(buf.data());
                for (size_t i = 0; i < n; ++i) {
                    double acc = 0;
                    for (int ch = 0; ch < channels; ++ch)
                        acc += p[i * channels + static_cast<size_t>(ch)] / 32768.0;
                    out[i] = static_cast<float>(acc / channels);
                }
            } else if (fmt == 3 && bits == 32) {
                const float* p = reinterpret_cast<const float*>(buf.data());
                for (size_t i = 0; i < n; ++i) out[i] = p[i * channels];
            } else {
                std::fprintf(stderr, "error: unsupported wav format %u/%u-bit\n", fmt, bits);
                return false;
            }
            return true;
        } else {
            f.seekg(size, std::ios::cur);
        }
    }
    return false;
}

// Minimal sidecar scanner: extract "key": <int> / "key": "str" from the tap
// JSON sidecar (debug/taps.py schema; reference rust/cli/src/main.rs:226-262).
bool sidecar_int(const std::string& raw, const char* key, long* out) {
    const std::string pat = std::string("\"") + key + "\"";
    size_t p = raw.find(pat);
    if (p == std::string::npos) return false;
    p = raw.find(':', p);
    if (p == std::string::npos) return false;
    *out = std::strtol(raw.c_str() + p + 1, nullptr, 10);
    return true;
}

bool sidecar_str(const std::string& raw, const char* key, std::string* out) {
    const std::string pat = std::string("\"") + key + "\"";
    size_t p = raw.find(pat);
    if (p == std::string::npos) return false;
    p = raw.find(':', p);
    size_t q0 = raw.find('"', p + 1);
    if (q0 == std::string::npos) return false;
    size_t q1 = raw.find('"', q0 + 1);
    if (q1 == std::string::npos) return false;
    *out = raw.substr(q0 + 1, q1 - q0 - 1);
    return true;
}

void dump_features_file(const std::string& path, const float* feats,
                        size_t frames, int n_mels) {
    std::ofstream f(path, std::ios::binary);
    f.write(reinterpret_cast<const char*>(feats),
            static_cast<std::streamsize>(frames * static_cast<size_t>(n_mels)
                                         * sizeof(float)));
    std::ofstream j(path + ".json");
    j << "{\n \"kind\": \"mel_features_f32\",\n \"layout\": \"frames_major\","
      << "\n \"bins\": " << n_mels << ",\n \"frames\": " << frames << "\n}\n";
}

void drain(ParakeetSession* s) {
    ParakeetEvent ev;
    while (parakeet_poll_event(s, &ev)) {
        if (ev.type == PARAKEET_EVENT_PARTIAL_TEXT)
            std::printf("Partial: %s\n", ev.text);
        else if (ev.type == PARAKEET_EVENT_FINAL_TEXT)
            std::printf("Final: %s\n", ev.text);
        else
            std::fprintf(stderr, "Error: %s\n", ev.error_message);
        std::fflush(stdout);
    }
}

}  // namespace

int main(int argc, char** argv) {
    // env default with flag override (reference CLI parity,
    // rust/cli/src/main.rs:46,190: --feature-norm overrides
    // PARAKEET_FEATURE_NORM)
    std::string feature_norm = "per_feature";
    if (const char* e = std::getenv("TRT_ASR_FEATURE_NORM")) feature_norm = e;
    else if (const char* p = std::getenv("PARAKEET_FEATURE_NORM")) feature_norm = p;
    std::string input, model_dir, dump_features;
    double stream_sim = 0.0;
    int n_mels = 0;  // 0 = from sidecar (replay) or 128 default
    bool raw_pcm = false, features_input = false, mock = false, no_sleep = false;
    bool timestamps = false;
    std::string last_final;

    for (int i = 1; i < argc; ++i) {
        std::string a = argv[i];
        auto next = [&]() -> std::string { return i + 1 < argc ? argv[++i] : ""; };
        if (a == "--model-dir") model_dir = next();
        else if (a == "--stream-sim") stream_sim = std::atof(next().c_str());
        else if (a == "--raw-pcm") raw_pcm = true;
        else if (a == "--features-input") features_input = true;
        else if (a == "--feature-norm") feature_norm = next();
        else if (a == "--n-mels") n_mels = std::atoi(next().c_str());
        else if (a == "--dump-features") dump_features = next();
        else if (a == "--mock") mock = true;
        else if (a == "--no-sleep") no_sleep = true;
        else if (a == "--timestamps") timestamps = true;
        else if (a[0] != '-') input = a;
        else {
            std::fprintf(stderr, "unknown flag %s\n", a.c_str());
            return 2;
        }
    }
    if (feature_norm != "none" && feature_norm != "per_feature") {
        // validate the FINAL value: flag values and env defaults alike —
        // an unknown string would otherwise silently decode unnormalized
        std::fprintf(stderr, "invalid --feature-norm '%s' (none|per_feature; "
                     "also via TRT_ASR_FEATURE_NORM/PARAKEET_FEATURE_NORM)\n",
                     feature_norm.c_str());
        return 2;
    }
    if (input.empty()) {
        std::fprintf(stderr,
                     "usage: trt_asr_cli <input> --model-dir DIR [--stream-sim S] "
                     "[--raw-pcm] [--features-input] [--feature-norm none|per_feature] "
                     "[--n-mels N] [--dump-features PATH] [--mock] [--no-sleep] "
                     "[--timestamps]\n");
        return 2;
    }

    ParakeetConfig cfg{};
    cfg.model_dir = model_dir.c_str();
    cfg.device_id = 0;
    cfg.use_fp16 = true;
    cfg.use_mock = mock;
    ParakeetSession* sess = parakeet_create_session(&cfg);
    if (!sess) {
        std::fprintf(stderr, "failed to create session\n");
        return 1;
    }
    std::fprintf(stderr, "%s\n", trt_asr_runtime_info(sess));
    // A push or finalize the backend refuses (its error is on stderr) ends
    // the run with exit 1: a failure never reads as an empty transcript.
    auto fail = [&](const char* what) {
        std::fprintf(stderr, "%s failed\n", what);
        parakeet_destroy_session(sess);
        return 1;
    };

    if (features_input) {
        // replay a tap dump: raw f32 + JSON sidecar (layout/bins), the
        // deterministic-replay path (reference main.rs:209-338). --n-mels
        // overrides the sidecar, like the reference's flag.
        std::ifstream f(input, std::ios::binary);
        std::vector<char> raw((std::istreambuf_iterator<char>(f)),
                              std::istreambuf_iterator<char>());
        std::string layout = "frames_major";
        {
            std::ifstream js(input + ".json");
            if (js) {
                std::string sc((std::istreambuf_iterator<char>(js)),
                               std::istreambuf_iterator<char>());
                long bins = 0;
                if (n_mels == 0 && sidecar_int(sc, "bins", &bins) && bins > 0)
                    n_mels = static_cast<int>(bins);
                sidecar_str(sc, "layout", &layout);
            }
        }
        if (n_mels == 0) n_mels = 128;
        const size_t nm = static_cast<size_t>(n_mels);
        const size_t frames = raw.size() / sizeof(float) / nm;
        float* data = reinterpret_cast<float*>(raw.data());
        std::vector<float> tc;
        if (layout == "bins_major") {   // [C, T] -> [T, C]
            tc.resize(frames * nm);
            for (size_t t = 0; t < frames; ++t)
                for (size_t c = 0; c < nm; ++c) tc[t * nm + c] = data[c * frames + t];
            data = tc.data();
        }
        for (size_t s0 = 0; s0 < frames; s0 += 256) {
            const size_t n = std::min<size_t>(256, frames - s0);
            if (trt_asr_push_features_tc(sess, data + s0 * nm, n) != 0)
                return fail("push_features");
            drain(sess);
        }
    } else {
        if (n_mels == 0) {
            // audio path: the CLI computes features itself, and the mel
            // count is MODEL config, not a caller guess — a 128-mel
            // default against a 32-mel model decoded plausible-looking
            // garbage (r3 WER gate, native surface). Replay inputs keep
            // sidecar/flag precedence above.
            const int m = trt_asr_n_mels(sess);
            n_mels = m > 0 ? m : 128;
        }
        trt_asr::FeatureConfig fcfg;
        fcfg.n_mels = n_mels;
        trt_asr::LogMelExtractor mel(fcfg);
        std::vector<float> audio;
        if (raw_pcm) {
            std::ifstream f(input, std::ios::binary);
            std::vector<char> raw((std::istreambuf_iterator<char>(f)),
                                  std::istreambuf_iterator<char>());
            audio.resize(raw.size() / sizeof(float));
            std::memcpy(audio.data(), raw.data(), audio.size() * sizeof(float));
        } else if (!load_wav_16k_mono(input, audio)) {
            std::fprintf(stderr, "failed to load %s\n", input.c_str());
            parakeet_destroy_session(sess);
            return 1;
        }

        // full-utterance features + stats, applied per chunk (reference
        // per_feature semantics, main.rs:398-405)
        std::vector<float> feats = mel.compute(audio.data(), audio.size());
        const int total_frames = mel.num_frames(audio.size());
        const size_t nm = static_cast<size_t>(n_mels);
        if (feature_norm == "per_feature" && total_frames > 1) {
            auto stats = trt_asr::compute_per_feature_stats(feats.data(), total_frames, n_mels);
            trt_asr::apply_per_feature_norm(feats.data(), total_frames, n_mels, stats);
        }
        if (!dump_features.empty())
            dump_features_file(dump_features, feats.data(),
                               static_cast<size_t>(total_frames), n_mels);

        if (stream_sim > 0) {
            const int frames_per_chunk =
                static_cast<int>(stream_sim * 16000) / mel.config().hop_length;
            auto t0 = std::chrono::steady_clock::now();
            int i = 0;
            for (int s0 = 0; s0 < total_frames; s0 += frames_per_chunk, ++i) {
                const int n = std::min(frames_per_chunk, total_frames - s0);
                if (trt_asr_push_features_tc(sess,
                                             feats.data() + static_cast<size_t>(s0) * nm,
                                             static_cast<size_t>(n)) != 0)
                    return fail("push_features");
                drain(sess);
                if (!no_sleep) {
                    auto target = t0 + std::chrono::milliseconds(
                                           static_cast<int64_t>((i + 1) * stream_sim * 1000));
                    std::this_thread::sleep_until(target);
                }
            }
        } else if (total_frames > 0) {
            if (trt_asr_push_features_tc(sess, feats.data(),
                                         static_cast<size_t>(total_frames)) != 0)
                return fail("push_features");
            drain(sess);
        }
    }

    if (trt_asr_finalize(sess) != 0) return fail("finalize");
    ParakeetEvent ev;
    while (parakeet_poll_event(sess, &ev)) {
        if (ev.type == PARAKEET_EVENT_FINAL_TEXT) {
            std::printf("Final: %s\n", ev.text);
            last_final = ev.text;
        } else if (ev.type == PARAKEET_EVENT_PARTIAL_TEXT) {
            std::printf("Partial: %s\n", ev.text);
        } else {
            std::fprintf(stderr, "Error: %s\n", ev.error_message);
        }
    }
    std::printf("Transcript: %s\n", last_final.c_str());
    if (timestamps) {
        // "Word: [start end] word" lines, same surface as the Python CLI
        std::string tsv = trt_asr_word_timestamps(sess);
        size_t pos = 0;
        while (pos < tsv.size()) {
            size_t eol = tsv.find('\n', pos);
            if (eol == std::string::npos) eol = tsv.size();
            const std::string line = tsv.substr(pos, eol - pos);
            pos = eol + 1;
            const size_t t1 = line.find('\t');
            const size_t t2 = line.find('\t', t1 + 1);
            const size_t t3 = line.find('\t', t2 + 1);
            if (t1 == std::string::npos || t2 == std::string::npos ||
                t3 == std::string::npos)
                continue;
            std::printf("Word: [%s %s] %s\n", line.substr(0, t1).c_str(),
                        line.substr(t1 + 1, t2 - t1 - 1).c_str(),
                        line.substr(t3 + 1).c_str());
        }
    }
    parakeet_destroy_session(sess);
    return 0;
}
