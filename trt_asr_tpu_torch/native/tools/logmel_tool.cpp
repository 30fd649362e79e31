// Native log-mel check tool: raw f32le audio on stdin (or file) -> raw
// f32le frames-major features on stdout. Used by
// tests/test_torch_native_runtime.py to assert C++-vs-Python frontend
// parity (the reference's frontend lived in Rust with only a shape test;
// we check numerics cross-implementation).
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <iterator>
#include <vector>

#include "logmel.h"

int main(int argc, char** argv) {
    bool norm = false;
    std::string path;
    for (int i = 1; i < argc; ++i) {
        if (std::strcmp(argv[i], "--per-feature-norm") == 0) norm = true;
        else path = argv[i];
    }
    std::vector<char> raw;
    if (!path.empty()) {
        std::ifstream f(path, std::ios::binary);
        raw.assign((std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
    } else {
        raw.assign((std::istreambuf_iterator<char>(std::cin)),
                   std::istreambuf_iterator<char>());
    }
    std::vector<float> audio(raw.size() / sizeof(float));
    std::memcpy(audio.data(), raw.data(), audio.size() * sizeof(float));

    trt_asr::LogMelExtractor mel;
    auto feats = mel.compute(audio.data(), audio.size());
    const int frames = mel.num_frames(audio.size());
    if (norm && frames > 1) {
        auto st = trt_asr::compute_per_feature_stats(feats.data(), frames, mel.n_mels());
        trt_asr::apply_per_feature_norm(feats.data(), frames, mel.n_mels(), st);
    }
    std::fwrite(feats.data(), sizeof(float), feats.size(), stdout);
    std::fprintf(stderr, "frames=%d mels=%d\n", frames, mel.n_mels());
    return 0;
}
