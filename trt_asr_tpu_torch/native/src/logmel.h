// Native log-mel frontend — C++ equivalent of the reference's Rust
// frontend (rust/features/src/lib.rs), held to the JAX package's frontend
// within 2e-4 and to the port's (trt_asr_tpu_torch/frontend/logmel.py,
// a float32 DFT) within that plus its own tolerance against JAX's
// (tests/test_torch_native_runtime.py): 16 kHz, n_fft 512, win 400
// (symmetric Hann), hop 160, 128 HTK mels over [0, 8 kHz], ln(e + 1e-5),
// per-feature utterance normalization with N-1 std + 1e-5.
#pragma once

#include <cstddef>
#include <vector>

namespace trt_asr {

struct FeatureConfig {
    int sample_rate = 16000;
    int n_fft = 512;
    int win_length = 400;
    int hop_length = 160;
    int n_mels = 128;
};

class LogMelExtractor {
  public:
    explicit LogMelExtractor(const FeatureConfig& cfg = {});

    // audio [S] -> frames-major features [T * n_mels]; T = (S - win)/hop + 1.
    std::vector<float> compute(const float* audio, size_t n) const;
    int num_frames(size_t n) const;
    int n_mels() const { return cfg_.n_mels; }
    const FeatureConfig& config() const { return cfg_; }

  private:
    FeatureConfig cfg_;
    std::vector<float> window_;                 // [win]
    std::vector<std::vector<float>> mel_;       // [n_mels][n_bins]
};

struct FeatureStats {
    std::vector<float> mean, std;
};

FeatureStats compute_per_feature_stats(const float* feats_tc, int frames, int n_mels);
void apply_per_feature_norm(float* feats_tc, int frames, int n_mels,
                            const FeatureStats& stats);

// In-place iterative radix-2 real FFT helper (n must be a power of two).
// out_re/out_im sized n/2+1.
void rfft_power(const float* in, int n, std::vector<float>& power);

}  // namespace trt_asr
