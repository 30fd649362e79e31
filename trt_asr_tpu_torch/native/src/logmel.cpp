#include "logmel.h"

#include <cmath>
#include <complex>
#include <cstring>

namespace trt_asr {

namespace {

constexpr double kPi = 3.14159265358979323846;

double hz_to_mel(double hz) { return 2595.0 * std::log10(1.0 + hz / 700.0); }
double mel_to_hz(double mel) { return 700.0 * (std::pow(10.0, mel / 2595.0) - 1.0); }

// iterative radix-2 complex FFT (decimation in time), n power of two
void fft_inplace(std::vector<std::complex<double>>& a) {
    const size_t n = a.size();
    for (size_t i = 1, j = 0; i < n; ++i) {
        size_t bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    for (size_t len = 2; len <= n; len <<= 1) {
        const double ang = -2.0 * kPi / static_cast<double>(len);
        const std::complex<double> wl(std::cos(ang), std::sin(ang));
        for (size_t i = 0; i < n; i += len) {
            std::complex<double> w(1.0, 0.0);
            for (size_t k = 0; k < len / 2; ++k) {
                const auto u = a[i + k];
                const auto v = a[i + k + len / 2] * w;
                a[i + k] = u + v;
                a[i + k + len / 2] = u - v;
                w *= wl;
            }
        }
    }
}

}  // namespace

void rfft_power(const float* in, int n, std::vector<float>& power) {
    std::vector<std::complex<double>> buf(static_cast<size_t>(n));
    for (int i = 0; i < n; ++i) buf[static_cast<size_t>(i)] = {in[i], 0.0};
    fft_inplace(buf);
    const int bins = n / 2 + 1;
    power.resize(static_cast<size_t>(bins));
    for (int k = 0; k < bins; ++k) {
        const auto c = buf[static_cast<size_t>(k)];
        power[static_cast<size_t>(k)] =
            static_cast<float>(c.real() * c.real() + c.imag() * c.imag());
    }
}

LogMelExtractor::LogMelExtractor(const FeatureConfig& cfg) : cfg_(cfg) {
    window_.resize(static_cast<size_t>(cfg_.win_length));
    for (int i = 0; i < cfg_.win_length; ++i) {
        window_[static_cast<size_t>(i)] = static_cast<float>(
            0.5 * (1.0 - std::cos(2.0 * kPi * i / (cfg_.win_length - 1))));
    }
    // HTK triangular mel bank, edge conventions matching the reference
    // frontend (left-exclusive rising, center-inclusive falling).
    const int bins = cfg_.n_fft / 2 + 1;
    const double f_max = cfg_.sample_rate / 2.0;
    const double min_mel = hz_to_mel(0.0), max_mel = hz_to_mel(f_max);
    std::vector<double> pts(static_cast<size_t>(cfg_.n_mels) + 2);
    for (size_t i = 0; i < pts.size(); ++i)
        pts[i] = mel_to_hz(min_mel + (max_mel - min_mel) *
                           static_cast<double>(i) / (cfg_.n_mels + 1));
    mel_.assign(static_cast<size_t>(cfg_.n_mels),
                std::vector<float>(static_cast<size_t>(bins), 0.0f));
    for (int m = 0; m < cfg_.n_mels; ++m) {
        const double left = pts[static_cast<size_t>(m)];
        const double center = pts[static_cast<size_t>(m) + 1];
        const double right = pts[static_cast<size_t>(m) + 2];
        for (int k = 0; k < bins; ++k) {
            const double freq = static_cast<double>(k) * cfg_.sample_rate / cfg_.n_fft;
            float& w = mel_[static_cast<size_t>(m)][static_cast<size_t>(k)];
            if (freq > left && freq < center)
                w = static_cast<float>((freq - left) / (center - left));
            else if (freq >= center && freq < right)
                w = static_cast<float>((right - freq) / (right - center));
        }
    }
}

int LogMelExtractor::num_frames(size_t n) const {
    if (n < static_cast<size_t>(cfg_.win_length)) return 0;
    return static_cast<int>((n - static_cast<size_t>(cfg_.win_length)) /
                            static_cast<size_t>(cfg_.hop_length)) + 1;
}

std::vector<float> LogMelExtractor::compute(const float* audio, size_t n) const {
    const int frames = num_frames(n);
    std::vector<float> out;
    if (frames <= 0) return out;
    out.resize(static_cast<size_t>(frames) * static_cast<size_t>(cfg_.n_mels));
    std::vector<float> fft_in(static_cast<size_t>(cfg_.n_fft), 0.0f);
    std::vector<float> power;
    for (int t = 0; t < frames; ++t) {
        const float* frame = audio + static_cast<size_t>(t) * cfg_.hop_length;
        for (int i = 0; i < cfg_.win_length; ++i)
            fft_in[static_cast<size_t>(i)] = frame[i] * window_[static_cast<size_t>(i)];
        for (int i = cfg_.win_length; i < cfg_.n_fft; ++i)
            fft_in[static_cast<size_t>(i)] = 0.0f;
        rfft_power(fft_in.data(), cfg_.n_fft, power);
        float* row = &out[static_cast<size_t>(t) * static_cast<size_t>(cfg_.n_mels)];
        for (int m = 0; m < cfg_.n_mels; ++m) {
            double e = 0.0;
            const auto& mw = mel_[static_cast<size_t>(m)];
            for (size_t k = 0; k < mw.size(); ++k)
                if (mw[k] != 0.0f) e += static_cast<double>(power[k]) * mw[k];
            row[m] = static_cast<float>(std::log(e + 1e-5));
        }
    }
    return out;
}

FeatureStats compute_per_feature_stats(const float* feats_tc, int frames, int n_mels) {
    FeatureStats s;
    s.mean.assign(static_cast<size_t>(n_mels), 0.0f);
    s.std.assign(static_cast<size_t>(n_mels), 0.0f);
    if (frames <= 0 || n_mels <= 0) return s;
    std::vector<double> mean(static_cast<size_t>(n_mels), 0.0);
    for (int t = 0; t < frames; ++t)
        for (int m = 0; m < n_mels; ++m)
            mean[static_cast<size_t>(m)] += feats_tc[static_cast<size_t>(t) * n_mels + m];
    for (int m = 0; m < n_mels; ++m) mean[static_cast<size_t>(m)] /= frames;
    std::vector<double> var(static_cast<size_t>(n_mels), 0.0);
    for (int t = 0; t < frames; ++t)
        for (int m = 0; m < n_mels; ++m) {
            const double d = feats_tc[static_cast<size_t>(t) * n_mels + m] -
                             mean[static_cast<size_t>(m)];
            var[static_cast<size_t>(m)] += d * d;
        }
    const double denom = frames > 1 ? frames - 1 : 1;
    for (int m = 0; m < n_mels; ++m) {
        s.mean[static_cast<size_t>(m)] = static_cast<float>(mean[static_cast<size_t>(m)]);
        s.std[static_cast<size_t>(m)] =
            static_cast<float>(std::sqrt(var[static_cast<size_t>(m)] / denom) + 1e-5);
    }
    return s;
}

void apply_per_feature_norm(float* feats_tc, int frames, int n_mels,
                            const FeatureStats& stats) {
    for (int t = 0; t < frames; ++t)
        for (int m = 0; m < n_mels; ++m) {
            float& v = feats_tc[static_cast<size_t>(t) * n_mels + m];
            v = (v - stats.mean[static_cast<size_t>(m)]) / stats.std[static_cast<size_t>(m)];
        }
}

}  // namespace trt_asr
