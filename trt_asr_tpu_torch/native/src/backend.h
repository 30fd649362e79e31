// Backend interface: the seam between the native session shell and the
// compute engine. Mirrors the reference's engine-substitution design
// (real TRT engines vs CMake-selected mock, cpp/CMakeLists.txt:10-19) —
// ours selects at RUNTIME (config.use_mock / TRT_ASR_BACKEND=mock), so one
// binary serves CI and production.
#pragma once

#include <cstddef>
#include <string>
#include <vector>

namespace trt_asr {

struct BackendEvent {
    int type = 0;        // ParakeetEventType
    int segment_id = 0;
    std::string text;
    std::string error;
};

class Backend {
  public:
    virtual ~Backend() = default;
    virtual bool init(const std::string& model_dir, std::string& err) = 0;
    virtual void reset_utterance() = 0;
    // feats frames-major [frames, n_mels]
    virtual bool push_features(const float* feats_tc, size_t frames, std::string& err) = 0;
    virtual bool finalize(std::string& err) = 0;
    virtual bool poll(BackendEvent& ev) = 0;
    virtual std::string info() const = 0;
    virtual int n_mels() const = 0;
    // Word timings as TSV lines "start_s\tend_s\tlogp\tword\n"
    // (frame-anchored TDT timestamps + decode-time word log-probability —
    // beyond the reference's text-only events). Empty string when none
    // are available yet.
    virtual std::string word_timestamps_tsv() { return ""; }
    // Committed transcript prefix (never rewritten by later decoding).
    // Greedy backends: the whole transcript; beam (TRT_ASR_BEAM): the
    // hypothesis pool's common prefix.
    virtual std::string stable_text() { return ""; }
};

Backend* make_mock_backend();
Backend* make_python_backend();

}  // namespace trt_asr
