// Mock backend: zero-dependency stand-in (reference cpp/src/mock_lib.cpp:
// "Mock transcription for N frames"). Used for hardware-free testing of the
// full native stack: C ABI, session shell, CLI, feature frontend.
#include "backend.h"

#include <deque>
#include <mutex>
#include <string>

namespace trt_asr {

namespace {

// Event queue is mutex-guarded like the reference's ParakeetSession queue
// (parakeet_trt.cpp:1649-1650): a daemon embedding the C ABI may poll from
// a different thread than the one pushing features. The Python backend gets
// the same serialization from the GIL; this one needs it explicitly.
class MockBackend final : public Backend {
  public:
    bool init(const std::string&, std::string&) override { return true; }

    void reset_utterance() override {
        std::lock_guard<std::mutex> lk(mu_);
        total_frames_ = 0;
        partial_sent_ = false;
        segment_++;
        events_.clear();
    }

    bool push_features(const float*, size_t frames, std::string&) override {
        std::lock_guard<std::mutex> lk(mu_);
        total_frames_ += frames;
        if (total_frames_ >= 100 && !partial_sent_) {
            partial_sent_ = true;
            events_.push_back({0, segment_,
                               "Mock partial for " + std::to_string(total_frames_) +
                                   " frames", ""});
        }
        return true;
    }

    bool finalize(std::string&) override {
        std::lock_guard<std::mutex> lk(mu_);
        events_.push_back({1, segment_,
                           "Mock transcription for " + std::to_string(total_frames_) +
                               " frames", ""});
        return true;
    }

    bool poll(BackendEvent& ev) override {
        std::lock_guard<std::mutex> lk(mu_);
        if (events_.empty()) return false;
        ev = events_.front();
        events_.pop_front();
        return true;
    }

    std::string info() const override { return "backend=mock"; }
    int n_mels() const override { return 128; }

    std::string stable_text() override {
        // mock transcripts never rewrite: stable == the final-form text
        std::lock_guard<std::mutex> lk(mu_);
        return "Mock transcription for " + std::to_string(total_frames_) +
               " frames";
    }

    std::string word_timestamps_tsv() override {
        // Deterministic stand-in mirroring the mock transcript: one "word"
        // per 100 pushed frames (10 ms each), evenly tiled — enough for
        // hardware-free tests of the ABI/CLI timestamp plumbing.
        std::lock_guard<std::mutex> lk(mu_);
        std::string out;
        const size_t words = total_frames_ / 100;
        for (size_t i = 0; i < words; ++i) {
            const double s = static_cast<double>(i);      // 100 frames = 1 s
            out += std::to_string(s) + "\t" + std::to_string(s + 1.0) +
                   "\t0.0\tmock" + std::to_string(i) + "\n";
        }
        return out;
    }

  private:
    std::mutex mu_;
    size_t total_frames_ = 0;
    bool partial_sent_ = false;
    int segment_ = 0;
    std::deque<BackendEvent> events_;
};

}  // namespace

Backend* make_mock_backend() { return new MockBackend(); }

}  // namespace trt_asr
