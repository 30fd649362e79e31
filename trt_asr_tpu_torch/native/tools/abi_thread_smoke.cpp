// Concurrency smoke over the C ABI: one thread pushes feature chunks and
// finalizes while the main thread polls events — the daemon embedding
// pattern the reference supports via its mutex-guarded event queue
// (parakeet_trt.cpp:1649-1650). Run under the mock backend (no Python); any
// data race is visible to TSan/valgrind and a lost/garbled FINAL event
// fails the exit code. Exit 0 = final event observed with the expected
// frame count, all polled strings well-formed.
#include "trt_asr_tpu.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

int main() {
    ParakeetConfig cfg{};
    cfg.model_dir = "";
    cfg.use_mock = 1;
    ParakeetSession* s = parakeet_create_session(&cfg);
    if (!s) {
        std::fprintf(stderr, "create_session failed\n");
        return 1;
    }

    constexpr int kChunks = 200;
    constexpr size_t kFrames = 16;
    const int n_mels = trt_asr_n_mels(s);
    std::atomic<bool> push_failed{false};

    std::thread pusher([&] {
        std::vector<float> feats(kFrames * static_cast<size_t>(n_mels), 0.1f);
        for (int i = 0; i < kChunks; ++i) {
            if (trt_asr_push_features_tc(s, feats.data(), kFrames) != 0) {
                push_failed = true;
                return;
            }
        }
        if (trt_asr_finalize(s) != 0) push_failed = true;
    });

    // poll concurrently with the pushes; stop on FINAL or timeout
    bool got_final = false;
    std::string final_text;
    int polled = 0;
    const auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(30);
    while (std::chrono::steady_clock::now() < deadline) {
        ParakeetEvent ev{};
        if (parakeet_poll_event(s, &ev)) {
            ++polled;
            if (!ev.text || !ev.error_message) {
                std::fprintf(stderr, "null event string\n");
                pusher.join();
                return 1;
            }
            if (ev.type == PARAKEET_EVENT_FINAL_TEXT) {
                got_final = true;
                final_text = ev.text;
                break;
            }
        } else {
            std::this_thread::yield();
        }
    }
    pusher.join();
    parakeet_destroy_session(s);

    const std::string expect =
        "Mock transcription for " + std::to_string(kChunks * kFrames) + " frames";
    if (push_failed) {
        std::fprintf(stderr, "push/finalize failed\n");
        return 1;
    }
    if (!got_final || final_text != expect) {
        std::fprintf(stderr, "bad final: got_final=%d text='%s' expect='%s'\n",
                     got_final ? 1 : 0, final_text.c_str(), expect.c_str());
        return 1;
    }
    std::printf("abi_thread_smoke ok: %d events polled, final='%s'\n", polled,
                final_text.c_str());
    return 0;
}
