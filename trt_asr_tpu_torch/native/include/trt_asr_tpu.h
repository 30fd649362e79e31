/* C ABI of the streaming ASR runtime of trt_asr_tpu_torch (PyTorch/CUDA).
 *
 * The same ABI as the repository's cpp/include/trt_asr_tpu.h, byte for
 * byte in its declarations: the symbols, the ParakeetConfig and
 * ParakeetEvent layouts and the event codes. A client built against that
 * header links against libtrt_asr_tpu_torch.so unchanged.
 *
 * Drop-in surface parity with the reference engine's C ABI
 * (gracee3/trt-asr-engine cpp/include/parakeet_trt.h:33-46): same symbol
 * names, event model, and call sequence
 * (create -> [reset -> push* -> poll*]* -> destroy), so a host written
 * against the reference links against this library unchanged. The v2-style
 * additions (token events, finalize, explicit layout) live in the
 * trt_asr_* names below, mirroring the reference's forward-looking
 * cpp/include/trt_asr.h.
 *
 * Backends: "mock" (no Python and no device, for hardware-free CI —
 * reference mock_lib.cpp analog) and "torch" (embedded CPython driving
 * trt_asr_tpu_torch on the CUDA device, or on the CPU when the
 * environment asks for it with JAX_PLATFORMS=cpu).
 */
#ifndef TRT_ASR_TPU_H
#define TRT_ASR_TPU_H

#include <stdint.h>
#include <stddef.h>
#include <stdbool.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
    PARAKEET_EVENT_PARTIAL_TEXT = 0,
    PARAKEET_EVENT_FINAL_TEXT = 1,
    PARAKEET_EVENT_ERROR = 2
} ParakeetEventType;

typedef struct {
    ParakeetEventType type;
    int32_t segment_id;
    const char* text;           /* owned by the session; valid until next poll */
    const char* error_message;
} ParakeetEvent;

typedef struct ParakeetSession ParakeetSession;

typedef struct {
    const char* model_dir;
    int32_t device_id;          /* kept for ABI parity; ignored: the device is env-driven */
    bool use_fp16;              /* kept for ABI parity; compute settings are env-driven */
    bool use_mock;              /* extension: force the mock backend */
} ParakeetConfig;

ParakeetSession* parakeet_create_session(const ParakeetConfig* config);
void parakeet_destroy_session(ParakeetSession* session);

void parakeet_reset_utterance(ParakeetSession* session);

/* features: bins-major [C, num_frames] f32 (reference layout: the CLI
 * transposes [T,C] -> [C,T] before pushing, rust/cli/src/main.rs:78-88). */
int parakeet_push_features(ParakeetSession* session, const float* features,
                           size_t num_frames);

void parakeet_set_debug_context(ParakeetSession* session, const char* id,
                                uint64_t utt_seq, uint64_t audio_chunk_idx,
                                uint64_t feature_idx);

bool parakeet_poll_event(ParakeetSession* session, ParakeetEvent* event);

/* ---- v2 extensions ---- */

/* frames-major [num_frames, C] push (no transpose needed). */
int trt_asr_push_features_tc(ParakeetSession* session, const float* features,
                             size_t num_frames);

/* IEEE 754 half-precision frames-major push; converted to f32 on the host
 * (reference trt_asr.h f16 push + the N10 scalar converters,
 * parakeet_trt.cpp:1016-1053). */
int trt_asr_push_features_tc_f16(ParakeetSession* session,
                                 const uint16_t* features_f16,
                                 size_t num_frames);

/* 16 kHz mono f32 audio push; features computed natively in the runtime. */
int trt_asr_push_audio(ParakeetSession* session, const float* samples,
                       size_t num_samples);

/* End of utterance: flush the final chunk, emit FINAL_TEXT. */
int trt_asr_finalize(ParakeetSession* session);

/* Library/runtime description, e.g. "trt-asr-tpu 0.1 backend=mock". */
const char* trt_asr_runtime_info(ParakeetSession* session);

/* The model's mel-bin count (feature dim). Clients computing features
 * themselves (the CLI's native log-mel) MUST use this instead of assuming
 * 128: a mismatched mel count decodes plausible-looking garbage (caught
 * by the runtime's shape check since r3, but the count is model config,
 * not a caller guess). Returns <=0 if unknown. */
int trt_asr_n_mels(ParakeetSession* session);

/* Word-level timestamps for the utterance so far, as TSV lines
 * "start_s\tend_s\tlogp\tword\n" (frame-anchored TDT decode timestamps
 * with per-word decode-time log-probability —
 * capability beyond the reference's text-only event protocol). The
 * returned string is owned by the session and valid until the next call.
 * Empty string when nothing has been emitted. */
const char* trt_asr_word_timestamps(ParakeetSession* session);

/* Committed transcript prefix — text no future decoding can rewrite.
 * Greedy sessions never revise, so this equals the transcript; under
 * TRT_ASR_BEAM the beam session returns the hypothesis pool's common
 * prefix (partials may rewrite beyond it). Lets a native consumer
 * render flicker-free partial captions. Owned by the session, valid
 * until the next call. */
const char* trt_asr_stable_text(ParakeetSession* session);

#ifdef __cplusplus
}
#endif

#endif /* TRT_ASR_TPU_H */
