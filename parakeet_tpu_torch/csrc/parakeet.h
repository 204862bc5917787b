/* parakeet.h — flat C API of parakeet_tpu_torch, the PyTorch/CUDA port of
 * the parakeet-tpu speech framework. The ABI is that of the repository's
 * csrc/parakeet.h: libparakeet_c embeds (or, when loaded inside a Python
 * process, attaches to) CPython and drives the parakeet_tpu_torch package.
 * The surface is deliberately dumb — integer handles and UTF-8/JSON
 * strings — so any language with a C FFI can bind it without
 * struct-layout or callback marshaling.
 *
 * Threading: all functions are safe to call from any thread; calls
 * serialize on the Python GIL. When the host process has no Python
 * interpreter, the first call initializes one.
 *
 * Memory: every char* RETURNED by this library (results, version) is
 * heap-allocated; release it with parakeet_free_string(). Strings PASSED
 * IN are borrowed (copied internally). parakeet_last_error() is the one
 * exception: it returns a thread-local buffer owned by the library —
 * valid until the next failing call on that thread; do not free.
 */
#ifndef PARAKEET_C_API_H
#define PARAKEET_C_API_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Create a transcriber.
 *   model:        "tdt-ctc-110m" | "tdt-600m" | "rnnt-600m" | "test-tiny"
 *   weights_path: safetensors checkpoint, or NULL for random init
 *                 (pipeline smoke tests)
 *   vocab_path:   SentencePiece vocab .txt, or NULL (raw token ids)
 *   options_json: optional JSON object (or NULL), e.g.
 *                 {"device":"cuda","decoder":"ctc","timestamps":true,
 *                  "quantize":"int4","beam_size":4}
 *                 — full list in parakeet_tpu_torch/capi.py. The models
 *                 run on the CUDA card unless "device" is "cpu".
 * Returns a positive handle, or 0 on error (see parakeet_last_error). */
int64_t parakeet_create(const char *model, const char *weights_path,
                        const char *vocab_path, const char *options_json);

/* Transcribe an audio file (wav/flac/mp3/ogg; format auto-detected).
 * Returns a JSON string:
 *   {"text": "...", "token_ids": [...],
 *    "words": [{"word","start","end","confidence"}, ...]}
 * or NULL on error. Free with parakeet_free_string(). */
char *parakeet_transcribe(int64_t handle, const char *audio_path);

/* Transcribe a raw float32 PCM buffer (mono, any sample rate —
 * resampled to the model rate). Same result contract as above. */
char *parakeet_transcribe_pcm(int64_t handle, const float *pcm,
                              int64_t num_samples, int32_t sample_rate);

/* int16 overload (samples scaled by 1/32768, the reference's int16
 * read_audio overload). */
char *parakeet_transcribe_pcm_s16(int64_t handle, const int16_t *pcm,
                                  int64_t num_samples, int32_t sample_rate);

/* Forced alignment: word timings for a KNOWN transcript (CTC-head
 * models created with a vocab). Same result JSON as parakeet_transcribe
 * (the "words" array is the point); NULL on error. */
char *parakeet_align(int64_t handle, const char *audio_path,
                     const char *text);

/* ---- diarization ---------------------------------------------------- */

/* Create a speaker-attributed transcriber (ASR + Sortformer fusion).
 *   model: "diarized" (110m ASR + sortformer-117m) | "test-tiny-diarized"
 * Returns a positive handle, or 0 on error. */
int64_t parakeet_diarize_create(const char *model, const char *asr_weights,
                                const char *sortformer_weights,
                                const char *vocab_path,
                                const char *options_json);

/* Speaker-attributed transcription:
 *   {"text", "words": [{"word","start","end","confidence","speaker"}],
 *    "segments": [{"speaker","start","end"}]}
 * NULL on error; free with parakeet_free_string(). */
char *parakeet_diarize(int64_t handle, const char *audio_path);

/* ---- streaming (mic-buffer FFI) ------------------------------------
 * Feed raw PCM chunks at the MODEL rate (16 kHz; the streaming path
 * never resamples — reference StreamingTranscriber contract). */

/* Create a streaming transcriber.
 *   model: "eou-120m" | "nemotron-600m" | "test-tiny-stream"
 *   options_json extras: {"latency": 0|1|6|13} (nemotron right context)
 * Returns a positive handle, or 0 on error. */
int64_t parakeet_stream_create(const char *model, const char *weights_path,
                               const char *vocab_path,
                               const char *options_json);

/* Feed one chunk; returns {"delta": "<new text>", "text": "<so far>"}
 * or NULL on error. Free with parakeet_free_string(). */
char *parakeet_stream_feed(int64_t handle, const float *pcm,
                           int64_t num_samples);
char *parakeet_stream_feed_s16(int64_t handle, const int16_t *pcm,
                               int64_t num_samples);

/* Accumulated result so far: {"text", "token_ids"} (or NULL on error). */
char *parakeet_stream_text(int64_t handle);

/* Reset stream state for a new utterance (caches, tokens, offsets). */
void parakeet_stream_reset(int64_t handle);

/* Destroy a handle — offline or streaming (idempotent; invalid handles
 * are ignored). */
void parakeet_destroy(int64_t handle);

/* Last error message for the CALLING THREAD ("" if none). Owned by the
 * library; valid until the next failing call on this thread. */
const char *parakeet_last_error(void);

/* Package version as a heap string; free with parakeet_free_string(). */
char *parakeet_version(void);

/* Release a string returned by this library. NULL is a no-op. */
void parakeet_free_string(char *s);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* PARAKEET_C_API_H */
