/* Native host-side audio helpers of tts_tpu_torch (a copy of tts_tpu's
 * native/audio_io.c), bound via ctypes (tts_tpu_torch/native/__init__.py),
 * which builds this file with the system C compiler at first use.
 *
 * They cover the host work around the device programs: PCM conversion,
 * linear resampling (the interpolate-resample the reference fuses into its
 * graphs, Qwen_TTS/Export_Qwen_TTS_ONNX.py:544-551), multi-channel downmix
 * and RMS loudness normalization (audio_normalizer, :1912-1917). Each has a
 * numpy twin in the Python module.
 */
#include <math.h>
#include <stdint.h>
#include <stddef.h>

/* int16 PCM -> float32 in [-1, 1) */
void pcm16_to_f32(const int16_t *in, float *out, long n) {
    const float s = 1.0f / 32768.0f;
    for (long i = 0; i < n; ++i) out[i] = (float)in[i] * s;
}

/* float32 -> int16 PCM with clamp */
void f32_to_pcm16(const float *in, int16_t *out, long n) {
    for (long i = 0; i < n; ++i) {
        float v = in[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = (int16_t)lrintf(v);
    }
}

/* linear resample float32 mono: n_out samples spanning [0, n_in-1] */
void resample_linear_f32(const float *in, long n_in, float *out, long n_out) {
    if (n_in <= 1 || n_out <= 1) {
        for (long i = 0; i < n_out; ++i) out[i] = n_in > 0 ? in[0] : 0.0f;
        return;
    }
    const double step = (double)(n_in - 1) / (double)(n_out - 1);
    for (long i = 0; i < n_out; ++i) {
        double x = step * (double)i;
        long j = (long)x;
        if (j >= n_in - 1) j = n_in - 2;
        double f = x - (double)j;
        out[i] = (float)((1.0 - f) * in[j] + f * in[j + 1]);
    }
}

/* multi-channel int16 -> mono int16 average */
void downmix_i16(const int16_t *in, int16_t *out, long frames, int channels) {
    for (long i = 0; i < frames; ++i) {
        long acc = 0;
        for (int c = 0; c < channels; ++c) acc += in[i * channels + c];
        out[i] = (int16_t)(acc / channels);
    }
}

/* RMS loudness normalization toward target_rms; returns applied gain */
float rms_normalize_f32(float *x, long n, float target_rms) {
    if (n <= 0) return 1.0f;
    double acc = 0.0;
    for (long i = 0; i < n; ++i) acc += (double)x[i] * (double)x[i];
    double rms = sqrt(acc / (double)n);
    if (rms < 1e-8) return 1.0f;
    float gain = (float)(target_rms / rms);
    for (long i = 0; i < n; ++i) x[i] *= gain;
    return gain;
}

/* overlap-discard chunk assembler: copy src[skip:skip+keep] into dst */
void copy_skip_i16(const int16_t *src, int16_t *dst, long skip, long keep) {
    for (long i = 0; i < keep; ++i) dst[i] = src[skip + i];
}
