// parakeet-tpu native runtime components.
//
// C++ implementations of the host-side hot paths that the C++ reference also
// keeps native (audio_io.cpp): the windowed-sinc Kaiser resampler (an
// O(N*32) inner loop), channel downmix, and int16->float conversion.
// Numerics match audio_io.cpp:96-195 exactly (Kaiser beta=7.857, half-width
// 16, cutoff min(1, dst/src), widened filter when downsampling, per-output
// weight-sum normalization, GCD rate simplification).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

// Modified Bessel I0 via the standard power series (matches the reference's
// 30-term expansion with early exit).
double bessel_i0(double x) {
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 30; ++k) {
        term *= (x * x) / (4.0 * static_cast<double>(k) * k);
        sum += term;
        if (term < 1e-12 * sum) break;
    }
    return sum;
}

constexpr int kHalfWidth = 16;
constexpr double kBeta = 7.857;  // ~80 dB stopband

}  // namespace

extern "C" {

// Output length for sinc_resample given input length and rates.
int64_t pk_resample_out_len(int64_t input_len, int src_rate, int dst_rate) {
    if (src_rate == dst_rate) return input_len;
    int g = std::gcd(src_rate, dst_rate);
    int64_t up = dst_rate / g, down = src_rate / g;
    return (input_len * up + down - 1) / down;
}

// Windowed-sinc resample: out must hold pk_resample_out_len() floats.
void pk_sinc_resample(const float* input, int64_t input_len, int src_rate,
                      int dst_rate, float* output) {
    if (src_rate == dst_rate) {
        std::copy(input, input + input_len, output);
        return;
    }
    const int64_t out_len = pk_resample_out_len(input_len, src_rate, dst_rate);
    const double ratio = static_cast<double>(src_rate) / dst_rate;
    const double cutoff = std::min(1.0, 1.0 / std::max(ratio, 1.0));
    const double width_factor = std::max(1.0, ratio);
    const double sample_ratio = static_cast<double>(dst_rate) / src_rate;

    // Precompute the Kaiser denominator once.
    const double i0_beta = bessel_i0(kBeta);

    for (int64_t i = 0; i < out_len; ++i) {
        const double src_pos = static_cast<double>(i) / sample_ratio;
        const int64_t center = static_cast<int64_t>(std::floor(src_pos));
        double sum = 0.0, weight_sum = 0.0;
        const int64_t start = center - kHalfWidth + 1;
        const int64_t end = center + kHalfWidth;
        for (int64_t j = start; j <= end; ++j) {
            if (j < 0 || j >= input_len) continue;
            const double dist = src_pos - static_cast<double>(j);
            const double window_pos = dist / width_factor;
            if (std::abs(window_pos) > kHalfWidth) continue;
            const double n = window_pos + kHalfWidth;
            const double arg = 2.0 * n / (2.0 * kHalfWidth) - 1.0;
            const double val = std::max(1.0 - arg * arg, 0.0);
            const double w = bessel_i0(kBeta * std::sqrt(val)) / i0_beta;
            const double x = dist * cutoff * M_PI;
            const double sinc_val = (std::abs(x) < 1e-10) ? 1.0 : std::sin(x) / x;
            const double weight = sinc_val * w * cutoff;
            sum += input[j] * weight;
            weight_sum += weight;
        }
        output[i] = (weight_sum > 1e-10) ? static_cast<float>(sum / weight_sum) : 0.0f;
    }
}

// Mean-downmix interleaved multi-channel to mono (audio_io.cpp:198-214).
void pk_downmix_to_mono(const float* interleaved, int64_t frames, int channels,
                        float* output) {
    const double inv = 1.0 / channels;
    for (int64_t i = 0; i < frames; ++i) {
        double acc = 0.0;
        const float* p = interleaved + i * channels;
        for (int c = 0; c < channels; ++c) acc += p[c];
        output[i] = static_cast<float>(acc * inv);
    }
}

// int16 PCM -> float32 in [-1, 1) with 1/32768 scaling.
void pk_int16_to_float(const int16_t* input, int64_t n, float* output) {
    constexpr float kScale = 1.0f / 32768.0f;
    for (int64_t i = 0; i < n; ++i) output[i] = input[i] * kScale;
}

// Preemphasis y[i] = x[i] - coeff*x[i-1]; `prev` carries streaming state.
// Returns the new `prev` (last raw input sample). One rounding (a fused
// multiply-add): what `cur - coeff * prev` compiles to under the
// reference's -march=native on a host with FMA, here on every host.
float pk_preemphasis(const float* input, int64_t n, float coeff, float prev,
                     float* output) {
    for (int64_t i = 0; i < n; ++i) {
        const float cur = input[i];
        output[i] = std::fma(-coeff, prev, cur);
        prev = cur;
    }
    return prev;
}

int pk_native_abi_version(void) { return 1; }

}  // extern "C"
