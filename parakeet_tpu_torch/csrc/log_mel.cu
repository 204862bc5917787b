// Fused log-mel spectrogram for Hopper (sm_90a): K3.
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_frontend.py::
// fused_log_mel (_frontend_kernel), reached through
// audio/frontend.py::preprocess_audio_fused. On one preemphasized,
// reflect-padded clip x (N,) f32, for T = (N - n_fft)/hop + 1 frames:
//
//   re[t,f], im[t,f] = sum_k x[t*hop + k] * Wc[k,f], ... * Ws[k,f]
//                      Wc, Ws = window * cos / sin of the DFT angle, f32
//   power[t,f]       = re*re + im*im
//   out[t,m]         = log(sum_f power[t,f] * fb[f,m] + 2^-24)
//
// Two launches on the caller's stream:
//   the DFT            ffn_gemm.cuh's tiled GEMM over bins 0 .. n_fft/2 - 1
//                      with A the waveform itself, rows hop apart (lda =
//                      hop): frame t is x[t*hop .. t*hop + n_fft), so no
//                      frame matrix is built. The caller lays W out as 64
//                      cos rows then their 64 sin rows per 128-column tile.
//                      One slice: the FE_POWER epilogue writes the power
//                      (T, n_fft/2). Several k slices (splits > 1): the
//                      FE_PARTIAL epilogue writes each slice's re and im
//                      sums (splits, T, columns) f32
//   log_mel_close      one block per 8 frames: the power of the block's
//                      frames (read, or formed from the slices summed in
//                      order), the Nyquist bin n_fft/2 as a dot product of
//                      each frame with its cos and sin rows, then the mel
//                      product over each filter's band of nonzero weights
//                      and the log, from shared memory
// IEEE f32 throughout (no TF32), as the reference runs Precision.HIGHEST.
//
// What bounds it on the card: operations, the DFT's 2 * T * n_fft * (n_fft
// + 2) FLOPs (0.53 GFLOP for 10 s of audio at n_fft 512, hop 160; 3.16 at
// 60 s) against a few MB of samples, matrices and output. The design keeps
// the FMA units fed where the old 64x64 GEMM did not: the DFT runs on the
// GEMM that reaches 32-36 TFLOP/s in K6. Two things limit it on one clip:
//   - few blocks: 10 s give 16 x 4 tiles of 64 frames, under the card's
//     132 SMs, and a nonlinear epilogue cannot split k. The plan
//     (ops/gemm_plan.py dft_plan) splits k into slices of linear partials
//     when the tiles alone would leave SMs idle; the closing pass, which
//     replaces the old second GEMM launch, then forms the power;
//   - 257 bins = 4 x 64 + 1: a fifth column tile would carry one bin, so
//     the Nyquist bin is taken in the closing pass instead (n_fft FMAs a
//     frame, against 128 x n_fft for a tile).
// The mel product stays in the closing pass: the Slaney filterbank's 80
// triangles hold 501 nonzero weights of 257 x 80, one contiguous band per
// filter, so each output sums its band (2 to 19 bins) in bin order, which
// gives the dense product's sum exactly (the skipped terms add +0). A
// dense sum read the filterbank 257 times per output and cost 0.037 ms a
// call, latency-bound, whatever the clip's length.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "ffn_gemm.cuh"

namespace {

constexpr int LM_ROWS = 8, LM_THREADS = 256;  // frames per block of the closing pass
constexpr int TILE_BINS = FBN / 2;
constexpr float LOG_GUARD = 5.96046448e-8f;  // 2^-24

// Shared memory of the closing pass (floats): the block's power rows, the
// Nyquist bin's two rows, the filterbank's bands and their starts and
// offsets (ints)
inline int close_smem_bytes(int n_half, int n_fft, int nnz, int n_mels) {
  return (LM_ROWS * (n_half + 1) + 2 * n_fft + nnz + 2 * n_mels + 1) * (int)sizeof(float);
}

// spec: (T, n_half) power when splits == 0, else (splits, T, n_cols) re/im
// partials in the DFT tile layout. nyq: (2, n_fft) window·cos and
// window·sin of the Nyquist bin. The filterbank as its bands: mel m's
// weights band_w[band_off[m] .. band_off[m + 1]) for bins band_lo[m] on;
// every weight outside the band is 0, so the band's sum in bin order is
// the dense product's.
__global__ void __launch_bounds__(LM_THREADS) log_mel_close_kernel(
    const float* __restrict__ spec, int splits, const float* __restrict__ x, int hop, int n_fft,
    const float* __restrict__ nyq, const float* __restrict__ band_w, const int* __restrict__ band_lo,
    const int* __restrict__ band_off, float* __restrict__ out, int T, int n_half, int n_cols, int n_mels) {
  extern __shared__ float lm_smem[];
  const int ldp = n_half + 1, nnz = band_off[n_mels];
  float* ps = lm_smem;                    // LM_ROWS x (n_half + 1) power rows
  float* nq = ps + LM_ROWS * ldp;         // 2 x n_fft
  float* bw = nq + 2 * n_fft;             // nnz band weights
  int* blo = reinterpret_cast<int*>(bw + nnz);  // n_mels band starts
  int* boff = blo + n_mels;               // n_mels + 1 band offsets
  const int t0 = blockIdx.x * LM_ROWS, tid = threadIdx.x;
  const int rows = min(LM_ROWS, T - t0);
  for (int i = tid; i < 2 * n_fft; i += LM_THREADS) nq[i] = nyq[i];
  for (int i = tid; i < nnz; i += LM_THREADS) bw[i] = band_w[i];
  for (int i = tid; i <= n_mels; i += LM_THREADS) {
    boff[i] = band_off[i];
    if (i < n_mels) blo[i] = band_lo[i];
  }
  for (int i = tid; i < rows * n_half; i += LM_THREADS) {
    const int r = i / n_half, f = i - r * n_half, t = t0 + r;
    float p;
    if (splits == 0) {
      p = spec[(size_t)t * n_half + f];
    } else {
      // tile f / 64 holds re of its 64 bins in columns 0-63, im in 64-127
      const float* pz = spec + (size_t)t * n_cols + (f / TILE_BINS) * FBN + f % TILE_BINS;
      const size_t slice = (size_t)T * n_cols;
      float re = 0.f, im = 0.f;
#pragma unroll 4
      for (int z = 0; z < splits; ++z) {
        re += pz[z * slice];
        im += pz[z * slice + TILE_BINS];
      }
      p = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    }
    ps[r * ldp + f] = p;
  }
  __syncthreads();
  // the Nyquist bin: one warp per frame
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += LM_THREADS / 32) {
    const float* fr = x + (size_t)(t0 + r) * hop;
    float re = 0.f, im = 0.f;
#pragma unroll 4
    for (int k = lane; k < n_fft; k += 32) {
      const float v = fr[k];
      re = fmaf(v, nq[k], re);
      im = fmaf(v, nq[n_fft + k], im);
    }
    re = warp_sum(re);
    im = warp_sum(im);
    if (lane == 0) ps[r * ldp + n_half] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
  }
  __syncthreads();
  // mel and log over each filter's band
  for (int i = tid; i < rows * n_mels; i += LM_THREADS) {
    const int r = i / n_mels, m = i - r * n_mels;
    const float* p = ps + r * ldp + blo[m];
    const int o0 = boff[m], n = boff[m + 1] - o0;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(p[j], bw[o0 + j], acc);
    out[(size_t)(t0 + r) * n_mels + m] = logf(acc + LOG_GUARD);
  }
}

}  // namespace

extern "C" {

// x (N,) f32, 16-byte aligned; wdft (n_cols, n_fft) f32, the window·cos
// and window·sin rows of bins 0 .. n_fft/2 - 1 in the tile layout above
// (n_cols = 128 * ceil(n_fft / 128), zero rows past the last bin); nyq
// (2, n_fft); the mel filterbank as bands: band_w (nnz,) f32, band_lo
// (n_mels,) and band_off (n_mels + 1,) int32 (band_off[n_mels] = nnz).
// rows, splits: the DFT's block rows (64, 96 or 128) and k slices from the
// plan. Scratch (allocated by the caller): spec, (T, n_fft/2) f32 when
// splits == 1, else (splits, T, n_cols). out (T, n_mels) f32.
int pk_log_mel(const float* x, const float* wdft, const float* nyq, const float* band_w,
               const int* band_lo, const int* band_off, int nnz, float* spec, float* out, int T,
               int hop, int n_fft, int n_mels, int rows, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_half = n_fft / 2, n_cols = (n_half + TILE_BINS - 1) / TILE_BINS * FBN;
  if (T <= 0 || n_fft % 2 != 0) return (int)cudaErrorInvalidValue;
  FfnGemmArgs dft = {};
  dft.a = x;
  dft.lda = hop;
  dft.w[0] = wdft;
  dft.out[0] = spec;
  dft.M = T; dft.N = n_cols; dft.K = n_fft;
  cudaError_t err;
  if (splits == 1) {
    dft.nseg = n_half;
    err = launch_tiled_gemm_rows<float, FE_POWER>(dft, rows, s);
  } else {
    err = launch_tiled_gemm_rows<float, FE_PARTIAL>(dft, rows, s, splits);
  }
  if (err != cudaSuccess) return (int)err;

  const int smem = close_smem_bytes(n_half, n_fft, nnz, n_mels);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(log_mel_close_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  log_mel_close_kernel<<<(T + LM_ROWS - 1) / LM_ROWS, LM_THREADS, smem, s>>>(
      spec, splits == 1 ? 0 : splits, x, hop, n_fft, nyq, band_w, band_lo, band_off, out, T, n_half,
      n_cols, n_mels);
  return (int)cudaGetLastError();
}

}  // extern "C"
