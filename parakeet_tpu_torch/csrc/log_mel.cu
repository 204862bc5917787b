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
// Two launches of gemm.cuh's tiled GEMM on the caller's stream:
//   gemm_nt_kernel<POWER>  A is the waveform itself with rows hop apart
//                          (lda = hop < K = n_fft): frame t is x[t*hop ..
//                          t*hop + n_fft), so no frame matrix is built. The
//                          cos and sin rows of W are interleaved as the tile
//                          is loaded (as K5 interleaves the GLU halves), so
//                          each thread holds re and im of its bins and
//                          writes the power (T, n_fft/2+1); the (T, 2F)
//                          spectrum never reaches device memory
//   gemm_nt_kernel<LOG>    power @ fb, log(. + 2^-24) in the epilogue
// IEEE f32 throughout (no TF32), as the reference runs Precision.HIGHEST.
//
// What bounds it on the card: the DFT GEMM, 2 * T * n_fft * 2F FLOPs (0.53
// GFLOP for 10 s of audio at n_fft 512, hop 160), on the CUDA cores in f32
// FMA; the waveform (4 bytes a sample, each read from L1/L2 by the
// n_fft/hop = 3.2 frames that overlap it) and the power (T x 257 x 4
// bytes) are small. One clip gives few tiles (288 blocks of 32 frames x 64
// columns at 10 s), so a batch of clips in one launch is later work.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "gemm.cuh"

extern "C" {

// x (N,) f32; wcos, wsin (n_freqs, n_fft) f32, the window-weighted DFT
// matrices transposed; fb_t (n_mels, n_freqs) f32, the mel filterbank
// transposed. Scratch (allocated by the caller): power (T, n_freqs) f32.
// out (T, n_mels) f32.
int pk_log_mel(const float* x, const float* wcos, const float* wsin, const float* fb_t,
               float* power, float* out, int T, int hop, int n_fft, int n_freqs, int n_mels,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  GemmArgs dft = {};
  dft.a = x;
  dft.lda = hop;
  dft.w[0] = wcos;
  dft.w[1] = wsin;
  dft.out[0] = power;
  dft.M = T; dft.N = 2 * n_freqs; dft.K = n_fft; dft.nseg = n_freqs;
  if ((err = launch_gemm<float, EPI_POWER>(dft, s)) != cudaSuccess) return (int)err;

  GemmArgs mel = {};
  mel.a = power;
  mel.w[0] = fb_t;
  mel.out[0] = out;
  mel.M = T; mel.N = n_mels; mel.K = n_freqs; mel.nseg = n_mels;
  if ((err = launch_gemm<float, EPI_LOG>(mel, s)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
