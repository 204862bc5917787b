// Relative-position attention with the projections outside ("v1") for
// Hopper (sm_90a): K2.
//
// Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
// fused_rel_attention (_attn_kernel), which the reference's encoder runs
// under set_fused_attention("v1") and for every attention with quantized
// projections (models/encoder.py rel_position_attention). Per (b, h), on
// q_u = q + u, q_v = q + v, k, v (B, H, T, hd) and the projected position
// table P (H, 2T-1, hd), row r = relative position T-1-r:
//
//   score[t,s] = ((q_u[t].k[s]) + (q_v[t].P[T-1-t+s])) / sqrt(hd)
//                                       the scale after the sum; -1e9 where
//                                       s >= len (the reference's order)
//   prob = round(exp(score - max) / sum)  f32 softmax normalised BEFORE AV,
//                                       the probabilities rounded to T
//   out[t] = round(sum_s prob[t,s] v[s]) f32 accumulation
//
// What bounds it on the card: the operations, 3 units of B*H*T^2*hd
// multiply-adds on the valid keys (content, position, AV) — at T'=751, B=8,
// H=8, hd=64 0.134 ms of IEEE f32 FMA at 67 TFLOP/s, 0.010 of bf16 on the
// tensor cores, where the inputs' bytes take 0.005. The rounding point is
// what shapes the bf16 design: the probabilities are normalised before they
// are rounded, so a row's max and sum over every key must be known before
// its first AV product (K1's core rounds the unnormalised e and divides
// after AV, one sweep).
//
// bf16: rel_attn_v1_wgmma_kernel, K1's wgmma core (rel_attention.cuh
// rel_attn_wgmma_kernel) in two sweeps over a block's keys. Block: 64 query
// rows of one (b, h), one consumer warpgroup and a producer warp (TMA, a
// 2-stage ring of key tiles of 64 under full/empty mbarriers).
//   sweep 1  S = q_u K^T (wgmma m64n64), R = q_v Band^T (m64n128), R
//            pre-skewed through the 64 x 68 f32 buffer onto S, (S + R) *
//            scale, masked; the running row max and rescaled sum
//   merge    where the plan splits the keys over a thread-block cluster,
//            the splits' maxima and sums in split order through
//            distributed shared memory: every split holds the row's max M
//            and sum L over all keys
//   sweep 2  the scores again (or, KEEP, read back from the shared memory
//            where sweep 1 left them), p = round(exp(s - M) / L) packed in
//            the accumulator layout as wgmma's A from registers, O += P V
//            on wgmma with V's rows as they come (B MN-major, wgmma's
//            transposed B: no transposed copy of v)
//   close    unsplit: O rounded; split: the splits' O summed in split order
//            in distributed shared memory, rounded once
// Recomputing costs 5 units of B*H*T^2*hd on the tensor cores against 3;
// KEEP (the plan's `kept` key tiles of 64 x 64 f32 scores a split, the
// keys split until a split's tiles fit) trades the recompute for shared
// memory and one block an SM. The plan (ops/rel_attention.py v1_core_plan)
// picks the splits (where the grid underfills a wave, as K1's core_plan)
// and whether sweep 2 recomputes.
//
// f32: K1's 8-warp core (rel_attn_f32_kernel<HD, true>: 256 threads,
// register-blocked score patches, a cp.async ring; IEEE FMA on the CUDA
// cores, no TF32, no tensor cores) on K2's operands: the scale after the
// sum, P per head, the output (B, H, T, hd). It divides after AV: in f32
// the reference's rounding of the normalised probabilities is the
// identity, so only the place of one f32 division an output moves
// (ops/kernel_numerics.py). Keys split in a cluster as K1's core_plan says.
//
// Both cores take every T (keys in tiles, no length cap: the reference's
// v1 path stops at T = 768 for VMEM, past which it runs XLA attention, the
// same function) and hd 32, 64 and 128.
//
// Measured (chip_smoke.py, device ms, B=8, H=8, mixed lengths; NVIDIA H100
// 80GB HBM3, 700.00 W), hd 64 at T'=126 / 751 / 1001, then hd 128 at 751:
// bf16 0.0142 / 0.177 / 0.253, 0.317 (2.1-2.4x K1's bf16 core on the same
// scores: the CUDA-core work of two sweeps); f32 0.0202 / 0.416 / 0.603,
// 0.863 (level with K1's f32 core). Keeping the scores: 0.0142 against
// 0.0161 recomputed at T'=126, 0.334 against 0.175 at 751. The design
// before, on the CUDA cores in both dtypes with a block's score rows in
// shared memory, in turns on the same inputs: bf16 0.0398 / 0.678 / 1.143,
// 1.113; f32 0.0382 / 0.758 / 1.285, 2.081.
//
// Plain C interface, loaded with ctypes. Returns cudaGetLastError() (0 =
// success).

#include "rel_attention.cuh"

namespace {

// K2's scores kept between the sweeps: one 64 x 64 f32 tile a key tile, in
// the consumers' accumulator layout (float i of thread c at i * 128 + c)
constexpr int V1_KEPT_TILE = 64 * 64 * 4;

struct V1Maps {
  CUtensorMap q[2];  // q_u, q_v: (hd, T, B H), boxes of 64 x 64 rows (hd >= 64)
  CUtensorMap k;     // keys, as q
  CUtensorMap pos;   // P: (hd, 2T - 1, H), boxes of 64 x 128 rows (hd >= 64)
  CUtensorMap v;     // values: (hd, T, B H), boxes of min(hd, 64) x 64 keys
};

// wgmma descriptor of a value tile as it lands, 64 key rows of min(hd, 64)
// values, read MN-major (wgmma's transposed B): the 8-row groups along the
// keys 1,024 bytes apart under the 128-byte swizzle (hd >= 64, one 64-value
// chunk of the head dims) or 512 under the 64-byte one (hd = 32; the
// leading offset is not read, N being one swizzle width); k16 step kk
// starts 16 rows further
template <int HD>
__device__ __forceinline__ uint64_t v1_value_desc(const void* tile, int kk) {
  constexpr uint32_t ROW = HD >= 64 ? 128 : 64;
  return (uint64_t)(((smem_u32(tile) + kk * 16 * ROW) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * ROW >> 4) << 32) | ((uint64_t)(HD >= 64 ? 1 : 2) << 62);
}

// A consumer thread's scores of key tile key0 .. key0 + 63 from stage st
// (keys, then their band of 128 position rows), in the accumulator layout:
// (S + R) * scale, -1e9 past the length, -inf past the keys an item
// averages. K1's products and skew (rel_attention.cuh rel_attn_wgmma_kernel).
template <int HD>
__device__ __forceinline__ void v1_scores(float (&sc)[32], const bf16* q_u, const bf16* q_v, const unsigned char* st,
                                          float* skew, int warp, int lane, int key0, int n_keys, int kv_len,
                                          float scale) {
  using W = WgTile<HD>;
  constexpr int BM = W::BM, BN = W::BN, NB = W::NB, HC = W::HC, KK = W::KK, SLD = W::SLD;
  const int g = lane >> 2, q4 = lane & 3;
  const bf16* ks = reinterpret_cast<const bf16*>(st);
  const bf16* bs = reinterpret_cast<const bf16*>(st + W::K_BYTES);
  float rr[64];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) rr[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_m64n64k16(sc, sw128_desc(q_u + c * BM * 64) + 2 * kk, sw128_desc(ks + c * BN * 64) + 2 * kk);
#pragma unroll
  for (int c = 0; c < HC; ++c)
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      wgmma_m64n128k16(rr, sw128_desc(q_v + c * BM * 64) + 2 * kk, sw128_desc(bs + c * NB * 64) + 2 * kk);
  wgmma_commit();
  wgmma_wait<0>();
  // the position term: R[i][c] lands on S[i][c + i - 63]
  __syncwarp();  // the warp's reads of the previous tile are done
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * q4 + (i & 1);
    const int j = col + row - (BM - 1);
    if (j >= 0 && j < BN) skew[row * SLD + j] = rr[i];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * q4 + (i & 1);
    const float v = (sc[i] + skew[row * SLD + col]) * scale;
    const int key = key0 + col;
    sc[i] = key >= n_keys ? -INFINITY : key >= kv_len ? -1e9f : v;
  }
}

template <int HD, bool KEEP>
__global__ void __launch_bounds__(160, HD == 128 || KEEP ? 1 : 2)
    rel_attn_v1_wgmma_kernel(const __grid_constant__ CoreArgs a, const __grid_constant__ V1Maps maps) {
  using W = WgTile<HD>;
  constexpr int BM = W::BM, BN = W::BN, NB = W::NB, HC = W::HC, SLD = W::SLD;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char v1_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(v1_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* q_u = reinterpret_cast<bf16*>(base);
  bf16* q_v = reinterpret_cast<bf16*>(base + W::Q_BYTES);
  unsigned char* stages = base + 2 * W::Q_BYTES;
  float* skew = reinterpret_cast<float*>(stages + 2 * W::STAGE);
  float* mrow = skew + BM * SLD;
  float* lrow = mrow + BM;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(lrow + BM);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + 2;
  float* kept = reinterpret_cast<float*>(qbar + 8);  // KEEP: a split's scores, V1_KEPT_TILE a key tile

  const int Tn = a.Tn, H = a.H, S = a.S;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int z = blockIdx.x % S, t0 = blockIdx.x / S * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kv_len = min(a.lengths[b], Tn);
  const int n_keys = kv_len > 0 ? kv_len : Tn;  // no valid key: the average of all Tn
  int it0, it1;
  core_range(n_keys, Tn, BN, S, z, it0, it1);
  const int n = max(0, it1 - it0);  // this split's key tiles; steps 0 .. n-1 sweep 1, n .. 2n-1 sweep 2

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float o[HD / 2];
  if (warp == 4) {
    // producer: q_u and q_v once; per step its stage's keys and band
    // (sweep 1; sweep 2 unless KEEP) and values (sweep 2)
    const size_t head = (size_t)bh * Tn * HD;
    if constexpr (HD >= 64) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * W::Q_BYTES);
#pragma unroll
        for (int c = 0; c < HC; ++c) {
          tma_3d(q_u + c * BM * 64, &maps.q[0], 64 * c, t0, bh, qbar);
          tma_3d(q_v + c * BM * 64, &maps.q[1], 64 * c, t0, bh, qbar);
        }
      }
    } else {
      wg_fill32<BM>(q_u, static_cast<const bf16*>(a.qu) + head, HD, t0, Tn, lane);
      wg_fill32<BM>(q_v, static_cast<const bf16*>(a.qv) + head, HD, t0, Tn, lane);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(qbar);
    }
    // the first two steps of sweep 2 wait only for stages that sweep 1
    // frees, so they are issued before the cluster's exchange of row
    // statistics, which the consumers join after sweep 1
    const int exchange_at = min(2 * n, n + 2);
    for (int k = 0; k < 2 * n; ++k) {
      if (S > 1 && k == exchange_at) cg::this_cluster().sync();
      const int s = k & 1;
      if (k >= 2) mbar_wait(&empty[s], ((k >> 1) - 1) & 1);
      const bool second = k >= n, scores = !second || !KEEP;
      const int key0 = (it0 + (second ? k - n : k)) * BN, prow = Tn - BM - t0 + key0;  // band row j: P[prow + j]
      unsigned char* st = stages + s * W::STAGE;
      bf16* ks = reinterpret_cast<bf16*>(st);
      bf16* bs = reinterpret_cast<bf16*>(st + W::K_BYTES);
      bf16* vs = reinterpret_cast<bf16*>(st + W::K_BYTES + W::B_BYTES);
      if constexpr (HD >= 64) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], (scores ? W::K_BYTES + W::B_BYTES : 0) + (second ? W::V_BYTES : 0));
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            if (scores) {
              tma_3d(ks + c * BN * 64, &maps.k, 64 * c, key0, bh, &full[s]);
              tma_3d(bs + c * NB * 64, &maps.pos, 64 * c, prow, h, &full[s]);
            }
            if (second) tma_3d(vs + c * BN * 64, &maps.v, 64 * c, key0, bh, &full[s]);
          }
        }
      } else {
        if (scores) {
          wg_fill32<BN>(ks, static_cast<const bf16*>(a.kh) + head, HD, key0, Tn, lane);
          wg_fill32<NB>(bs, static_cast<const bf16*>(a.pos) + (size_t)h * (2 * Tn - 1) * HD, HD, prow, 2 * Tn - 1,
                        lane);
          fence_proxy_async();
        }
        __syncwarp();
        if (lane == 0) {
          if (second) {
            mbar_expect_tx(&full[s], W::V_BYTES);
            tma_3d(vs, &maps.v, 0, key0, bh, &full[s]);
          } else {
            mbar_arrive(&full[s]);
          }
        }
      }
    }
    if (S > 1 && exchange_at == 2 * n) cg::this_cluster().sync();
  } else {
    // consumers: thread (warp, g, q4) holds rows 16 warp + g (+ 8) and, of
    // every 8 columns, 2 q4 and 2 q4 + 1 of S, R and O
    const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    mbar_wait(qbar, 0);

    // sweep 1: the running max and the sum of exp(score - max), rescaled
    // as the max grows (a row over the 4 lanes that hold it)
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int k = 0; k < n; ++k) {
      const int s = k & 1;
      mbar_wait(&full[s], (k >> 1) & 1);
      float sc[32];
      v1_scores<HD>(sc, q_u, q_v, stages + s * W::STAGE, skew, warp, lane, (it0 + k) * BN, n_keys, kv_len, a.scale);
      if (lane == 0) mbar_arrive(&empty[s]);  // the products are done: the stage goes back to the producer
      if constexpr (KEEP) {
#pragma unroll
        for (int i = 0; i < 32; ++i) kept[(k * 32 + i) * 128 + tid] = sc[i];
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        l[r] *= expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) l[(i >> 1) & 1] += expf(sc[i] - m[(i >> 1) & 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    // every split's max and sum of the row, merged in split order
    if (S > 1) {
      if (q4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mrow[16 * warp + g + 8 * r] = m[r];
          lrow[16 * warp + g + 8 * r] = l[r];
        }
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r;
        float M = -INFINITY, L = 0.f;
        for (int zz = 0; zz < S; ++zz) M = fmaxf(M, cluster.map_shared_rank(mrow, zz)[row]);
        for (int zz = 0; zz < S; ++zz)
          L += cluster.map_shared_rank(lrow, zz)[row] * expf(cluster.map_shared_rank(mrow, zz)[row] - M);
        m[r] = M;
        l[r] = L;
      }
    }

    // sweep 2: the normalised probabilities, rounded to bf16, times v
    for (int j = 0; j < n; ++j) {
      const int k = n + j, s = k & 1;
      mbar_wait(&full[s], (k >> 1) & 1);
      const unsigned char* st = stages + s * W::STAGE;
      float sc[32];
      if constexpr (KEEP) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = kept[(j * 32 + i) * 128 + tid];
      } else {
        v1_scores<HD>(sc, q_u, q_v, st, skew, warp, lane, (it0 + j) * BN, n_keys, kv_len, a.scale);
      }
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        pa[i >> 1] = pack_bf16(expf(sc[i] - m[r]) / l[r], expf(sc[i + 1] - m[r]) / l[r]);
      }
      const bf16* vs = reinterpret_cast<const bf16*>(st + W::K_BYTES + W::B_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a4[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        if constexpr (HD == 32) {
          wgmma_m64n32k16_rs<1>(o, a4, v1_value_desc<HD>(vs, kk));
        } else {
          // hd 128: the two 64-value chunks of the head dims, each a tile
          // (the accumulator's columns 64 c .. 64 c + 63 are o[32 c ..])
#pragma unroll
          for (int c = 0; c < HC; ++c)
            wgmma_m64n64k16_rs<1>(*reinterpret_cast<float(*)[32]>(o + 32 * c), a4,
                                  v1_value_desc<HD>(vs + c * BN * 64, kk));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  bf16* out = static_cast<bf16*>(a.ctx) + (size_t)bh * Tn * HD;
  const int g = lane >> 2, q4 = lane & 3;
  if (S == 1) {
    if (warp == 4) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 16 * warp + g + 8 * r;
      if (t >= Tn) continue;
#pragma unroll
      for (int i = 2 * r; i < HD / 2; i += 4) {
        const int col = 8 * (i >> 2) + 2 * q4;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)t * HD + col) = __floats2bfloat162_rn(o[i], o[i + 1]);
      }
    }
    return;
  }
  __syncthreads();  // every product and copy of the block is done: the stages are free
  float* ost = reinterpret_cast<float*>(stages);  // BM x OLD
  if (warp < 4) {
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int row = 16 * warp + g + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * q4;
      *reinterpret_cast<float2*>(ost + row * W::OLD + col) = make_float2(o[i], o[i + 1]);
    }
  }
  core_cluster_close<bf16, true>(ost, W::OLD, nullptr, nullptr, BM, HD, S, z, out, HD, t0, Tn, tid, 160);
}

// Dynamic shared memory of the bf16 core with `kept` score tiles a split
// (ops/rel_attention.py v1_core_plan computes the same number)
template <int HD>
constexpr int v1_wgmma_smem(int kept) {
  return WgTile<HD>::SMEM + kept * V1_KEPT_TILE;
}

template <int HD>
cudaError_t launch_v1_wgmma(const CoreArgs& c, int B, int kept, int smem, cudaStream_t stream) {
  if (smem != v1_wgmma_smem<HD>(kept) || kept < 0) return cudaErrorInvalidValue;
  const int BH = B * c.H, T = c.Tn;
  V1Maps maps{};
  const cuuint64_t qd[3] = {(cuuint64_t)HD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t qs[2] = {(cuuint64_t)HD * 2, (cuuint64_t)T * HD * 2};
  const cuuint32_t qb[3] = {64, 64, 1};
  const cuuint64_t pd[3] = {(cuuint64_t)HD, (cuuint64_t)(2 * T - 1), (cuuint64_t)c.H};
  const cuuint64_t ps[2] = {(cuuint64_t)HD * 2, (cuuint64_t)(2 * T - 1) * HD * 2};
  const cuuint32_t pb[3] = {64, 128, 1};
  const cuuint32_t vb[3] = {HD >= 64 ? 64u : 32u, 64, 1};
  bool ok = encode_bf16_box(&maps.v, c.vh, 3, qd, qs, vb,
                            HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (HD >= 64)
    ok = ok && encode_bf16_box(&maps.q[0], c.qu, 3, qd, qs, qb) && encode_bf16_box(&maps.q[1], c.qv, 3, qd, qs, qb) &&
         encode_bf16_box(&maps.k, c.kh, 3, qd, qs, qb) && encode_bf16_box(&maps.pos, c.pos, 3, pd, ps, pb);
  if (!ok) return cudaErrorInvalidValue;
  if (kept > 0) return launch_core(rel_attn_v1_wgmma_kernel<HD, true>, 64, 160, smem, c, B, stream, maps);
  return launch_core(rel_attn_v1_wgmma_kernel<HD, false>, 64, 160, smem, c, B, stream, maps);
}

template <int HD>
cudaError_t launch_v1_f32(const CoreArgs& c, int B, int smem, cudaStream_t stream) {
  using F = F32Tile<HD>;
  if (smem != F::SMEM) return cudaErrorInvalidValue;
  return launch_core(rel_attn_f32_kernel<HD, true>, F::BM, F::THREADS, F::SMEM, c, B, stream);
}

int run_v1(int dtype, const CoreArgs& c, int B, int HD, int kept, int smem, cudaStream_t stream) {
  if (c.S != 1 && c.S != 2 && c.S != 4 && c.S != 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && kept == 0) {
    switch (HD) {
      case 32: return (int)launch_v1_f32<32>(c, B, smem, stream);
      case 64: return (int)launch_v1_f32<64>(c, B, smem, stream);
      case 128: return (int)launch_v1_f32<128>(c, B, smem, stream);
    }
  } else if (dtype == 1) {
    switch (HD) {
      case 32: return (int)launch_v1_wgmma<32>(c, B, kept, smem, stream);
      case 64: return (int)launch_v1_wgmma<64>(c, B, kept, smem, stream);
      case 128: return (int)launch_v1_wgmma<128>(c, B, kept, smem, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qu, qv, kh, vh, out (B, H, T, hd); pos
// (H, 2T-1, hd), all in the activation dtype; lengths (B,) int32 valid keys.
// hd in {32, 64, 128}. splits, kept, smem: the launch plan
// (ops/rel_attention.py v1_core_plan): key splits of each query tile (1, 2,
// 4 or 8, a thread-block cluster), the bf16 core's score tiles kept a split
// between its sweeps (0: recomputed; f32: 0) and the dynamic shared memory,
// refused if it disagrees with the kernel's layout.
int pk_rel_attention_v1(int dtype, const void* qu, const void* qv, const void* kh, const void* vh,
                        const void* pos, const int* lengths, void* out, int B, int H, int T,
                        int HD, int splits, int kept, int smem, void* stream) {
  if (B * H * T == 0) return 0;
  const CoreArgs c = {qu, qv, kh, vh, pos, lengths, out, T, H, splits, 0, 1.f / sqrtf((float)HD)};
  return run_v1(dtype, c, B, HD, kept, smem, static_cast<cudaStream_t>(stream));
}

// Blocks of K2's core one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error:
// what v1_core_plan's `resident` is checked against
int pk_rel_attention_v1_resident(int dtype, int hd, int kept) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return core_resident(rel_attn_f32_kernel<32, true>, F32Tile<32>::THREADS, F32Tile<32>::SMEM);
      case 64: return core_resident(rel_attn_f32_kernel<64, true>, F32Tile<64>::THREADS, F32Tile<64>::SMEM);
      case 128: return core_resident(rel_attn_f32_kernel<128, true>, F32Tile<128>::THREADS, F32Tile<128>::SMEM);
    }
  } else if (dtype == 1 && kept > 0) {
    switch (hd) {
      case 32: return core_resident(rel_attn_v1_wgmma_kernel<32, true>, 160, v1_wgmma_smem<32>(kept));
      case 64: return core_resident(rel_attn_v1_wgmma_kernel<64, true>, 160, v1_wgmma_smem<64>(kept));
      case 128: return core_resident(rel_attn_v1_wgmma_kernel<128, true>, 160, v1_wgmma_smem<128>(kept));
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return core_resident(rel_attn_v1_wgmma_kernel<32, false>, 160, v1_wgmma_smem<32>(0));
      case 64: return core_resident(rel_attn_v1_wgmma_kernel<64, false>, 160, v1_wgmma_smem<64>(0));
      case 128: return core_resident(rel_attn_v1_wgmma_kernel<128, false>, 160, v1_wgmma_smem<128>(0));
    }
  }
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
