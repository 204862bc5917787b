// Device code and launch sequences of K1, the fused rel-pos attention block
// (see rel_attention.cu for what it computes, what bounds it and what the
// design does about it): the two attention cores (bf16 on the tensor
// cores, f32 on the CUDA cores), their split over keys inside a
// thread-block cluster, and run_block, which launches the whole block on
// the caller's stream. The GEMMs are ffn_gemm.cuh's. Included by
// rel_attention.cu and ffn_attention.cu.
#pragma once

#include "ffn_gemm.cuh"

namespace {

// ─── The split over keys ─────────────────────────────────────────────────────
// A core launch runs S = `splits` blocks (1, 2, 4 or 8) for every query tile
// of every (b, h), as one thread-block cluster: split z takes key tiles
// [z tps, (z + 1) tps) of the ceil(T / BN) (tps = ceil(tiles / S)), cut at
// the item's own key count. Each leaves its rows' running max, sum and
// unnormalised output in its shared memory; the cluster then merges them
// through distributed shared memory, split z closing rows [z, z + 1) BM / S
// in the order 0, 1, ..., S - 1. No partial reaches device memory, no
// other launch runs, and a run repeats bit for bit. The plan
// (ops/rel_attention.py core_plan) picks S.

__device__ __forceinline__ void core_range(int n_keys, int Tn, int BN, int S, int z, int& it0, int& it1) {
  const int tiles = (Tn + BN - 1) / BN, tps = (tiles + S - 1) / S;
  it0 = z * tps;
  it1 = min((n_keys + BN - 1) / BN, it0 + tps);
}

// The merge, run by every thread of every block of the cluster once the
// block's f32 output rows (ost, `old` floats a row), row maxima and row sums
// are in its shared memory: out[t, c] = sum_z o_z w_z / sum_z l_z w_z with
// w_z = exp(m_z - max_z m_z), summed in split order. SUM (K2's bf16 core,
// whose splits normalised before AV): out[t, c] = sum_z o_z in split order,
// mrow and lrow unread. out points at (t = 0, the head's first column), rows
// `ld` apart.
template <typename T, bool SUM = false>
__device__ __forceinline__ void core_cluster_close(const float* ost, int old, const float* mrow, const float* lrow,
                                                   int bm, int hd, int S, int z, T* out, int ld, int t0, int Tn,
                                                   int tid, int nthreads) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partials are in place
  const int rows = bm / S, r0 = z * rows, q = hd / 4;
  for (int i = tid; i < rows * q; i += nthreads) {
    const int r = r0 + i / q, c = (i % q) * 4, t = t0 + r;
    if (t >= Tn) continue;
    float M = -INFINITY;
    if constexpr (!SUM)
      for (int zz = 0; zz < S; ++zz) M = fmaxf(M, cluster.map_shared_rank(mrow, zz)[r]);
    float L = 0.f, y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
    for (int zz = 0; zz < S; ++zz) {
      float w = 1.f;
      if constexpr (!SUM) {
        w = expf(cluster.map_shared_rank(mrow, zz)[r] - M);
        L += cluster.map_shared_rank(lrow, zz)[r] * w;
      }
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(ost, zz) + r * old + c);
      y0 += v.x * w;
      y1 += v.y * w;
      y2 += v.z * w;
      y3 += v.w * w;
    }
    const float inv = SUM ? 1.f : 1.f / L;
    T* o = out + (size_t)t * ld + c;
    st(o, y0 * inv);
    st(o + 1, y1 * inv);
    st(o + 2, y2 * inv);
    st(o + 3, y3 * inv);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// K1's operands; K2's (the v1 cores, rel_attention_v1.cu) where marked
struct CoreArgs {
  const void* qu;        // (B, H, T, hd), 1/sqrt(hd) and u folded in; K2: q + u, unscaled
  const void* qv;        // (B, H, T, hd), 1/sqrt(hd) and v folded in; K2: q + v, unscaled
  const void* kh;        // (B, H, T, hd)
  const void* vh;        // f32 (B, H, T, hd); bf16 transposed, (B, H, hd, vt_ld); K2: (B, H, T, hd)
  const void* pos;       // (2T - 1, H hd): P, row r the relative position T - 1 - r; K2: (H, 2T - 1, hd)
  const int* lengths;    // (B,) valid keys (min(len, T) taken here)
  void* ctx;             // (B, T, H hd); K2: (B, H, T, hd)
  int Tn, H, S, vt_ld;
  float scale;           // K2: 1/sqrt(hd), applied to each score after the sum
};

// ─── The f32 core (IEEE FMA on the CUDA cores) ───────────────────────────────
// Block: BM query rows of one (b, h), 256 threads (8 warps): BM / RPT row
// groups of 8 threads (of 16 at hd = 128: two halves of the head dims).
// Thread (ty, tx) owns the RPT x PN scores of rows RPT ty + i and keys
// tx PN + j of each key tile (PN = BN / 8), and the running output of the
// same rows over its head dims, (tx + 8 g) 4 .. +3; at hd = 128 half hh
// sums the scores over the head dims of alternate 16-byte chunks 4 e + 4 hh
// .. + 3 (neighbouring lanes on distinct banks), the two halves add them
// (a shuffle), and each takes half of the output's head dims. Key
// tiles of BN rows stream with their values through a double-buffered
// cp.async ring; their band of BM + BN - 1 projected position rows has one
// buffer, refilled for the next tile while the block runs AV on this one.
// hd = 64: 128 rows in 4-row patches of 8 keys (0.42 shared-memory words
// an FMA); hd = 128: 64 rows in 4-row patches of 4 keys (32-key tiles),
// halves of the head dims (0.59 words an FMA in the scores); hd = 32: 64
// rows in 2-row patches, two blocks an SM. Each way a block of 8 warps.
// The tiles' swizzle follows the patch: rows PN apart on distinct banks.
// V1 (K2, rel_attention_v1.cu): the same core on K2's operands: q_u and
// q_v unscaled, the scale applied to each score after the content and
// position sums (at hd 32 it is no power of two, so folding it into q
// would round elsewhere), P per head ((H, 2T - 1, hd)), the output (B, H,
// T, hd). Normalised after AV as in K1: in f32 the reference's rounding of
// the normalised probabilities is the identity, so only the place of one
// f32 division an output moves.

template <int HD>
struct F32Tile {
  static constexpr int BM = HD == 64 ? 128 : 64, BN = HD == 128 ? 32 : 64, RPT = HD == 32 ? 2 : 4;
  static constexpr int HS = HD == 128 ? 2 : 1;  // halves of the head dims
  static constexpr int THREADS = 8 * BM / RPT * HS;
  // probabilities (BM x (BN + 4)), q_u and q_v, two stages of keys and
  // values, one band
  static constexpr int SMEM = 4 * (BM * (BN + 4) + HD * (2 * BM + 4 * BN + BM + BN - 1));
};
static_assert(F32Tile<32>::SMEM == 82816 && F32Tile<64>::SMEM == 214784 && F32Tile<128>::SMEM == 188928,
              "ops/rel_attention.py core_plan's shared memory");
static_assert(F32Tile<32>::THREADS == 256 && F32Tile<64>::THREADS == 256 && F32Tile<128>::THREADS == 256,
              "8 warps a block");

// Element offset of (row r, element e) in a shared tile of HD-wide f32 rows
// whose 16-byte chunks are XOR-swizzled by r >> SH, so that the rows PN =
// 1 << SH apart that neighbouring threads read fall in distinct bank groups.
template <int HD, int SH>
__device__ __forceinline__ int core_swz(int r, int e) {
  constexpr int NC = HD / 4, MASK = (NC < 8 ? NC : 8) - 1;
  return r * HD + (((e / 4) ^ ((r >> SH) & MASK)) * 4) + e % 4;
}

// Rows row0 .. row0 + n - 1 of src (HD-wide rows `stride` floats apart)
// into a swizzled tile, zero for rows outside [0, hi), by 16-byte cp.async.
template <int HD, int SH, int THREADS>
__device__ __forceinline__ void core_copy_rows(float* dst, const float* src, size_t stride, int row0, int n, int hi,
                                               int tid) {
  constexpr int NC = HD / 4;
  for (int i = tid; i < n * NC; i += THREADS) {
    const int j = i / NC, c = (i - j * NC) * 4;
    const int r = row0 + j;
    const bool ok = r >= 0 && r < hi;
    cp_async16(dst + core_swz<HD, SH>(j, c), ok ? src + (size_t)r * stride + c : src, ok);
  }
}

template <int HD, bool V1 = false>
__global__ void __launch_bounds__(F32Tile<HD>::THREADS, HD == 32 ? 2 : 1) rel_attn_f32_kernel(const CoreArgs a) {
  using F = F32Tile<HD>;
  constexpr int BM = F::BM, BN = F::BN, RPT = F::RPT, HS = F::HS, THREADS = F::THREADS;
  constexpr int PN = BN / 8, PB = BM + BN - 1, G = HD / 32 / HS, LDP = BN + 4, SH = PN == 4 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char core_smem[];
  float* ps = reinterpret_cast<float*>(core_smem);
  float* q_u = ps + BM * LDP;
  float* q_v = q_u + BM * HD;
  float* ring = q_v + BM * HD;        // two stages of BN keys and their values
  float* band = ring + 4 * BN * HD;   // PB position rows

  const int Tn = a.Tn, H = a.H, S = a.S;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int z = blockIdx.x % S, t0 = blockIdx.x / S * BM;
  // lane bits 0-2: tx; bit 3 (hd = 128): the half of the head dims
  const int tid = threadIdx.x, tx = tid & 7, hh = HS == 2 ? (tid >> 3) & 1 : 0, ty = tid >> (HS == 2 ? 4 : 3);
  const int D = H * HD;
  const int kv_len = min(a.lengths[b], Tn);
  // keys past kv_len carry -1e9 and add exactly 0 once a valid key is seen;
  // an item with no valid key averages all Tn keys, as the reference does
  const int n_keys = kv_len > 0 ? kv_len : Tn;
  int it0, it1;
  core_range(n_keys, Tn, BN, S, z, it0, it1);
  const size_t head = (size_t)bh * Tn * HD;
  const float* kh = static_cast<const float*>(a.kh) + head;
  const float* vh = static_cast<const float*>(a.vh) + head;
  // P's rows: K1's (2T - 1, H hd), D apart; K2's per head, hd apart
  const size_t pld = V1 ? HD : D;
  const float* ph = static_cast<const float*>(a.pos) + (V1 ? (size_t)h * (2 * Tn - 1) * HD : (size_t)h * HD);

  auto load_kv = [&](int it) {
    float* stage = ring + ((it - it0) & 1) * 2 * BN * HD;
    core_copy_rows<HD, SH, THREADS>(stage, kh, HD, it * BN, BN, Tn, tid);
    core_copy_rows<HD, SH, THREADS>(stage + BN * HD, vh, HD, it * BN, BN, Tn, tid);
  };
  // band row j of key tile s0 holds P[Tn - BM - t0 + s0 + j]; score (row
  // tr, key ks) reads band row ks - tr + BM - 1
  auto load_band = [&](int it) {
    core_copy_rows<HD, SH, THREADS>(band, ph, pld, Tn - BM - t0 + it * BN, PB, 2 * Tn - 1, tid);
  };
  core_copy_rows<HD, SH, THREADS>(q_u, static_cast<const float*>(a.qu) + head, HD, t0, BM, Tn, tid);
  core_copy_rows<HD, SH, THREADS>(q_v, static_cast<const float*>(a.qv) + head, HD, t0, BM, Tn, tid);
  if (it0 < it1) {
    load_kv(it0);
    load_band(it0);
  }
  cp_async_commit();

  float acc[RPT][4 * G], m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int d = 0; d < 4 * G; ++d) acc[i][d] = 0.f;
  }
  const int band0 = tx * PN - ty * RPT + BM - RPT;  // the patch reads band rows band0 .. band0 + PN + RPT - 2

  for (int it = it0; it < it1; ++it) {
    cp_async_wait<0>();
    // tile it and its band have landed for every thread; every thread is
    // done with tile it - 1 (its stage and the probabilities)
    __syncthreads();
    if (it + 1 < it1) load_kv(it + 1);
    cp_async_commit();
    const float* ks = ring + ((it - it0) & 1) * 2 * BN * HD;
    const float* vs = ks + BN * HD;

    // scores: content (q_u . k) and position (q_v . P band) over the
    // thread's head dims in order, 4 values per shared read
    float s[RPT][PN];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < PN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int e = 4 * hh; e < HD; e += 4 * HS) {  // the halves take alternate 16-byte chunks
      float4 q[RPT], k[PN];
#pragma unroll
      for (int i = 0; i < RPT; ++i) q[i] = *reinterpret_cast<const float4*>(q_u + core_swz<HD, SH>(ty * RPT + i, e));
#pragma unroll
      for (int j = 0; j < PN; ++j) k[j] = *reinterpret_cast<const float4*>(ks + core_swz<HD, SH>(tx * PN + j, e));
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
          s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
          s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
          s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
        }
      float4 r[PN + RPT - 1];
#pragma unroll
      for (int i = 0; i < RPT; ++i) q[i] = *reinterpret_cast<const float4*>(q_v + core_swz<HD, SH>(ty * RPT + i, e));
#pragma unroll
      for (int c = 0; c < PN + RPT - 1; ++c)
        r[c] = *reinterpret_cast<const float4*>(band + core_swz<HD, SH>(band0 + c, e));
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) {
          const float4 p = r[j - i + RPT - 1];
          s[i][j] = fmaf(q[i].x, p.x, s[i][j]);
          s[i][j] = fmaf(q[i].y, p.y, s[i][j]);
          s[i][j] = fmaf(q[i].z, p.z, s[i][j]);
          s[i][j] = fmaf(q[i].w, p.w, s[i][j]);
        }
    }
    if constexpr (HS == 2) {  // the two halves' sums (the same in both: addition commutes)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], 8);
    }
    if constexpr (V1) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < PN; ++j) s[i][j] *= a.scale;
    }

    // online softmax: the tile's row max over the 8 threads of a row group,
    // the running sums and outputs rescaled, the probabilities to shared
    const int s_base = it * BN + tx * PN;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < PN; ++j) {
        const int key = s_base + j;
        if (key >= n_keys) s[i][j] = -INFINITY;
        else if (key >= kv_len) s[i][j] = -1e9f;
        tmax = fmaxf(tmax, s[i][j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 4));
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < 4 * G; ++d) acc[i][d] *= alpha;
      float* prow = ps + (ty * RPT + i) * LDP + tx * PN;
#pragma unroll
      for (int j = 0; j < PN; j += 4) {
        float4 p4;
        p4.x = expf(s[i][j] - m_new);
        p4.y = expf(s[i][j + 1] - m_new);
        p4.z = expf(s[i][j + 2] - m_new);
        p4.w = expf(s[i][j + 3] - m_new);
        l[i] += p4.x + p4.y + p4.z + p4.w;
        if (hh == 0) *reinterpret_cast<float4*>(prow + j) = p4;  // both halves hold the same
      }
    }
    __syncthreads();  // the tile's probabilities are complete; the band is free
    if (it + 1 < it1) load_band(it + 1);
    cp_async_commit();

    // AV: RPT rows x 4G head dims per thread, 4 keys per step; keys at or
    // past n_keys have probability 0 and are skipped in whole steps of 4
    const int lim = min(BN, (n_keys - it * BN + 3) & ~3);
    for (int kk = 0; kk < lim; kk += 4) {
      float4 pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = *reinterpret_cast<const float4*>(ps + (ty * RPT + i) * LDP + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          const float4 v =
              *reinterpret_cast<const float4*>(vs + core_swz<HD, SH>(kk + q, (tx + 8 * (hh * G + gi)) * 4));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = q == 0 ? pr[i].x : q == 1 ? pr[i].y : q == 2 ? pr[i].z : pr[i].w;
            acc[i][gi * 4 + 0] = fmaf(p, v.x, acc[i][gi * 4 + 0]);
            acc[i][gi * 4 + 1] = fmaf(p, v.y, acc[i][gi * 4 + 1]);
            acc[i][gi * 4 + 2] = fmaf(p, v.z, acc[i][gi * 4 + 2]);
            acc[i][gi * 4 + 3] = fmaf(p, v.w, acc[i][gi * 4 + 3]);
          }
        }
      }
    }
  }

  // the row sums over the 8 threads of the row group
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
  // K1 writes ctx (B, T, H hd), K2 its (B, H, T, hd)
  const int old_ld = V1 ? HD : D;
  float* out = static_cast<float*>(a.ctx) + (V1 ? (size_t)bh * Tn * HD : (size_t)b * Tn * D + h * HD);
  if (S == 1) {
    // normalise after AV
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = t0 + ty * RPT + i;
      if (t >= Tn) continue;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int d = 0; d < 4; ++d)
          out[(size_t)t * old_ld + (tx + 8 * (hh * G + gi)) * 4 + d] = acc[i][gi * 4 + d] * inv;
    }
    return;
  }
  __syncthreads();  // no copy is in flight and every thread is done with the ring
  float* ost = ring;  // BM x (HD + 4)
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      *reinterpret_cast<float4*>(ost + r * (HD + 4) + (tx + 8 * (hh * G + gi)) * 4) =
          make_float4(acc[i][gi * 4], acc[i][gi * 4 + 1], acc[i][gi * 4 + 2], acc[i][gi * 4 + 3]);
    if (tx == 0 && hh == 0) {
      ps[r] = m[i];
      ps[BM + r] = l[i];
    }
  }
  core_cluster_close<float>(ost, HD + 4, ps, ps + BM, BM, HD, S, z, out, old_ld, t0, Tn, tid, THREADS);
}

// ─── The bf16 core (wgmma on the tensor cores, fed by TMA) ──────────────────
// Block: 64 query rows of one (b, h); one consumer warpgroup (warps 0-3)
// and one producer warp (warp 4), 160 threads. The producer brings q_u and
// q_v once, then per key tile of 64 keys the keys (64 x hd), the band of
// 127 projected position rows (padded with one row to 128) and the values,
// stored transposed (hd x 64 keys), into a 2-stage ring under full/empty
// mbarriers; every tile is K-major in 128-byte swizzled rows of 64 values,
// wgmma's own layout (hd = 128: two such chunks a row; hd = 32: half a
// row, filled by the producer's lanes, since a TMA box of 64-byte rows
// would not land in that layout; the values by TMA at every hd). Per tile:
//   S = q_u K^T          wgmma m64n64, A and B from shared memory
//   R = q_v Band^T       wgmma m64n128
//   S[i][j] += R[i][j - i + 63]  through shared memory: each warp writes
//                        R's values that land in its own 16 rows of S,
//                        pre-skewed, and reads them back (no block barrier)
//   mask, online softmax in f32 (a row over the 4 lanes that hold it)
//   O += bf16(e) V       wgmma m64n{hd}, A (the probabilities, rounded to
//                        bf16 as the reference kernel rounds them before
//                        AV) from registers: the accumulator layout of S is
//                        the register layout of A
// Normalised after AV by the sum of the unrounded e.

template <int HD>
struct WgTile {
  static constexpr int BM = 64, BN = 64, NB = 128;      // query rows, keys a tile, band rows
  static constexpr int HC = HD < 64 ? 1 : HD / 64;      // swizzled chunks of 64 values a row
  static constexpr int KK = (HD < 64 ? HD : 64) / 16;   // k16 steps a chunk
  static constexpr int Q_BYTES = BM * 128 * HC;         // q_u, and q_v
  static constexpr int K_BYTES = BN * 128 * HC;
  static constexpr int B_BYTES = NB * 128 * HC;
  static constexpr int V_BYTES = HD * 128;              // hd rows of 64 keys
  static constexpr int STAGE = K_BYTES + B_BYTES + V_BYTES;
  static constexpr int SLD = BM + 4;                    // skew buffer row, floats
  static constexpr int OLD = HD + 4;                    // merge staging row, floats
  // 1 KB to align the tiles to the swizzle's 1,024-byte period, q_u and
  // q_v, two stages, the skew buffer, the row maxima and sums (the merge),
  // 5 mbarriers
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * STAGE + BM * SLD * 4 + 2 * BM * 4 + 8 * 8;
};
static_assert(WgTile<32>::SMEM == 92736 && WgTile<64>::SMEM == 100928 && WgTile<128>::SMEM == 182848,
              "ops/rel_attention.py core_plan's shared memory");
static_assert(64 * WgTile<128>::OLD * 4 <= 2 * WgTile<128>::STAGE, "the merge staging fits the ring");

struct CoreMaps {
  CUtensorMap q[2];  // q_u, q_v: (hd, T, B H), boxes of 64 x 64 rows
  CUtensorMap k;     // keys, as q
  CUtensorMap pos;   // P: (H hd, 2T - 1), boxes of 64 x 128 rows
  CUtensorMap vt;    // values transposed: (T, hd, B H), boxes of 64 keys x hd rows
};

// hd = 32: rows row0 .. row0 + ROWS - 1 of src (32 values, `stride` apart;
// zero outside [0, hi)) into the left half of 128-byte swizzled rows, by
// the producer warp's lanes
template <int ROWS>
__device__ __forceinline__ void wg_fill32(bf16* dst, const bf16* src, size_t stride, int row0, int hi, int lane) {
  for (int i = lane; i < ROWS * 4; i += 32) {
    const int r = i >> 2, c = i & 3, gr = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < hi) v = *reinterpret_cast<const uint4*>(src + (size_t)gr * stride + c * 8);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(dst) + r * 128 + ((c ^ (r & 7)) << 4)) = v;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__global__ void __launch_bounds__(160, HD == 128 ? 1 : 2)
    rel_attn_wgmma_kernel(const __grid_constant__ CoreArgs a, const __grid_constant__ CoreMaps maps) {
  using W = WgTile<HD>;
  constexpr int BM = W::BM, BN = W::BN, HC = W::HC, KK = W::KK, SLD = W::SLD;
  extern __shared__ unsigned char wg_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* q_u = reinterpret_cast<bf16*>(base);
  bf16* q_v = reinterpret_cast<bf16*>(base + W::Q_BYTES);
  unsigned char* stages = base + 2 * W::Q_BYTES;
  float* skew = reinterpret_cast<float*>(stages + 2 * W::STAGE);
  float* mrow = skew + BM * SLD;
  float* lrow = mrow + BM;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(lrow + BM);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + 2;

  const int Tn = a.Tn, H = a.H, S = a.S;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int z = blockIdx.x % S, t0 = blockIdx.x / S * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = H * HD;
  const int kv_len = min(a.lengths[b], Tn);
  const int n_keys = kv_len > 0 ? kv_len : Tn;  // no valid key: the average of all Tn
  int it0, it1;
  core_range(n_keys, Tn, BN, S, z, it0, it1);

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float o[HD / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (warp == 4) {
    // producer
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
    for (int it = it0; it < it1; ++it) {
      const int k = it - it0, s = k & 1;
      if (k >= 2) mbar_wait(&empty[s], ((k >> 1) - 1) & 1);
      unsigned char* st = stages + s * W::STAGE;
      bf16* ks = reinterpret_cast<bf16*>(st);
      bf16* bs = reinterpret_cast<bf16*>(st + W::K_BYTES);
      bf16* vs = reinterpret_cast<bf16*>(st + W::K_BYTES + W::B_BYTES);
      const int key0 = it * BN, prow = Tn - BM - t0 + key0;  // band row j: P[prow + j]
      if constexpr (HD >= 64) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], W::STAGE);
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            tma_3d(ks + c * BN * 64, &maps.k, 64 * c, key0, bh, &full[s]);
            tma_2d(bs + c * W::NB * 64, &maps.pos, h * HD + 64 * c, prow, &full[s]);
          }
          tma_3d(vs, &maps.vt, key0, 0, bh, &full[s]);
        }
      } else {
        wg_fill32<BN>(ks, static_cast<const bf16*>(a.kh) + head, HD, key0, Tn, lane);
        wg_fill32<W::NB>(bs, static_cast<const bf16*>(a.pos) + h * HD, D, prow, 2 * Tn - 1, lane);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[s], W::V_BYTES);
          tma_3d(vs, &maps.vt, key0, 0, bh, &full[s]);
        }
      }
    }
  } else {
    // consumers: thread (warp, g, q4) holds rows 16 warp + g (+ 8) and, of
    // every 8 columns, 2 q4 and 2 q4 + 1 of S, R and O
    const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    mbar_wait(qbar, 0);
    for (int it = it0; it < it1; ++it) {
      const int k = it - it0, s = k & 1;
      mbar_wait(&full[s], (k >> 1) & 1);
      const unsigned char* st = stages + s * W::STAGE;
      const bf16* ks = reinterpret_cast<const bf16*>(st);
      const bf16* bs = reinterpret_cast<const bf16*>(st + W::K_BYTES);
      const bf16* vs = reinterpret_cast<const bf16*>(st + W::K_BYTES + W::B_BYTES);
      float sc[32], rr[64];
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
          wgmma_m64n128k16(rr, sw128_desc(q_v + c * BM * 64) + 2 * kk, sw128_desc(bs + c * W::NB * 64) + 2 * kk);
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
        sc[i] += skew[row * SLD + col];
      }

      // mask, online softmax
      const int key0 = it * BN;
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * (i >> 2) + 2 * q4 + (i & 1);
        if (key >= n_keys) sc[i] = -INFINITY;
        else if (key >= kv_len) sc[i] = -1e9f;
        tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
        tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
        const float m_new = fmaxf(m[r], tmax[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[16];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = expf(sc[i] - m[r]), p1 = expf(sc[i + 1] - m[r]);
        l[r] += p0 + p1;
        pa[i >> 1] = pack_bf16(p0, p1);
      }

      // O += P V, the keys in 4 k16 steps
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a4[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        const uint64_t dv = sw128_desc(vs) + 2 * kk;
        if constexpr (HD == 32) wgmma_m64n32k16_rs(o, a4, dv);
        else if constexpr (HD == 64) wgmma_m64n64k16_rs(o, a4, dv);
        else wgmma_m64n128k16_rs(o, a4, dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage goes back to the producer
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }

  bf16* out = static_cast<bf16*>(a.ctx) + (size_t)b * Tn * D + h * HD;
  const int g = lane >> 2, q4 = lane & 3;
  if (S == 1) {
    if (warp == 4) return;
    // normalise after AV
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + 16 * warp + g + 8 * r;
      if (t >= Tn) continue;
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 2 * r; i < HD / 2; i += 4) {
        const int col = 8 * (i >> 2) + 2 * q4;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)t * D + col) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
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
    if (q4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mrow[16 * warp + g + 8 * r] = m[r];
        lrow[16 * warp + g + 8 * r] = l[r];
      }
    }
  }
  core_cluster_close<bf16>(ost, W::OLD, mrow, lrow, BM, HD, S, z, out, D, t0, Tn, tid, 160);
}

// ─── Host side ───────────────────────────────────────────────────────────────

// A bf16 tensor of `dims` (innermost first) with the outer strides given
// in bytes, in boxes of `box` under the 128-byte swizzle (or `swizzle`)
inline bool encode_bf16_box(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The core's launch: S * ceil(T / bm) blocks along x (the S splits of a
// query tile consecutive, one cluster when S > 1), B H along y
template <typename Kernel, typename... Args>
cudaError_t launch_core(Kernel kernel, int bm, int threads, int smem, const CoreArgs& c, int B, cudaStream_t stream,
                        Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(c.S * ((c.Tn + bm - 1) / bm), B * c.H);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = c.S > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, c, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32_core(const CoreArgs& c, int B, cudaStream_t stream) {
  using F = F32Tile<HD>;
  return launch_core(rel_attn_f32_kernel<HD>, F::BM, F::THREADS, F::SMEM, c, B, stream);
}

template <int HD>
cudaError_t launch_wgmma_core(const CoreArgs& c, int B, cudaStream_t stream) {
  const int BH = B * c.H, T = c.Tn, DL = c.H * HD;
  CoreMaps maps{};
  const cuuint64_t qd[3] = {(cuuint64_t)HD, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t qs[2] = {(cuuint64_t)HD * 2, (cuuint64_t)T * HD * 2};
  const cuuint32_t qb[3] = {64, 64, 1};
  const cuuint64_t pd[2] = {(cuuint64_t)DL, (cuuint64_t)(2 * T - 1)};
  const cuuint64_t pst[1] = {(cuuint64_t)DL * 2};
  const cuuint32_t pb[2] = {64, 128};
  const cuuint64_t vd[3] = {(cuuint64_t)T, (cuuint64_t)HD, (cuuint64_t)BH};
  const cuuint64_t vs[2] = {(cuuint64_t)c.vt_ld * 2, (cuuint64_t)HD * c.vt_ld * 2};
  const cuuint32_t vb[3] = {64, HD, 1};
  bool ok = encode_bf16_box(&maps.vt, c.vh, 3, vd, vs, vb);
  if (HD >= 64)
    ok = ok && encode_bf16_box(&maps.q[0], c.qu, 3, qd, qs, qb) && encode_bf16_box(&maps.q[1], c.qv, 3, qd, qs, qb) &&
         encode_bf16_box(&maps.k, c.kh, 3, qd, qs, qb) && encode_bf16_box(&maps.pos, c.pos, 2, pd, pst, pb);
  if (!ok) return cudaErrorInvalidValue;
  return launch_core(rel_attn_wgmma_kernel<HD>, WgTile<HD>::BM, 160, WgTile<HD>::SMEM, c, B, stream, maps);
}

// The attention core on `stream`: f32 on the CUDA cores, bf16 on the
// tensor cores; splits, the plan's key splits (1, 2, 4 or 8; refused
// otherwise)
template <typename T>
cudaError_t launch_attn(const void* qu, const void* qv, const void* kh, const void* vh, const void* pos,
                        const int* lengths, void* ctx, int B, int Tn, int H, int HD, int splits,
                        cudaStream_t stream) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return cudaErrorInvalidValue;
  const CoreArgs c = {qu, qv, kh, vh, pos, lengths, ctx, Tn, H, splits, sizeof(T) == 2 ? (Tn + 7) & ~7 : 0};
  if constexpr (sizeof(T) == 4) {
    switch (HD) {
      case 32: return launch_f32_core<32>(c, B, stream);
      case 64: return launch_f32_core<64>(c, B, stream);
      case 128: return launch_f32_core<128>(c, B, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (HD) {
      case 32: return launch_wgmma_core<32>(c, B, stream);
      case 64: return launch_wgmma_core<64>(c, B, stream);
      case 128: return launch_wgmma_core<128>(c, B, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

// Blocks of the core held at once on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error:
// what ops/rel_attention.py core_plan's `resident` is checked against
template <typename Kernel>
int core_resident(Kernel kernel, int threads, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

inline int core_resident(int dtype, int hd) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return core_resident(rel_attn_f32_kernel<32>, F32Tile<32>::THREADS, F32Tile<32>::SMEM);
      case 64: return core_resident(rel_attn_f32_kernel<64>, F32Tile<64>::THREADS, F32Tile<64>::SMEM);
      case 128: return core_resident(rel_attn_f32_kernel<128>, F32Tile<128>::THREADS, F32Tile<128>::SMEM);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return core_resident(rel_attn_wgmma_kernel<32>, 160, WgTile<32>::SMEM);
      case 64: return core_resident(rel_attn_wgmma_kernel<64>, 160, WgTile<64>::SMEM);
      case 128: return core_resident(rel_attn_wgmma_kernel<128>, 160, WgTile<128>::SMEM);
    }
  }
  return -(int)cudaErrorInvalidValue;
}

// The launch plan (ops/rel_attention.py block_plan, heads_plan): hopper
// (bf16, D <= 1024, not head-sharded: the Hopper design below), qkv (the
// tiled QKV GEMM's block rows, 64, 96 or 128; the Hopper design's
// LayerNorm cluster of column tiles), pos_splits (the tiled position GEMM's
// k slices), out_splits (the out-projection's k slices, tiled or in a
// cluster), core_splits (the core's key splits). D is the model width (x's
// rows); the weights hold H heads of HD (HD = 0: D / H), DL = H * HD wide.
// part holds max(pos_splits * (2T-1) * DL, out_splits * B*T * D) f32
// partials (the tiled GEMMs). The LayerNorm's output borrows ctx ((B*T, D))
// until the core writes ctx ((B*T, DL)). In bf16 vh holds v transposed,
// (B, H, HD, T rounded up to 8).
//
// The Hopper design, 3 launches, every GEMM on hopper_gemm_kernel:
//   1. QKV (the head-major fold) on LN(x) (the LayerNorm on the A path,
//      once a cluster of column tiles) and, in blocks of the same launch
//      that skip it, the position GEMM P = round(pe pos_w^T)
//   2. the core
//   3. the out-projection, k split over a cluster: round(x + y + bo)
// The tiled design (f32; bf16 at D > 1024, or head-sharded), 7 launches
// with the LayerNorm (6 without): the LayerNorm, the QKV GEMM, the
// position GEMM and its closing pass, the core, the out-projection and its
// closing pass.
//
// Head-sharded (partial != null): the weights are one 'model' rank's H
// heads of a wider layer (wq, wk, wv, pos_w (DL, D); wo (D, DL)), and the
// out-projection over them, with no bias and no residual, goes to partial
// ((B*T, D) f32, its k slices summed in order, not rounded): the caller sums
// the ranks' partials, then adds the bias and the residual once.
template <typename T>
int run_block(const void* x, const float* ln_w, const float* ln_b, float eps, const void* wq,
              const void* bq, const void* wk, const void* bk, const void* wv, const void* bv,
              const void* bias_u, const void* bias_v, const void* pe, const void* pos_w,
              const void* wo, const void* bo, const int* lengths, float* part, void* qu,
              void* qv, void* kh, void* vh, void* pos, void* ctx, void* out, int B, int Tn,
              int D, int H, int hopper, int qkv, int pos_splits, int out_splits, int core_splits,
              cudaStream_t stream, int HD = 0, float* partial = nullptr) {
  if (HD == 0) HD = D / H;
  const int M = B * Tn, DL = H * HD;
  if (M == 0) return 0;
  if (hopper && (sizeof(T) != 2 || partial != nullptr || DL != D)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  FfnGemmArgs g = {};
  g.w[0] = wq; g.w[1] = wk; g.w[2] = wv;
  g.bias[0] = bq; g.bias[1] = bk; g.bias[2] = bv;
  g.out[0] = qu; g.out[1] = qv; g.out[2] = kh; g.out[3] = vh;
  g.bias_u = bias_u; g.bias_v = bias_v;
  g.M = M; g.N = 3 * DL; g.K = D; g.nseg = DL;
  g.T = Tn; g.H = H; g.HD = HD;
  g.scale = 1.f / sqrtf((float)HD);
  g.vt_ld = sizeof(T) == 2 ? (Tn + 7) & ~7 : 0;

  if (hopper) {
    HgArgs q = {};
    q.g[0] = g;
    q.g[0].a = x;
    FfnGemmArgs& p = q.g[1];
    p.a = pe;
    p.w[0] = pos_w;
    p.out[0] = pos;
    p.M = 2 * Tn - 1; p.N = D; p.K = D;
    if (ln_w != nullptr) {
      q.ln_w = ln_w; q.ln_b = ln_b; q.eps = eps;
      q.cn = qkv;
      q.xn = ctx;  // LN(x) until the core writes ctx
      err = launch_hopper_gemm<HE_QKV_POS, true>(q, stream);
    } else {
      err = launch_hopper_gemm<HE_QKV_POS, false>(q, stream);
    }
    if (err != cudaSuccess) return (int)err;
    if ((err = launch_attn<T>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, HD, core_splits, stream)) != cudaSuccess)
      return (int)err;
    return (int)launch_cluster_linear(ctx, wo, bo, ln_w != nullptr ? x : nullptr, 1.f, out, nullptr, nullptr, 0.f,
                                      nullptr, M, D, D, out_splits, stream);
  }

  g.a = x;
  if (ln_w != nullptr) {
    if ((err = launch_layer_norm_rows<T>(x, ln_w, ln_b, ctx, M, D, eps, stream)) != cudaSuccess)
      return (int)err;
    g.a = ctx;
  }
  // D = H * hd with hd in {32, 64, 128}: rows are 16-byte aligned
  if ((err = launch_tiled_gemm_rows<T, FE_QKV, false>(g, qkv, stream)) != cudaSuccess) return (int)err;

  if ((err = launch_linear<T, false>(pe, pos_w, nullptr, nullptr, pos, part, 2 * Tn - 1, DL, D,
                                     pos_splits, stream)) != cudaSuccess)
    return (int)err;

  if ((err = launch_attn<T>(qu, qv, kh, vh, pos, lengths, ctx, B, Tn, H, HD, core_splits, stream)) != cudaSuccess)
    return (int)err;

  if (partial == nullptr)
    return (int)launch_linear<T, false>(ctx, wo, bo, ln_w != nullptr ? x : nullptr, out, part, M, D, D,
                                        out_splits, stream);
  FfnGemmArgs o = {};
  o.a = ctx;
  o.w[0] = wo;
  o.out[0] = part;
  o.M = M; o.N = D; o.K = DL;
  if ((err = launch_tiled_gemm<T, FE_PARTIAL, 128, false>(o, out_splits, stream)) != cudaSuccess) return (int)err;
  // the f32 closing pass: the slices summed in order, nothing added, no rounding
  return (int)launch_gemm_reduce<float>(part, out_splits, nullptr, 1.f, nullptr, nullptr, nullptr, 0.f, partial,
                                        M, D, stream);
}

}  // namespace
