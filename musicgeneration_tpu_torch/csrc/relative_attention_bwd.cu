// Kernel C: fused relative global attention, backward (Music Transformer).
//
// Replaces musicgeneration_tpu/ops/pallas_attention.py::_bwd (its
// pallas_calls: the one-pass _bwd_fused_kernel, and the split pair
// _bwd_dq_de_kernel / _bwd_dkv_kernel). Given the forward's inputs, its
// output O and LSE, and dO, computes per (batch, head)
//
//   p[t, s]  = exp(logits[t, s] - lse[t])     (logits exactly as kernel A)
//   g[t, s]  = p[t, s] (dO_t . v_s - delta_t), delta_t = dO_t . O_t
//   dQ_t     = scale * sum_s g[t, s] (k_s + E[max_seq - 1 - t + s])
//   dK_s     = scale * sum_t g[t, s] q_t
//   dV_s     = sum_t p[t, s] dO_t
//   dE[r]    = scale * sum_{b, h, t - s = max_seq - 1 - r} g[t, s] q_t
//
// with the TPU kernel's rounding points: E rounded to the q dtype, g
// rounded to the compute dtype before the dQ, dK and dE products, p
// rounded to the dO dtype before dV, f32 accumulation, dQ/dK/dV stored in
// the q dtype and dE in f32. scale = 1/8 (dh 64) is a power of two, so it
// is applied once at the end, bit-equal to the TPU's prescaled q. delta
// is computed by the wrapper (the JAX package computes it outside its
// kernels too).
//
// Design for this card (FlashAttention-2's split). The TPU kernel walks
// a sequential grid and revisits its dK, dV and dE outputs across grid
// steps; GPU blocks run in no order, so:
//
//  * dkv: one block per (64-key tile, b*h) loops over the query tiles
//    that see it (from the diagonal on, when causal) and keeps dK and dV
//    in registers;
//  * dq: one block per (64-query tile, b*h) loops over its causal key
//    tiles and keeps dQ in registers. Its dE contributions land on the
//    band of 128 E rows each (query tile, key tile) touches,
//    base = max_seq - BQ - t0 + s0 (kernel A's index map; g[t, s] meets
//    band row (63 - tl) + sl). Consecutive key tiles' bands overlap by 64
//    rows, so the block carries 128 rows in registers and retires the
//    lower 64 after each key tile into its own partial window
//    de_part[b*h, q tile, :, :] (no atomics);
//  * reduce: one thread per dE element sums the partial windows that
//    cover it in a fixed order (deterministic) and drops band rows past
//    the table, as de_padded[:max_seq] does.
//
// Both tile kernels recompute the logits micro-tile with kernel A's very
// fmaf chains and mask adds, so p comes from the same logits that
// produced kernel A's LSE: fully masked (-1e9 / -2e9) rows stay finite.
//
// What bounds it: at the training shape (B8 H4 L512 dh64, bf16, causal)
// the least traffic is q, k, v, O, dO, dQ, dK, dV, the E table, dE and
// the LSE, ~17 MB (~5 us at 3.35 TB/s), and the causal work is about
// eight 64-deep products per (t, s <= t) pair, ~4.3 GFLOP (~4.4 us on
// bf16 tensor cores). This first version multiplies on the CUDA cores in
// f32 (FMA): exact products for bf16 inputs, full f32 for f32 inputs,
// and far from that bound; mma/wgmma and TMA are for a later version.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int DH = 64;           // head dim (the reference fixes dh = 64)
constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // key rows per tile
constexpr int NT = 256;          // threads: 16 x 16, each a 4x4 micro-tile
constexpr int LD = DH + 1;       // shared row stride (conflict-free fills)
constexpr int LDT = BK + 1;      // P / G tile stride
constexpr int GW = 3 * BK;       // padded G row: zeros | g[t, :] | zeros
constexpr int LDG = GW + 1;
constexpr int BAND = BQ + BK;    // E rows one (query tile, key tile) reads
constexpr float NEG_INF = -1e9f;

constexpr int DKV_SMEM_FLOATS = 2 * BK * LD + 2 * BQ * LD + BAND * LD
                                + 2 * BQ * LDT + 2 * BQ;
constexpr int DQ_SMEM_FLOATS = 2 * BQ * LD + 2 * BK * LD + BAND * LD
                               + BQ * LDG + 2 * BQ;

// Rows [r0, r0 + n) of a [L, 64] tile into shared memory as f32, rows past
// L as zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int n, int L) {
  for (int i = threadIdx.x; i < n * DH; i += NT) {
    const int r = i / DH, c = i % DH, row = r0 + r;
    dst[r * LD + c] = row < L ? mg::to_f(src[(size_t)row * DH + c]) : 0.f;
  }
}

// The band of BAND E rows starting at `base`, rounded to the q dtype;
// rows outside the table read as zero (the TPU's slack rows).
template <typename T>
__device__ __forceinline__ void stage_band(float* Es, const float* e,
                                           int base, int max_seq) {
  for (int i = threadIdx.x; i < BAND * DH; i += NT) {
    const int r = i / DH, c = i % DH, ei = base + r;
    Es[r * LD + c] = (ei >= 0 && ei < max_seq)
                         ? mg::round_to<T>(e[(size_t)ei * DH + c])
                         : 0.f;
  }
}

// One 4x4 (t, s) micro-tile: sqk = q.k and sqe = q.E_band accumulated in
// kernel A's order (so logits are bit-equal to the forward's), and
// dp = dO.v.
__device__ __forceinline__ void tile_products(
    const float* Qs, const float* Ks, const float* Es, const float* dOs,
    const float* Vs, int ty, int tx, float (&sqk)[4][4], float (&sqe)[4][4],
    float (&dp)[4][4]) {
  const int rbase = 60 - 4 * ty + 4 * tx;  // band row of (i, j): +3-i+j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sqk[i][j] = sqe[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DH; ++c) {
    float qv[4], kv[4], ev[7], ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty * 4 + i) * LD + c];
      ov[i] = dOs[(ty * 4 + i) * LD + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx * 4 + j) * LD + c];
      vv[j] = Vs[(tx * 4 + j) * LD + c];
    }
#pragma unroll
    for (int r = 0; r < 7; ++r) ev[r] = Es[(rbase + r) * LD + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sqk[i][j] = fmaf(qv[i], kv[j], sqk[i][j]);
        sqe[i][j] = fmaf(qv[i], ev[3 - i + j], sqe[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// p and g of element (t, s) from the micro-tile sums. Rows and keys past
// L get p = 0 (their lse / delta slots are staged as 0).
__device__ __forceinline__ void p_and_g(float sqk, float sqe, float dp,
                                        int t, int s, int L, int causal,
                                        const float* pad, float scale,
                                        float lse_t, float delta_t,
                                        float& p, float& g) {
  float x = (sqk + sqe) * scale;
  if (causal && s > t) x += NEG_INF;
  if (s < L && t < L) {
    if (pad) x += pad[s] * NEG_INF;
  } else {
    x = -INFINITY;
  }
  p = expf(x - lse_t);
  g = p * (dp - delta_t);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rel_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ e,
                        const float* __restrict__ key_pad,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int H, int L, int max_seq,
                        int causal, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* Qs = Vs + BK * LD;           // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Es = dOs + BQ * LD;          // [BAND][LD]
  float* Ps = Es + BAND * LD;         // [BQ][LDT], p in the dO dtype
  float* Gs = Ps + BQ * LDT;          // [BQ][LDT], g in the q dtype
  float* lse_s = Gs + BQ * LDT;       // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n_tiles = (L + BK - 1) / BK;
  const int kt = blockIdx.x;  // key tile 0 sees the most query tiles
  const int s0 = kt * BK;
  const size_t off = (size_t)bh * L * DH;
  const float* pad = key_pad ? key_pad + (size_t)b * L : nullptr;

  stage_rows(Ks, k + off, s0, BK, L);
  stage_rows(Vs, v + off, s0, BK, L);

  // this thread's dK / dV rows s0 + ty*4 + i, columns tx + 16*j
  float dkr[4][4], dvr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dkr[i][j] = dvr[i][j] = 0.f;

  // query tiles with t0 + BQ - 1 >= s0 see this key tile (BQ == BK)
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int t0 = qt * BQ;
    __syncthreads();  // previous query tile fully consumed
    stage_rows(Qs, q + off, t0, BQ, L);
    stage_rows(dOs, dout + off, t0, BQ, L);
    stage_band<T>(Es, e, max_seq - BQ - t0 + s0, max_seq);
    if (tid < BQ) {
      const int t = t0 + tid;
      lse_s[tid] = t < L ? lse[(size_t)bh * L + t] : 0.f;
      delta_s[tid] = t < L ? delta[(size_t)bh * L + t] : 0.f;
    }
    __syncthreads();

    float sqk[4][4], sqe[4][4], dp[4][4];
    tile_products(Qs, Ks, Es, dOs, Vs, ty, tx, sqk, sqe, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx * 4 + j;
        float p, g;
        p_and_g(sqk[i][j], sqe[i][j], dp[i][j], t0 + tl, s0 + sl, L, causal,
                pad, scale, lse_s[tl], delta_s[tl], p, g);
        Ps[tl * LDT + sl] = mg::round_to<T>(p);
        Gs[tl * LDT + sl] = mg::round_to<T>(g);
      }
    }
    __syncthreads();  // Ps, Gs complete

#pragma unroll 4
    for (int t = 0; t < BQ; ++t) {
      float pv[4], gv[4], ov[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[t * LDT + ty * 4 + i];
        gv[i] = Gs[t * LDT + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ov[j] = dOs[t * LD + tx + 16 * j];
        qv[j] = Qs[t * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dvr[i][j] = fmaf(pv[i], ov[j], dvr[i][j]);
          dkr[i][j] = fmaf(gv[i], qv[j], dkr[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t o = off + (size_t)s * DH + tx + 16 * j;
      dk[o] = mg::from_f<T>(dkr[i][j] * scale);
      dv[o] = mg::from_f<T>(dvr[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
rel_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ e,
                       const float* __restrict__ key_pad,
                       const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       float* __restrict__ de_part, int H, int L,
                       int max_seq, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][LD]
  float* dOs = Qs + BQ * LD;          // [BQ][LD]
  float* Ks = dOs + BQ * LD;          // [BK][LD]
  float* Vs = Ks + BK * LD;           // [BK][LD]
  float* Es = Vs + BK * LD;           // [BAND][LD]
  float* Gp = Es + BAND * LD;         // [BQ][LDG]: g at columns [BK, 2 BK)
  float* lse_s = Gp + BQ * LDG;       // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int n_tiles = (L + BQ - 1) / BQ;
  // heaviest query tiles (most causal key tiles) are scheduled first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int t0 = qt * BQ;
  const size_t off = (size_t)bh * L * DH;
  const float* pad = key_pad ? key_pad + (size_t)b * L : nullptr;
  // this block's dE window: row w is E row max_seq - BQ - t0 + w
  float* part = de_part + ((size_t)bh * n_tiles + qt) * (size_t)(n_tiles + 1)
                              * BK * DH;

  stage_rows(Qs, q + off, t0, BQ, L);
  stage_rows(dOs, dout + off, t0, BQ, L);
  if (tid < BQ) {
    const int t = t0 + tid;
    lse_s[tid] = t < L ? lse[(size_t)bh * L + t] : 0.f;
    delta_s[tid] = t < L ? delta[(size_t)bh * L + t] : 0.f;
  }
  for (int i = tid; i < BQ * LDG; i += NT) Gp[i] = 0.f;  // zero margins

  // dQ rows t0 + ty*4 + i, columns tx + 16*j; dE band rows ty + 16*a
  // (a < 4: rows 0-63, retired after each key tile; a >= 4: rows 64-127,
  // carried to the next tile as its rows 0-63), columns tx + 16*j
  float dqr[4][4], der[8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dqr[i][j] = 0.f;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) der[a][j] = 0.f;

  const int n_kv = causal ? min(n_tiles, qt + 1) : n_tiles;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int s0 = kt * BK;
    __syncthreads();  // previous key tile fully consumed
    stage_rows(Ks, k + off, s0, BK, L);
    stage_rows(Vs, v + off, s0, BK, L);
    stage_band<T>(Es, e, max_seq - BQ - t0 + s0, max_seq);
    __syncthreads();

    float sqk[4][4], sqe[4][4], dp[4][4];
    tile_products(Qs, Ks, Es, dOs, Vs, ty, tx, sqk, sqe, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tl = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx * 4 + j;
        float p, g;
        p_and_g(sqk[i][j], sqe[i][j], dp[i][j], t0 + tl, s0 + sl, L, causal,
                pad, scale, lse_s[tl], delta_s[tl], p, g);
        Gp[tl * LDG + BK + sl] = mg::round_to<T>(g);
      }
    }
    __syncthreads();  // Gp complete

    // dQ[t] += sum_s g[t, s] (K[s] + E_band[(63 - t) + s])
#pragma unroll 4
    for (int s = 0; s < BK; ++s) {
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[s * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = ty * 4 + i;
        const float gv = Gp[tl * LDG + BK + s];
        const float* er = Es + (BQ - 1 - tl + s) * LD + tx;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dqr[i][j] = fmaf(gv, kv[j], dqr[i][j]);
          dqr[i][j] = fmaf(gv, er[16 * j], dqr[i][j]);
        }
      }
    }

    // dE_band[r] += sum_t g[t, t + r - 63] q_t  (zero margins cover the
    // (t, r) pairs whose key falls outside the tile)
#pragma unroll 2
    for (int tl = 0; tl < BQ; ++tl) {
      float qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = Qs[tl * LD + tx + 16 * j];
      const float* grow = Gp + tl * LDG + BK + tl - (BQ - 1) + ty;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float gv = grow[16 * a];
#pragma unroll
        for (int j = 0; j < 4; ++j) der[a][j] = fmaf(gv, qv[j], der[a][j]);
      }
    }

    // band rows 0-63 are final for this block: window row kt*BK + r
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        part[(size_t)(kt * BK + ty + 16 * a) * DH + tx + 16 * j] = der[a][j];
        der[a][j] = der[a + 4][j];
        der[a + 4][j] = 0.f;
      }
  }
  // the last key tile's rows 64-127: window rows n_kv*BK + r
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      part[(size_t)(n_kv * BK + ty + 16 * a) * DH + tx + 16 * j] = der[a][j];

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[off + (size_t)t * DH + tx + 16 * j] = mg::from_f<T>(dqr[i][j] * scale);
  }
}

// dE[r, c] = scale * sum over (b*h, query tile) windows covering row r,
// in a fixed order; E rows no tile touches get exactly zero.
__global__ void __launch_bounds__(NT)
rel_attn_bwd_de_reduce(const float* __restrict__ de_part,
                       float* __restrict__ de, int BH, int n_tiles,
                       int max_seq, int causal, float scale) {
  const int idx = blockIdx.x * NT + threadIdx.x;
  if (idx >= max_seq * DH) return;
  const int r = idx / DH, c = idx % DH;
  const size_t win = (size_t)(n_tiles + 1) * BK * DH;
  float acc = 0.f;
  for (int bh = 0; bh < BH; ++bh) {
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int n_kv = causal ? min(n_tiles, qt + 1) : n_tiles;
      const int w = r - (max_seq - BQ - qt * BQ);
      if (w >= 0 && w < (n_kv + 1) * BK)
        acc += de_part[((size_t)bh * n_tiles + qt) * win + (size_t)w * DH + c];
    }
  }
  de[idx] = acc * scale;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* e,
           const void* key_pad, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, void* de,
           void* de_part, int B, int H, int L, int max_seq, int causal,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  const int n_tiles = (L + BQ - 1) / BQ;
  const dim3 grid(n_tiles, B * H);
  const size_t smem_kv = DKV_SMEM_FLOATS * sizeof(float);
  const size_t smem_q = DQ_SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_attn_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  rel_attn_bwd_dkv_kernel<T><<<grid, NT, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(e),
      static_cast<const float*>(key_pad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, max_seq, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attn_bwd_dq_kernel<T><<<grid, NT, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(e),
      static_cast<const float*>(key_pad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<float*>(de_part), H, L, max_seq,
      causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attn_bwd_de_reduce<<<(max_seq * DH + NT - 1) / NT, NT, 0, stream>>>(
      static_cast<const float*>(de_part), static_cast<float*>(de), B * H,
      n_tiles, max_seq, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq, dk, dv: [B, H, L, 64] contiguous, float32 (is_bf16 =
// 0) or bfloat16; e, de: [max_seq, 64] float32; key_pad: [B, L] float32 or
// NULL; lse, delta: [B, H, L] float32; de_part: scratch of
// B*H * n * (n + 1) * 64 * 64 floats, n = ceil(L / 64). Launches three
// kernels (dK/dV, dQ with dE partials, dE reduction) on `stream`; returns
// the first CUDA error, or 0.
extern "C" int mg_rel_attn_bwd(int is_bf16, const void* q, const void* k,
                               const void* v, const void* e,
                               const void* key_pad, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               void* dk, void* dv, void* de, void* de_part,
                               int B, int H, int L, int max_seq, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, e, key_pad, dout, lse, delta, dq,
                                 dk, dv, de, de_part, B, H, L, max_seq,
                                 causal, s);
  return launch<float>(q, k, v, e, key_pad, dout, lse, delta, dq, dk, dv, de,
                       de_part, B, H, L, max_seq, causal, s);
}
