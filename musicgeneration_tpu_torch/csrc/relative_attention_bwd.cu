// Kernel C: fused relative global attention, backward (Music Transformer).
//
// Replaces musicgeneration_tpu/ops/pallas_attention.py::_bwd (its
// pallas_calls: the one-pass _bwd_fused_kernel, and the split pair
// _bwd_dq_de_kernel / _bwd_dkv_kernel). Given the forward's inputs, its
// output O and LSE, and dO, computes per (batch, head)
//
//   p[t, s]  = exp(logits[t, s] - lse[t]) u[t]  (logits exactly as kernel A)
//   g[t, s]  = p[t, s] (dO_t . v_s - delta_t), delta_t = dO_t . O_t
//   dQ_t     = scale * sum_s g[t, s] (k_s + E[max_seq - 1 - t + s])
//   dK_s     = scale * sum_t g[t, s] q_t
//   dV_s     = sum_t p[t, s] dO_t
//   dE[r]    = scale * sum_{b, h, t - s = max_seq - 1 - r} g[t, s] q_t
//
// where u[t] = 1 but on a row whose every key is masked (below), with the
// TPU kernel's rounding points: E rounded to the q dtype, g
// rounded to the compute dtype before the dQ, dK and dE products, p
// rounded to the dO dtype before dV, f32 accumulation, dQ/dK/dV stored in
// the q dtype and dE in f32. scale = 1/8 (dh 64) is a power of two, so it
// is applied once at the end, bit-equal to the TPU's prescaled q.
//
// The split for this card (FlashAttention-2's). The TPU kernel walks a
// sequential grid and revisits its dK, dV and dE outputs across grid
// steps; GPU blocks run in no order, so a call makes these launches:
//
//  * prep: delta_t = dO_t . O_t in f32 and, in bf16, E in the q dtype
//    (the JAX wrapper makes both outside its kernels; here one launch),
//    and u[t] with the extended walk's flags;
//  * dkv: one block per (64-key tile, b*h) walks the query tiles that see
//    it (from the diagonal on, when causal) and keeps dK and dV in
//    registers;
//  * dq: one block per (64-query tile, b*h) walks its causal key tiles
//    and keeps dQ in registers. Its dE contributions land on the band of
//    128 E rows each (query tile, key tile) touches, base = max_seq - 64 -
//    t0 + s0 (kernel A's index map; g[t, s] meets band row (63 - tl) +
//    sl). Consecutive key tiles' bands overlap by 64 rows, so the block
//    carries 128 rows in registers and retires the lower 64 after each
//    key tile into its own partial window (no atomics). Window chunk c
//    of query tile qt holds E rows max_seq - 64 (qt + 1 - c) + i; chunks
//    past qt are past the table (the TPU's slack rows, which
//    de_padded[:max_seq] drops), so the tensor-core body computes and
//    stores only chunks 0 .. qt: qt + 1 chunks a query tile, n (n + 1) / 2
//    a (b, h) for n query tiles, causal or not;
//  * reduce: dE row by row, the windows that cover it summed in a fixed
//    order (deterministic: two calls give bit-equal results); E rows no
//    (t, s) pair touches get exactly zero.
//
// The extended walk (causal). A row whose reachable keys (s <= t) are all
// padded gets from kernel A the plain forward's result, an average over
// every key whose logit carries a single -1e9, later keys included, and
// an LSE at the -1e9 floor (csrc/relative_attention.cu). Its p = e^(x -
// lse) is then not 0 past the diagonal, so the causal walk alone would
// miss those pairs. The prep launch flags each (b*h, query tile) holding
// such a row: a real row with lse < -5e8 (kernel A's `unmet_rows` test).
// A flagged query tile's dq block walks every key tile; each dkv block,
// after its causal query tiles, walks the flagged ones before its
// diagonal. For s > t the E rows lie past the table (zero), as in the
// plain version, so those pairs add to dQ through g.K alone, to dK and
// dV, and to no dE window. For every other row they add p = e^(-1e9 + x
// - lse) = 0 exactly, so its bits do not change; a block without flagged
// tiles pays one flag load, issued before its walk.
//
// The row scale u. On such a row (and, without causal, on a row whose
// keys are all padded) kernel A's LSE is m + log(l) rounded to m = -1e9:
// log(l) lies below the f32 spacing there (64), so e^(x - lse) is 1 on
// each of the l keys at the floor where the forward weighed each 1/l. The
// JAX _bwd recomputes p from that LSE alone and so gives the row l times
// the gradient of its forward. Here the prep launch sums e^(x_s - lse)
// over every key of a row with lse < -5e8 (one warp a row, CUDA-core f32
// products of the same rounded operands: only their order differs from
// the tile's, which moves x only where |logit| before the mask is >= 32)
// and stores u = 1 / sum; every other row gets u = 1, so its p keeps its
// bits. dQ, dK, dV and dE are then those of the forward (the plain
// version's `unmet_row_scale`).
//
// What bounds it: at the training shape (B8 H4 L512 dh64, bf16, causal)
// the least traffic is q, k, v, O, dO, dQ, dK, dV, the E table, dE and
// the LSE, ~17 MB (~5 us at 3.35 TB/s), and the causal work is about
// eight 64-deep products per (t, s <= t) pair, ~4.3 GFLOP (~4.4 us on
// bf16 tensor cores): bytes, with the tensor cores close behind.
//
// Two bodies; the dtype chooses one in `launch`, with no fallback between
// them.
// * bf16 (every main path): every product on the tensor cores, mma.sync
//   m16n8k16 with bf16 operands from ldmatrix and f32 accumulators (the
//   TPU kernel's products exactly), 4 warps of 16 rows a block. The dq and
//   dkv blocks are one launch (`rel_attn_bwd_tc_kernel`), heaviest first,
//   so the light blocks of either fill the SMs while the heavy ones run:
//   under causal each alone leaves most SMs idle through its last, longest
//   blocks (on an H100 SXM at 700 W, two launches took 70 us at the
//   training shape, one 42). Each
//   block takes its logits from rel_attn_tile.cuh's `tile_logits`, the
//   function behind kernel A's bf16 LSE (same q.k and Gq products, skewed
//   slab read, scale and masks, in the same order), so p = e^(x - lse)
//   starts from the logits that produced that LSE, and from their exact
//   difference (2^((x - lse) log2 e) on the SFU): fully masked rows
//   (-1e9, -2e9) stay finite and rows past L (lse = +inf) get p = 0. K,
//   V, Q, dO and E (bf16) come through cp.async into swizzled double
//   buffers and a three-slot E ring that slides by 64 rows a tile, so the
//   next tile's loads are in flight during this one's products.
//   - dq, per key tile: S as above; dP = dO.V^T (V through ldmatrix as K
//     is for q.k); g = p (dP - delta) rounded to bf16 into A fragments in
//     registers; dQ += g.K (K through ldmatrix.trans); each warp writes
//     its g skewed into a zeroed bf16 slab, slab[r, 15 - r + sl] =
//     g[r, sl] (the inverse of A's skewed read), and dQ += slab . E_window
//     over its 80 band rows (5 k16 steps); then, after a barrier, warp w
//     computes dE_band rows 16w .. 16w + 15 (low) and 64 + 16w .. (high)
//     as slab^T . Q over the k16 steps of the warps whose windows reach
//     them (5 in all), retires the low rows to the window and moves the
//     high ones down: no exchange between warps. 250 registers, 0 spilled
//     (ptxas, sm_90a): the dQ, dE-low and dE-high accumulators (96) stay
//     in registers and the Q and dO fragments are reloaded each tile.
//   - dkv, per query tile: S, dP and g in query-row orientation; bf16 P
//     and g stored as two swizzled 64 x 64 tiles; then each warp takes 16
//     keys: dV += P^T.dO and dK += g^T.Q, A operands through
//     ldmatrix.trans of the stored tiles. The E ring is indexed by query
//     tile: the band slides down by 64 rows from one query tile to the
//     next.
//   - reduce: a block of 256 threads per 2 E rows, 8 groups of (b, h)
//     summed apart by 16 threads a row (16-byte loads) and then in order.
// * f32 (the parity mode: the train-step parity holds it to 1e-5): the
//   CUDA-core body, every product an f32 FMA (TF32 would lose that). The
//   logits micro-tile uses kernel A's f32 fmaf chains and mask adds, so p
//   comes from the logits behind A's f32 LSE. 256 threads, each a 4x4
//   (t, s) micro-tile; Q, dO, K, V, the 128-row E band and P/G in shared
//   memory at stride 65; separate dkv and dq launches; dE windows of
//   n + 1 chunks per query tile, reduced by one thread per dE element.
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "rel_attn_tile.cuh"

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
                                + 2 * BQ * LDT + 3 * BQ;
constexpr int DQ_SMEM_FLOATS = 2 * BQ * LD + 2 * BK * LD + BAND * LD
                               + BQ * LDG + 3 * BQ;

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
// L get p = 0 (their lse / delta / u slots are staged as 0).
__device__ __forceinline__ void p_and_g(float sqk, float sqe, float dp,
                                        int t, int s, int L, int causal,
                                        const float* pad, float scale,
                                        float lse_t, float delta_t,
                                        float u_t, float& p, float& g) {
  float x = (sqk + sqe) * scale;
  if (causal && s > t) x += NEG_INF;
  if (s < L && t < L) {
    if (pad) x += pad[s] * NEG_INF;
  } else {
    x = -INFINITY;
  }
  p = expf(x - lse_t) * u_t;
  g = p * (dp - delta_t);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rel_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ e,
                        const float* __restrict__ key_pad,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ u, T* __restrict__ dk,
                        T* __restrict__ dv, const int* __restrict__ flags,
                        int H, int L, int max_seq, int causal, float scale) {
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
  float* u_s = delta_s + BQ;          // [BQ]

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

  // query tiles with t0 + BQ - 1 >= s0 see this key tile (BQ == BK); then,
  // under causal, the extended walk: the flagged query tiles before it
  const int* fl = flags + (size_t)bh * n_tiles;
  for (int it = causal ? kt : 0; it < n_tiles + (causal ? kt : 0); ++it) {
    const int qt = it < n_tiles ? it : it - n_tiles;
    if (it >= n_tiles && !fl[qt]) continue;
    const int t0 = qt * BQ;
    __syncthreads();  // previous query tile fully consumed
    stage_rows(Qs, q + off, t0, BQ, L);
    stage_rows(dOs, dout + off, t0, BQ, L);
    stage_band<T>(Es, e, max_seq - BQ - t0 + s0, max_seq);
    if (tid < BQ) {
      const int t = t0 + tid;
      lse_s[tid] = t < L ? lse[(size_t)bh * L + t] : 0.f;
      delta_s[tid] = t < L ? delta[(size_t)bh * L + t] : 0.f;
      u_s[tid] = t < L ? u[(size_t)bh * L + t] : 0.f;
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
                pad, scale, lse_s[tl], delta_s[tl], u_s[tl], p, g);
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
                       const float* __restrict__ delta,
                       const float* __restrict__ u, T* __restrict__ dq,
                       float* __restrict__ de_part,
                       const int* __restrict__ flags, int H, int L,
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
  float* u_s = delta_s + BQ;          // [BQ]

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
    u_s[tid] = t < L ? u[(size_t)bh * L + t] : 0.f;
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

  // under causal, the causal key tiles, or every tile for a flagged query
  // tile (the extended walk: its window chunks past qt lie past the table,
  // where the reduction never reads)
  const int n_kv = !causal || flags[(size_t)bh * n_tiles + qt]
                       ? n_tiles : min(n_tiles, qt + 1);
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
                pad, scale, lse_s[tl], delta_s[tl], u_s[tl], p, g);
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

// ---------------------------------------------------------------------
// The bf16 body on the tensor cores (the design note at the top).

namespace tc = mg::tc;
using bf16 = __nv_bfloat16;

constexpr int GS_LD = 88;                     // bf16 row stride of a g slab
constexpr int GS_BYTES = 16 * GS_LD * 2;      // 176 B rows: conflict-free
constexpr int RED_GROUPS = 8;                 // (b, h) groups of the reduce

// Byte offsets in dynamic shared memory.
struct DqSmem {
  static constexpr int Q = 0;
  static constexpr int DO = Q + tc::TILE_BYTES;
  static constexpr int K = DO + tc::TILE_BYTES;        // 2 buffers
  static constexpr int V = K + 2 * tc::TILE_BYTES;     // 2 buffers
  static constexpr int E = V + 2 * tc::TILE_BYTES;     // the E ring
  static constexpr int GQ = E + 3 * tc::TILE_BYTES;    // 4 f32 Gq slabs
  static constexpr int GS = GQ + 4 * tc::SLAB_BYTES;   // 4 bf16 g slabs
  static constexpr int BYTES = GS + 4 * GS_BYTES;
};
struct DkvSmem {
  static constexpr int K = 0;
  static constexpr int V = K + tc::TILE_BYTES;
  static constexpr int Q = V + tc::TILE_BYTES;         // 2 buffers
  static constexpr int DO = Q + 2 * tc::TILE_BYTES;    // 2 buffers
  static constexpr int E = DO + 2 * tc::TILE_BYTES;    // the E ring
  static constexpr int GQ = E + 3 * tc::TILE_BYTES;    // 4 f32 Gq slabs
  static constexpr int P = GQ + 4 * tc::SLAB_BYTES;    // bf16 p tile
  static constexpr int G = P + tc::TILE_BYTES;         // bf16 g tile
  static constexpr int BYTES = G + tc::TILE_BYTES;
};

// dE partial windows of one (b, h): query tile qt's window, chunks
// 0 .. qt of 64 x 64 floats, starts at chunk qt (qt + 1) / 2.
__host__ __device__ __forceinline__ size_t part_chunks(int n) {
  return (size_t)n * (n + 1) / 2;
}

// acc[j] += a . tile[rows row0 .. row0 + 15, 8j ..]: one k16 step whose
// B operand is 16 stored rows (k) by 64 columns (n), through
// ldmatrix.trans.
__device__ __forceinline__ void mma_kn(float (&acc)[8][4],
                                       const uint32_t (&a)[4],
                                       const char* tile, int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    tc::ldsm_x4_t(b, tc::smem_u32(tile + tc::swz(row0 + (lane & 7)
                                                     + 8 * ((lane >> 3) & 1),
                                                 2 * jp + (lane >> 4))));
    tc::mma(acc[2 * jp], a, b[0], b[1]);
    tc::mma(acc[2 * jp + 1], a, b[2], b[3]);
  }
}

// p = e^(x - lse) u and g = p (dP - delta) in place of the logits, for
// the thread's rows g and g + 8; p and g rounded to bf16 as pairs of
// columns (pb may be null).
__device__ __forceinline__ void grad_logits(float (&s)[8][4],
                                            const float (&dp)[8][4],
                                            const float (&lse)[2],
                                            const float (&dl)[2],
                                            const float (&u)[2],
                                            uint32_t (*pb)[2],
                                            uint32_t (&gb)[8][2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float p[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        p[b] = tc::exp2_approx((s[j][2 * h + b] - lse[h]) * tc::LOG2E)
               * u[h];
        s[j][2 * h + b] = p[b] * (dp[j][2 * h + b] - dl[h]);
      }
      if (pb) pb[j][h] = tc::pack_bf16(p[0], p[1]);
      gb[j][h] = tc::pack_bf16(s[j][2 * h], s[j][2 * h + 1]);
    }
}

// A flag of the extended walk, loaded where it is written in the code (a
// volatile load stays ahead of the walk it is read after).
__device__ __forceinline__ int ldg_flag(const int* p) {
  int v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

// The arguments of the tensor-core kernel.
struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* e;         // E in the q dtype
  const float* key_pad;  // [B, L] or null
  const bf16* dout;
  const float* lse;
  const float* delta;
  const float* u;        // [B*H, L]: the prep launch's row scale
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* de_part;
  const int* flags;      // [B*H, n_tiles]: the extended walk's query tiles
  int H, L, max_seq, causal;
  float scale;
};

// lse, delta and u of the thread's rows g and g + 8 of the warp's 16 in
// the query tile at t0; rows past L get lse = +inf, so p = e^(x - inf) =
// 0.
__device__ __forceinline__ void row_stats(const BwdArgs& p, int bh, int t0,
                                          float (&lse)[2], float (&dl)[2],
                                          float (&u)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 16 * warp + (lane >> 2) + 8 * h;
    lse[h] = t < p.L ? p.lse[(size_t)bh * p.L + t] : INFINITY;
    dl[h] = t < p.L ? p.delta[(size_t)bh * p.L + t] : 0.f;
    u[h] = t < p.L ? p.u[(size_t)bh * p.L + t] : 0.f;
  }
}

// The dq block of query tile qt of (b, h) = bh.
__device__ __forceinline__ void dq_block(const BwdArgs& p, int qt, int bh,
                                         char* smem) {
  using S = DqSmem;
  const bf16* e = p.e;
  const int L = p.L, max_seq = p.max_seq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = bh / p.H;
  const int n_tiles = (L + BK - 1) / BK;
  const int t0 = qt * BQ;
  // under causal the causal key tiles, or, for a query tile flagged by
  // the prep launch, every key tile (the extended walk: past the diagonal
  // the E chunks lie past the table and load as zeros, so those tiles add
  // to dQ through g.K alone and write no dE window)
  const int n_kv = !p.causal || p.flags[(size_t)bh * n_tiles + qt]
                       ? n_tiles : min(n_tiles, qt + 1);
  const size_t off = (size_t)bh * L * DH;
  const bf16* kb = p.k + off;
  const bf16* vb = p.v + off;
  float* part = p.de_part
                + (bh * part_chunks(n_tiles) + part_chunks(qt)) * (BK * DH);

  tc::TileArgs a;
  a.nkeys = L;
  a.pad = p.key_pad ? p.key_pad + (size_t)b * L : nullptr;
  a.t0 = t0;
  a.s0 = 0;
  a.causal = p.causal;
  a.scale = p.scale;
  const int ebase = max_seq - BQ - t0;  // E row of band row 0, key tile 0

  tc::tile_load(smem + S::Q, p.q + off, DH, t0, L);
  tc::tile_load(smem + S::DO, p.dout + off, DH, t0, L);
  tc::tile_load(smem + S::K, kb, DH, 0, L);
  tc::tile_load(smem + S::V, vb, DH, 0, L);
  // E rows outside [0, max_seq) read as zero (the TPU's slack rows)
  tc::tile_load(smem + S::E, e, DH, ebase, max_seq);
  tc::tile_load(smem + S::E + tc::TILE_BYTES, e, DH, ebase + BK, max_seq);
  tc::cp_async_commit();
  // the g slabs' columns outside 15 - r .. 78 - r stay zero
  for (int i = threadIdx.x; i < 4 * GS_BYTES / 16; i += tc::NT)
    reinterpret_cast<uint4*>(smem + S::GS)[i] = make_uint4(0, 0, 0, 0);
  float lse_r[2], dl_r[2], u_r[2];
  row_stats(p, bh, t0, lse_r, dl_r, u_r);
  float dqa[8][4], de_lo[8][4], de_hi[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[j][i] = de_lo[j][i] = de_hi[j][i] = 0.f;
  tc::cp_async_wait_all();
  __syncthreads();

  float* gq_slab =
      reinterpret_cast<float*>(smem + S::GQ + warp * tc::SLAB_BYTES);
  char* gs_slab = smem + S::GS + warp * GS_BYTES;
  uint16_t* gs16 = reinterpret_cast<uint16_t*>(gs_slab);
  const int wb = 48 - 16 * warp;  // the warp's E window: band rows wb ..

  for (int kt = 0; kt < n_kv; ++kt) {
    const bool more = kt + 1 < n_kv;
    if (more) {  // key tile kt + 1 and E chunk kt + 2, during this tile
      tc::tile_load(smem + S::K + ((kt + 1) & 1) * tc::TILE_BYTES, kb, DH,
                    (kt + 1) * BK, L);
      tc::tile_load(smem + S::V + ((kt + 1) & 1) * tc::TILE_BYTES, vb, DH,
                    (kt + 1) * BK, L);
      tc::tile_load(smem + S::E + ((kt + 2) % 3) * tc::TILE_BYTES, e, DH,
                    ebase + (kt + 2) * BK, max_seq);
      tc::cp_async_commit();
    }
    const char* kbuf = smem + S::K + (kt & 1) * tc::TILE_BYTES;
    const char* vbuf = smem + S::V + (kt & 1) * tc::TILE_BYTES;
    const char* e0 = smem + S::E + (kt % 3) * tc::TILE_BYTES;
    const char* e1 = smem + S::E + ((kt + 1) % 3) * tc::TILE_BYTES;

    float s[8][4], dp[8][4];
    {
      uint32_t qf[4][4];
      tc::a_frags(qf, smem + S::Q, 16 * warp);
      tc::tile_logits<false>(a, kt * BK, kbuf, e0, e1, gq_slab, qf, s);
    }
    {
      uint32_t of[4][4];
      tc::a_frags(of, smem + S::DO, 16 * warp);
      tc::mma_nt(dp, of, vbuf);
    }
    uint32_t gb[8][2];
    grad_logits(s, dp, lse_r, dl_r, u_r, nullptr, gb);

    // g skewed into the slab: slab[r, 15 - r + sl] = g[r, sl]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        uint16_t* dst = gs16 + r * GS_LD + 15 - r + 8 * j + 2 * t4;
        dst[0] = (uint16_t)(gb[j][h] & 0xffffu);
        dst[1] = (uint16_t)(gb[j][h] >> 16);
      }
    // dQ += g . K: keys 16kk.. are g's n8 tiles 2kk and 2kk + 1, already
    // in the A fragment's layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t af[4] = {gb[2 * kk][0], gb[2 * kk][1], gb[2 * kk + 1][0],
                              gb[2 * kk + 1][1]};
      mma_kn(dqa, af, kbuf, 16 * kk);
    }
    __syncthreads();  // every warp's slab is written: dE reads all four

    // dQ += slab . E_window: band rows wb + 16kc .., in one ring slot
#pragma unroll
    for (int kc = 0; kc < 5; ++kc) {
      uint32_t af[4];
      tc::ldsm_x4(af, tc::smem_u32(gs_slab
                                   + ((lane & 7) + 8 * ((lane >> 3) & 1))
                                         * (GS_LD * 2)
                                   + (16 * kc + 8 * (lane >> 4)) * 2));
      const int br = wb + 16 * kc;
      mma_kn(dqa, af, (br >> 6) ? e1 : e0, br & 63);
    }

    // dE band rows of E rows below max_seq: window chunk kt (low) and,
    // before the diagonal, kt + 1 (high); warp w owns band rows 16w ..
    // and 64 + 16w .., which the windows of warps kk >= 3 - w (low) and
    // kk <= 3 - w (high) reach, at slab columns 16 (w + kk - 3) and
    // 16 (w + kk + 1)
    if (kt <= qt) {
      const bool hi = kt < qt;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bool lo_on = kk >= 3 - warp, hi_on = hi && kk <= 3 - warp;
        const char* slab_kk = smem + S::GS + kk * GS_BYTES;
        const int arow = (lane & 7) + 8 * (lane >> 4);
        const int acol = 8 * ((lane >> 3) & 1);
        if (lo_on) {
          uint32_t af[4];
          tc::ldsm_x4_t(af, tc::smem_u32(slab_kk + arow * (GS_LD * 2)
                                         + (16 * (warp + kk - 3) + acol) * 2));
          mma_kn(de_lo, af, smem + S::Q, 16 * kk);
        }
        if (hi_on) {
          uint32_t af[4];
          tc::ldsm_x4_t(af, tc::smem_u32(slab_kk + arow * (GS_LD * 2)
                                         + (16 * (warp + kk + 1) + acol) * 2));
          mma_kn(de_hi, af, smem + S::Q, 16 * kk);
        }
      }
      // the low rows are final: window rows 64 kt + 16 w + ..
      float* dst = part + (size_t)(kt * BK + 16 * warp) * DH;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(dst + (g + 8 * h) * DH + 8 * j + 2 * t4) =
              make_float2(de_lo[j][2 * h], de_lo[j][2 * h + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          de_lo[j][i] = de_hi[j][i];
          de_hi[j][i] = 0.f;
        }
      }
    }
    if (more) tc::cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 16 * warp + g + 8 * h;
    if (t >= L) continue;
    bf16* row = p.dq + off + (size_t)t * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = tc::pack_bf16(
          dqa[j][2 * h] * p.scale, dqa[j][2 * h + 1] * p.scale);
  }
}

// The dkv block of key tile kt of (b, h) = bh.
__device__ __forceinline__ void dkv_block(const BwdArgs& p, int kt, int bh,
                                          char* smem) {
  using S = DkvSmem;
  const bf16* e = p.e;
  const int L = p.L, max_seq = p.max_seq;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = bh / p.H;
  const int n_tiles = (L + BQ - 1) / BQ;
  const int s0 = kt * BK;
  // query tiles with t0 + 63 >= s0 see this key tile (BQ == BK)
  const int qt0 = p.causal ? kt : 0;
  const size_t off = (size_t)bh * L * DH;
  const bf16* qb = p.q + off;
  const bf16* ob = p.dout + off;
  // the extended walk (causal): after the causal query tiles, the tiles
  // before the diagonal that the prep launch flagged. Their first 32 flags
  // load now and are read after the causal walk; past 32 tiles, `next_ext`
  // loads them then.
  const int* fl = p.flags + (size_t)bh * n_tiles;
  const int fpre = p.causal && lane < min(kt, 32) ? ldg_flag(fl + lane) : 0;
  // the first flagged query tile >= from and < kt, or -1 (every thread of
  // the block calls it with the same `from`)
  auto next_ext = [&](int from) -> int {
    if (from < 32) {
      const unsigned m = __ballot_sync(0xffffffffu, fpre != 0) & (~0u << from);
      if (m) return __ffs(m) - 1;
      from = 32;
    }
    for (int w0 = from & ~31; w0 < kt; w0 += 32) {
      const int q = w0 + lane;
      const unsigned m =
          __ballot_sync(0xffffffffu, q >= from && q < kt && fl[q] != 0);
      if (m) return w0 + __ffs(m) - 1;
    }
    return -1;
  };

  tc::TileArgs a;
  a.nkeys = L - s0;
  a.pad = p.key_pad ? p.key_pad + (size_t)b * L + s0 : nullptr;
  a.s0 = s0;
  a.causal = p.causal;
  a.scale = p.scale;
  // query tile qt's band starts at E row max_seq - 64 - 64 qt + s0, 64
  // rows lower than the previous tile's
  const int ebase = max_seq - BQ + s0;

  tc::tile_load(smem + S::K, p.k + off, DH, s0, L);
  tc::tile_load(smem + S::V, p.v + off, DH, s0, L);
  tc::tile_load(smem + S::Q, qb, DH, qt0 * BQ, L);
  tc::tile_load(smem + S::DO, ob, DH, qt0 * BQ, L);
  tc::tile_load(smem + S::E, e, DH, ebase - qt0 * BQ, max_seq);
  tc::tile_load(smem + S::E + tc::TILE_BYTES, e, DH, ebase - qt0 * BQ + BK,
                max_seq);
  tc::cp_async_commit();
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[j][i] = dva[j][i] = 0.f;
  tc::cp_async_wait_all();
  __syncthreads();

  float* gq_slab =
      reinterpret_cast<float*>(smem + S::GQ + warp * tc::SLAB_BYTES);
  // walk position i holds query tile qt, its E chunk hh in ring slot
  // (hh + 2 i) % 3: consecutive tiles share a chunk, and the extended
  // tiles' chunks all lie past the table (zeros)
  int qt = qt0;
  for (int i = 0; qt >= 0; ++i) {
    const int buf = i & 1;
    const int nxt = qt >= qt0 && qt + 1 < n_tiles
                        ? qt + 1
                        : (p.causal ? next_ext(qt >= qt0 ? 0 : qt + 1) : -1);
    if (nxt >= 0) {  // the next tile and its lower E chunk, during this one
      tc::tile_load(smem + S::Q + (buf ^ 1) * tc::TILE_BYTES, qb, DH,
                    nxt * BQ, L);
      tc::tile_load(smem + S::DO + (buf ^ 1) * tc::TILE_BYTES, ob, DH,
                    nxt * BQ, L);
      tc::tile_load(smem + S::E + ((2 * i + 2) % 3) * tc::TILE_BYTES, e, DH,
                    ebase - nxt * BQ, max_seq);
      tc::cp_async_commit();
    }
    const int t0 = qt * BQ;
    a.t0 = t0;
    const char* qbuf = smem + S::Q + buf * tc::TILE_BYTES;
    const char* obuf = smem + S::DO + buf * tc::TILE_BYTES;
    float lse_r[2], dl_r[2], u_r[2];
    row_stats(p, bh, t0, lse_r, dl_r, u_r);

    float s[8][4], dp[8][4];
    {
      uint32_t qf[4][4];
      tc::a_frags(qf, qbuf, 16 * warp);
      tc::tile_logits<false>(
          a, 0, smem + S::K,
          smem + S::E + ((2 * i) % 3) * tc::TILE_BYTES,
          smem + S::E + ((1 + 2 * i) % 3) * tc::TILE_BYTES, gq_slab, qf, s);
    }
    {
      uint32_t of[4][4];
      tc::a_frags(of, obuf, 16 * warp);
      tc::mma_nt(dp, of, smem + S::V);
    }
    uint32_t pb[8][2], gb[8][2];
    grad_logits(s, dp, lse_r, dl_r, u_r, pb, gb);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off_b = tc::swz(16 * warp + g + 8 * h, j) + 4 * t4;
        *reinterpret_cast<uint32_t*>(smem + S::P + off_b) = pb[j][h];
        *reinterpret_cast<uint32_t*>(smem + S::G + off_b) = gb[j][h];
      }
    __syncthreads();  // the p and g tiles are complete

    // dV += P^T . dO and dK += g^T . Q for keys 16 warp ..: A operands
    // are 16 x 16 blocks of the stored tiles, transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int off_a = tc::swz(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                2 * warp + ((lane >> 3) & 1));
      uint32_t pa[4], ga[4];
      tc::ldsm_x4_t(pa, tc::smem_u32(smem + S::P + off_a));
      tc::ldsm_x4_t(ga, tc::smem_u32(smem + S::G + off_a));
      mma_kn(dva, pa, obuf, 16 * kk);
      mma_kn(dka, ga, qbuf, 16 * kk);
    }
    if (nxt >= 0) tc::cp_async_wait_all();
    __syncthreads();
    if (nxt >= 0 && nxt < qt0 && qt >= qt0) {
      // into the extended walk: the next tile's upper chunk, in the slot
      // this tile's lower chunk held, lies past the table too (zeros)
      tc::tile_load(smem + S::E + ((2 * i + 3) % 3) * tc::TILE_BYTES, e, DH,
                    max_seq, max_seq);
      tc::cp_async_commit();
      tc::cp_async_wait_all();
      __syncthreads();
    }
    qt = nxt;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int sk = s0 + 16 * warp + g + 8 * h;
    if (sk >= L) continue;
    bf16* krow = p.dk + off + (size_t)sk * DH + 2 * t4;
    bf16* vrow = p.dv + off + (size_t)sk * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(krow + 8 * j) = tc::pack_bf16(
          dka[j][2 * h] * p.scale, dka[j][2 * h + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + 8 * j) =
          tc::pack_bf16(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

// One launch runs every dq and dkv block, so the light blocks of either
// fill the SMs while the heavy ones run. blockIdx.x is (b, h), blockIdx.y
// 2 j + role, j = 0 the heaviest: under causal the dq block of query tile
// n - 1 - j and the dkv block of key tile j each walk n - j tiles, and
// blocks are handed out in the order of their linear index, x fastest.
__global__ void __launch_bounds__(tc::NT, 2)
rel_attn_bwd_tc_kernel(const BwdArgs p) {
  extern __shared__ __align__(128) char tc_smem[];
  const int j = blockIdx.y >> 1;
  if (blockIdx.y & 1)
    dkv_block(p, j, blockIdx.x, tc_smem);
  else
    dq_block(p, (p.L + BQ - 1) / BQ - 1 - j, blockIdx.x, tc_smem);
}

// The sum over every key s of e^(x_s - lse_t) for query row t of one
// (b, h), x_s the logit as the bodies form it ((q.k + q.E) * scale, then
// the masks) from the same rounded operands, one warp: lanes take keys.
template <typename T>
__device__ float floor_row_sum(const T* __restrict__ qrow,
                               const T* __restrict__ kb,
                               const float* __restrict__ e,
                               const float* __restrict__ pad, int t, int L,
                               int max_seq, int causal, float scale,
                               float lse_t) {
  float sum = 0.f;
  for (int s = threadIdx.x & 31; s < L; s += 32) {
    const T* kr = kb + (size_t)s * DH;
    const int ei = max_seq - 1 - t + s;  // >= 0; past the table: zero
    float qk = 0.f, qe = 0.f;
    for (int c = 0; c < DH; ++c) {
      const float qc = mg::to_f(qrow[c]);
      qk = fmaf(qc, mg::to_f(kr[c]), qk);
      if (ei < max_seq)
        qe = fmaf(qc, mg::round_to<T>(e[(size_t)ei * DH + c]), qe);
    }
    float x = (qk + qe) * scale;
    if (causal && s > t) x += NEG_INF;
    if (pad) x += pad[s] * NEG_INF;
    sum += expf(x - lse_t);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// delta[row] = dO[row] . O[row] in f32 (8 threads a row, 16-byte loads)
// and, with e_lp, E in bf16: the two inputs the JAX wrapper prepares
// outside its kernels, in one launch. The launch also writes, one warp a
// (b*h, query tile), the row scale u (1 / floor_row_sum on a real row
// whose LSE is at the -1e9 floor, below -5e8: kernel A's `unmet_rows`
// test, on the LSE; else 1) and the extended walk's flags:
// flags[bh * n_tiles + qt] = 1 when a row of query tile qt is at the
// floor, else 0 (read only under causal).
template <typename T>
__global__ void __launch_bounds__(256)
rel_attn_bwd_prep(const T* __restrict__ dout, const T* __restrict__ out,
                  float* __restrict__ delta, int rows,
                  const float* __restrict__ e, bf16* __restrict__ e_lp,
                  int e_elems, const float* __restrict__ lse,
                  int* __restrict__ flags, float* __restrict__ u,
                  const T* __restrict__ q, const T* __restrict__ k,
                  const float* __restrict__ key_pad, int H, int L,
                  int max_seq, int causal, float scale, int n_flags) {
  const int row_blocks = (rows + 31) / 32;
  const int e_blocks = (e_elems + 2047) / 2048;
  if ((int)blockIdx.x < row_blocks) {
    const int row = blockIdx.x * 32 + (threadIdx.x >> 3);
    const int c = (threadIdx.x & 7) * 8;
    float acc = 0.f;
    if (row < rows) {
      float a[8], o[8];
      mg::widen8(mg::load_raw8(dout + (size_t)row * DH + c), a);
      mg::widen8(mg::load_raw8(out + (size_t)row * DH + c), o);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(a[i], o[i], acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (row < rows && (threadIdx.x & 7) == 0) delta[row] = acc;
  } else if ((int)blockIdx.x < row_blocks + e_blocks) {
    const int i = ((blockIdx.x - row_blocks) * 256 + threadIdx.x) * 8;
    if (i < e_elems) {
      const float4 x0 = *reinterpret_cast<const float4*>(e + i);
      const float4 x1 = *reinterpret_cast<const float4*>(e + i + 4);
      *reinterpret_cast<uint4*>(e_lp + i) = make_uint4(
          tc::pack_bf16(x0.x, x0.y), tc::pack_bf16(x0.z, x0.w),
          tc::pack_bf16(x1.x, x1.y), tc::pack_bf16(x1.z, x1.w));
    }
  } else {
    const int lane = threadIdx.x & 31;
    const int f = (blockIdx.x - row_blocks - e_blocks) * 8 + (threadIdx.x >> 5);
    if (f < n_flags) {
      const int n_tiles = (L + BQ - 1) / BQ;
      const int bh = f / n_tiles, t0 = (f % n_tiles) * BQ;
      const float* lrow = lse + (size_t)bh * L;
      unsigned floor_rows[2];
      float mine[2] = {1.f, 1.f};  // u of rows t0 + lane + 32 h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + lane + 32 * h;
        floor_rows[h] = __ballot_sync(0xffffffffu,
                                      t < L && lrow[t] < 0.5f * NEG_INF);
      }
      if (lane == 0) flags[f] = (floor_rows[0] | floor_rows[1]) != 0u;
      const size_t off = (size_t)bh * L * DH;
      const float* pad = key_pad ? key_pad + (size_t)(bh / H) * L : nullptr;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        for (unsigned m = floor_rows[h]; m; m &= m - 1) {
          const int r = __ffs(m) - 1, t = t0 + r + 32 * h;
          const float sum = floor_row_sum(q + off + (size_t)t * DH, k + off,
                                          e, pad, t, L, max_seq, causal,
                                          scale, lrow[t]);
          if (lane == r) mine[h] = 1.f / sum;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + lane + 32 * h;
        if (t < L) u[(size_t)bh * L + t] = mine[h];
      }
    }
  }
}

// dE[r] = scale * the sum of the window rows that hold E row r, r =
// max_seq - 64 (m + 1) + i: chunk qt - m of every (b, h)'s window of
// query tile qt >= m. A block takes 2 rows; 16 threads a row (a float4
// each) in each of 8 groups of (b, h), which sum their windows in order
// (bh, then qt) and are then summed in group order: a fixed order.
__global__ void __launch_bounds__(256)
rel_attn_bwd_de_reduce_tc(const float* __restrict__ de_part,
                          float* __restrict__ de, int BH, int n_tiles,
                          int max_seq, float scale) {
  __shared__ float4 acc_s[2][RED_GROUPS][16];
  const int c4 = threadIdx.x & 15, grp = (threadIdx.x >> 4) & 7;
  const int rs = threadIdx.x >> 7;
  const int r = blockIdx.x * 2 + rs;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < max_seq) {
    const int m = (max_seq - 1 - r) / BK;
    const int i = r - (max_seq - BK * (m + 1));
    const size_t per_bh = part_chunks(n_tiles);
    for (int bh = grp; bh < BH; bh += RED_GROUPS) {
#pragma unroll 4
      for (int qt = m; qt < n_tiles; ++qt) {
        const float4 x = *reinterpret_cast<const float4*>(
            de_part + ((bh * per_bh + part_chunks(qt) + qt - m) * BK + i) * DH
            + 4 * c4);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
    }
  }
  acc_s[rs][grp][c4] = acc;
  __syncthreads();
  if (grp == 0 && r < max_seq) {
    float4 sum = acc_s[rs][0][c4];
#pragma unroll
    for (int gi = 1; gi < RED_GROUPS; ++gi) {
      const float4 x = acc_s[rs][gi][c4];
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(de + (size_t)r * DH + 4 * c4) =
        make_float4(sum.x * scale, sum.y * scale, sum.z * scale,
                    sum.w * scale);
  }
}

// Floats of dE partial windows a call needs: the tensor-core body keeps
// chunks 0 .. qt of query tile qt, the CUDA-core body n + 1 chunks.
template <bool TC>
long long windows(int B, int H, int L) {
  const size_t n = (L + BQ - 1) / BQ;
  return (long long)((size_t)B * H * (TC ? part_chunks(n) : n * (n + 1))
                     * BK * DH);
}

// TC picks the body: the tensor-core kernel (bf16 only) or the CUDA-core
// ones. By default the dtype picks it; both take the same arguments (`e`
// in f32 for the CUDA-core body, `e_lp`, filled by the prep kernel, for
// the other). Launches the prep kernel (delta, E in bf16, flags, u), the
// dK/dV and dQ work (one launch on the tensor cores, two on the CUDA
// cores) and the dE reduction.
template <typename T, bool TC = std::is_same<T, __nv_bfloat16>::value>
int launch(const void* q, const void* k, const void* v, const void* e,
           void* e_lp, const void* key_pad, const void* out,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, void* de, void* de_part, int B, int H, int L,
           int max_seq, int causal, cudaStream_t stream) {
  static_assert(!TC || std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core body takes bf16");
  const float scale = 1.0f / sqrtf((float)DH);
  const int n_tiles = (L + BQ - 1) / BQ;
  const int rows = B * H * L;
  const int e_elems = TC ? max_seq * DH : 0;
  // the extended walk's flags, then the row scale u: past the dE windows
  // in the same scratch
  int* flags = reinterpret_cast<int*>(static_cast<float*>(de_part)
                                      + windows<TC>(B, H, L));
  const int n_flags = B * H * n_tiles;
  float* u = reinterpret_cast<float*>(flags + n_flags);
  rel_attn_bwd_prep<T><<<(rows + 31) / 32 + (e_elems + 2047) / 2048
                             + (n_flags + 7) / 8,
                         256, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(out),
      static_cast<float*>(delta), rows, static_cast<const float*>(e),
      static_cast<bf16*>(e_lp), e_elems, static_cast<const float*>(lse),
      flags, u, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(key_pad), H, L, max_seq, causal, scale,
      n_flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (TC) {
    constexpr int smem = DkvSmem::BYTES > DqSmem::BYTES ? DkvSmem::BYTES
                                                        : DqSmem::BYTES;
    err = cudaFuncSetAttribute(rel_attn_bwd_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    BwdArgs a;
    a.q = static_cast<const bf16*>(q);
    a.k = static_cast<const bf16*>(k);
    a.v = static_cast<const bf16*>(v);
    a.e = static_cast<const bf16*>(e_lp);
    a.key_pad = static_cast<const float*>(key_pad);
    a.dout = static_cast<const bf16*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.delta = static_cast<const float*>(delta);
    a.u = u;
    a.dq = static_cast<bf16*>(dq);
    a.dk = static_cast<bf16*>(dk);
    a.dv = static_cast<bf16*>(dv);
    a.de_part = static_cast<float*>(de_part);
    a.flags = flags;
    a.H = H;
    a.L = L;
    a.max_seq = max_seq;
    a.causal = causal;
    a.scale = scale;
    rel_attn_bwd_tc_kernel<<<dim3(B * H, 2 * n_tiles), tc::NT, smem,
                             stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rel_attn_bwd_de_reduce_tc<<<(max_seq + 1) / 2, 256, 0, stream>>>(
        static_cast<const float*>(de_part), static_cast<float*>(de), B * H,
        n_tiles, max_seq, scale);
    return (int)cudaGetLastError();
  } else {
    const dim3 grid(n_tiles, B * H);
    const size_t smem_kv = DKV_SMEM_FLOATS * sizeof(float);
    const size_t smem_q = DQ_SMEM_FLOATS * sizeof(float);
    err = cudaFuncSetAttribute(rel_attn_bwd_dkv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
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
        static_cast<const float*>(lse), static_cast<const float*>(delta), u,
        static_cast<T*>(dk), static_cast<T*>(dv), flags, H, L, max_seq,
        causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rel_attn_bwd_dq_kernel<T><<<grid, NT, smem_q, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(e),
        static_cast<const float*>(key_pad), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), u,
        static_cast<T*>(dq), static_cast<float*>(de_part), flags, H, L,
        max_seq, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rel_attn_bwd_de_reduce<<<(max_seq * DH + NT - 1) / NT, NT, 0, stream>>>(
        static_cast<const float*>(de_part), static_cast<float*>(de), B * H,
        n_tiles, max_seq, causal, scale);
    return (int)cudaGetLastError();
  }
}

// Floats of the scratch a call needs: the dE partial windows, one int
// flag per (b*h, query tile) for the extended walk, and u per row.
template <bool TC>
long long scratch(int B, int H, int L) {
  return windows<TC>(B, H, L) + (long long)B * H * ((L + BQ - 1) / BQ)
         + (long long)B * H * L;
}

}  // namespace

// Floats of the de_part scratch that mg_rel_attn_bwd needs for these
// shapes and this dtype.
extern "C" long long mg_rel_attn_bwd_scratch(int is_bf16, int B, int H,
                                             int L) {
  return is_bf16 ? scratch<true>(B, H, L) : scratch<false>(B, H, L);
}

// q, k, v, out, dout, dq, dk, dv: [B, H, L, 64] contiguous, float32
// (is_bf16 = 0) or bfloat16; e, de: [max_seq, 64] float32; key_pad: [B, L]
// float32 or NULL; lse: [B, H, L] float32. Scratch: delta [B, H, L]
// float32; e_lp [max_seq, 64] bfloat16 (bf16 only); de_part of
// mg_rel_attn_bwd_scratch(...) floats. Launches kernel C's kernels on
// `stream`; returns the first CUDA error, or 0.
extern "C" int mg_rel_attn_bwd(int is_bf16, const void* q, const void* k,
                               const void* v, const void* e, void* e_lp,
                               const void* key_pad, const void* out,
                               const void* dout, const void* lse, void* delta,
                               void* dq, void* dk, void* dv, void* de,
                               void* de_part, int B, int H, int L,
                               int max_seq, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, e, e_lp, key_pad, out, dout, lse,
                                 delta, dq, dk, dv, de, de_part, B, H, L,
                                 max_seq, causal, s);
  return launch<float>(q, k, v, e, e_lp, key_pad, out, dout, lse, delta, dq,
                       dk, dv, de, de_part, B, H, L, max_seq, causal, s);
}
