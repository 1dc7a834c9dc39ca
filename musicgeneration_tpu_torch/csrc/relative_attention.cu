// Kernel A: fused relative global attention, forward (Music Transformer).
//
// Replaces musicgeneration_tpu/ops/pallas_attention.py::fused_relative_attention
// (its forward pallas_call in _fused_fwd_impl: body _kernel, _tile_logits,
// _shear). Computes, per (batch, head):
//
//   logits[t, s] = (q_t . k_s + q_t . E[max_seq - 1 - t + s]) / sqrt(dh)
//                  + (s > t) * -1e9 + key_pad[s] * -1e9
//   out = softmax(logits) V,   lse = logsumexp(logits)
//
// with the TPU kernel's numerics: E rounded to the q dtype, products in
// f32, E rows past the table read as zero (the TPU's zero slack rows),
// additive -1e9 masks (so fully masked rows agree too), the running max
// starting at -1e9, an online softmax in f32, P rounded to the V dtype
// before PV, O stored in the q dtype and the LSE in f32.
//
// Under causal, both bodies skip the key tiles that start after a query
// tile's last row, as the TPU kernel does. That is exact for every row
// with at least one unmasked key among the keys it reaches (s <= t): a
// skipped logit then adds e^(-1e9 + ...) = 0. A row whose reachable keys
// are all padded is not: the plain version's logits are -1e9 on those
// keys and on every later unpadded key (one mask each) and -2e9 on later
// padded keys, so it averages V over the single-mask keys, later ones
// included. Key 0 padded under causal gives such rows (the model's
// key_pad with pad_in_input and an input that starts with the pad id, up
// to its first other token). So after the causal walk the block votes
// (__syncthreads_or): if a real row of its query tile still has its
// running max at the -1e9 floor, it walks the remaining key tiles too,
// with the same masked body. Every other row's bits are unchanged by
// those tiles (alpha = e^0 = 1, p = 0), and a block without such rows
// pays the vote alone. (The JAX Pallas kernel skips the same tiles, so
// its answer for such rows depends on its block size; the port holds
// itself to the plain version, which is the definition.)
//
// What bounds it: at the prefill shape (B8 H4 L512 dh64, bf16) the
// causal work is ~1.6 GFLOP (QK, QE and PV) against ~8.9 MB of traffic
// (q, k, v, out, the E table, the LSE): bytes bound it at ~2.6 us on an
// H100 SXM, with the tensor-core time (~1.6 us) close behind.
//
// Two bodies; the dtype chooses one in `launch`, with no fallback between
// them.
// * bf16 (the model's dtype on every main path): `rel_attn_fwd_tc_kernel`
//   runs the tensor-core tile of rel_attn_tile.cuh (mma.sync m16n8k16,
//   bf16 operands and f32 accumulation, exactly the TPU kernel's
//   products): one block of 128 threads owns a 64-query tile, the carry in
//   registers, and walks the causal key tiles with cp.async loads in
//   flight and a sliding three-slot E ring (the csrc note there).
// * f32 (the parity mode: train-step parity and the greedy f32 checks):
//   `rel_attn_fwd_kernel`, on the CUDA cores in f32 (FMA), which keeps f32
//   inputs in full f32 (TF32 would not meet the 1e-4 check). One block of
//   256 threads owns a 64-query tile of one (batch, head) and walks the
//   causal KV tiles only. The TPU needed a shear (log2(BQ) lane rolls) to
//   align Q.E^T with the keys, because lanes do not gather cheaply there;
//   here the alignment is index arithmetic: the block stages the band of
//   BQ+BK E rows its (query tile, key tile) touches, base = max_seq - BQ -
//   t0 + s0, and each thread's 4x4 (t, s) micro-tile reads band rows
//   (63 - tl) + sl, seven distinct rows per depth step. Q, K, V, the E
//   band and P live in shared memory (~98 KB).
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "rel_attn_tile.cuh"

namespace {

constexpr int DH = 64;             // head dim (the reference fixes dh = 64)
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 64;             // key rows per tile
constexpr int NT = 256;            // threads: 16 x 16, each a 4x4 micro-tile
constexpr int LD = DH + 1;         // shared row stride (conflict-free fills)
constexpr int LDP = BK + 1;
constexpr int SMEM_FLOATS = BQ * LD + BK * LD + BK * LD + (BQ + BK) * LD
                            + BQ * LDP;
constexpr float NEG_INF = -1e9f;

template <typename T>
__global__ void __launch_bounds__(NT)
rel_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ e,
                    const float* __restrict__ key_pad, T* __restrict__ out,
                    float* __restrict__ lse, int H, int L, int max_seq,
                    int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Es = Vs + BK * LD;         // [BQ + BK][LD], band of E rows
  float* Ps = Es + (BQ + BK) * LD;  // [BQ][LDP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  // heaviest query tiles (most causal KV tiles) are scheduled first
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t off = (size_t)bh * L * DH;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;
  const float* pad = key_pad ? key_pad + (size_t)b * L : nullptr;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, c = i % DH, t = t0 + r;
    Qs[r * LD + c] = t < L ? mg::to_f(qb[(size_t)t * DH + c]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (L + BK - 1) / BK;
  const int n_kv = causal ? min(n_tiles, (t0 + BQ - 1) / BK + 1) : n_tiles;
  // band row of micro-tile element (i, j) is rbase + 3 - i + j
  const int rbase = 60 - 4 * ty + 4 * tx;

  int n_end = n_kv;  // n_tiles after a vote for the extended walk
  for (int kt = 0; kt < n_end; ++kt) {
    const int s0 = kt * BK;
    const int ebase = max_seq - BQ - t0 + s0;
    __syncthreads();  // previous tile's Ks/Vs/Es/Ps fully consumed
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, c = i % DH, s = s0 + r;
      const bool in = s < L;
      Ks[r * LD + c] = in ? mg::to_f(kb[(size_t)s * DH + c]) : 0.f;
      Vs[r * LD + c] = in ? mg::to_f(vb[(size_t)s * DH + c]) : 0.f;
    }
    for (int i = tid; i < (BQ + BK) * DH; i += NT) {
      const int r = i / DH, c = i % DH, ei = ebase + r;
      // E drops to the q dtype, as the TPU wrapper's e.astype(q.dtype)
      Es[r * LD + c] = (ei >= 0 && ei < max_seq)
                           ? mg::round_to<T>(e[(size_t)ei * DH + c])
                           : 0.f;
    }
    __syncthreads();

    float sqk[4][4], sqe[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sqk[i][j] = sqe[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DH; ++c) {
      float qv[4], kv[4], ev[7];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx * 4 + j) * LD + c];
#pragma unroll
      for (int r = 0; r < 7; ++r) ev[r] = Es[(rbase + r) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sqk[i][j] = fmaf(qv[i], kv[j], sqk[i][j]);
          sqe[i][j] = fmaf(qv[i], ev[3 - i + j], sqe[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      float lg[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        float x = (sqk[i][j] + sqe[i][j]) * scale;
        if (causal && s > t) x += NEG_INF;
        if (s < L) {
          if (pad) x += pad[s] * NEG_INF;
        } else {
          x = -INFINITY;  // past the sequence: no weight at all
        }
        lg[j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a query row are lanes tx = 0..15 of one warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(lg[j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDP + tx * 4 + j] = mg::round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int s = 0; s < BK; ++s) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[s * LD + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    if (kt + 1 == n_kv && n_kv < n_tiles) {  // the extended walk's vote
      bool unmet = false;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        unmet |= t0 + ty * 4 + i < L && m[i] < 0.5f * NEG_INF;
      if (__syncthreads_or(unmet)) n_end = n_tiles;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= L) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[off + (size_t)t * DH + tx * 4 + j] = mg::from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[(size_t)bh * L + t] = m[i] + logf(lc);
  }
}

// The bf16 body: the tensor-core tile with its carry in registers.
__global__ void __launch_bounds__(mg::tc::NT, 2)
rel_attn_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ e,
                       const float* __restrict__ key_pad,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int H, int L, int max_seq,
                       int causal, float scale) {
  namespace tc = mg::tc;
  extern __shared__ __align__(128) char tc_smem[];
  const int bh = blockIdx.y;
  const int b = bh / H;
  // heaviest query tiles (most causal KV tiles) are scheduled first
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tc::BQ;
  const size_t off = (size_t)bh * L * DH;
  tc::TileArgs a;
  a.q = q + off + (size_t)t0 * DH;
  a.k = k + off;
  a.v = v + off;
  a.ld = DH;
  a.nq = min(tc::BQ, L - t0);
  a.nkeys = L;
  a.pad = key_pad ? key_pad + (size_t)b * L : nullptr;
  a.e = e;
  a.max_seq = max_seq;
  a.ebase = max_seq - tc::BQ - t0;
  a.t0 = t0;
  a.s0 = 0;
  a.causal = causal;
  a.scale = scale;
  const int n_tiles = (L + tc::BK - 1) / tc::BK;
  const int n_kv =
      causal ? min(n_tiles, (t0 + tc::BQ - 1) / tc::BK + 1) : n_tiles;

  tc::Carry c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    c.m[h] = NEG_INF;
    c.l[h] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    c.o[j][0] = c.o[j][1] = c.o[j][2] = c.o[j][3] = 0.f;
  tc::attend<false>(a, n_kv, n_tiles, tc_smem, c);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 16 * warp + g + 8 * h;
    if (t >= L) continue;  // rows past L write nothing
    const float lc = fmaxf(c.l[h], 1e-30f);
    __nv_bfloat16* orow = out + off + (size_t)t * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          tc::pack_bf16(c.o[j][2 * h] / lc, c.o[j][2 * h + 1] / lc);
    if (t4 == 0) lse[(size_t)bh * L + t] = c.m[h] + logf(lc);
  }
}

// TC picks the body: the tensor-core tile (bf16 only) or the CUDA-core
// one. By default the dtype picks it; both bodies take the same arguments.
template <typename T, bool TC = std::is_same<T, __nv_bfloat16>::value>
int launch(const void* q, const void* k, const void* v, const void* e,
           const void* key_pad, void* out, void* lse, int B, int H, int L,
           int max_seq, int causal, cudaStream_t stream) {
  static_assert(!TC || std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core body takes bf16");
  void (*kernel)(const T*, const T*, const T*, const float*, const float*,
                 T*, float*, int, int, int, int, float);
  int threads, smem;
  if constexpr (TC) {
    kernel = rel_attn_fwd_tc_kernel;
    threads = mg::tc::NT;
    smem = mg::tc::Smem<false>::BYTES;
  } else {
    kernel = rel_attn_fwd_kernel<T>;
    threads = NT;
    smem = SMEM_FLOATS * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(e),
      static_cast<const float*>(key_pad), static_cast<T*>(out),
      static_cast<float*>(lse), H, L, max_seq, causal,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [B, H, L, 64] contiguous, float32 (is_bf16 = 0) or
// bfloat16; e: [max_seq, 64] float32; key_pad: [B, L] float32 or NULL;
// lse: [B, H, L] float32. Returns cudaGetLastError() after the launch.
extern "C" int mg_rel_attn_fwd(int is_bf16, const void* q, const void* k,
                               const void* v, const void* e,
                               const void* key_pad, void* out, void* lse,
                               int B, int H, int L, int max_seq, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, e, key_pad, out, lse, B, H, L,
                                 max_seq, causal, s);
  return launch<float>(q, k, v, e, key_pad, out, lse, B, H, L, max_seq,
                       causal, s);
}
