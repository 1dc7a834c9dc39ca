// Kernel G: one round of ring (sequence-parallel) relative attention.
//
// Replaces musicgeneration_tpu/parallel/ring_attention_pallas.py::
// ring_relative_attention_pallas (its pallas_call at :269, body _kernel,
// _shear). The TPU kernel runs the whole ring in one call and rotates the
// K/V/pad blocks between chips by remote DMA from inside the kernel; here
// the rotation is NCCL point-to-point outside the kernel (or indexing on a
// virtual mesh of one device) and one launch computes one round's tile
// for every shard it is given:
//
//   logits[t, s] = (q_t . k_s + srel[t, s]) / sqrt(dh)
//                  + (s > t) * -1e9 + pad[s] * -1e9
//   srel[t, s]   = q_t . E[max_seq - 1 - (t - s)] for s <= t, else 0
//   m' = max(m, rowmax), l' = l e^(m - m') + sum e^(logits - m'),
//   acc' = acc e^(m - m') + e^(logits - m') V
//
// for shard i = rank0 + blockIdx.z, its queries at global rows t0 = i *
// Lloc, the block it holds after r rotations starting at s0 = src * Lloc,
// src = (i - r) mod n. Numerics of the ring kernel, not of kernel A: K, V
// and E in f32, P kept in f32 for PV, the carry (m, l, acc) in f32 with m
// from -1e9, out = acc / max(l, 1e-30) in the q dtype after the last
// round. The carry is read and written in place in device memory.
//
// Under causal, key tiles that start after the query tile's last row are
// skipped, so a round whose block lies wholly after the shard's queries
// (src > i) reads nothing but the carry's m. That is exact whenever a row
// has at least one unmasked key among the keys seen so far: a skipped
// logit is below m - 1e9 + |x| and its e^(logit - m) is 0 in f32. A row
// whose every key so far is masked is not: the plain ring walks every
// round, and such a row's carry averages V over every key whose logit
// carries a single -1e9 (a later unpadded key too) until its first
// unmasked key wipes it out with e^(m - m') = 0. So a block whose carry,
// after the causal tiles of its round (none when src > i), still holds a
// real row at the -1e9 floor walks the remaining key tiles of the round
// with the same masked body (a __syncthreads_or vote); other rows' bits
// are unchanged by them, as in kernel A.
//
// What bounds it: at the main shape (B 8, H 4, L 2048 over 4 shards of
// Lloc 512, bf16) one ring pass does ~67M causal (t, s) pairs of three
// 64-deep products. On the tensor cores with the split below that is five
// bf16 products, ~43 us at 989 TFLOP/s, against ~51 us of bytes a pass
// (q, k, v, the E rows, the f32 carry read and written, out): bytes bound
// it.
//
// Two bodies; the dtype chooses one in `launch`, with no fallback between
// them. Both take the grid (Lloc / 64, B * H, S), one block per 64-query
// tile of one (shard, batch, head), and walk the 64-key tiles of the
// block the shard holds.
// * bf16: `ring_tile_tc_kernel` runs the tensor-core tile of
//   rel_attn_tile.cuh with its split products: q.k in bf16 (exact), E and
//   P as hi + lo bf16 pairs, q.E = q.E_hi + q.E_lo and P.V = P_hi.V +
//   P_lo.V into one f32 accumulator, so the ring kernel's f32 E and P
//   lose ~2^-17 of each product. The carry is read from device memory
//   into registers and written back; a block whose key tiles are all
//   skipped writes nothing but, in the last round, out.
// * f32 (the parity mode): `ring_tile_kernel` on the CUDA cores in f32
//   (FMA), which is the ring kernel's arithmetic. One block of 256 threads
//   keeps Q, K, V, a band of the 128 E rows the (query tile, key tile)
//   pair touches (base = max_seq - 64 - tq + sk, each 4x4 micro-tile
//   reading seven band rows per depth step) and P in shared memory (~98
//   KB). E rows past the table stage as zero, which is srel's zero for
//   s > t. The shear the TPU needed to align q.E with the keys is index
//   arithmetic here.
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
ring_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ pad,
                 const float* __restrict__ e, float* __restrict__ m_c,
                 float* __restrict__ l_c, float* __restrict__ acc_c,
                 T* __restrict__ out, int B, int H, int Lloc, int max_seq,
                 int rank0, int r, int n, int nkv, int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* Ks = Qs + BQ * LD;         // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Es = Vs + BK * LD;         // [BQ + BK][LD], band of E rows
  float* Ps = Es + (BQ + BK) * LD;  // [BQ][LDP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int shard = blockIdx.z;
  const int my = rank0 + shard;
  const int src = ((my - r) % n + n) % n;
  const int t0 = my * Lloc, s0 = src * Lloc;
  const int kvb = nkv == 1 ? 0 : src;
  const int d = H * DH;
  const int qt0 = blockIdx.x * BQ;  // first local query row of the tile
  const int tq = t0 + qt0;          // its global row
  const T* qb = q + ((size_t)shard * B + b) * Lloc * d + h * DH;
  const T* kb = k + ((size_t)kvb * B + b) * Lloc * d + h * DH;
  const T* vb = v + ((size_t)kvb * B + b) * Lloc * d + h * DH;
  const float* pb = pad ? pad + ((size_t)kvb * B + b) * Lloc : nullptr;
  const size_t crow = (((size_t)shard * B + b) * H + h) * Lloc;  // carry row 0

  for (int i = tid; i < BQ * DH; i += NT) {
    const int rr = i / DH, c = i % DH, tl = qt0 + rr;
    Qs[rr * LD + c] = tl < Lloc ? mg::to_f(qb[(size_t)tl * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tl = qt0 + ty * 4 + i;
    const bool in = tl < Lloc;
    m[i] = in ? m_c[crow + tl] : NEG_INF;
    l[i] = in ? l_c[crow + tl] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] = in ? acc_c[(crow + tl) * DH + tx * 4 + j] : 0.f;
  }

  const int n_tiles = (Lloc + BK - 1) / BK;
  int n_kv = n_tiles;
  if (causal) {
    // last real query row of the tile; tiles starting after it are skipped
    const int t_last = t0 + min(qt0 + BQ, Lloc) - 1;
    n_kv = t_last < s0 ? 0 : min(n_tiles, (t_last - s0) / BK + 1);
  }
  // band row of micro-tile element (i, j) is rbase + 3 - i + j
  const int rbase = 60 - 4 * ty + 4 * tx;

  // the extended walk's vote: a real row whose carry has met no unmasked
  // key (its m at the -1e9 floor) after the causal tiles
  auto unmet = [&]() {
    bool any = false;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      any |= qt0 + ty * 4 + i < Lloc && m[i] < 0.5f * NEG_INF;
    return __syncthreads_or(any) != 0;
  };
  int n_end = n_kv;
  if (n_kv == 0 && causal && unmet()) n_end = n_tiles;
  for (int kt = 0; kt < n_end; ++kt) {
    const int sk = kt * BK;         // first local key of the tile
    const int ebase = max_seq - BQ - tq + s0 + sk;
    __syncthreads();  // previous tile's Ks/Vs/Es/Ps fully consumed
    for (int i = tid; i < BK * DH; i += NT) {
      const int rr = i / DH, c = i % DH, sl = sk + rr;
      const bool in = sl < Lloc;
      Ks[rr * LD + c] = in ? mg::to_f(kb[(size_t)sl * d + c]) : 0.f;
      Vs[rr * LD + c] = in ? mg::to_f(vb[(size_t)sl * d + c]) : 0.f;
    }
    for (int i = tid; i < (BQ + BK) * DH; i += NT) {
      const int rr = i / DH, c = i % DH, ei = ebase + rr;
      // E stays f32 (the ring kernel's e.astype(f32)); rows past the
      // table are the s > t pairs, whose srel is zero
      Es[rr * LD + c] =
          (ei >= 0 && ei < max_seq) ? e[(size_t)ei * DH + c] : 0.f;
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
      for (int rr = 0; rr < 7; ++rr) ev[rr] = Es[(rbase + rr) * LD + c];
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
      const int t = tq + ty * 4 + i;
      float lg[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = sk + tx * 4 + j, s = s0 + sl;
        float x = (sqk[i][j] + sqe[i][j]) * scale;
        if (causal && s > t) x += NEG_INF;
        if (sl < Lloc) {
          if (pb) x += pb[sl] * NEG_INF;
        } else {
          x = -INFINITY;  // past the block: no weight at all
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
        Ps[(ty * 4 + i) * LDP + tx * 4 + j] = p;  // P stays f32
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
    if (kt + 1 == n_kv && n_kv < n_tiles && unmet()) n_end = n_tiles;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tl = qt0 + ty * 4 + i;
    if (tl >= Lloc) continue;
    if (tx == 0) {
      m_c[crow + tl] = m[i];
      l_c[crow + tl] = l[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc_c[(crow + tl) * DH + tx * 4 + j] = acc[i][j];
    if (out) {
      const float lc = fmaxf(l[i], 1e-30f);
      T* ob = out + (((size_t)shard * B + b) * Lloc + tl) * d + h * DH;
#pragma unroll
      for (int j = 0; j < 4; ++j) ob[tx * 4 + j] = mg::from_f<T>(acc[i][j] / lc);
    }
  }
}

// The bf16 body: the tensor-core tile with split products, its carry read
// from and written back to device memory.
__global__ void __launch_bounds__(mg::tc::NT, 2)
ring_tile_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ pad,
                    const float* __restrict__ e, float* __restrict__ m_c,
                    float* __restrict__ l_c, float* __restrict__ acc_c,
                    __nv_bfloat16* __restrict__ out, int B, int H, int Lloc,
                    int max_seq, int rank0, int r, int n, int nkv,
                    int causal, float scale) {
  namespace tc = mg::tc;
  extern __shared__ __align__(128) char tc_smem[];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int shard = blockIdx.z;
  const int my = rank0 + shard;
  const int src = ((my - r) % n + n) % n;
  const int t0 = my * Lloc, s0 = src * Lloc;
  const int kvb = nkv == 1 ? 0 : src;
  const int d = H * DH;
  const int qt0 = blockIdx.x * tc::BQ;  // first local query row of the tile
  const int tq = t0 + qt0;              // its global row
  const size_t crow = (((size_t)shard * B + b) * H + h) * Lloc;  // carry row 0

  const int n_tiles = (Lloc + tc::BK - 1) / tc::BK;
  int n_kv = n_tiles;
  if (causal) {
    // last real query row of the tile; tiles starting after it are skipped
    const int t_last = t0 + min(qt0 + tc::BQ, Lloc) - 1;
    n_kv = t_last < s0 ? 0 : min(n_tiles, (t_last - s0) / tc::BK + 1);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  tc::Carry c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tl = qt0 + 16 * warp + g + 8 * i;
    c.m[i] = tl < Lloc ? m_c[crow + tl] : NEG_INF;
  }
  const int nq = min(tc::BQ, Lloc - qt0);
  // a round with no causal tile reads the carry's m alone, unless a row of
  // it has met no unmasked key (the extended walk)
  const bool extend_all = n_kv == 0 && causal && tc::unmet_rows(c, nq);
  if (n_kv == 0 && !extend_all && !out) return;  // the carry stays as it is
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tl = qt0 + 16 * warp + g + 8 * i;
    const bool in = tl < Lloc;
    c.l[i] = in ? l_c[crow + tl] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 a2 =
          in ? *reinterpret_cast<const float2*>(acc_c + (crow + tl) * DH
                                                + 8 * j + 2 * t4)
             : make_float2(0.f, 0.f);
      c.o[j][2 * i] = a2.x;
      c.o[j][2 * i + 1] = a2.y;
    }
  }

  tc::TileArgs a;
  a.q = q + (((size_t)shard * B + b) * Lloc + qt0) * d + h * DH;
  a.k = k + ((size_t)kvb * B + b) * Lloc * d + h * DH;
  a.v = v + ((size_t)kvb * B + b) * Lloc * d + h * DH;
  a.ld = d;
  a.nq = nq;
  a.nkeys = Lloc;
  a.pad = pad ? pad + ((size_t)kvb * B + b) * Lloc : nullptr;
  a.e = e;
  a.max_seq = max_seq;
  a.ebase = max_seq - tc::BQ - tq + s0;
  a.t0 = tq;
  a.s0 = s0;
  a.causal = causal;
  a.scale = scale;
  // the causal tiles and, after a vote, the extended walk
  const int n_end = extend_all ? n_tiles : n_kv;
  tc::attend<true>(a, n_end, causal ? n_tiles : n_end, tc_smem, c);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tl = qt0 + 16 * warp + g + 8 * i;
    if (tl >= Lloc) continue;
    if (n_end > 0) {
      if (t4 == 0) {
        m_c[crow + tl] = c.m[i];
        l_c[crow + tl] = c.l[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(acc_c + (crow + tl) * DH + 8 * j
                                   + 2 * t4) =
            make_float2(c.o[j][2 * i], c.o[j][2 * i + 1]);
    }
    if (out) {
      const float lc = fmaxf(c.l[i], 1e-30f);
      __nv_bfloat16* ob =
          out + (((size_t)shard * B + b) * Lloc + tl) * d + h * DH + 2 * t4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            tc::pack_bf16(c.o[j][2 * i] / lc, c.o[j][2 * i + 1] / lc);
    }
  }
}

// TC picks the body: the tensor-core tile (bf16 only) or the CUDA-core
// one. By default the dtype picks it; both bodies take the same arguments.
template <typename T, bool TC = std::is_same<T, __nv_bfloat16>::value>
int launch(const void* q, const void* k, const void* v, const void* pad,
           const void* e, void* m, void* l, void* acc, void* out, int S,
           int B, int H, int Lloc, int max_seq, int rank0, int r, int n,
           int nkv, int causal, cudaStream_t stream) {
  static_assert(!TC || std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core body takes bf16");
  void (*kernel)(const T*, const T*, const T*, const float*, const float*,
                 float*, float*, float*, T*, int, int, int, int, int, int,
                 int, int, int, float);
  int threads, smem;
  if constexpr (TC) {
    kernel = ring_tile_tc_kernel;
    threads = mg::tc::NT;
    smem = mg::tc::Smem<true>::BYTES;
  } else {
    kernel = ring_tile_kernel<T>;
    threads = NT;
    smem = SMEM_FLOATS * sizeof(float);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Lloc + BQ - 1) / BQ, B * H, S);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(pad),
      static_cast<const float*>(e), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(acc),
      static_cast<T*>(out), B, H, Lloc, max_seq, rank0, r, n, nkv, causal,
      1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [S, B, Lloc, H * 64] contiguous, float32 (is_bf16 = 0) or
// bfloat16; k, v: [nkv, B, Lloc, H * 64] (nkv 1: every shard reads block
// 0; nkv n: shard i reads block (i - r) mod n); pad: [nkv, B, Lloc] float32
// or NULL; e: [max_seq, 64] float32; m, l: [S, B, H, Lloc] and acc
// [S, B, H, Lloc, 64] float32, updated in place; out: NULL except on the
// last round. The S shards are ring indices rank0 .. rank0 + S - 1 of n.
// Returns cudaGetLastError() after the launch.
extern "C" int mg_ring_tile(int is_bf16, const void* q, const void* k,
                            const void* v, const void* pad, const void* e,
                            void* m, void* l, void* acc, void* out, int S,
                            int B, int H, int Lloc, int max_seq, int rank0,
                            int r, int n, int nkv, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, pad, e, m, l, acc, out, S, B, H,
                                 Lloc, max_seq, rank0, r, n, nkv, causal, s);
  return launch<float>(q, k, v, pad, e, m, l, acc, out, S, B, H, Lloc,
                       max_seq, rank0, r, n, nkv, causal, s);
}
