// One tile of relative global attention on Hopper's tensor cores: 64
// queries against the 64-key tiles of one key block, bf16 operands and f32
// accumulation. Kernel A (csrc/relative_attention.cu) and kernel G
// (csrc/ring_attention.cu) run their bf16 mode through `attend` below,
// and kernel C's bf16 backward (csrc/relative_attention_bwd.cu) takes its
// logits from the same `tile_logits`; their f32 modes keep their own
// CUDA-core bodies (f32 operands, TF32 would lose the 1e-4 the parity
// checks hold them to).
//
// For each 64-key tile (keys s0 + 64 kt ..):
//
//   logits[t, s] = (q_t . k_s + q_t . E[ebase + 64 kt + 63 - tl + sl]) * scale
//                  + causal(s > t) * -1e9 + pad[s] * -1e9   (-inf past the block)
//   m' = max(m, rowmax), l' = l e^(m - m') + sum e^(logits - m'),
//   o' = o e^(m - m') + e^(logits - m') V
//
// with tl, sl the row and key inside the tile and E rows outside
// [0, max_seq) read as zero (the TPU kernel's slack; for kernel G also
// srel's zero for s > t).
//
// Design. One block of 4 warps (128 threads) owns 64 query rows, 16 a
// warp, and runs every product as mma.sync.m16n8k16 (bf16 x bf16 -> f32)
// with operands from ldmatrix. The JAX kernel puts K and the E band into
// one matrix-unit dot (pallas_attention.py:200-206); here they are two
// mma sequences on the same Q fragments, which stay in registers for the
// whole block.
// * q.k: 8 n8-tiles x 4 k16-steps a warp into S (32 f32 registers).
// * The relative term without the TPU's shear: a warp's rows tl read band
//   rows 63 - tl + sl, a window of 79 rows starting at 48 - 16 warp, so
//   Gq = Q . E_window^T is 10 n8-tiles, not 16. The warp writes its
//   [16 x 80] f32 Gq to a private slab and reads it back skewed,
//   srel[r, sl] = slab[r, 15 - r + sl] (r the row inside the warp), into
//   the S fragment positions. The slab's row stride (88 floats) puts the 8
//   rows of one fragment on distinct banks.
// * Masks and the online softmax in f32 on the S fragments, the row max
//   and sum reduced over the 4 lanes of an mma row by __shfl_xor_sync.
//   The causal mask is added only on tiles that cross the diagonal and
//   the key mask only where a key is padded or past the block (both are
//   the same for the whole block), and e^x is 2^(x log2 e) on the SFU
//   (ex2.approx, ~2^-22 relative): together ~10 % of the time of A and G
//   against an accurate expf and masks on every tile.
// * P.V: the S accumulators, rounded to bf16, are the A fragments of P.V
//   in registers; V comes through ldmatrix.trans.
// * K and V tiles are bf16 in shared memory, XOR-swizzled by 16-byte
//   chunk, loaded with cp.async into two buffers, so the next key tile's
//   loads are in flight during this tile's products.
// * The E band slides by 64 rows from one key tile to the next, so a ring
//   of three 64-row slots holds it and each key tile stages only the 64
//   new rows: their f32 loads are issued before the tile's products and
//   converted to bf16 (kernel A: the JAX wrapper's e.astype(q.dtype)) or
//   to a hi/lo bf16 pair (kernel G) after them.
// Shared memory: K and V 2 x 2 x 8 KB, E 3 x 8 KB (G: hi and lo, 6 x 8
// KB), the four Gq slabs 22 KB (Q passes through them before the loop):
// 78 KB for A, 102 KB for G, two blocks an SM.
//
// Why mma.sync and not wgmma: at kernel A's prefill shape the bound is
// bytes (~2.6 us) with the tensor-core time (~1.6 us) behind it, a block
// walks at most 8 key tiles at L 512, and the skewed relative term needs
// the S accumulators in a known per-thread layout; m16n8k16's layout is
// documented and fixed, and its issue rate is not what sets the pace here.
//
// Kernel G's split products (kSplit). The ring kernel keeps E and P in
// f32. q, k and v are bf16, so q.k is exact in f32 on the tensor cores;
// each f32 operand of the other two products is split into bf16 hi + lo
// and both halves multiplied into one f32 accumulator:
// q.E = q.E_hi + q.E_lo, P.V = P_hi.V + P_lo.V. The residual is ~2^-17 of
// each product (hi keeps 8 bits of the mantissa, lo the next 8).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mg {
namespace tc {

constexpr int DH = 64;                  // head dim
constexpr int BQ = 64;                  // query rows per block
constexpr int BK = 64;                  // keys per tile
constexpr int NT = 128;                 // 4 warps x 16 query rows
constexpr int TILE_BYTES = 64 * 64 * 2; // 64 rows of 64 bf16, 128 B a row
constexpr int N_GQ = 10;                // n8-tiles of a warp's E window
constexpr int SLAB_LD = 88;             // f32 row stride of a Gq slab
constexpr int SLAB_BYTES = 16 * SLAB_LD * 4;
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offsets in dynamic shared memory. kSplit keeps hi slots 0-2 and lo
// slots 3-5 of the E ring.
template <bool kSplit>
struct Smem {
  static constexpr int E_SLOTS = kSplit ? 6 : 3;
  static constexpr int K = 0;                          // 2 buffers
  static constexpr int V = 2 * TILE_BYTES;             // 2 buffers
  static constexpr int E = 4 * TILE_BYTES;             // the E ring
  static constexpr int SLAB = E + E_SLOTS * TILE_BYTES;  // Q, then Gq slabs
  static constexpr int BYTES = SLAB + 4 * SLAB_BYTES;
};

// Where one query tile and its key block live. Pointers are to row 0
// with the head offset applied; rows of q, k and v are `ld` elements
// apart.
struct TileArgs {
  const __nv_bfloat16* q;  // the tile's query row 0
  const __nv_bfloat16* k;  // the block's key row 0
  const __nv_bfloat16* v;
  int ld;
  int nq;                  // real query rows of the tile (1..64)
  int nkeys;               // keys of the block; keys past it get -inf
  const float* pad;        // [nkeys] 1.0 = padded key, or null
  const float* e;          // [max_seq, 64] f32
  int max_seq;
  int ebase;               // E row of band row 0 of key tile 0
  int t0;                  // global row of query row 0
  int s0;                  // global key of the block's key 0
  int causal;
  float scale;
};

// The online-softmax carry of a thread: rows g and g + 8 of its warp's 16
// (g = lane / 4), columns 8 j + 2 (lane % 4) + {0, 1} of o.
struct Carry {
  float o[8][4];
  float m[2];
  float l[2];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a 64 x 64 bf16 tile.
// The XOR puts the same chunk of 8 consecutive rows on 8 different bank
// groups, so ldmatrix and the staging stores are conflict-free.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// 16 bytes global -> shared, asynchronous; zero-filled when !in (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A read-only f32x4 load, kept where it is written so that it is in
// flight during the products that follow it.
__device__ __forceinline__ float4 ldg4(const float* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

// 2^x on the SFU (ex2.approx.ftz: ~2^-22 relative, results below 2^-126
// flush to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to bf16 (nearest even), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}
// x0 and x1 as hi + lo bf16 pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// 64 E rows e[row0 ..] as f32 in registers, 8 float4 a thread (16
// threads a row); rows outside [0, max_seq) are zero.
struct EStage {
  float4 x[8];
};
__device__ __forceinline__ void e_load(EStage& st, const float* e,
                                       int max_seq, int row0) {
  const int c4 = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int er = row0 + (threadIdx.x >> 4) + 8 * i;
    st.x[i] = (er >= 0 && er < max_seq)
                  ? ldg4(e + (size_t)er * DH + 4 * c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
// ... converted into ring slot `slot` (kSplit: hi and lo).
template <bool kSplit>
__device__ __forceinline__ void e_store(const EStage& st, char* smem,
                                        int slot) {
  char* hi = smem + Smem<kSplit>::E + slot * TILE_BYTES;
  char* lo = hi + 3 * TILE_BYTES;
  const int c4 = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (threadIdx.x >> 4) + 8 * i;
    const int off = swz(r, c4 >> 1) + (c4 & 1) * 8;
    const float4 v = st.x[i];
    if (kSplit) {
      uint2 h, l;
      split_bf16(v.x, v.y, h.x, l.x);
      split_bf16(v.z, v.w, h.y, l.y);
      *reinterpret_cast<uint2*>(hi + off) = h;
      *reinterpret_cast<uint2*>(lo + off) = l;
    } else {
      *reinterpret_cast<uint2*>(hi + off) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
}

// Rows row0 .. row0 + 63 of 64 bf16 from `src` (rows `ld` apart; rows
// outside [0, n) zero) into a swizzled tile at `dst`, asynchronously: 4
// chunks of 16 B a thread.
__device__ __forceinline__ void tile_load(char* dst,
                                          const __nv_bfloat16* src, int ld,
                                          int row0, int n) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + NT * i, r = idx >> 3, ch = idx & 7;
    const bool in = row0 + r >= 0 && row0 + r < n;
    cp_async16(smem_u32(dst + swz(r, ch)),
               src + (size_t)(in ? row0 + r : 0) * ld + ch * 8, in);
  }
}

// A fragments of rows row0 .. row0 + 15 of a swizzled 64 x 64 tile, one
// per k16 step of its 64 columns.
__device__ __forceinline__ void a_frags(uint32_t (&f)[4][4], const char* tile,
                                        int row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(f[kk], smem_u32(tile + swz(row0 + (lane & 7)
                                           + 8 * ((lane >> 3) & 1),
                                       2 * kk + (lane >> 4))));
}

// acc[j] = A . tile[8j + n, :]^T over the 64 columns, A given as a_frags
// gives it: rows of the stored tile are the n index (q.k's B operand, K
// as stored). One ldmatrix.x4 gives two k16 steps.
__device__ __forceinline__ void mma_nt(float (&acc)[8][4],
                                       const uint32_t (&af)[4][4],
                                       const char* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk2 = 0; kk2 < 2; ++kk2) {
      uint32_t b[4];
      ldsm_x4(b, smem_u32(tile + swz(8 * j + (lane & 7),
                                     4 * kk2 + (lane >> 3))));
      mma(acc[j], af[2 * kk2], b[0], b[1]);
      mma(acc[j], af[2 * kk2 + 1], b[2], b[3]);
    }
  }
}

// The logits of one 64 x 64 tile for the warp's 16 query rows, in the S
// fragment layout (s[j][2h + b]: row g + 8h, key 8j + 2 t4 + b): q.k
// against the key tile at `kbuf`, the relative term from band rows 0-63 in
// the E ring slot at `e0` and 64-127 at `e1` (kSplit: their lo halves 3
// slots further on), the scale, then the causal mask where the tile
// crosses the diagonal and the key mask where a key is padded or past the
// block (keys kcol0 .. kcol0 + 63 of the block; -1e9 and -inf). `slab` is
// the warp's private Gq slab. Kernels A and G (tile_step) and kernel C's
// backward (csrc/relative_attention_bwd.cu) all take their logits from
// here, so C's p = e^(x - lse) starts from the very logits behind A's LSE.
template <bool kSplit>
__device__ __forceinline__ void tile_logits(const TileArgs& a, int kcol0,
                                            const char* kbuf, const char* e0,
                                            const char* e1, float* slab,
                                            const uint32_t (&qf)[4][4],
                                            float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // q.k: n8-tile j holds keys 8j..8j+7
  mma_nt(s, qf, kbuf);

  // Gq = Q . E^T over the warp's window of band rows wb .. wb + 79, to
  // the slab
  __syncwarp();  // this warp's reads of the previous tile's slab are done
  const int wb = 48 - 16 * warp;
#pragma unroll
  for (int jj = 0; jj < N_GQ; ++jj) {
    const int br = wb + 8 * jj;
    const char* ehi = (br >> 6) ? e1 : e0;
    const int row = (br & 63) + (lane & 7);
    float gq[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk2 = 0; kk2 < 2; ++kk2) {
      const int off = swz(row, 4 * kk2 + (lane >> 3));
      uint32_t b[4];
      ldsm_x4(b, smem_u32(ehi + off));
      mma(gq, qf[2 * kk2], b[0], b[1]);
      mma(gq, qf[2 * kk2 + 1], b[2], b[3]);
      if (kSplit) {
        ldsm_x4(b, smem_u32(ehi + 3 * TILE_BYTES + off));
        mma(gq, qf[2 * kk2], b[0], b[1]);
        mma(gq, qf[2 * kk2 + 1], b[2], b[3]);
      }
    }
    *reinterpret_cast<float2*>(slab + g * SLAB_LD + 8 * jj + 2 * t4) =
        make_float2(gq[0], gq[1]);
    *reinterpret_cast<float2*>(slab + (g + 8) * SLAB_LD + 8 * jj + 2 * t4) =
        make_float2(gq[2], gq[3]);
  }
  __syncwarp();
  // srel[r, sl] = Gq[r, 63 - (16 warp + r) + sl - wb] = slab[r, 15 - r + sl]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int r = g + 8 * h;
        s[j][2 * h + b] += slab[r * SLAB_LD + 15 - r + 8 * j + 2 * t4 + b];
      }

  // logits: scale, then the causal mask where the tile crosses the
  // diagonal, then the key mask where a key is padded or past the block
  // (-1e9 and -inf); both conditions are the same for the whole block
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] *= a.scale;
  if (a.causal && a.s0 + kcol0 + BK - 1 > a.t0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (a.s0 + kcol0 + 8 * j + 2 * t4 + (i & 1)
            > a.t0 + 16 * warp + g + 8 * (i >> 1))
          s[j][i] += NEG_INF;
  }
  if (a.pad || kcol0 + BK > a.nkeys) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int kl = kcol0 + 8 * j + 2 * t4 + b;
        const float add = kl < a.nkeys
                              ? (a.pad ? a.pad[kl] * NEG_INF : 0.f)
                              : -INFINITY;
        s[j][b] += add;
        s[j][2 + b] += add;
      }
  }
}

// Key tile kt of the block (buffer kt & 1): the logits, the online-softmax
// update and P.V into the carry.
template <bool kSplit>
__device__ __forceinline__ void tile_step(const TileArgs& a, int kt,
                                          char* smem,
                                          const uint32_t (&qf)[4][4],
                                          Carry& c) {
  using S = Smem<kSplit>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const char* vbuf = smem + S::V + (kt & 1) * TILE_BYTES;
  float s[8][4];
  tile_logits<kSplit>(a, kt * BK, smem + S::K + (kt & 1) * TILE_BYTES,
                      smem + S::E + (kt % 3) * TILE_BYTES,
                      smem + S::E + ((kt + 1) % 3) * TILE_BYTES,
                      reinterpret_cast<float*>(smem + S::SLAB
                                               + warp * SLAB_BYTES),
                      qf, s);
  // online softmax in f32, row by row (g, then g + 8); e^x as
  // 2^(x log2 e) on the SFU
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(c.m[h], mx);
    // differences before the scale, so that e^0 is exactly 1 also on a
    // fully masked row (m near -1e9), as expf would give
    const float alpha = exp2_approx((c.m[h] - m_new) * LOG2E);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float p = exp2_approx((s[j][2 * h + b] - m_new) * LOG2E);
        s[j][2 * h + b] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    c.l[h] = c.l[h] * alpha + rs;
    c.m[h] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c.o[j][2 * h] *= alpha;
      c.o[j][2 * h + 1] *= alpha;
    }
  }

  // P.V: keys 16kk.. are S tiles 2kk and 2kk + 1, already in the A
  // fragment's layout; one ldmatrix.x4.trans gives two n8-tiles of V
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ph[4], pl[4];
    if (kSplit) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
    } else {  // kernel A's P rounding to the V dtype
      ph[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      ph[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      ph[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ph[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4_t(b, smem_u32(vbuf + swz(16 * kk + (lane & 7)
                                           + 8 * ((lane >> 3) & 1),
                                       2 * jp + (lane >> 4))));
      mma(c.o[2 * jp], ph, b[0], b[1]);
      mma(c.o[2 * jp + 1], ph, b[2], b[3]);
      if (kSplit) {
        mma(c.o[2 * jp], pl, b[0], b[1]);
        mma(c.o[2 * jp + 1], pl, b[2], b[3]);
      }
    }
  }
}

// The extended walk's vote, on every thread of the block: true when a
// real query row of the tile (row < nq) has met no unmasked key yet, its
// running max still at the -1e9 floor (a real logit is far above -1e9 / 2;
// a masked one is -1e9 + x, which rounds to -1e9 for |x| < 32). Such a
// row's plain result averages V over every key whose logit carries a
// single -1e9, including the keys after it, so the causal skip is not
// exact for it: the block then walks the remaining key tiles too. For
// every other row those tiles add e^(-1e9 + x - m) = 0 with alpha =
// e^0 = 1, so their bits do not change.
__device__ __forceinline__ bool unmet_rows(const Carry& c, int nq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool unmet = false;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    unmet |= 16 * warp + (lane >> 2) + 8 * h < nq && c.m[h] < 0.5f * NEG_INF;
  return __syncthreads_or(unmet) != 0;
}

// The block's walk over key tiles 0 .. n_kv - 1 of its key block, the
// carry `c` in registers (every thread of the block calls it with the same
// n_kv and n_ext). After tile n_kv - 1, if a row has met no unmasked key
// (`unmet_rows`), it goes on through tiles n_kv .. n_ext - 1 (the extended
// walk), staging the key tile and E chunk that the last tile did not
// prefetch. `smem` holds Smem<kSplit>::BYTES.
template <bool kSplit>
__device__ __forceinline__ void attend(const TileArgs& a, int n_kv,
                                       int n_ext, char* smem, Carry& c) {
  using S = Smem<kSplit>;
  if (n_kv <= 0) return;
  const int warp = threadIdx.x >> 5;

  // Q and key tile 0 in flight while E chunks 0 and 1 are staged
  tile_load(smem + S::SLAB, a.q, a.ld, 0, a.nq);
  tile_load(smem + S::K, a.k, a.ld, 0, a.nkeys);
  tile_load(smem + S::V, a.v, a.ld, 0, a.nkeys);
  cp_async_commit();
  EStage st;
  e_load(st, a.e, a.max_seq, a.ebase);
  e_store<kSplit>(st, smem, 0);
  e_load(st, a.e, a.max_seq, a.ebase + BK);
  e_store<kSplit>(st, smem, 1);
  cp_async_wait_all();
  __syncthreads();
  // the warp's 16 query rows as A fragments, one per k16-step
  uint32_t qf[4][4];
  a_frags(qf, smem + S::SLAB, 16 * warp);
  __syncthreads();  // Q's area becomes the slabs

  int n_end = n_kv;
  for (int kt = 0; kt < n_end; ++kt) {
    const bool more = kt + 1 < n_end;
    if (more) {  // key tile kt + 1 and E chunk kt + 2, during this tile
      tile_load(smem + S::K + ((kt + 1) & 1) * TILE_BYTES, a.k, a.ld,
                (kt + 1) * BK, a.nkeys);
      tile_load(smem + S::V + ((kt + 1) & 1) * TILE_BYTES, a.v, a.ld,
                (kt + 1) * BK, a.nkeys);
      cp_async_commit();
      e_load(st, a.e, a.max_seq, a.ebase + (kt + 2) * BK);
    }
    tile_step<kSplit>(a, kt, smem, qf, c);
    if (more) {
      // slot (kt + 2) % 3 last held chunk kt - 1, which no warp reads
      // after the barrier that ended tile kt - 1
      e_store<kSplit>(st, smem, (kt + 2) % 3);
      cp_async_wait_all();
    }
    __syncthreads();
    if (kt + 1 == n_end && n_end < n_ext && unmet_rows(c, a.nq)) {
      n_end = n_ext;  // the extended walk: stage what tile kt skipped
      tile_load(smem + S::K + ((kt + 1) & 1) * TILE_BYTES, a.k, a.ld,
                (kt + 1) * BK, a.nkeys);
      tile_load(smem + S::V + ((kt + 1) & 1) * TILE_BYTES, a.v, a.ld,
                (kt + 1) * BK, a.nkeys);
      cp_async_commit();
      e_load(st, a.e, a.max_seq, a.ebase + (kt + 2) * BK);
      e_store<kSplit>(st, smem, (kt + 2) % 3);
      cp_async_wait_all();
      __syncthreads();
    }
  }
}

}  // namespace tc
}  // namespace mg
