// Kernels B and E in bf16 on Hopper's tensor cores: the three launches of
// one layer of the decode step (B, C = 1) and of the chunk-verify forward
// (E, C rows per batch row), over R = B * C rows. csrc/fused_decode.cu
// describes what they compute and runs them from launch_layers; its f32
// mode, and the bf16 body before this design (kept to be timed beside
// it), stay on the CUDA cores there.
//
// 1. qkv_tc_kernel: x W{q,k,v} + b. One block per (16 output columns of
//    the three matrices, 16 rows): 3d / 16 blocks a 16-row tile, so the
//    weights are read once by 48-192 blocks. K and V rows go into the
//    caches at row t + c, in place.
// 2. attn_tc_kernel: one block per (b*h, 128-row split of the cache), the
//    split's K and V rows staged once with cp.async and the C queries run
//    as the M rows of mma.sync.m16n8k16, 16 at a time (C = 1 is one row of
//    a 16-row tile). Each of the 4 warps takes 32 of the 128 keys. q.k and
//    P.V run on the tensor cores: q is bf16-exact (rounded in qkv), K and
//    V are bf16 and P is rounded to bf16 before PV, so both products are
//    exact bf16 products with f32 accumulation. E stays f32 (the TPU
//    kernel's numerics), so q.E runs on the CUDA cores, four f32 FMA
//    chains per (query, key) over the staged E window: window row w =
//    (nreal - 1 - r) + j holds E[max_seq - 1 - (t + c) + c0 + j] for the
//    tile's query r (c = c_base + r) and split key j, the skewed read of
//    rel_attn_tile.cuh. The split's rows outside [start[b], t + C) are
//    staged as zeros, not read: below t + C lie the live prefix and the
//    chunk's own rows, above it stale or unwritten rows that may hold
//    NaN, and 0 * NaN would be NaN even under a zero P. Each query writes
//    the (m, l, acc[64]) record of the split; a split with no key live
//    for it writes the empty record (m = -inf, l = 0, acc = 0).
// 3. tail_tc_kernel: one thread-block cluster of nc CTAs per 16 rows (8,
//    or 16 at d 640, 768, 896 and 1024: `tail_nc`). Each CTA owns d / nc columns of W_fc and
//    W2 and about f / nc of W1, so each matrix is read once per 16 rows,
//    spread over nc SMs; it streams its three slices through one ring of
//    shared-memory slots (`Stream`: up to 16 chunks of 64 rows in flight
//    from the kernel's first instruction on, across the combine, the layer
//    norms and the cluster barriers) while the tensor cores run (R as M).
//    The qkv blocks stream theirs the same way. The layer norms need whole
//    rows: each CTA combines the split records of its own attention
//    columns and stores them, in bf16, into every CTA's full-row buffer
//    through distributed shared memory (cluster.map_shared_rank), 16
//    bytes a store; the same goes for out1 and the FFN hidden layer. For
//    the LN statistics each CTA sends every other one the mean and the
//    squared deviations of its columns, which each merges in rank order:
//    one cluster barrier a layer norm. A cluster rather than separate
//    launches keeps the step at three launches a layer.
// The three launches overlap (programmatic dependent launch, below): each
// kernel lets the next one start at once, and the next one stages what
// does not depend on its predecessor (the weights, the E window, the
// biases and LN parameters) before it waits for it. So the weights' fetch
// and most of the launch gaps hide behind the previous kernel.
// int8 weights (-127..127) are converted to bf16 in shared memory, which
// is exact, and each column's scale multiplies the finished dot
// (`scaled`), as the TPU kernel's dot-then-scale.
//
// Kernel E must equal C chained kernel-B steps bit for bit (the int8
// check holds it so). Every output's reduction order here depends on
// neither R nor the row's place in a 16-row tile: the products sum k16
// steps in one fixed order (warp w takes step w of each 64-deep chunk,
// the four warps' sums added 0, 1, 2, 3), q.E is four FMA chains, the row
// max is exact, the row sum adds each warp's keys in a fixed order and
// the warps in rank order, the tail's statistics add a CTA's columns by
// a fixed lane tree and merge the CTAs in rank order. The cluster size
// depends on d alone. A masked key adds exact +0.0 (p = 0
// against a finite V row). Split boundaries are the same for every R,
// and a chunk row's extra empty records weigh exp(-inf) = 0 in the
// combine.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "rel_attn_tile.cuh"

namespace mg {
namespace dtc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using tc::cp_async16;
using tc::ldsm_x4;
using tc::ldsm_x4_t;
using tc::mma;
using tc::pack_bf16;
using tc::smem_u32;

constexpr int DH = 64;       // head dim
constexpr int NT = 128;      // threads of every block: 4 warps
constexpr int MR = 16;       // rows of a product tile (one m16 tile)
constexpr int SPLIT = 128;   // cache rows per attention block
constexpr int PART = DH + 2; // split record: m, l, acc[64]
constexpr int KC = 64;       // weight rows per staged chunk
constexpr int NP = 64;       // output columns per product pass
constexpr int QKV_COLS = 16; // output columns per qkv block
constexpr int MAX_NC = 16;   // CTAs of a tail cluster: 8, or 16 past d 512
constexpr int EW_LD = DH + 1;  // f32 row stride of the E window
constexpr int QE_LD = SPLIT + 8;  // f32 row stride of q.E (8 mod 32 banks)

// Bytes of a product's cross-warp sums: [4 warps][MR][NP] f32.
constexpr int RED_BYTES = 4 * MR * NP * 4;
constexpr int MAX_SLOTS = 16;  // slots of a weight stream's ring

// Programmatic dependent launch (the three kernels are launched with
// cudaLaunchAttributeProgrammaticStreamSerialization): each lets the next
// kernel of the stream start at once, and the next one does its
// independent work (its weights, the E window) before it waits for the
// previous grid to complete and its writes to be visible. Without the
// attribute both are no-ops.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !in (src must
// still be a valid address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// cp.async.wait_group with a run-time count (at most 15 groups pending)
__device__ __forceinline__ void cp_async_wait(int n) {
#define MG_WAIT(k) \
  case k:          \
    asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); \
    break;
  switch (n) {
    MG_WAIT(0) MG_WAIT(1) MG_WAIT(2) MG_WAIT(3) MG_WAIT(4) MG_WAIT(5)
    MG_WAIT(6) MG_WAIT(7) MG_WAIT(8) MG_WAIT(9) MG_WAIT(10) MG_WAIT(11)
    MG_WAIT(12) MG_WAIT(13) MG_WAIT(14)
    default:
      asm volatile("cp.async.wait_group 15;\n" ::: "memory");
  }
#undef MG_WAIT
}

template <typename W>
__device__ __forceinline__ float scaled(float dot, const float* scale,
                                        int col) {
  if constexpr (std::is_same<W, int8_t>::value)
    return __fmul_rn(dot, scale[col]);
  return dot;
}

// Stage weight rows k0 .. k0 + KC - 1, columns col0 .. col0 + ncols - 1
// of W ([K][ldw]) into `dst` (rows `row_bytes` apart: bf16 for bf16
// weights, raw int8 for int8 ones); rows past K are zero, columns past
// ncols are left as they are (they only reach output columns that no one
// reads). 16-byte cp.async where every row segment is aligned, plain
// loads otherwise. A copy is one cp.async a thread per 16 bytes, and the
// copies an SM keeps in flight bound the stream (about 4 bytes a clock an
// SM on this card), so none is spent on unused columns.
template <typename W>
__device__ __forceinline__ void stage_chunk(char* dst, int row_bytes,
                                            const W* w, int K, int ldw,
                                            int k0, int col0, int ncols,
                                            int width) {
  constexpr int PER16 = 16 / sizeof(W);          // elements per 16 bytes
  if (ldw % PER16 == 0 && ncols % PER16 == 0 && col0 % PER16 == 0) {
    const int ch_row = ncols / PER16;            // 16-byte chunks a row
    for (int i = threadIdx.x; i < KC * ch_row; i += NT) {
      const int r = i / ch_row, ch = i % ch_row;
      const bool in = k0 + r < K;
      cp_async16(smem_u32(dst + r * row_bytes + ch * 16),
                 w + (in ? (size_t)(k0 + r) * ldw + col0 + ch * PER16 : 0),
                 in);
    }
  } else {
    for (int i = threadIdx.x; i < KC * width; i += NT) {
      const int r = i / width, n = i % width;
      const W v = (k0 + r < K && n < ncols)
                      ? w[(size_t)(k0 + r) * ldw + col0 + n] : W();
      reinterpret_cast<W*>(dst + r * row_bytes)[n] = v;
    }
  }
}

// One CTA's column slice of a weight matrix: columns col0 .. col0 + ncols
// - 1 of w ([K][ldw]), taken in passes of NP columns, each pass in chunks
// of KC rows.
struct Slice {
  const void* w;
  int ldw, K, col0, ncols;
  __host__ __device__ int passes() const {
    return ncols > 0 ? (ncols + NP - 1) / NP : 0;
  }
  __host__ __device__ int chunks() const {
    return passes() * ((K + KC - 1) / KC);
  }
};

// The weight stream of a block: the chunks of up to three slices, in the
// order its products consume them, through a ring of `ns` shared-memory
// slots (slot i % ns holds chunk i). The first ns chunks are issued at
// once (`start`), and each consumed chunk's slot is refilled with chunk
// i + ns, so a block keeps ns chunks in flight across its products, the
// layer norms and the cluster barriers between them. One cp.async group
// is committed per chunk (empty past the last), so chunk i is complete
// after cp.async.wait_group(ns - 1) once i chunks were consumed; when the
// ring holds every chunk, a product waits once for all of its own. (One
// bulk copy, TMA, per weight row of 32-128 bytes was slower than cp.async
// here: PERF.md.) bf16 slots are [KC][width + 8] (row stride 16 bytes past a multiple of
// 32: conflict-free ldmatrix); int8 weights land raw in [KC][width] and
// are converted into the bf16 slot when consumed (-127..127 are exact).
template <typename W>
struct Stream {
  Slice s[3];
  int nslice, ns, width;
  int total;    // chunks of all slices (set by `start`)
  char* slots;  // ns x slot_bytes(width, W)
  __host__ __device__ static int slot_bytes(int width) {
    return KC * (width + 8) * 2
           + (std::is_same<W, int8_t>::value ? KC * width : 0);
  }
  __device__ char* slot(int i) const {
    return slots + (i % ns) * slot_bytes(width);
  }
  __device__ void issue(int i) const {  // chunk i into slot i % ns
    char* dst = slot(i);
    int sl = 0;
    while (sl < nslice && i >= s[sl].chunks()) i -= s[sl++].chunks();
    if (sl < nslice) {
      const Slice& x = s[sl];
      const int nk = (x.K + KC - 1) / KC, pass = i / nk, c = i % nk;
      const int np = min(NP, x.ncols - pass * NP);
      const W* w = static_cast<const W*>(x.w);
      if (std::is_same<W, int8_t>::value)
        stage_chunk<W>(dst + KC * (width + 8) * 2, width, w, x.K, x.ldw,
                       c * KC, x.col0 + pass * NP, np, width);
      else
        stage_chunk<W>(dst, (width + 8) * 2, w, x.K, x.ldw, c * KC,
                       x.col0 + pass * NP, np, width);
    }
    tc::cp_async_commit();
  }
  __device__ void start() {
    total = 0;
    for (int i = 0; i < nslice; ++i) total += s[i].chunks();
    for (int i = 0; i < ns; ++i) issue(i);
  }
};

// red[warp][r][n] (f32) = the warp's share of sum_k A[r][k] W[k][n] for
// the 16 rows of A (bf16 in shared memory, row stride lda elements,
// columns K .. roundup(K, KC) zero) and the n < ncols <= NP columns of the
// stream's next pass (chunks `next` ..): warp w takes k16 step w of every
// 64-deep chunk; `red_sum` adds the four warps in order. Every thread of
// the block calls it; it ends with a barrier.
template <typename W>
__device__ void product(const bf16* A, int lda, int K, int ncols,
                        const Stream<W>& st, int& next, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n16 = (ncols + 15) / 16;            // 16-column groups in use
  const int ld = st.width + 8;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nchunks = (K + KC - 1) / KC;
  // every chunk of the stream resident (ns >= total): one wait and one
  // barrier for the whole product, and no refills
  const bool resident = st.ns >= st.total;
  if (resident) {
    cp_async_wait(st.ns - (next + nchunks));
    __syncthreads();
  }
  for (int c = 0; c < nchunks; ++c, ++next) {
    if (!resident) {
      cp_async_wait(st.ns - 1);  // chunk `next` has landed
      __syncthreads();
    }
    bf16* buf = reinterpret_cast<bf16*>(st.slot(next));
    if constexpr (std::is_same<W, int8_t>::value) {
      const int8_t* src = reinterpret_cast<const int8_t*>(
          st.slot(next) + KC * ld * 2);
      for (int i = threadIdx.x; i < KC * st.width / 4; i += NT) {
        const char4 v = reinterpret_cast<const char4*>(src)[i];
        const int r = (4 * i) / st.width, n = (4 * i) % st.width;
        *reinterpret_cast<uint2*>(buf + r * ld + n) =
            make_uint2(pack_bf16((float)v.x, (float)v.y),
                       pack_bf16((float)v.z, (float)v.w));
      }
      __syncthreads();  // the chunk converted by every thread
    }
    // this warp's k16 step of the chunk
    uint32_t af[4];
    ldsm_x4(af, smem_u32(A + (lane & 15) * lda + c * KC + 16 * warp
                         + 8 * (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp < n16) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_u32(buf + (16 * warp + (lane & 7)
                                     + 8 * ((lane >> 3) & 1)) * ld
                              + 16 * jp + 8 * (lane >> 4)));
        mma(acc[2 * jp], af, b[0], b[1]);
        mma(acc[2 * jp + 1], af, b[2], b[3]);
      }
    }
    if (!resident) {
      __syncthreads();        // the slot is free: refill it
      st.issue(next + st.ns);
    }
  }
  float* rw = red + warp * MR * NP;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * n16) {
      *reinterpret_cast<float2*>(rw + g * NP + 8 * j + 2 * t4) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * NP + 8 * j + 2 * t4) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();
}

// The product's output (r, n): the four warps' sums in rank order.
__device__ __forceinline__ float red_sum(const float* red, int r, int n) {
  const int i = r * NP + n;
  return ((red[i] + red[MR * NP + i]) + red[2 * MR * NP + i])
         + red[3 * MR * NP + i];
}

// A stream's slot width: the widest pass of its slices, a multiple of 16.
__host__ __device__ inline int stream_width(int ncols_max) {
  return min(NP, (ncols_max + 15) / 16 * 16);
}

// ------------------------------------------------------------------ qkv

// Each qkv block streams its d x QKV_COLS slice: every chunk in flight.
__host__ __device__ inline int qkv_slots(int d) {
  return min(MAX_SLOTS, (d + KC - 1) / KC);
}
// shared memory of a qkv block: A, red, the bias and scales, the weight
// slots
template <typename W>
__host__ __device__ inline int qkv_smem(int d) {
  return MR * (d + 8) * 2 + RED_BYTES + 2 * QKV_COLS * 4
         + qkv_slots(d) * Stream<W>::slot_bytes(stream_width(QKV_COLS));
}

// grid (3d / QKV_COLS, ceil(R / 16)); x: [R, d] f32, bf16-exact (the
// layer input is rounded to the model dtype); row (b, c) is position t + c
// of batch row b.
template <typename W>
__global__ void __launch_bounds__(NT)
qkv_tc_kernel(const float* __restrict__ x, const W* __restrict__ wq,
              const bf16* __restrict__ bq, const W* __restrict__ wk,
              const bf16* __restrict__ bk, const W* __restrict__ wv,
              const bf16* __restrict__ bv, const float* __restrict__ sq,
              const float* __restrict__ sk, const float* __restrict__ sv,
              float* __restrict__ qout, bf16* __restrict__ kc,
              bf16* __restrict__ vc, int R, int C, int S, int d, int t) {
  extern __shared__ __align__(128) char smem[];
  const int lda = d + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + MR * lda * 2);
  const int col = blockIdx.x * QKV_COLS;  // in [0, 3d); one matrix a block
  const int which = col / d, o0 = col % d;
  Stream<W> st;
  st.s[0] = Slice{which == 0 ? wq : (which == 1 ? wk : wv), d, d, o0,
                  QKV_COLS};
  st.nslice = 1;
  st.ns = qkv_slots(d);
  st.width = stream_width(QKV_COLS);
  st.slots = smem + MR * lda * 2 + RED_BYTES + 2 * QKV_COLS * 4;
  let_next_start();
  st.start();  // the weights first: they come from device memory
  // the block's columns of the bias (and scales), in f32
  float* vb = red + 4 * MR * NP;  // [QKV_COLS] bias, [QKV_COLS] scales
  const bf16* bias = which == 0 ? bq : (which == 1 ? bk : bv);
  const float* sc = which == 0 ? sq : (which == 1 ? sk : sv);
  if (threadIdx.x < QKV_COLS) {
    vb[threadIdx.x] = to_f(bias[o0 + threadIdx.x]);
    if (std::is_same<W, int8_t>::value)
      vb[QKV_COLS + threadIdx.x] = sc[o0 + threadIdx.x];
  }
  wait_previous();  // x is the previous layer's output

  const int r0 = blockIdx.y * MR, nr = min(MR, R - r0);
  // x rows in bf16 (exact), eight float2 loads in flight a thread
  for (int i0 = threadIdx.x; i0 < MR * d / 2; i0 += 8 * NT) {
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * NT, r = (2 * i) / d;
      v[u] = i < MR * d / 2 && r < nr
                 ? *reinterpret_cast<const float2*>(
                       x + (size_t)(r0 + r) * d + (2 * i) % d)
                 : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * NT;
      if (i < MR * d / 2)
        *reinterpret_cast<uint32_t*>(A + ((2 * i) / d) * lda + (2 * i) % d) =
            pack_bf16(v[u].x, v[u].y);
    }
  }
  int next = 0;
  product<W>(A, lda, d, QKV_COLS, st, next, red);
  for (int i = threadIdx.x; i < nr * QKV_COLS; i += NT) {
    const int r = i / QKV_COLS, n = i % QKV_COLS, o = o0 + n;
    const float y = round_to<bf16>(
        scaled<W>(red_sum(red, r, n), vb + QKV_COLS, n) + vb[n]);
    const int row = r0 + r, b = row / C, c = row % C;
    if (which == 0)
      qout[(size_t)row * d + o] = y;
    else
      (which == 1 ? kc : vc)[((size_t)b * S + t + c) * d + o] = from_f<bf16>(y);
  }
}

// ------------------------------------------------------------ attention

struct AttnSmem {
  static constexpr int K = 0;                               // 2 x 64-row tiles
  static constexpr int V = K + 2 * tc::TILE_BYTES;
  static constexpr int EW = V + 2 * tc::TILE_BYTES;         // E window f32
  static constexpr int Q =                                  // [16][64] f32
      EW + ((MR + SPLIT - 1) * EW_LD * 4 + 15) / 16 * 16;
  static constexpr int QE = Q + MR * DH * 4;                // [16][QE_LD] f32
  static constexpr int RED = QE + MR * QE_LD * 4;           // [4][16][64] f32
  static constexpr int RMAX = RED + 4 * MR * DH * 4;        // [4][16]
  static constexpr int RSUM = RMAX + 4 * MR * 4;            // [4][16]
  static constexpr int BYTES = RSUM + 4 * MR * 4;
};

// grid (B*H, nsplit); q: [R, d] f32 (rounded to bf16 by qkv); the
// split of blockIdx.y is split0 + blockIdx.y; part: [R*H, nsplit, 66].
__global__ void __launch_bounds__(NT, 2)
attn_tc_kernel(const float* __restrict__ q, const bf16* __restrict__ kc,
               const bf16* __restrict__ vc, const float* __restrict__ e,
               const int* __restrict__ start, float* __restrict__ part,
               int H, int C, int S, int d, int t, int max_seq, int split0,
               float scale) {
  extern __shared__ __align__(128) char smem[];
  using SM = AttnSmem;
  float* ew = reinterpret_cast<float*>(smem + SM::EW);
  float* qs = reinterpret_cast<float*>(smem + SM::Q);
  float* qe = reinterpret_cast<float*>(smem + SM::QE);
  float* red = reinterpret_cast<float*>(smem + SM::RED);
  float* rmax = reinterpret_cast<float*>(smem + SM::RMAX);
  float* rsum = reinterpret_cast<float*>(smem + SM::RSUM);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = (split0 + blockIdx.y) * SPLIT;
  const int n_all = min(SPLIT, t + C - c0);  // split rows below t + C
  // rows below start[b] are masked (ragged serving)
  const int lo = start != nullptr ? max(start[b] - c0, 0) : 0;

  let_next_start();
  // the first queries' E window: row w holds E[ebase + w]; query r, key j
  // read w = nreal - 1 - r + j. Rows past the table meet only masked keys.
  auto stage_e = [&](int cb, int nreal) {
    const int ebase = max_seq - (t + cb + nreal) + c0;
    for (int i = threadIdx.x; i < (SPLIT + nreal - 1) * DH; i += NT) {
      const int w = i / DH, row = ebase + w;
      const bool in = row < max_seq;
      cp_async4(smem_u32(ew + w * EW_LD + i % DH),
                e + (in ? (size_t)row * DH + i % DH : 0), in);
    }
  };
  stage_e(0, min(MR, C));
  wait_previous();  // q, K and V come from the qkv launch
  // the split's K and V rows [lo, n_all), zeros elsewhere, in flight
  // while the first queries and E window are staged
  for (int i = threadIdx.x; i < SPLIT * 8; i += NT) {
    const int r = i >> 3, ch = i & 7;
    const bool in = r >= lo && r < n_all;
    const size_t off = in ? ((size_t)b * S + c0 + r) * d + h * DH + ch * 8 : 0;
    const int dst = (r >> 6) * tc::TILE_BYTES + tc::swz(r & 63, ch);
    cp_async16(smem_u32(smem + SM::K + dst), kc + off, in);
    cp_async16(smem_u32(smem + SM::V + dst), vc + off, in);
  }
  tc::cp_async_commit();

  const char* ktile = smem + SM::K + (warp >> 1) * tc::TILE_BYTES;
  const char* vtile = smem + SM::V + (warp >> 1) * tc::TILE_BYTES;
  const int kw = 32 * (warp & 1);  // the warp's first row in its tile
  for (int cb = 0; cb < C; cb += MR) {
    const int nreal = min(MR, C - cb);
    // queries cb .. cb + nreal - 1 (rows past nreal zero) and their E
    // window, all asynchronous, so that the loads are in flight together
    if (cb > 0) stage_e(cb, nreal);
    for (int i = threadIdx.x; i < MR * DH; i += NT) {
      const int r = i / DH;
      const bool in = r < nreal;
      cp_async4(smem_u32(qs + i),
                q + (in ? (size_t)(b * C + cb + r) * d + h * DH + i % DH : 0),
                in);
    }
    tc::cp_async_commit();
    tc::cp_async_wait_all();
    __syncthreads();

    // q.E on the CUDA cores: thread j's key for each query, four FMA
    // chains (dims i = 4 k + 0..3) added (0 + 1) + (2 + 3)
    {
      const int j = threadIdx.x;  // NT == SPLIT
      for (int r = 0; r < nreal; ++r) {
        if (j >= lo && j < n_all && c0 + j <= t + cb + r) {
          const float* qr = qs + r * DH;
          const float* er = ew + (nreal - 1 - r + j) * EW_LD;
          float a4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < DH; i += 4)
#pragma unroll
            for (int k = 0; k < 4; ++k) a4[k] = fmaf(qr[i + k], er[i + k], a4[k]);
          qe[r * QE_LD + j] = (a4[0] + a4[1]) + (a4[2] + a4[3]);
        }
      }
    }

    // q.k on the tensor cores: the warp's 32 keys, 4 n8-tiles
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * t4;
      af[kk][0] = pack_bf16(qs[g * DH + c], qs[g * DH + c + 1]);
      af[kk][1] = pack_bf16(qs[(g + 8) * DH + c], qs[(g + 8) * DH + c + 1]);
      af[kk][2] = pack_bf16(qs[g * DH + c + 8], qs[g * DH + c + 9]);
      af[kk][3] = pack_bf16(qs[(g + 8) * DH + c + 8],
                            qs[(g + 8) * DH + c + 9]);
    }
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
        uint32_t bb[4];
        ldsm_x4(bb, smem_u32(ktile + tc::swz(kw + 8 * j + (lane & 7),
                                             4 * kk2 + (lane >> 3))));
        mma(s[j], af[2 * kk2], bb[0], bb[1]);
        mma(s[j], af[2 * kk2 + 1], bb[2], bb[3]);
      }
    }
    __syncthreads();  // q.E is in qe

    // logits, -inf where masked; the row max over the block
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i >> 1), kl = 32 * warp + 8 * j + 2 * t4 + (i & 1);
        const bool live = r < nreal && kl >= lo && kl < n_all
                          && c0 + kl <= t + cb + r;
        s[j][i] = live ? (s[j][i] + qe[r * QE_LD + kl]) * scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      if (t4 == 0) rmax[warp * MR + g + 8 * hh] = mx[hh];
    }
    __syncthreads();
    float m[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      m[hh] = fmaxf(fmaxf(rmax[r], rmax[MR + r]),
                    fmaxf(rmax[2 * MR + r], rmax[3 * MR + r]));
    }
    // p = e^(x - m), 0 where masked (a wholly masked row has m = -inf);
    // l sums the unrounded p, PV takes p rounded to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[j][i];
        const float p = x != -INFINITY ? expf(x - m[i >> 1]) : 0.f;
        s[j][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      if (t4 == 0) rsum[warp * MR + g + 8 * hh] = rs[hh];
    }

    // P.V on the tensor cores: the warp's 32 keys are 2 k16 steps
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ph[4];
      ph[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      ph[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      ph[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      ph[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, smem_u32(vtile + tc::swz(kw + 16 * kk + (lane & 7)
                                                + 8 * ((lane >> 3) & 1),
                                            2 * jp + (lane >> 4))));
        mma(o[2 * jp], ph, bb[0], bb[1]);
        mma(o[2 * jp + 1], ph, bb[2], bb[3]);
      }
    }
    float* rw = red + warp * MR * DH;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(rw + g * DH + 8 * j + 2 * t4) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(rw + (g + 8) * DH + 8 * j + 2 * t4) =
          make_float2(o[j][2], o[j][3]);
    }
    __syncthreads();

    // the records: the warps' sums in rank order
    for (int i = threadIdx.x; i < nreal * (DH + 2); i += NT) {
      const int r = i / (DH + 2), k = i % (DH + 2);
      float* rec = part + ((size_t)((b * C + cb + r) * H + h) * gridDim.y
                           + blockIdx.y) * PART;
      float v;
      if (k == 0) {
        v = fmaxf(fmaxf(rmax[r], rmax[MR + r]),
                  fmaxf(rmax[2 * MR + r], rmax[3 * MR + r]));
      } else if (k == 1) {
        v = ((rsum[r] + rsum[MR + r]) + rsum[2 * MR + r]) + rsum[3 * MR + r];
      } else {
        const int c = r * DH + k - 2;
        v = ((red[c] + red[MR * DH + c]) + red[2 * MR * DH + c])
            + red[3 * MR * DH + c];
      }
      rec[k] = v;
    }
    __syncthreads();  // qs, ew, qe, red and the row arrays are free
  }
}

// ----------------------------------------------------------------- tail

// The tail's cluster: 8 CTAs, or 16 past d 512 where d / 16 is still a
// multiple of 8 (d 640, 768, 896, 1024), so that the widest models stream
// their weights through twice the SMs (16 needs the non-portable cluster
// size). A CTA's d / nc columns are a multiple of 8 (d is a multiple of
// 64): the rows go to every CTA 8 columns, 16 bytes, a store. So d / nc
// is at most 120 (d 960), and a CTA's columns span at most MAX_NH heads.
// Per-CTA column slices of the products: d / nc columns of W_fc and W2,
// and f split in slices of a multiple of 16 columns of W1.
__host__ __device__ inline int tail_nc(int d) {
  return d > 512 && d % (16 * 8) == 0 ? 16 : 8;
}
constexpr int MAX_NH = 3;
__host__ __device__ inline int f_slice(int f, int nc) {
  return ((f + nc - 1) / nc + 15) / 16 * 16;
}
__host__ __device__ inline int f_pad(int f) { return (f + KC - 1) / KC * KC; }
__host__ __device__ inline int tail_width(int d, int f, int nc) {
  return stream_width(max(d / nc, f_slice(f, nc)));
}
// Byte offsets of a tail CTA's shared memory; ns weight slots of
// `slot_bytes` at the end.
struct TailLayout {
  int abuf, hbuf, red, z, o1, xs, vec, stats, comb, slots, bytes;
  __host__ __device__ TailLayout(int d, int f, int nc, int ns,
                                 int slot_bytes) {
    const int dsl = d / nc;
    abuf = 0;                                      // bf16 [MR][d + 8]
    hbuf = abuf + MR * (d + 8) * 2;                // bf16 [MR][fpad + 8]
    red = (hbuf + MR * (f_pad(f) + 8) * 2 + 15) / 16 * 16;
    z = red + RED_BYTES;                           // f32 [MR][dsl]
    o1 = z + MR * dsl * 4;                         // f32 [MR][dsl]
    xs = o1 + MR * dsl * 4;                        // f32 [MR][dsl]
    vec = xs + MR * dsl * 4;                       // f32 [8][dsl] + [2][fsl]
    stats = vec + (8 * dsl + 2 * f_slice(f, nc)) * 4;  // f32 [4][nc][MR], [2][MR]
    comb = stats + (4 * nc * MR + 2 * MR) * 4;     // f32 [MR][MAX_NH][2]
    slots = (comb + MR * MAX_NH * 2 * 4 + 127) / 128 * 128;
    bytes = slots + ns * slot_bytes;
  }
};

// A CTA's columns of the tail's vectors, in f32: V_BFC .. V_S2 take dsl
// floats each, V_B1 and V_S1 fsl each (the scales only for int8).
enum { V_BFC, V_LN1S, V_LN1B, V_B2, V_LN2S, V_LN2B, V_SFC, V_S2 };

// barrier.cluster in two halves: arrive early, wait where it matters
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Eight f32 as bf16 into row r, columns col .. col + 7 of `buf` (row
// stride ld) in every CTA of the cluster: one 16-byte store each.
__device__ __forceinline__ void store8_all(cg::cluster_group& cluster,
                                           bf16* buf, int ld, int r,
                                           int col, const float* v) {
  const uint4 u = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                             pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  for (int p = 0; p < (int)cluster.num_blocks(); ++p)
    *reinterpret_cast<uint4*>(cluster.map_shared_rank(buf, p) + r * ld
                              + col) = u;
}

// out1 or the layer output: LN over the row of z with the cluster's
// statistics, rounded to bf16; returned for the CTA's columns in `dst`
// (f32, [MR][dsl]); lns, lnb: the CTA's columns of the LN parameters.
// Each CTA takes the mean and the sum of squared deviations of its own
// columns (two passes, 8 lanes a row) and stores them into slot `rank` of
// `mom` ([2][nc][MR]) in every CTA; after one cluster barrier each CTA
// merges the nc pairs in rank order (Chan et al.'s pairwise update), so
// every row's statistics take one fixed order.
__device__ __forceinline__ void tail_ln(cg::cluster_group& cluster,
                                        const float* z, float* dst, int dsl,
                                        int d, const float* lns,
                                        const float* lnb, float eps,
                                        float* mom, float* mu, float* rstd,
                                        int rank) {
  // 8 lanes a row (MR * 8 == NT): lane l sums columns l, l + 8, ... in
  // order, then the lanes add by the tree xor 1, 2, 4
  static_assert(MR * 8 == NT, "8 lanes a row");
  const int nc = (int)cluster.num_blocks();
  const int r = threadIdx.x >> 3, l8 = threadIdx.x & 7;
  auto lanes = [](float v) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  };
  float s = 0.f;
  for (int c = l8; c < dsl; c += 8) s += z[r * dsl + c];
  const float m = lanes(s) / dsl;
  float m2 = 0.f;
  for (int c = l8; c < dsl; c += 8) {
    const float dv = z[r * dsl + c] - m;
    m2 = fmaf(dv, dv, m2);
  }
  m2 = lanes(m2);
  for (int p = l8; p < nc; p += 8) {  // lane l8: CTAs l8, l8 + 8
    float* peer = cluster.map_shared_rank(mom, p);
    peer[rank * MR + r] = m;
    peer[(nc + rank) * MR + r] = m2;
  }
  cluster.sync();
  if (threadIdx.x < MR) {
    const int rr = threadIdx.x;
    float mean = mom[rr], q = mom[nc * MR + rr];
    for (int p = 1; p < nc; ++p) {  // p CTAs of dsl columns, then one more
      const float w = 1.0f / (p + 1), k = (float)(p * dsl) * w;
      const float delta = mom[p * MR + rr] - mean;
      mean = fmaf(delta, w, mean);
      q = (q + mom[(nc + p) * MR + rr]) + delta * delta * k;
    }
    mu[rr] = mean;
    rstd[rr] = rsqrtf(q / d + eps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * dsl; i += NT) {
    const int rr = i / dsl, c = i % dsl;
    dst[i] = round_to<bf16>((z[i] - mu[rr]) * rstd[rr] * lns[c] + lnb[c]);
  }
  __syncthreads();
}

// One cluster of nc = tail_nc(d) CTAs per 16 rows: grid (nc, ceil(R /
// 16)). W as
// qkv_tc_kernel's; sfc, s1, s2: the column scales (int8 only); ns: the
// weight stream's slots (the launch sizes them to the shared memory).
template <typename W>
__global__ void __launch_bounds__(NT, 1)
tail_tc_kernel(const float* __restrict__ part, float* __restrict__ x,
               const W* __restrict__ wfc, const bf16* __restrict__ bfc,
               const bf16* __restrict__ ln1s, const bf16* __restrict__ ln1b,
               const W* __restrict__ w1, const bf16* __restrict__ b1,
               const W* __restrict__ w2, const bf16* __restrict__ b2,
               const bf16* __restrict__ ln2s, const bf16* __restrict__ ln2b,
               const float* __restrict__ sfc, const float* __restrict__ s1,
               const float* __restrict__ s2, int R, int H, int d, int f,
               int nsplit, int ns, float eps) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nc = (int)cluster.num_blocks();  // tail_nc(d)
  const int dsl = d / nc, dc0 = rank * dsl;
  const int fsl = f_slice(f, nc), fc0 = rank * fsl;
  const int fn = max(0, min(fsl, f - fc0));
  const int fp = f_pad(f), lda = d + 8, ldh = fp + 8;

  // the CTA's slices of W_fc, W1 and W2, ns chunks in flight from here on
  Stream<W> st;
  st.s[0] = Slice{wfc, d, d, dc0, dsl};
  st.s[1] = Slice{w1, f, d, fc0, fn};
  st.s[2] = Slice{w2, d, f, dc0, dsl};
  st.nslice = 3;
  st.ns = ns;
  st.width = tail_width(d, f, nc);
  const TailLayout L(d, f, nc, ns, Stream<W>::slot_bytes(st.width));
  st.slots = smem + L.slots;
  let_next_start();
  cluster_arrive_relaxed();  // this CTA has started (waited for below)
  st.start();

  bf16* abuf = reinterpret_cast<bf16*>(smem + L.abuf);
  bf16* hbuf = reinterpret_cast<bf16*>(smem + L.hbuf);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* z = reinterpret_cast<float*>(smem + L.z);
  float* o1 = reinterpret_cast<float*>(smem + L.o1);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* vec = reinterpret_cast<float*>(smem + L.vec);
  float* vb1 = vec + 8 * dsl;
  float* vs1 = vb1 + fsl;
  float* stats = reinterpret_cast<float*>(smem + L.stats);
  float* mu = stats + 4 * nc * MR;
  float* rstd = mu + MR;
  float* comb = reinterpret_cast<float*>(smem + L.comb);
  const int r0 = blockIdx.y * MR, nr = min(MR, R - r0);

  // before the previous kernel's results: the FFN input's pad columns
  // (zero) and the CTA's columns of the biases, LN parameters and scales
  for (int i = threadIdx.x; i < MR * (fp - f); i += NT)
    hbuf[(i / (fp - f)) * ldh + f + i % (fp - f)] = from_f<bf16>(0.f);
  for (int i = threadIdx.x; i < dsl; i += NT) {
    const int col = dc0 + i;
    vec[V_BFC * dsl + i] = to_f(bfc[col]);
    vec[V_LN1S * dsl + i] = to_f(ln1s[col]);
    vec[V_LN1B * dsl + i] = to_f(ln1b[col]);
    vec[V_B2 * dsl + i] = to_f(b2[col]);
    vec[V_LN2S * dsl + i] = to_f(ln2s[col]);
    vec[V_LN2B * dsl + i] = to_f(ln2b[col]);
    if (kInt8) {
      vec[V_SFC * dsl + i] = sfc[col];
      vec[V_S2 * dsl + i] = s2[col];
    }
  }
  for (int i = threadIdx.x; i < fn; i += NT) {
    vb1[i] = to_f(b1[fc0 + i]);
    if (kInt8) vs1[i] = s1[fc0 + i];
  }

  wait_previous();  // the split records, and x
  // combine the split records of this CTA's attention columns (an empty
  // split's m = -inf weighs exp(-inf) = 0): first each (row, head)'s max
  // M and sum L = sum l e^(m - M), while the other threads stage the
  // CTA's columns of x (the residual); then the columns, eight a thread,
  // each taking the weights e^(m - M) again (the same bits), so that any
  // number of splits fits
  const int h0 = dc0 / DH, nh = (dc0 + dsl - 1) / DH - h0 + 1;
  if (threadIdx.x < MR * nh) {
    const int r = threadIdx.x / nh, hh = threadIdx.x % nh;
    float* cr = comb + (r * MAX_NH + hh) * 2;
    if (r < nr) {
      const float* pp = part + (size_t)((r0 + r) * H + h0 + hh) * nsplit * PART;
      float M = -INFINITY;
      for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, pp[sp * PART]);
      float Lsum = 0.f;
      for (int sp = 0; sp < nsplit; ++sp)
        Lsum += pp[sp * PART + 1] * expf(pp[sp * PART] - M);
      cr[0] = M;
      cr[1] = Lsum;
    }
  } else {
    for (int i = threadIdx.x - MR * nh; i < MR * dsl; i += NT - MR * nh) {
      const int r = i / dsl;
      xs[i] = r < nr ? x[(size_t)(r0 + r) * d + dc0 + i % dsl] : 0.f;
    }
  }
  __syncthreads();
  cluster_wait();  // every CTA has started: their shared memory is ours
  const int d8 = dsl / 8;  // 8-column groups of the CTA's slice
  for (int i = threadIdx.x; i < MR * d8; i += NT) {
    const int r = i / d8, col = dc0 + 8 * (i % d8);
    float a[8] = {};
    if (r < nr) {
      const float* pp = part + (size_t)((r0 + r) * H + col / DH) * nsplit * PART;
      const float* cr = comb + (r * MAX_NH + col / DH - h0) * 2;
      const float M = cr[0];
      for (int sp = 0; sp < nsplit; ++sp) {
        const float wgt = expf(pp[sp * PART] - M);
        const float* acc = pp + sp * PART + 2 + col % DH;
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] += acc[k] * wgt;
      }
      const float lc = fmaxf(cr[1], 1e-30f);
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = a[k] / lc;
    }
    store8_all(cluster, abuf, lda, r, col, a);
  }
  cluster.sync();

  int next = 0;  // the stream's next chunk
  // fc, residual: z = bf16(attn W_fc + b_fc) + x over the CTA's columns
  for (int p0 = 0; p0 < dsl; p0 += NP) {
    const int np = min(NP, dsl - p0);  // the pass's columns
    product<W>(abuf, lda, d, np, st, next, red);
    for (int i = threadIdx.x; i < MR * np; i += NT) {
      const int r = i / np, cl = p0 + i % np;
      z[r * dsl + cl] =
          r < nr ? round_to<bf16>(scaled<W>(red_sum(red, r, i % np),
                                            vec + V_SFC * dsl, cl)
                                  + vec[V_BFC * dsl + cl])
                       + xs[r * dsl + cl]
                 : 0.f;
    }
  }
  __syncthreads();
  // out1 = LN1(z), into every CTA's full rows (the fc reads of abuf are
  // done: every CTA passed the statistics' cluster barrier)
  tail_ln(cluster, z, o1, dsl, d, vec + V_LN1S * dsl, vec + V_LN1B * dsl,
          eps, stats, mu, rstd, rank);
  for (int i = threadIdx.x; i < MR * d8; i += NT) {
    const int r = i / d8, c8 = 8 * (i % d8);
    store8_all(cluster, abuf, lda, r, dc0 + c8, o1 + r * dsl + c8);
  }
  cluster.sync();

  // FFN hidden layer: relu(bf16(out1 W1 + b1)) over the CTA's columns,
  // into every CTA's full rows
  for (int p0 = 0; p0 < fn; p0 += NP) {
    const int np = min(NP, fn - p0);
    product<W>(abuf, lda, d, np, st, next, red);
    auto hidden = [&](int r, int n) {
      return fmaxf(round_to<bf16>(scaled<W>(red_sum(red, r, n), vs1, p0 + n)
                                  + vb1[p0 + n]), 0.f);
    };
    if (np % 8 == 0) {
      for (int i = threadIdx.x; i < MR * np / 8; i += NT) {
        const int r = i / (np / 8), n8 = 8 * (i % (np / 8));
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = hidden(r, n8 + k);
        store8_all(cluster, hbuf, ldh, r, fc0 + p0 + n8, v);
      }
    } else {  // f not a multiple of 8: the last CTA's last pass
      for (int i = threadIdx.x; i < MR * np; i += NT) {
        const int r = i / np, n = i % np;
        const bf16 v = from_f<bf16>(hidden(r, n));
        for (int p = 0; p < nc; ++p)
          cluster.map_shared_rank(hbuf, p)[r * ldh + fc0 + p0 + n] = v;
      }
    }
  }
  cluster.sync();

  // FFN output, residual: z = out1 + bf16(h W2 + b2)
  for (int p0 = 0; p0 < dsl; p0 += NP) {
    const int np = min(NP, dsl - p0);
    product<W>(hbuf, ldh, f, np, st, next, red);
    for (int i = threadIdx.x; i < MR * np; i += NT) {
      const int r = i / np, cl = p0 + i % np;
      z[r * dsl + cl] =
          o1[r * dsl + cl]
          + round_to<bf16>(scaled<W>(red_sum(red, r, i % np),
                                     vec + V_S2 * dsl, cl)
                           + vec[V_B2 * dsl + cl]);
    }
  }
  __syncthreads();
  // the layer output = LN2(z), rounded to bf16, for the real rows
  tail_ln(cluster, z, o1, dsl, d, vec + V_LN2S * dsl, vec + V_LN2B * dsl,
          eps, stats + 2 * nc * MR, mu, rstd, rank);
  for (int i = threadIdx.x; i < nr * dsl; i += NT)
    x[(size_t)(r0 + i / dsl) * d + dc0 + i % dsl] = o1[i];
  tc::cp_async_wait_all();  // the stream's empty tail groups
}

// The tail's slots: as many as the shared memory takes past the rest, at
// most MAX_SLOTS and no more than CTA 0's chunks (the most of any CTA).
template <typename W>
inline int tail_slots(int d, int f) {
  const int nc = tail_nc(d);
  const int sb = Stream<W>::slot_bytes(tail_width(d, f, nc));
  const int rest = TailLayout(d, f, nc, 0, sb).bytes;
  const int fn0 = min(f_slice(f, nc), f);
  const int chunks = Slice{nullptr, d, d, 0, d / nc}.chunks()
                     + Slice{nullptr, f, d, 0, fn0}.chunks()
                     + Slice{nullptr, d, f, 0, d / nc}.chunks();
  return max(1, min(min(MAX_SLOTS, chunks), (232448 - rest) / sb));
}

}  // namespace dtc
}  // namespace mg
