// Kernels B, E and F: the decode step, the chunk-verify forward and the
// chunked decode loop (C whole sampling-and-decode steps per launch,
// described at its code below) through every layer of a MusicTransformer.
//
// Kernel B replaces musicgeneration_tpu/ops/pallas_decode.py::
// fused_decode_step (its pallas_calls over _kernel / _kernel_grid*, layer
// body _layer_step), its int8 `scales` mode included. Per layer, for each
// batch row b at absolute position t:
//
//   q, k, v = x W{q,k,v} + b            (rounded to the model dtype)
//   cache[b, t] = k, v                   (written IN PLACE, see below)
//   a_s = (q . k_s + q . E[max_seq - 1 - t + s]) / sqrt(64),
//         s in [start[b], t]             (start = 0 when not ragged)
//   attn = softmax(a) V                  (f32 softmax, P in the cache dtype)
//   out1 = LN1(attn W_fc + b_fc + x)     (eps 1e-6, f32 statistics)
//   x'   = LN2(out1 + relu(out1 W1 + b1) W2 + b2)
//
// with the TPU kernel's quantization points: projection outputs, attn,
// fc, out1, the FFN pre-activation and output, and the layer output are
// rounded to the model dtype; E stays f32; matmuls read model-dtype
// weights into f32 and accumulate in f32.
//
// Weight-only int8 (the TPU's stream mode with scales=, pallas_decode.py:
// 781-884): the six matrices W{q,k,v}, W_fc, W1 and W2 are int8 with one
// f32 scale per (layer, output column). Each product is the f32 dot of
// the activations with the int8 values, multiplied once by its column's
// scale after the dot and before the bias (_make_stream_mm :814-821);
// biases, LN and the caches stay in the model dtype. qkv_kernel and
// tail_kernel take the weight type W (T or int8_t) as a template
// argument, so the model-dtype instantiations are the programs they were;
// kernels B and E share them, so E's int8 mode still equals C chained
// int8 kernel-B steps bit for bit. The int8 loads are single bytes (32
// consecutive ones per warp). tail_kernel's products are latency-bound
// (one block per row, each thread's column dot a serial chain), so what
// sets their time is how many loads each thread keeps in flight, not the
// bytes: dot_column loads the int8 weights in groups before using them.
//
// Design for this card: three launches per layer on the current stream.
//  1. qkv_kernel: x W + b for q, k, v. Each block owns 32 output columns
//     of 8 rows; its 8 warps split the input dimension and reduce
//     through shared memory. k and v go straight into the cache — the
//     port updates the KV cache in place (the JAX kernel returned the
//     rows and the caller wrote them with dynamic_update_slice).
//  2. attn_kernel: split-K over the live prefix [0, t] — one block per
//     (b*h, 128 positions) — writing f32 partials (m, l, acc[64]).
//     Because row t is already in the cache, the current token is just
//     the last position of the prefix: the TPU kernel's analytic fold
//     (pallas_decode.py:325-341) by the same formula, E[max_seq - 1].
//     Ragged mode (continuous-batching serving; the TPU kernel's
//     start_col, pallas_decode.py:95-103, :237-240): row b masks the
//     cache rows below start[b], and the grid starts at the split of
//     start_min <= min(start) (the live-window floor), so the splits
//     wholly below it are never launched. A split wholly below start[b]
//     for one row writes the empty record (m = -inf, l = 0, acc = 0),
//     which the combine weighs by exp(-inf) = 0; row t is always live,
//     so every row has a finite maximum.
//  3. tail_kernel: one block per row combines the partials, then fc,
//     residual, LN1, FFN1, ReLU, FFN2, residual, LN2.
//
// What bounds it: at the flagship decode shape (6 layers, d 256, B 8,
// t ~ 768 of a 1024-row bf16 cache) the step must read ~38 MB of KV
// cache plus ~4 MB of weights and does ~50 MFLOP: bytes bound it, at
// ~13 us on an H100 SXM. Reading only the live prefix [0, t] (as the TPU
// kernel did) keeps the bytes at their minimum; split-K spreads the
// cache read over B*H*ceil((t+1)/128) blocks so it is not limited by
// B*H blocks. At this size the 18 launches per step cost more than the
// bytes; a CUDA graph or one persistent kernel is the next step.
//
// Kernel E replaces musicgeneration_tpu/ops/pallas_decode.py::
// fused_decode_chunk (pallas_calls at :1487 and :1568 over _kernel_chunk
// / _kernel_chunk_grid*, layer body _layer_chunk_step), its int8 `scales`
// mode included: the verify forward of speculative decoding. C tokens at positions
// t..t+C-1 of each batch row go through every layer at once; query c
// attends the rows [0, t+c] with the bias q . E[max_seq - 1 - (t+c) + s].
// It is C chained kernel-B steps computed together, with the same three
// launches per layer over R = B*C rows:
//  1. qkv_kernel over the R rows: row (b, c) writes its K/V into cache
//     row t+c of batch b, so the chunk's own keys are just the last rows
//     of the prefix (the TPU kernel's separate in-chunk causal pass and
//     its lane-roll band extraction have no counterpart here).
//  2. chunk_attn_kernel: one block per (b*h, 128-row split of [0, t+C)).
//     The block stages the split's V rows, the C queries and the E window
//     of 128 + C - 1 rows that covers every query's band in shared memory
//     and keeps each thread's K row in registers: the cache and E are read
//     once per chunk instead of once per query. It then runs kernel B's
//     split body for each query in turn (query c masks s > t+c), with
//     kernel B's reduction orders, and writes one (m, l, acc) record per
//     query; a split wholly above t+c writes the empty record. Kernel E
//     therefore gives the same bits as C kernel-B steps up to the row's
//     extra empty records, which the combine weighs by 0.
//  3. tail_kernel over the R rows.
// What bounds it: the same bytes as one decode step plus the chunk's
// rows (the weights and the prefix read once for C tokens), so on the
// bytes it costs about one kernel-B step; the C queries per block are
// a serial loop, the first thing to parallelise for speed. C runs from
// 2 to 128 (no power-of-two or sublane constraint on this card).
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int DH = 64;          // head dim
constexpr int QKV_COLS = 32;    // output columns per qkv block
constexpr int QKV_WARPS = 8;    // warps splitting the input dimension
constexpr int QKV_ROWS = 8;     // batch rows per qkv block
constexpr int ATT_CHUNK = 128;  // cache positions per attention block
constexpr int PART = DH + 2;    // partial record: m, l, acc[64]
constexpr int TAIL_THREADS = 256;
constexpr int MAX_CHUNK = 128;  // kernel E's largest C

// One output column's product, scaled where the weights are int8: the
// scale multiplies the finished f32 dot (never contracted into an FMA
// with the bias), as the TPU kernel's dot-then-scale.
template <typename W>
__device__ __forceinline__ float scaled(float dot, const float* scale,
                                        int col) {
  if constexpr (std::is_same<W, int8_t>::value)
    return __fmul_rn(dot, scale[col]);
  return dot;
}

// R = B*C rows of x; row (b, c) is position t + c of batch row b (C = 1
// for kernel B). W: the weights' type, T or int8_t (then sq, sk, sv are
// the [d] scales of the layer's columns; unused otherwise).
template <typename T, typename W>
__global__ void __launch_bounds__(QKV_WARPS * 32)
qkv_kernel(const float* __restrict__ x, const W* __restrict__ wq,
           const T* __restrict__ bq, const W* __restrict__ wk,
           const T* __restrict__ bk, const W* __restrict__ wv,
           const T* __restrict__ bv, const float* __restrict__ sq,
           const float* __restrict__ sk, const float* __restrict__ sv,
           float* __restrict__ qout, T* __restrict__ kc, T* __restrict__ vc,
           int R, int C, int S, int d, int t) {
  extern __shared__ float sm[];
  float* xs = sm;                    // [QKV_ROWS][d]
  float* red = sm + QKV_ROWS * d;    // [QKV_WARPS][QKV_ROWS][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * QKV_ROWS;
  const int nr = min(QKV_ROWS, R - r0);
  for (int i = threadIdx.x; i < QKV_ROWS * d; i += blockDim.x) {
    const int r = i / d;
    xs[i] = r < nr ? x[(size_t)(r0 + r) * d + i % d] : 0.f;
  }
  __syncthreads();

  const int col = blockIdx.x * QKV_COLS + lane;  // in [0, 3d)
  const int which = col / d, o = col % d;
  const W* wm = which == 0 ? wq : (which == 1 ? wk : wv);
  float acc[QKV_ROWS];
#pragma unroll
  for (int r = 0; r < QKV_ROWS; ++r) acc[r] = 0.f;
  const int per = d / QKV_WARPS;
  const int i0 = warp * per;
#pragma unroll 4
  for (int i = i0; i < i0 + per; ++i) {
    const float w = mg::to_f(wm[(size_t)i * d + o]);
#pragma unroll
    for (int r = 0; r < QKV_ROWS; ++r) acc[r] = fmaf(xs[r * d + i], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < QKV_ROWS; ++r)
    red[(warp * QKV_ROWS + r) * 32 + lane] = acc[r];
  __syncthreads();

  // thread (row = warp, column = lane) sums the warps' partials
  const int r = warp;
  if (r >= nr) return;
  float y = 0.f;
#pragma unroll
  for (int w = 0; w < QKV_WARPS; ++w) y += red[(w * QKV_ROWS + r) * 32 + lane];
  const T* bias = which == 0 ? bq : (which == 1 ? bk : bv);
  y = scaled<W>(y, which == 0 ? sq : (which == 1 ? sk : sv), o);
  y = mg::round_to<T>(y + mg::to_f(bias[o]));
  const int row = r0 + r, b = row / C, c = row % C;
  if (which == 0) {
    qout[(size_t)row * d + o] = y;
  } else {
    T* cache = which == 1 ? kc : vc;
    cache[((size_t)b * S + t + c) * d + o] = mg::from_f<T>(y);
  }
}

template <typename T>
__global__ void __launch_bounds__(ATT_CHUNK)
attn_kernel(const float* __restrict__ q, const T* __restrict__ kc,
            const T* __restrict__ vc, const float* __restrict__ e,
            const int* __restrict__ start, float* __restrict__ part, int H,
            int S, int d, int t, int max_seq, int split0, float scale) {
  __shared__ float qs[DH];
  __shared__ float ps[ATT_CHUNK];
  __shared__ float accs[2][DH];
  __shared__ float red[ATT_CHUNK / 32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = (split0 + blockIdx.y) * ATT_CHUNK;
  const int n = min(ATT_CHUNK, t + 1 - c0);
  // this block's first live position: rows below start[b] are masked
  const int lo = start != nullptr ? max(start[b] - c0, 0) : 0;
  if (threadIdx.x < DH) qs[threadIdx.x] = q[(size_t)b * d + h * DH + threadIdx.x];
  __syncthreads();

  float logit = -INFINITY;
  if ((int)threadIdx.x < n && (int)threadIdx.x >= lo) {
    const int s = c0 + threadIdx.x;
    const T* krow = kc + ((size_t)b * S + s) * d + h * DH;
    const float* erow = e + (size_t)(max_seq - 1 - t + s) * DH;
    float qk = 0.f, qe = 0.f;
#pragma unroll
    for (int c = 0; c < DH; c += 8) {
      float kv[8], ev[8];
      mg::load8(krow + c, kv);
      mg::load8(erow + c, ev);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qk = fmaf(qs[c + i], kv[i], qk);
        qe = fmaf(qs[c + i], ev[i], qe);
      }
    }
    logit = (qk + qe) * scale;
  }
  const float m = mg::block_max(logit, red);
  // a masked position weighs 0; in a wholly masked split m is -inf too,
  // and exp(-inf - -inf) would be NaN
  const float p = logit != -INFINITY ? expf(logit - m) : 0.f;
  // weights drop to the cache dtype entering PV (pallas_decode.py:249)
  ps[threadIdx.x] = mg::round_to<T>(p);
  const float l = mg::block_sum(p, red);  // its barriers also publish ps

  const int dim = threadIdx.x & (DH - 1), half = threadIdx.x / DH;
  const int j1 = min(n, (half + 1) * (ATT_CHUNK / 2));
  float acc = 0.f;
  for (int j = max(half * (ATT_CHUNK / 2), lo); j < j1; ++j)
    acc = fmaf(ps[j],
               mg::to_f(vc[((size_t)b * S + c0 + j) * d + h * DH + dim]),
               acc);
  accs[half][dim] = acc;
  __syncthreads();
  float* rec = part + ((size_t)bh * gridDim.y + blockIdx.y) * PART;
  if (threadIdx.x < DH) rec[2 + threadIdx.x] = accs[0][threadIdx.x] + accs[1][threadIdx.x];
  if (threadIdx.x == 0) {
    rec[0] = m;
    rec[1] = l;
  }
}

// Dynamic shared memory of chunk_attn_kernel: the C queries, the split's
// V rows and the E window (rows padded to DH + 1 floats, so the 32
// threads of a warp, reading 32 consecutive rows, hit 32 banks).
inline size_t chunk_attn_smem(int C) {
  return ((size_t)C * DH + (size_t)ATT_CHUNK * DH
          + (size_t)(ATT_CHUNK + C - 1) * (DH + 1)) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(ATT_CHUNK)
chunk_attn_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const float* __restrict__ e,
                  float* __restrict__ part, int H, int C, int S, int d,
                  int t, int max_seq, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                       // [C][DH]
  float* vs = qs + C * DH;              // [ATT_CHUNK][DH]
  float* es = vs + ATT_CHUNK * DH;      // [ATT_CHUNK + C - 1][DH + 1]
  __shared__ float ps[ATT_CHUNK];
  __shared__ float accs[2][DH];
  __shared__ float red[ATT_CHUNK / 32];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c0 = blockIdx.y * ATT_CHUNK;
  const int n_all = min(ATT_CHUNK, t + C - c0);  // split rows below t + C
  // window row w holds E[e0 + w]; query c's row for position c0 + j is
  // w = C - 1 - c + j. Rows past max_seq - 1 meet only masked positions.
  const int e0 = max_seq - (t + C) + c0;
  const int n_e = ATT_CHUNK + C - 1;
  for (int i = threadIdx.x; i < C * DH; i += blockDim.x)
    qs[i] = q[(size_t)(b * C + i / DH) * d + h * DH + i % DH];
  for (int i = threadIdx.x; i < n_all * DH; i += blockDim.x)
    vs[i] = mg::to_f(vc[((size_t)b * S + c0 + i / DH) * d + h * DH + i % DH]);
  for (int i = threadIdx.x; i < n_e * DH; i += blockDim.x) {
    const int row = e0 + i / DH;
    es[(i / DH) * (DH + 1) + i % DH] =
        row < max_seq ? e[(size_t)row * DH + i % DH] : 0.f;
  }
  float kreg[DH];
  if ((int)threadIdx.x < n_all) {
    const T* krow = kc + ((size_t)b * S + c0 + threadIdx.x) * d + h * DH;
#pragma unroll
    for (int c = 0; c < DH; c += 8) mg::load8(krow + c, kreg + c);
  }
  __syncthreads();

  const int dim = threadIdx.x & (DH - 1), half = threadIdx.x / DH;
  for (int c = 0; c < C; ++c) {
    // kernel B's split body at position t + c (rows [c0, t + c] live)
    const int n = min(ATT_CHUNK, t + c + 1 - c0);  // <= 0: split above it
    float logit = -INFINITY;
    if ((int)threadIdx.x < n) {
      const float* qc = qs + c * DH;
      const float* erow = es + (C - 1 - c + threadIdx.x) * (DH + 1);
      float qk = 0.f, qe = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        qk = fmaf(qc[i], kreg[i], qk);
        qe = fmaf(qc[i], erow[i], qe);
      }
      logit = (qk + qe) * scale;
    }
    const float m = mg::block_max(logit, red);
    const float p = logit != -INFINITY ? expf(logit - m) : 0.f;
    ps[threadIdx.x] = mg::round_to<T>(p);
    const float l = mg::block_sum(p, red);  // its barriers also publish ps
    const int j1 = min(n, (half + 1) * (ATT_CHUNK / 2));
    float acc = 0.f;
    for (int j = half * (ATT_CHUNK / 2); j < j1; ++j)
      acc = fmaf(ps[j], vs[j * DH + dim], acc);
    accs[half][dim] = acc;
    __syncthreads();
    float* rec = part + ((size_t)((b * C + c) * H + h) * gridDim.y
                         + blockIdx.y) * PART;
    if (threadIdx.x < DH)
      rec[2 + threadIdx.x] = accs[0][threadIdx.x] + accs[1][threadIdx.x];
    if (threadIdx.x == 0) {
      rec[0] = m;
      rec[1] = l;
    }
    // the next query rewrites ps and accs only after block_max's barriers
  }
}

template <typename T>
__device__ void layer_norm(const float* z, const T* scale, const T* bias,
                           float* dst, int d, float eps, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) s += z[i];
  const float mu = mg::block_sum(s, red) / d;
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float c = z[i] - mu;
    v += c * c;
  }
  const float var = mg::block_sum(v, red) / d;
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    dst[i] = mg::round_to<T>((z[i] - mu) * r * mg::to_f(scale[i])
                             + mg::to_f(bias[i]));
}

// sum over i < n of a[i] * w[i * stride + col], in the order of i (the
// tail's products). The int8 instantiation loads each group of 8 weights
// into registers before it uses any: left to itself, nvcc issued a
// group's last byte load only after its first FMA, so every group waited
// for two round trips to memory (the model-dtype loop issues all 8 first).
template <typename W>
__device__ __forceinline__ float dot_column(const float* a, const W* w,
                                            int n, int stride, int col) {
  float acc = 0.f;
  if constexpr (std::is_same<W, int8_t>::value) {
    int i = 0;
    for (; i + 8 <= n; i += 8) {
      int8_t v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = w[(size_t)(i + k) * stride + col];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = fmaf(a[i + k], mg::to_f(v[k]), acc);
    }
    for (; i < n; ++i) acc = fmaf(a[i], mg::to_f(w[(size_t)i * stride + col]), acc);
  } else {
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc = fmaf(a[i], mg::to_f(w[(size_t)i * stride + col]), acc);
  }
  return acc;
}

// W as qkv_kernel's; sfc, s1, s2: the [d], [f], [d] column scales of
// W_fc, W1, W2 (int8 only)
template <typename T, typename W>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_kernel(const float* __restrict__ part, float* __restrict__ x,
            const W* __restrict__ wfc, const T* __restrict__ bfc,
            const T* __restrict__ ln1s, const T* __restrict__ ln1b,
            const W* __restrict__ w1, const T* __restrict__ b1,
            const W* __restrict__ w2, const T* __restrict__ b2,
            const T* __restrict__ ln2s, const T* __restrict__ ln2b,
            const float* __restrict__ sfc, const float* __restrict__ s1,
            const float* __restrict__ s2, int H, int d, int f, int nsplit,
            float eps) {
  extern __shared__ float sm[];
  float* a = sm;         // attn, then out1
  float* xin = a + d;    // layer input
  float* z = xin + d;    // pre-LN sums
  float* hb = z + d;     // FFN hidden [f]
  float* red = hb + f;   // [32]
  const int b = blockIdx.x;

  // combine the split-K partials of every head (an empty split's
  // m = -inf weighs exp(-inf) = 0: M is finite, row t being live)
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const int h = c / DH, dim = c % DH;
    const float* pp = part + (size_t)(b * H + h) * nsplit * PART;
    float M = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, pp[sp * PART]);
    float Lsum = 0.f, A = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float w = expf(pp[sp * PART] - M);
      Lsum += pp[sp * PART + 1] * w;
      A += pp[sp * PART + 2 + dim] * w;
    }
    a[c] = mg::round_to<T>(A / fmaxf(Lsum, 1e-30f));
    xin[c] = x[(size_t)b * d + c];
  }
  __syncthreads();

  for (int o = threadIdx.x; o < d; o += blockDim.x) {
    const float acc = dot_column(a, wfc, d, d, o);
    z[o] = mg::round_to<T>(scaled<W>(acc, sfc, o) + mg::to_f(bfc[o])) + xin[o];
  }
  __syncthreads();
  layer_norm<T>(z, ln1s, ln1b, a, d, eps, red);  // a := out1
  __syncthreads();

  for (int j = threadIdx.x; j < f; j += blockDim.x) {
    const float acc = dot_column(a, w1, d, f, j);
    hb[j] = fmaxf(mg::round_to<T>(scaled<W>(acc, s1, j) + mg::to_f(b1[j])),
                  0.f);
  }
  __syncthreads();

  for (int o = threadIdx.x; o < d; o += blockDim.x) {
    const float acc = dot_column(hb, w2, f, d, o);
    z[o] = a[o] + mg::round_to<T>(scaled<W>(acc, s2, o) + mg::to_f(b2[o]));
  }
  __syncthreads();
  layer_norm<T>(z, ln2s, ln2b, x + (size_t)b * d, d, eps, red);
}

// The layer loop of both kernels: R = B*C rows (C = 1 for kernel B),
// attention by attn_kernel (kernel B) or chunk_attn_kernel (kernel E).
// W: the six matrices' type (T, or int8_t with the six scale tables sc).
template <typename T, typename W>
int launch_layers(bool chunk, int num_layers, float* x, float* qbuf,
                  float* part, const void* const* w, const void* const* sc,
                  void* kc, void* vc, const float* e, const int* start,
                  int B, int C, int S, int d, int H, int f, int t,
                  int max_seq, int split0, cudaStream_t stream) {
  // per-layer element strides of the stacked [L, ...] arrays, in
  // WEIGHT_KEYS order: wq bq wk bk wv bv wfc bfc ln1s ln1b w1 b1 w2 b2
  // ln2s ln2b
  const size_t stride[16] = {(size_t)d * d, (size_t)d, (size_t)d * d,
                             (size_t)d,     (size_t)d * d, (size_t)d,
                             (size_t)d * d, (size_t)d, (size_t)d,
                             (size_t)d,     (size_t)d * f, (size_t)f,
                             (size_t)f * d, (size_t)d, (size_t)d,
                             (size_t)d};
  // the [L, d_out] scale tables' strides, in MATRIX_KEYS order: wq wk wv
  // wfc w1 w2
  const size_t sstride[6] = {(size_t)d, (size_t)d, (size_t)d,
                             (size_t)d, (size_t)f, (size_t)d};
  constexpr bool quant = std::is_same<W, int8_t>::value;
  const size_t cache_stride = (size_t)B * S * d;
  const int R = B * C;
  // live splits: from start_min's split to the one holding t + C - 1
  const int nsplit = (t + C + ATT_CHUNK - 1) / ATT_CHUNK - split0;
  const size_t qkv_smem = (QKV_ROWS * d + QKV_WARPS * QKV_ROWS * 32) * sizeof(float);
  const size_t tail_smem = (3 * d + f + 32) * sizeof(float);
  const size_t chunk_smem = chunk_attn_smem(C);
  const float scale = 1.0f / sqrtf((float)DH);
  cudaError_t err;
  if (chunk) {
    err = cudaFuncSetAttribute(chunk_attn_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)chunk_smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int li = 0; li < num_layers; ++li) {
    // layer li's vectors (T) and matrices (W), at their WEIGHT_KEYS index
    const T* p[16];
    const W* m[16] = {};
    for (int i = 0; i < 16; ++i)
      p[i] = static_cast<const T*>(w[i]) + li * stride[i];
    for (int i : {0, 2, 4, 6, 10, 12})
      m[i] = static_cast<const W*>(w[i]) + li * stride[i];
    const float* s[6] = {};
    if (quant)
      for (int i = 0; i < 6; ++i)
        s[i] = static_cast<const float*>(sc[i]) + li * sstride[i];
    T* kl = static_cast<T*>(kc) + li * cache_stride;
    T* vl = static_cast<T*>(vc) + li * cache_stride;
    const float* el = e + (size_t)li * max_seq * DH;

    qkv_kernel<T, W><<<dim3(3 * d / QKV_COLS, (R + QKV_ROWS - 1) / QKV_ROWS),
                       QKV_WARPS * 32, qkv_smem, stream>>>(
        x, m[0], p[1], m[2], p[3], m[4], p[5], s[0], s[1], s[2], qbuf, kl,
        vl, R, C, S, d, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (chunk)
      chunk_attn_kernel<T><<<dim3(B * H, nsplit), ATT_CHUNK, chunk_smem,
                             stream>>>(qbuf, kl, vl, el, part, H, C, S, d, t,
                                       max_seq, scale);
    else
      attn_kernel<T><<<dim3(B * H, nsplit), ATT_CHUNK, 0, stream>>>(
          qbuf, kl, vl, el, start, part, H, S, d, t, max_seq, split0, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tail_kernel<T, W><<<R, TAIL_THREADS, tail_smem, stream>>>(
        part, x, m[6], p[7], p[8], p[9], m[10], p[11], m[12], p[13], p[14],
        p[15], s[3], s[4], s[5], H, d, f, nsplit, 1e-6f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int launch_typed(bool chunk, int num_layers, float* x, float* qbuf,
                 float* part, const void* const* w, const void* const* sc,
                 void* kc, void* vc, const float* e, const int* start, int B,
                 int C, int S, int d, int H, int f, int t, int max_seq,
                 int split0, cudaStream_t stream) {
  if (sc != nullptr)
    return launch_layers<T, int8_t>(chunk, num_layers, x, qbuf, part, w, sc,
                                    kc, vc, e, start, B, C, S, d, H, f, t,
                                    max_seq, split0, stream);
  return launch_layers<T, T>(chunk, num_layers, x, qbuf, part, w, sc, kc, vc,
                             e, start, B, C, S, d, H, f, t, max_seq, split0,
                             stream);
}

int launch(bool chunk, int is_bf16, int num_layers, void* x, void* qbuf,
           void* part, const void* const* w, const void* const* sc, void* kc,
           void* vc, const void* e, const void* start, int B, int C, int S,
           int d, int H, int f, int t, int max_seq, int split0,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  float* qf = static_cast<float*>(qbuf);
  float* pf = static_cast<float*>(part);
  const float* ef = static_cast<const float*>(e);
  const int* st = static_cast<const int*>(start);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(chunk, num_layers, xf, qf, pf, w, sc,
                                       kc, vc, ef, st, B, C, S, d, H, f, t,
                                       max_seq, split0, s);
  return launch_typed<float>(chunk, num_layers, xf, qf, pf, w, sc, kc, vc,
                             ef, st, B, C, S, d, H, f, t, max_seq, split0, s);
}

}  // namespace

// Kernel B. x: [B, d] f32, the step's input, overwritten with its output;
// qbuf: [B, d] f32 scratch; part: [B*H, ceil((t+1)/128) - split0, 66] f32
// scratch; w: 16 pointers to the stacked [L, ...] weights (WEIGHT_KEYS
// order, [in, out] matrices) in the model dtype; sc: null, or 6 pointers
// to the [L, d_out] f32 scales of wq wk wv wfc w1 w2, which are then int8;
// kc, vc: [L, B, S, d] caches in the model dtype, row t written in place;
// e: [L, max_seq, 64] f32; start: [B] int32 first live row of each batch
// row (each <= t), or null for the non-ragged step; split0 = start_min /
// 128 with start_min <= min(start) (0 without start).
// Returns the first non-zero cudaGetLastError() of the 3*L launches.
extern "C" int mg_decode_step(int is_bf16, int num_layers, void* x,
                              void* qbuf, void* part, const void* const* w,
                              const void* const* sc, void* kc, void* vc,
                              const void* e, const void* start, int B, int S,
                              int d, int H, int f, int t, int max_seq,
                              int split0, void* stream) {
  return launch(false, is_bf16, num_layers, x, qbuf, part, w, sc, kc, vc, e,
                start, B, 1, S, d, H, f, t, max_seq, split0, stream);
}

// Kernel E. x: [B*C, d] f32 (row b*C + c at position t + c), overwritten
// with the output; qbuf: [B*C, d] f32 scratch; part: [B*C*H,
// ceil((t+C)/128), 66] f32 scratch; w, sc, e as for kernel B; kc, vc:
// [L, B, S, d] caches, rows [t, t+C) written in place; 2 <= C <= 128 and
// t + C <= min(S, max_seq), which the caller checks.
// Returns the first non-zero CUDA error of the attribute call and the 3*L
// launches.
extern "C" int mg_decode_chunk(int is_bf16, int num_layers, void* x,
                               void* qbuf, void* part, const void* const* w,
                               const void* const* sc, void* kc, void* vc,
                               const void* e, int B, int C, int S, int d,
                               int H, int f, int t, int max_seq,
                               void* stream) {
  if (C < 2 || C > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  return launch(true, is_bf16, num_layers, x, qbuf, part, w, sc, kc, vc, e,
                nullptr, B, C, S, d, H, f, t, max_seq, 0, stream);
}

// Kernel F replaces musicgeneration_tpu/ops/pallas_decode_loop.py::
// fused_decode_chunk (pallas_call :377 over _chunk_kernel :162; sampler
// sample_mask :108): C whole generation steps per launch. Each step of
// batch row b samples a token from the carried logits (greedy argmax, or
// Gumbel-max over logits * inv_temp after the sort-free top-k / top-p
// masks), embeds it (embed row * sqrt(d) and the positional row, rounded
// as the step path rounds), runs every layer with kernel B's arithmetic
// and rounding points, writes the step's K/V rows into the caches IN
// PLACE at row t, and runs the head (rounded to the model dtype, carried
// as f32). There is no host work between the steps of a launch.
//
// Design for this card: one block of 512 threads per batch row. Rows are
// independent (row b's step i reads only row b's cache), so no grid-wide
// barrier is needed; a later step reads the K/V rows an earlier one wrote
// after a __syncthreads (the same block, the same SM; the caches are
// read through plain, coherent loads, never the read-only path). The
// ~4 MB of bf16 weights stay L2-resident across the B blocks and the C
// steps. Products of the stacked weights ([in, out]) give each thread 8
// adjacent output columns (16-byte loads) over a slice of the input,
// summed through shared memory; the head ([V, d], the nn.Linear weight)
// is one warp per vocabulary row. Attention scores the live prefix
// [0, t] of all heads into shared memory (one warp per prefix row, its
// K row and E row read once for all heads), takes the softmax with one
// warp per head (a global max, as the plain version, so P rounds where
// it does) and sums PV with 8 columns per thread.
// What bounds it: a row's step streams its weights (~4 MB) and its K/V
// prefix through one SM, whose L2 bandwidth (~64 B/clock) sets ~100 us
// per step at the flagship's shapes; the card's bytes bound for a whole
// launch is far lower. Splitting a row across SMs (a cluster) and tensor
// cores are the levers for a later PR.
//
// The random stream: Philox4x32-10, key (seed lo, seed hi), counter
// (v / 4, b, t, 0), word v % 4 (ops/decode_loop.py's layout).

#include <limits.h>
#include <stdint.h>

namespace {

constexpr int LOOP_THREADS = 512;
constexpr int LOOP_WARPS = LOOP_THREADS / 32;
constexpr float LOOP_NEG = -1e30f;  // an entry the masks exclude
// rows each thread (or warp) loads before it uses any: the loads of one
// batch are in flight together (a store between two loads would keep
// them in order)
constexpr int LOOP_BATCH = 2;

struct LoopSampling {
  float inv_temp;
  int greedy, top_k, use_p;
  float top_p;
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const unsigned long long p0 = (unsigned long long)0xD2511F53u * c.x;
    const unsigned long long p1 = (unsigned long long)0xCD9E8D57u * c.z;
    c = make_uint4((uint32_t)(p1 >> 32) ^ c.y ^ k.x, (uint32_t)p1,
                   (uint32_t)(p0 >> 32) ^ c.w ^ k.y, (uint32_t)p0);
  }
  return c;
}

__device__ __forceinline__ float gumbel_noise(uint32_t bits) {
  const float u = fmaxf((float)(bits >> 8) * (1.0f / 16777216.0f), 1e-10f);
  return -logf(-logf(u));
}

// f32 -> int32, strictly monotone in float order
__device__ __forceinline__ int sort_key(float x) {
  const int s = __float_as_int(x);
  return s ^ ((s >> 31) & 0x7fffffff);
}

// The block's largest value, the lowest index on ties (every thread
// calls it and gets the index). red: LOOP_WARPS floats, redi as many ints.
__device__ int block_argmax(float v, int i, float* red, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  __syncthreads();
  if (lane == 0) {
    red[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  float bv = red[0];
  int bi = redi[0];
  for (int w = 1; w < LOOP_WARPS; ++w)
    if (red[w] > bv || (red[w] == bv && redi[w] < bi)) {
      bv = red[w];
      bi = redi[w];
    }
  return bi;
}

// Smallest int32 T with stat(T) < thr, stat(T) summed over the entries
// whose key is above T: 32 bisection steps with the overflow-safe
// midpoint (pallas_decode_loop.py:89-105). mass: count (null) or the
// probabilities.
__device__ int mask_search(const float* vals, const float* mass, int V,
                           float thr, float* red) {
  int lo = INT_MIN, hi = INT_MAX;
  for (int it = 0; it < 32; ++it) {
    const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
    float s = 0.f;
    for (int v = threadIdx.x; v < V; v += LOOP_THREADS)
      if (sort_key(vals[v]) > mid) s += mass != nullptr ? mass[v] : 1.f;
    if (mg::block_sum(s, red) >= thr)
      lo = mid;
    else
      hi = mid;
  }
  return hi;
}

// One draw of the sampler for batch row `row` at position t. vals: the
// carried logits [V] in shared memory, each thread reading and writing
// only its own entries v = tid + k * LOOP_THREADS; on return they hold
// the scaled, masked values the draw was taken over (untouched when
// greedy). probs: [V] shared scratch. Every thread gets the token.
__device__ int loop_sample(float* vals, float* probs, int V,
                           const LoopSampling& sp, uint2 key, uint32_t row,
                           uint32_t t, float* red, int* redi) {
  const int tid = threadIdx.x;
  if (sp.greedy) {
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int v = tid; v < V; v += LOOP_THREADS)
      if (vals[v] > bv) {
        bv = vals[v];
        bi = v;
      }
    return block_argmax(bv, bi, red, redi);
  }
  for (int v = tid; v < V; v += LOOP_THREADS) vals[v] *= sp.inv_temp;
  if (sp.top_k > 0) {
    const int tk = mask_search(vals, nullptr, V, (float)sp.top_k, red);
    for (int v = tid; v < V; v += LOOP_THREADS)
      if (sort_key(vals[v]) < tk) vals[v] = LOOP_NEG;
  }
  if (sp.use_p) {
    // excluded entries weigh exp(-1e30 - m) = 0, so the masses sum the
    // kept entries only
    float m = -INFINITY;
    for (int v = tid; v < V; v += LOOP_THREADS) m = fmaxf(m, vals[v]);
    m = mg::block_max(m, red);
    float s = 0.f;
    for (int v = tid; v < V; v += LOOP_THREADS) {
      probs[v] = expf(vals[v] - m);
      s += probs[v];
    }
    s = mg::block_sum(s, red);
    for (int v = tid; v < V; v += LOOP_THREADS) probs[v] = probs[v] / s;
    const int tp = mask_search(vals, probs, V, sp.top_p, red);
    for (int v = tid; v < V; v += LOOP_THREADS)
      if (sort_key(vals[v]) < tp) vals[v] = LOOP_NEG;
  }
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int g = tid; g * 4 < V; g += LOOP_THREADS) {
    const uint4 w = philox4x32_10(make_uint4(g, row, t, 0), key);
    const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = g * 4 + j;
      if (v >= V) break;
      const float y = vals[v] + gumbel_noise(word[j]);
      if (y > bv) {
        bv = y;
        bi = v;
      }
    }
  }
  return block_argmax(bv, bi, red, redi);
}

// out[o] = sum_i x[i] W[i * N + o] + bias[o], f32 (unrounded), for the
// N columns of an [K, N] matrix: each thread owns 8 adjacent columns
// over a slice of the K rows; part ([ks][N] <= 4096 floats) sums the
// slices. N % 8 == 0, N <= 4096. Ends with a barrier.
template <typename T>
__device__ void loop_matvec(const float* x, const T* W, const T* bias, int K,
                            int N, float* part, float* out) {
  const int tid = threadIdx.x;
  const int tpc = N / 8, ks = LOOP_THREADS / tpc;
  const int per = (K + ks - 1) / ks;
  if (tid < ks * tpc) {
    const int c0 = (tid % tpc) * 8, s = tid / tpc;
    const int i1 = min(K, (s + 1) * per);
    float acc[8] = {};
    // bf16 rows are half the registers: twice the loads in flight
    constexpr int kB = sizeof(T) == 2 ? 2 * LOOP_BATCH : LOOP_BATCH;
    for (int i0 = s * per; i0 < i1; i0 += kB) {
      mg::Raw8<T> raw[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (i0 + u < i1) raw[u] = mg::load_raw8(W + (size_t)(i0 + u) * N + c0);
#pragma unroll
      for (int u = 0; u < kB; ++u) {
        if (i0 + u >= i1) break;
        float w[8];
        mg::widen8(raw[u], w);
        const float xi = x[i0 + u];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xi, w[j], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; j += 4)  // 16-byte stores: no bank conflicts
      *reinterpret_cast<float4*>(part + s * N + c0 + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
  __syncthreads();
  for (int o = tid; o < N; o += LOOP_THREADS) {
    float sum = 0.f;
    for (int k = 0; k < ks; ++k) sum += part[k * N + o];
    out[o] = sum + mg::to_f(bias[o]);
  }
  __syncthreads();
}

template <typename T>
struct LoopArgs {
  float* logits;          // [B, V] f32, carried: read first, written last
  long long* tokens;      // [B, >= C] int64, row stride tok_stride
  const long long* seed;  // this chunk's seed
  const T* w[16];         // stacked [L, ...] weights, WEIGHT_KEYS order
  const T* embed;         // [V, d]
  const T* pos;           // [>= t0 + C, d]
  const T* fc_w;          // [V, d]
  const T* fc_b;          // [V]
  T* kc;                  // [L, B, S, d], rows [t0, t0 + C) written
  T* vc;
  const float* e;         // [L, max_seq, 64]
  int tok_stride, num_layers, C, S, d, H, f, V, t0, max_seq;
  float scale;            // sqrt(d) in the model dtype
  LoopSampling sp;
};

// Shared memory of kernel F's block, in floats: the logits and the
// sampler's probabilities (V rounded up to 4, so every later buffer is
// 16-byte aligned), five activation buffers, the partial sums, the scores
// of H heads (rows of S + 1, so the heads' rows start in different banks)
// and the reductions' scratch.
inline size_t loop_smem(int d, int f, int V, int S, int H) {
  const int w = d > f ? d : f;
  return ((size_t)2 * ((V + 3) & ~3) + 5 * (size_t)w + 8 * LOOP_THREADS
          + (size_t)H * (S + 1) + 64) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(LOOP_THREADS)
decode_loop_kernel(const LoopArgs<T> a) {
  extern __shared__ float sm[];
  const int V = a.V, d = a.d, f = a.f, H = a.H, S = a.S;
  const int w = d > f ? d : f;
  const int Vp = (V + 3) & ~3, SP = S + 1;
  float* lg = sm;                 // carried logits [V]
  float* pr = lg + Vp;            // sampler probabilities [V]
  float* x = pr + Vp;             // layer input / output [d]
  float* q = x + w;               // q, then the FFN output
  float* at = q + w;              // attention output, then out1
  float* z = at + w;              // pre-LN sums
  float* y = z + w;               // product outputs, FFN hidden [f]
  float* part = y + w;            // [8 * LOOP_THREADS]
  float* sc = part + 8 * LOOP_THREADS;  // scores / P [H][SP]
  float* red = sc + (size_t)H * SP;     // [16] reductions
  int* redi = reinterpret_cast<int*>(red + 16);  // [16]
  float* lsum = red + 32;               // [16] softmax sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const float att_scale = 1.0f / sqrtf((float)DH);
  const size_t wstride[16] = {(size_t)d * d, (size_t)d, (size_t)d * d,
                              (size_t)d,     (size_t)d * d, (size_t)d,
                              (size_t)d * d, (size_t)d, (size_t)d,
                              (size_t)d,     (size_t)d * f, (size_t)f,
                              (size_t)f * d, (size_t)d, (size_t)d,
                              (size_t)d};
  const unsigned long long seed = (unsigned long long)a.seed[0];
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));

  for (int v = tid; v < V; v += LOOP_THREADS) lg[v] = a.logits[(size_t)b * V + v];
  __syncthreads();
  for (int i = 0; i < a.C; ++i) {
    const int t = a.t0 + i;
    const int tok = loop_sample(lg, pr, V, a.sp, key, b, t, red, redi);
    if (tid == 0) a.tokens[(size_t)b * a.tok_stride + i] = tok;
    for (int c = tid; c < d; c += LOOP_THREADS)
      x[c] = mg::round_to<T>(
          mg::round_to<T>(mg::to_f(a.embed[(size_t)tok * d + c]) * a.scale)
          + mg::to_f(a.pos[(size_t)t * d + c]));
    __syncthreads();

    const int n = t + 1;  // live rows [0, t]
    for (int li = 0; li < a.num_layers; ++li) {
      const T* p[16];
      for (int k = 0; k < 16; ++k) p[k] = a.w[k] + li * wstride[k];
      T* kl = a.kc + (size_t)li * gridDim.x * S * d;
      T* vl = a.vc + (size_t)li * gridDim.x * S * d;
      const float* el = a.e + (size_t)li * a.max_seq * DH;
      T* krow = kl + ((size_t)b * S + t) * d;
      T* vrow = vl + ((size_t)b * S + t) * d;

      // q, k, v (rounded to the model dtype); row t into the caches
      loop_matvec<T>(x, p[0], p[1], d, d, part, q);
      for (int c = tid; c < d; c += LOOP_THREADS) q[c] = mg::round_to<T>(q[c]);
      loop_matvec<T>(x, p[2], p[3], d, d, part, y);
      for (int c = tid; c < d; c += LOOP_THREADS) krow[c] = mg::from_f<T>(y[c]);
      loop_matvec<T>(x, p[4], p[5], d, d, part, y);
      for (int c = tid; c < d; c += LOOP_THREADS) vrow[c] = mg::from_f<T>(y[c]);
      __syncthreads();  // publishes q and the cache rows to the block

      // scores of every head over [0, t]: (q.k_s + q.E[max_seq-1-t+s]) / 8.
      // One warp per prefix row, each lane 8 of the d dims: the K row is
      // one coalesced read and the E row is read once for every head; the
      // 8 lanes of a head sum their partial products by shuffles.
      for (int base = 0; base < d; base += 256) {
        const int c0 = base + lane * 8;
        float qv[8];  // this lane's slice of q, in registers for every row
#pragma unroll
        for (int j = 0; j < 8; ++j) qv[j] = c0 < d ? q[c0 + j] : 0.f;
        for (int s0 = warp; s0 < n; s0 += LOOP_BATCH * LOOP_WARPS) {
          mg::Raw8<T> kraw[LOOP_BATCH];
          mg::Raw8<float> eraw[LOOP_BATCH];
#pragma unroll
          for (int u = 0; u < LOOP_BATCH; ++u) {
            const int s = s0 + u * LOOP_WARPS;
            if (s < n && c0 < d) {
              kraw[u] = mg::load_raw8(kl + ((size_t)b * S + s) * d + c0);
              eraw[u] = mg::load_raw8(el + (size_t)(a.max_seq - 1 - t + s) * DH
                                  + (c0 & (DH - 1)));
            }
          }
#pragma unroll
          for (int u = 0; u < LOOP_BATCH; ++u) {
            const int s = s0 + u * LOOP_WARPS;
            float qk = 0.f, qe = 0.f;
            if (s < n && c0 < d) {
              float kv[8], ev[8];
              mg::widen8(kraw[u], kv);
              mg::widen8(eraw[u], ev);
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                qk = fmaf(qv[j], kv[j], qk);
                qe = fmaf(qv[j], ev[j], qe);
              }
            }
#pragma unroll
            for (int o = 4; o > 0; o >>= 1) {
              qk += __shfl_xor_sync(0xffffffffu, qk, o);
              qe += __shfl_xor_sync(0xffffffffu, qe, o);
            }
            if ((lane & 7) == 0 && c0 < d && s < n)
              sc[(size_t)(c0 / DH) * SP + s] = (qk + qe) * att_scale;
          }
        }
      }
      __syncthreads();
      // softmax, one warp per head: P in the cache dtype (pallas_decode.py
      // :249) over the sum of the unrounded P
      if (warp < H) {
        float* sh = sc + (size_t)warp * SP;
        float m = -INFINITY;
        for (int s = lane; s < n; s += 32) m = fmaxf(m, sh[s]);
        m = mg::warp_max(m);
        float l = 0.f;
        for (int s = lane; s < n; s += 32) {
          const float pv = expf(sh[s] - m);
          l += pv;
          sh[s] = mg::round_to<T>(pv);
        }
        l = mg::warp_sum(l);
        if (lane == 0) lsum[warp] = l;
      }
      __syncthreads();
      // PV: 8 columns per thread, the rows split over G groups
      {
        const int tpc = d / 8, G = LOOP_THREADS / tpc;
        if (tid < G * tpc) {
          const int g = tid / tpc, c0 = (tid % tpc) * 8;
          const float* ph = sc + (size_t)(c0 / DH) * SP;
          float acc[8] = {};
          for (int s0 = g; s0 < n; s0 += LOOP_BATCH * G) {
            mg::Raw8<T> raw[LOOP_BATCH];
#pragma unroll
            for (int u = 0; u < LOOP_BATCH; ++u)
              if (s0 + u * G < n)
                raw[u] = mg::load_raw8(vl + ((size_t)b * S + s0 + u * G) * d + c0);
#pragma unroll
            for (int u = 0; u < LOOP_BATCH; ++u) {
              if (s0 + u * G >= n) break;
              float vv[8];
              mg::widen8(raw[u], vv);
              const float pv = ph[s0 + u * G];
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[j] = fmaf(pv, vv[j], acc[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < 8; j += 4)
            *reinterpret_cast<float4*>(part + g * d + c0 + j) =
                make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        }
        __syncthreads();
        for (int c = tid; c < d; c += LOOP_THREADS) {
          float A = 0.f;
          for (int g = 0; g < G; ++g) A += part[g * d + c];
          at[c] = mg::round_to<T>(A / fmaxf(lsum[c / DH], 1e-30f));
        }
        __syncthreads();
      }

      // the tail: fc, residual, LN1, FFN (ReLU), residual, LN2
      loop_matvec<T>(at, p[6], p[7], d, d, part, y);
      for (int c = tid; c < d; c += LOOP_THREADS) z[c] = mg::round_to<T>(y[c]) + x[c];
      __syncthreads();
      layer_norm<T>(z, p[8], p[9], at, d, 1e-6f, red);  // at := out1
      __syncthreads();
      loop_matvec<T>(at, p[10], p[11], d, f, part, y);
      for (int j = tid; j < f; j += LOOP_THREADS) y[j] = fmaxf(mg::round_to<T>(y[j]), 0.f);
      __syncthreads();
      loop_matvec<T>(y, p[12], p[13], f, d, part, q);
      for (int c = tid; c < d; c += LOOP_THREADS) z[c] = at[c] + mg::round_to<T>(q[c]);
      __syncthreads();
      layer_norm<T>(z, p[14], p[15], x, d, 1e-6f, red);
      __syncthreads();
    }

    // the head, one warp per vocabulary row: the logits in the model dtype
    for (int v0 = warp; v0 < V; v0 += LOOP_BATCH * LOOP_WARPS) {
      float acc[LOOP_BATCH] = {};
      for (int c = lane * 8; c < d; c += 256) {
        mg::Raw8<T> raw[LOOP_BATCH];
#pragma unroll
        for (int u = 0; u < LOOP_BATCH; ++u)
          if (v0 + u * LOOP_WARPS < V)
            raw[u] = mg::load_raw8(a.fc_w + (size_t)(v0 + u * LOOP_WARPS) * d + c);
#pragma unroll
        for (int u = 0; u < LOOP_BATCH; ++u) {
          if (v0 + u * LOOP_WARPS >= V) break;
          float wv[8];
          mg::widen8(raw[u], wv);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[u] = fmaf(x[c + j], wv[j], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < LOOP_BATCH; ++u) {
        const int v = v0 + u * LOOP_WARPS;
        const float sum = mg::warp_sum(acc[u]);
        if (lane == 0 && v < V) lg[v] = mg::round_to<T>(sum + mg::to_f(a.fc_b[v]));
      }
    }
    __syncthreads();
  }
  for (int v = tid; v < V; v += LOOP_THREADS) a.logits[(size_t)b * V + v] = lg[v];
}

// The sampler alone: one block per row n of logits [N, V].
__global__ void __launch_bounds__(LOOP_THREADS)
loop_sample_kernel(const float* __restrict__ logits,
                   long long* __restrict__ tokens, float* __restrict__ masked,
                   const long long* __restrict__ seeds,
                   const int* __restrict__ rows, const int* __restrict__ pos,
                   int V, LoopSampling sp) {
  extern __shared__ float sm[];
  float* vals = sm;
  float* probs = vals + V;
  float* red = probs + V;
  int* redi = reinterpret_cast<int*>(red + 16);
  const int n = blockIdx.x;
  for (int v = threadIdx.x; v < V; v += LOOP_THREADS)
    vals[v] = logits[(size_t)n * V + v];
  __syncthreads();
  const unsigned long long seed = (unsigned long long)seeds[n];
  const int tok = loop_sample(vals, probs, V, sp,
                              make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)),
                              rows[n], pos[n], red, redi);
  for (int v = threadIdx.x; v < V; v += LOOP_THREADS)
    masked[(size_t)n * V + v] = vals[v];
  if (threadIdx.x == 0) tokens[n] = tok;
}

template <typename T>
int decode_loop(int num_layers, void* logits, void* tokens, int tok_stride,
                const void* seed, const void* const* w, const void* embed,
                const void* pos, const void* fc_w, const void* fc_b, void* kc,
                void* vc, const void* e, int B, int C, int S, int d, int H,
                int f, int V, int t0, int max_seq, float scale,
                LoopSampling sp, cudaStream_t stream) {
  LoopArgs<T> a;
  a.logits = static_cast<float*>(logits);
  a.tokens = static_cast<long long*>(tokens);
  a.seed = static_cast<const long long*>(seed);
  for (int i = 0; i < 16; ++i) a.w[i] = static_cast<const T*>(w[i]);
  a.embed = static_cast<const T*>(embed);
  a.pos = static_cast<const T*>(pos);
  a.fc_w = static_cast<const T*>(fc_w);
  a.fc_b = static_cast<const T*>(fc_b);
  a.kc = static_cast<T*>(kc);
  a.vc = static_cast<T*>(vc);
  a.e = static_cast<const float*>(e);
  a.tok_stride = tok_stride;
  a.num_layers = num_layers;
  a.C = C;
  a.S = S;
  a.d = d;
  a.H = H;
  a.f = f;
  a.V = V;
  a.t0 = t0;
  a.max_seq = max_seq;
  a.scale = scale;
  a.sp = sp;
  const size_t smem = loop_smem(d, f, V, S, H);
  cudaError_t err = cudaFuncSetAttribute(
      decode_loop_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_loop_kernel<T><<<B, LOOP_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel F. logits: [B, V] f32, the logits of position t0 - 1, overwritten
// with the last step's; tokens: int64, row b's C tokens at tokens[b *
// tok_stride + i]; seed: one int64 on the device; w: 16 pointers to the
// stacked [L, ...] weights (WEIGHT_KEYS order, [in, out]); embed, fc_w:
// [V, d]; pos: [>= t0 + C, d]; fc_b: [V], all in the model dtype; kc, vc:
// [L, B, S, d] caches, rows [t0, t0 + C) written in place; e: [L,
// max_seq, 64] f32; scale: sqrt(d) in the model dtype. dh = 64, d <=
// 1024 with d / 64 heads, f % 8 == 0, t0 + C <= min(S, max_seq) and the
// shared memory within a block's: the caller checks. Returns the first
// non-zero CUDA error of the attribute call and the launch.
extern "C" int mg_decode_loop(int is_bf16, int num_layers, void* logits,
                              void* tokens, int tok_stride, const void* seed,
                              const void* const* w, const void* embed,
                              const void* pos, const void* fc_w,
                              const void* fc_b, void* kc, void* vc,
                              const void* e, int B, int C, int S, int d,
                              int H, int f, int V, int t0, int max_seq,
                              float scale, float inv_temp, int greedy,
                              int top_k, int use_p, float top_p,
                              void* stream) {
  const LoopSampling sp{inv_temp, greedy, top_k, use_p, top_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || H > LOOP_WARPS || d % 8 || f % 8 || f > 8 * LOOP_THREADS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return decode_loop<__nv_bfloat16>(num_layers, logits, tokens, tok_stride,
                                      seed, w, embed, pos, fc_w, fc_b, kc, vc,
                                      e, B, C, S, d, H, f, V, t0, max_seq,
                                      scale, sp, s);
  return decode_loop<float>(num_layers, logits, tokens, tok_stride, seed, w,
                            embed, pos, fc_w, fc_b, kc, vc, e, B, C, S, d, H,
                            f, V, t0, max_seq, scale, sp, s);
}

// Kernel F's sampler alone (for holding it against the plain one): row n
// of logits [N, V] f32 drawn for batch row rows[n] at position pos[n]
// under seeds[n]; writes tokens[n] and the masked scaled row masked[n]
// (the raw row when greedy).
extern "C" int mg_loop_sample(const void* logits, void* tokens, void* masked,
                              const void* seeds, const void* rows,
                              const void* pos, int N, int V, float inv_temp,
                              int greedy, int top_k, int use_p, float top_p,
                              void* stream) {
  const LoopSampling sp{inv_temp, greedy, top_k, use_p, top_p};
  const size_t smem = ((size_t)2 * V + 64) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      loop_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  loop_sample_kernel<<<N, LOOP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<long long*>(tokens),
      static_cast<float*>(masked), static_cast<const long long*>(seeds),
      static_cast<const int*>(rows), static_cast<const int*>(pos), V, sp);
  return (int)cudaGetLastError();
}
