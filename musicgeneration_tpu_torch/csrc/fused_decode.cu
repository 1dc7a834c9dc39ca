// Kernels B and E: the decode step and the chunk-verify forward through
// every layer of a MusicTransformer.
//
// Kernel B replaces musicgeneration_tpu/ops/pallas_decode.py::
// fused_decode_step (its pallas_calls over _kernel / _kernel_grid*, layer
// body _layer_step), without int8 weights. Per layer, for each batch row
// b at absolute position t:
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
// / _kernel_chunk_grid*, layer body _layer_chunk_step), without int8: the
// verify forward of speculative decoding. C tokens at positions
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

// R = B*C rows of x; row (b, c) is position t + c of batch row b (C = 1
// for kernel B)
template <typename T>
__global__ void __launch_bounds__(QKV_WARPS * 32)
qkv_kernel(const float* __restrict__ x, const T* __restrict__ wq,
           const T* __restrict__ bq, const T* __restrict__ wk,
           const T* __restrict__ bk, const T* __restrict__ wv,
           const T* __restrict__ bv, float* __restrict__ qout,
           T* __restrict__ kc, T* __restrict__ vc, int R, int C, int S,
           int d, int t) {
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
  const T* W = which == 0 ? wq : (which == 1 ? wk : wv);
  float acc[QKV_ROWS];
#pragma unroll
  for (int r = 0; r < QKV_ROWS; ++r) acc[r] = 0.f;
  const int per = d / QKV_WARPS;
  const int i0 = warp * per;
#pragma unroll 4
  for (int i = i0; i < i0 + per; ++i) {
    const float w = mg::to_f(W[(size_t)i * d + o]);
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

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS)
tail_kernel(const float* __restrict__ part, float* __restrict__ x,
            const T* __restrict__ wfc, const T* __restrict__ bfc,
            const T* __restrict__ ln1s, const T* __restrict__ ln1b,
            const T* __restrict__ w1, const T* __restrict__ b1,
            const T* __restrict__ w2, const T* __restrict__ b2,
            const T* __restrict__ ln2s, const T* __restrict__ ln2b, int H,
            int d, int f, int nsplit, float eps) {
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
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < d; ++i) acc = fmaf(a[i], mg::to_f(wfc[(size_t)i * d + o]), acc);
    z[o] = mg::round_to<T>(acc + mg::to_f(bfc[o])) + xin[o];
  }
  __syncthreads();
  layer_norm<T>(z, ln1s, ln1b, a, d, eps, red);  // a := out1
  __syncthreads();

  for (int j = threadIdx.x; j < f; j += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < d; ++i) acc = fmaf(a[i], mg::to_f(w1[(size_t)i * f + j]), acc);
    hb[j] = fmaxf(mg::round_to<T>(acc + mg::to_f(b1[j])), 0.f);
  }
  __syncthreads();

  for (int o = threadIdx.x; o < d; o += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < f; ++j) acc = fmaf(hb[j], mg::to_f(w2[(size_t)j * d + o]), acc);
    z[o] = a[o] + mg::round_to<T>(acc + mg::to_f(b2[o]));
  }
  __syncthreads();
  layer_norm<T>(z, ln2s, ln2b, x + (size_t)b * d, d, eps, red);
}

// The layer loop of both kernels: R = B*C rows (C = 1 for kernel B),
// attention by attn_kernel (kernel B) or chunk_attn_kernel (kernel E).
template <typename T>
int launch_layers(bool chunk, int num_layers, float* x, float* qbuf,
                  float* part, const void* const* w, void* kc, void* vc,
                  const float* e, const int* start, int B, int C, int S,
                  int d, int H, int f, int t, int max_seq, int split0,
                  cudaStream_t stream) {
  // per-layer element strides of the stacked [L, ...] arrays, in
  // WEIGHT_KEYS order: wq bq wk bk wv bv wfc bfc ln1s ln1b w1 b1 w2 b2
  // ln2s ln2b
  const size_t stride[16] = {(size_t)d * d, (size_t)d, (size_t)d * d,
                             (size_t)d,     (size_t)d * d, (size_t)d,
                             (size_t)d * d, (size_t)d, (size_t)d,
                             (size_t)d,     (size_t)d * f, (size_t)f,
                             (size_t)f * d, (size_t)d, (size_t)d,
                             (size_t)d};
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
    const T* p[16];
    for (int i = 0; i < 16; ++i)
      p[i] = static_cast<const T*>(w[i]) + li * stride[i];
    T* kl = static_cast<T*>(kc) + li * cache_stride;
    T* vl = static_cast<T*>(vc) + li * cache_stride;
    const float* el = e + (size_t)li * max_seq * DH;

    qkv_kernel<T><<<dim3(3 * d / QKV_COLS, (R + QKV_ROWS - 1) / QKV_ROWS),
                    QKV_WARPS * 32, qkv_smem, stream>>>(
        x, p[0], p[1], p[2], p[3], p[4], p[5], qbuf, kl, vl, R, C, S, d, t);
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
    tail_kernel<T><<<R, TAIL_THREADS, tail_smem, stream>>>(
        part, x, p[6], p[7], p[8], p[9], p[10], p[11], p[12], p[13], p[14],
        p[15], H, d, f, nsplit, 1e-6f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch(bool chunk, int is_bf16, int num_layers, void* x, void* qbuf,
           void* part, const void* const* w, void* kc, void* vc,
           const void* e, const void* start, int B, int C, int S, int d,
           int H, int f, int t, int max_seq, int split0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  float* qf = static_cast<float*>(qbuf);
  float* pf = static_cast<float*>(part);
  const float* ef = static_cast<const float*>(e);
  const int* st = static_cast<const int*>(start);
  if (is_bf16)
    return launch_layers<__nv_bfloat16>(chunk, num_layers, xf, qf, pf, w, kc,
                                        vc, ef, st, B, C, S, d, H, f, t,
                                        max_seq, split0, s);
  return launch_layers<float>(chunk, num_layers, xf, qf, pf, w, kc, vc, ef,
                              st, B, C, S, d, H, f, t, max_seq, split0, s);
}

}  // namespace

// Kernel B. x: [B, d] f32, the step's input, overwritten with its output;
// qbuf: [B, d] f32 scratch; part: [B*H, ceil((t+1)/128) - split0, 66] f32
// scratch; w: 16 pointers to the stacked [L, ...] weights (WEIGHT_KEYS
// order, [in, out] matrices) in the model dtype; kc, vc: [L, B, S, d]
// caches in the model dtype, row t written in place; e: [L, max_seq, 64]
// f32; start: [B] int32 first live row of each batch row (each <= t), or
// null for the non-ragged step; split0 = start_min / 128 with start_min
// <= min(start) (0 without start).
// Returns the first non-zero cudaGetLastError() of the 3*L launches.
extern "C" int mg_decode_step(int is_bf16, int num_layers, void* x,
                              void* qbuf, void* part, const void* const* w,
                              void* kc, void* vc, const void* e,
                              const void* start, int B, int S, int d, int H,
                              int f, int t, int max_seq, int split0,
                              void* stream) {
  return launch(false, is_bf16, num_layers, x, qbuf, part, w, kc, vc, e,
                start, B, 1, S, d, H, f, t, max_seq, split0, stream);
}

// Kernel E. x: [B*C, d] f32 (row b*C + c at position t + c), overwritten
// with the output; qbuf: [B*C, d] f32 scratch; part: [B*C*H,
// ceil((t+C)/128), 66] f32 scratch; w, e as for kernel B; kc, vc: [L, B,
// S, d] caches, rows [t, t+C) written in place; 2 <= C <= 128 and
// t + C <= min(S, max_seq), which the caller checks.
// Returns the first non-zero CUDA error of the attribute call and the 3*L
// launches.
extern "C" int mg_decode_chunk(int is_bf16, int num_layers, void* x,
                               void* qbuf, void* part, const void* const* w,
                               void* kc, void* vc, const void* e, int B,
                               int C, int S, int d, int H, int f, int t,
                               int max_seq, void* stream) {
  if (C < 2 || C > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  return launch(true, is_bf16, num_layers, x, qbuf, part, w, kc, vc, e,
                nullptr, B, C, S, d, H, f, t, max_seq, 0, stream);
}
