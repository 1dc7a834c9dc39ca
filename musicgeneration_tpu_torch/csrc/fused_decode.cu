// Kernel B: one decode step through every layer of a MusicTransformer.
//
// Replaces musicgeneration_tpu/ops/pallas_decode.py::fused_decode_step
// (its pallas_calls over _kernel / _kernel_grid*, layer body _layer_step),
// without int8 weights. Per layer, for each batch row b at absolute
// position t:
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
//     of 8 batch rows; its 8 warps split the input dimension and reduce
//     through shared memory. k and v go straight into cache row t — the
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
//  3. tail_kernel: one block per batch row combines the partials, then
//     fc, residual, LN1, FFN1, ReLU, FFN2, residual, LN2.
//
// What bounds it: at the flagship decode shape (6 layers, d 256, B 8,
// t ~ 768 of a 1024-row bf16 cache) the step must read ~38 MB of KV
// cache plus ~4 MB of weights and does ~50 MFLOP: bytes bound it, at
// ~13 us on an H100 SXM. Reading only the live prefix [0, t] (as the TPU
// kernel did) keeps the bytes at their minimum; split-K spreads the
// cache read over B*H*ceil((t+1)/128) blocks so it is not limited by
// B*H blocks. At this size the 18 launches per step cost more than the
// bytes; a CUDA graph or one persistent kernel is the next step.
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

template <typename T>
__global__ void __launch_bounds__(QKV_WARPS * 32)
qkv_kernel(const float* __restrict__ x, const T* __restrict__ wq,
           const T* __restrict__ bq, const T* __restrict__ wk,
           const T* __restrict__ bk, const T* __restrict__ wv,
           const T* __restrict__ bv, float* __restrict__ qout,
           T* __restrict__ kc, T* __restrict__ vc, int B, int S, int d,
           int t) {
  extern __shared__ float sm[];
  float* xs = sm;                    // [QKV_ROWS][d]
  float* red = sm + QKV_ROWS * d;    // [QKV_WARPS][QKV_ROWS][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * QKV_ROWS;
  const int nr = min(QKV_ROWS, B - r0);
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
  const int b = r0 + r;
  if (which == 0) {
    qout[(size_t)b * d + o] = y;
  } else {
    T* cache = which == 1 ? kc : vc;
    cache[((size_t)b * S + t) * d + o] = mg::from_f<T>(y);
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

template <typename T>
int launch_step(int num_layers, float* x, float* qbuf, float* part,
                const void* const* w, void* kc, void* vc, const float* e,
                const int* start, int B, int S, int d, int H, int f, int t,
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
  const size_t cache_stride = (size_t)B * S * d;
  // live splits: from start_min's split to the one holding t
  const int nsplit = (t + 1 + ATT_CHUNK - 1) / ATT_CHUNK - split0;
  const size_t qkv_smem = (QKV_ROWS * d + QKV_WARPS * QKV_ROWS * 32) * sizeof(float);
  const size_t tail_smem = (3 * d + f + 32) * sizeof(float);
  const float scale = 1.0f / sqrtf((float)DH);
  for (int li = 0; li < num_layers; ++li) {
    const T* p[16];
    for (int i = 0; i < 16; ++i)
      p[i] = static_cast<const T*>(w[i]) + li * stride[i];
    T* kl = static_cast<T*>(kc) + li * cache_stride;
    T* vl = static_cast<T*>(vc) + li * cache_stride;
    const float* el = e + (size_t)li * max_seq * DH;

    qkv_kernel<T><<<dim3(3 * d / QKV_COLS, (B + QKV_ROWS - 1) / QKV_ROWS),
                    QKV_WARPS * 32, qkv_smem, stream>>>(
        x, p[0], p[1], p[2], p[3], p[4], p[5], qbuf, kl, vl, B, S, d, t);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attn_kernel<T><<<dim3(B * H, nsplit), ATT_CHUNK, 0, stream>>>(
        qbuf, kl, vl, el, start, part, H, S, d, t, max_seq, split0, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tail_kernel<T><<<B, TAIL_THREADS, tail_smem, stream>>>(
        part, x, p[6], p[7], p[8], p[9], p[10], p[11], p[12], p[13], p[14],
        p[15], H, d, f, nsplit, 1e-6f);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// x: [B, d] f32, the step's input, overwritten with its output;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xf = static_cast<float*>(x);
  float* qf = static_cast<float*>(qbuf);
  float* pf = static_cast<float*>(part);
  const float* ef = static_cast<const float*>(e);
  const int* st = static_cast<const int*>(start);
  if (is_bf16)
    return launch_step<__nv_bfloat16>(num_layers, xf, qf, pf, w, kc, vc, ef,
                                      st, B, S, d, H, f, t, max_seq, split0,
                                      s);
  return launch_step<float>(num_layers, xf, qf, pf, w, kc, vc, ef, st, B, S,
                            d, H, f, t, max_seq, split0, s);
}
