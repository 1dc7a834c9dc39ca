// Kernel D: one decode step of a stacked GRU (EventMelodyRNN,
// PerformanceRNN).
//
// Replaces musicgeneration_tpu/ops/pallas_gru_decode.py::fused_gru_step
// (its pallas_call over _kernel). Per layer l, for each batch row b:
//
//   gi = x W_ih^T + b_ih        (f32 sums, rounded to the model dtype)
//   gh = h[l] W_hh^T + b_hh     (f32 sums, rounded to the model dtype)
//   r = sigmoid(gi_r + gh_r), z = sigmoid(gi_z + gh_z)
//   n = tanh(gi_n + r * gh_n),  h'[l] = (1 - z) * n + z * h[l]   (f32)
//
// h'[l] is stored in the model dtype and is the next layer's x. Gate
// order r, z, n, as torch nn.GRU and ops/gru.py.
//
// Weights stay in nn.GRU's layout, W_ih [3H, in] and W_hh [3H, H], each
// row zero-padded to a multiple of 8 elements when the model's weights
// are packed (layer 0's input is 308 wide for EventMelodyRNN), so every
// row is read with 16-byte copies.
//
// What bounds it: at full width (H 512, 3 layers, in 308 or 512, B <= 64)
// the step must read the weights once, 8.8-9.4 MB in bf16 (2.6-2.8 us at
// 3.35 TB/s) and does 2 * B * 3H * (in + H) * L operations, far below the
// card's rate: bytes bound it. The weights fit in the 50 MB L2, so a
// decode loop reads them from L2 after the first step. The layers depend
// on each other, so the step is three dependent launches whose fixed
// costs (launch, first loads, a cluster barrier) weigh more than the
// bytes at decode batch sizes.
//
// Two bodies; the dtype chooses one in `launch_step`, with no fallback
// between them.
// * bf16 (every main path): `gru_layer_tc_kernel`, on the tensor cores.
//   The gate rows are the M rows of mma.sync.m16n8k16 (bf16 operands, f32
//   accumulators) and the batch rows the N columns: a decode GEMV at
//   small B is one n8 tile (up to 4 a block, 32 rows; more rows take
//   more blocks along grid.y). W_ih and W_hh rows are k-contiguous, so
//   ldmatrix gives A fragments from the staged rows, and x and h rows
//   are k-contiguous, so it gives B fragments: no f32 staging copy. One
//   thread-block cluster of GRU_NC CTAs owns 16 hidden units and splits
//   the K of both products into GRU_NC contiguous ranges of k16 steps:
//   H / 16 x GRU_NC = 128 CTAs at H 512, each staging 6 weight tiles of
//   16 rows (r, z and n of W_ih and of W_hh) over its K range with
//   16-byte cp.async. Each of 6 warps runs one tile's k16 steps in
//   order; the CTAs' partial gi and gh go through distributed shared
//   memory to the CTA that owns the unit (4 units a CTA), which adds them
//   in rank order (so two calls give the same bits) and runs the gate
//   epilogue in registers, rounding gi and gh to bf16. The launches are
//   chained by programmatic dependent launch: each layer's CTAs stage
//   their weights, which no kernel writes, before they wait for the
//   previous layer; x and h are staged after the wait.
// * f32 (the parity mode): `gru_layer_kernel`, on the CUDA cores, every
//   product an f32 FMA (TF32 would lose the 1e-4 the checks hold it to).
//   One launch per layer, grid (H/4, ceil(B/8)): a block stages the x and
//   h[l] rows of up to GRU_ROWS batch rows in shared memory as f32 (the
//   loads of a batch issued before any store), each warp owns one hidden
//   unit and computes its six dot products for every staged row, reduces
//   them across the warp and applies the epilogue in registers. It was
//   also the bf16 body before the tensor-core one (launch_step<bf16,
//   false> still reaches it, so the two can be timed on the same inputs).
#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "rel_attn_tile.cuh"

namespace {

constexpr int GRU_WARPS = 4;  // hidden units per block, one per warp
constexpr int GRU_ROWS = 8;   // batch rows staged per block

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Rows [0, nr) of src (row stride width) into dst [GRU_ROWS][P] as f32;
// rows past nr and columns past width zero. Each thread loads a batch of
// STAGE_BATCH elements before it stores any, so the loads are in flight
// together.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int nr,
                                           int width, int P) {
  constexpr int STAGE_BATCH = 8;
  const int n = GRU_ROWS * P;
  for (int i0 = threadIdx.x; i0 < n; i0 += STAGE_BATCH * blockDim.x) {
    float v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x, r = i / P, k = i - r * P;
      v[u] = i < n && r < nr && k < width
                 ? mg::to_f(src[(size_t)r * width + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

// acc[g][r] += W[g * H + j, :] . s[r, :] over k < P, for the nr staged
// rows; s is [GRU_ROWS][P] f32 in shared memory, W rows P wide.
template <typename T>
__device__ __forceinline__ void dot3(const T* __restrict__ W, int H, int j,
                                     int P, const float* s, int nr,
                                     float acc[3][GRU_ROWS]) {
  const int lane = threadIdx.x & 31;
  for (int k = lane * 8; k < P; k += 32 * 8) {
    float w[3][8];
#pragma unroll
    for (int g = 0; g < 3; ++g)
      mg::load8(W + ((size_t)g * H + j) * P + k, w[g]);
#pragma unroll
    for (int r = 0; r < GRU_ROWS; ++r) {
      if (r < nr) {
        float v[8];
        mg::load8(s + r * P + k, v);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          float a = acc[g][r];
#pragma unroll
          for (int e = 0; e < 8; ++e) a = fmaf(w[g][e], v[e], a);
          acc[g][r] = a;
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < GRU_ROWS; ++r)
      if (r < nr) acc[g][r] = mg::warp_sum(acc[g][r]);
}

// One layer. x: [B, in] (row stride in), h: [B, H] this layer's hidden,
// hout: [B, H]; wih [3H, P], whh [3H, PH] (zero-padded rows); bih, bhh
// [3H] f32. grid (ceil(H / GRU_WARPS), ceil(B / GRU_ROWS)).
template <typename T>
__global__ void __launch_bounds__(GRU_WARPS * 32)
gru_layer_kernel(const T* __restrict__ x, int in, int P,
                 const T* __restrict__ h, T* __restrict__ hout,
                 const T* __restrict__ wih, const T* __restrict__ whh,
                 const float* __restrict__ bih,
                 const float* __restrict__ bhh, int B, int H, int PH) {
  extern __shared__ float sm[];
  float* xs = sm;                  // [GRU_ROWS][P]
  float* hs = sm + GRU_ROWS * P;   // [GRU_ROWS][PH]
  const int r0 = blockIdx.y * GRU_ROWS;
  const int nr = min(GRU_ROWS, B - r0);
  stage_rows(xs, x + (size_t)r0 * in, nr, in, P);
  stage_rows(hs, h + (size_t)r0 * H, nr, H, PH);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * GRU_WARPS + warp;
  if (j >= H) return;
  float gi[3][GRU_ROWS], gh[3][GRU_ROWS];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int r = 0; r < GRU_ROWS; ++r) gi[g][r] = gh[g][r] = 0.f;
  dot3(wih, H, j, P, xs, nr, gi);
  dot3(whh, H, j, PH, hs, nr, gh);

  // lane r finishes batch row r (every lane holds every warp sum)
#pragma unroll
  for (int r = 0; r < GRU_ROWS; ++r) {
    if (r == lane && r < nr) {
      float ai[3], ah[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        ai[g] = mg::round_to<T>(gi[g][r] + bih[g * H + j]);
        ah[g] = mg::round_to<T>(gh[g][r] + bhh[g * H + j]);
      }
      const float rg = sigmoidf_(ai[0] + ah[0]);
      const float zg = sigmoidf_(ai[1] + ah[1]);
      const float ng = tanhf(ai[2] + rg * ah[2]);
      const float hp = hs[r * PH + j];
      hout[(size_t)(r0 + r) * H + j] = mg::from_f<T>((1.f - zg) * ng + zg * hp);
    }
  }
}

// ------------------------------------------------------------------
// The bf16 body on the tensor cores (the design note at the top).

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int GRU_NC = 4;         // CTAs of a cluster: the K split
constexpr int GRU_MT = 16;        // hidden units of a cluster (one m16 tile)
constexpr int GRU_UC = GRU_MT / GRU_NC;  // units whose epilogue a CTA runs
constexpr int GRU_NB = 32;        // batch rows of a block (4 n8 tiles)
constexpr int GRU_TC_WARPS = 6;   // one per (matrix, gate) tile
constexpr int GRU_TC_THREADS = GRU_TC_WARPS * 32;

// Byte offsets of a block's shared memory; kr_ih and kr_hh: the k16 steps
// of a CTA's K range of W_ih and W_hh (rank 0's, the widest).
struct GruSmem {
  int ld_ih, ld_hh;  // bf16 row strides: the K range plus 8 (odd in 16 B)
  int wi, wh, xs, hs, part, bytes;
  __host__ __device__ GruSmem(int kr_ih, int kr_hh) {
    ld_ih = 16 * kr_ih + 8;
    ld_hh = 16 * kr_hh + 8;
    wi = 0;                                   // [3 * 16][ld_ih] bf16
    wh = wi + 3 * GRU_MT * ld_ih * 2;         // [3 * 16][ld_hh]
    xs = wh + 3 * GRU_MT * ld_hh * 2;         // [GRU_NB][ld_ih]
    hs = xs + GRU_NB * ld_ih * 2;             // [GRU_NB][ld_hh]
    part = hs + GRU_NB * ld_hh * 2;           // f32 [NC][6][UC][NB]
    bytes = part + GRU_NC * GRU_TC_WARPS * GRU_UC * GRU_NB * 4;
  }
};

// k16 steps of a CTA's K range: ceil(ceil(width / 16) / GRU_NC).
__host__ __device__ inline int gru_kr(int width) {
  return ((width + 15) / 16 + GRU_NC - 1) / GRU_NC;
}

// Rows [0, n) of 16-byte chunks: columns k0 .. k0 + 16 kr - 1 of rows
// `rows` of src (row stride ld elements, `width` real columns, a multiple
// of 8 when `aligned`) into dst (row stride ldd), asynchronously; columns
// past width and rows with !row_in are zero.
__device__ __forceinline__ void gru_stage(char* dst, int ldd, const bf16* src,
                                          int ld, int width, int k0, int kr,
                                          int n, int row0, int row_end,
                                          bool aligned) {
  const int ch = 2 * kr;  // 16-byte chunks a row
  if (aligned) {
    for (int i = threadIdx.x; i < n * ch; i += blockDim.x) {
      const int r = i / ch, c = i % ch, col = k0 + 8 * c;
      const bool in = row0 + r < row_end && col < width;
      mg::tc::cp_async16(mg::tc::smem_u32(dst + (r * ldd + 8 * c) * 2),
                         src + (in ? (size_t)(row0 + r) * ld + col : 0), in);
    }
  } else {  // rows not 16-byte aligned (an input width not a multiple of 8)
    for (int i = threadIdx.x; i < n * 16 * kr; i += blockDim.x) {
      const int r = i / (16 * kr), c = i % (16 * kr), col = k0 + c;
      reinterpret_cast<bf16*>(dst)[r * ldd + c] =
          row0 + r < row_end && col < width ? src[(size_t)(row0 + r) * ld + col]
                                            : __float2bfloat16(0.f);
    }
  }
}

// ldmatrix.x2: the B fragment of one n8 tile and one k16 step
__device__ __forceinline__ void ldsm_x2(uint32_t (&d)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(d[0]), "=r"(d[1])
               : "r"(addr));
}

// One layer. grid (GRU_NC * ceil(H / 16), ceil(B / GRU_NB)), clusters of
// GRU_NC along x; x: [B, in] (row stride in), h, hout: [B, H]; wih [3H,
// P], whh [3H, PH] (zero-padded rows); bih, bhh [3H] f32.
__global__ void __launch_bounds__(GRU_TC_THREADS)
gru_layer_tc_kernel(const bf16* __restrict__ x, int in, int P,
                    const bf16* __restrict__ h, bf16* __restrict__ hout,
                    const bf16* __restrict__ wih, const bf16* __restrict__ whh,
                    const float* __restrict__ bih,
                    const float* __restrict__ bhh, int B, int H, int PH) {
  extern __shared__ __align__(128) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int u0 = (blockIdx.x / GRU_NC) * GRU_MT;
  const int r0 = blockIdx.y * GRU_NB, nr = min(GRU_NB, B - r0);
  const int kr_ih = gru_kr(P), kr_hh = gru_kr(PH);
  const GruSmem S(kr_ih, kr_hh);
  // this CTA's K range of each matrix: k16 steps [rank kr, (rank + 1) kr)
  const int ns_ih = max(0, min(kr_ih, (P + 15) / 16 - rank * kr_ih));
  const int ns_hh = max(0, min(kr_hh, (PH + 15) / 16 - rank * kr_hh));
  const int k0_ih = 16 * rank * kr_ih, k0_hh = 16 * rank * kr_hh;

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the weights first (no kernel writes them): rows gate * H + u0 .. + 15
  // of both matrices, the CTA's K range
  for (int gt = 0; gt < 3; ++gt) {
    gru_stage(smem + S.wi + gt * GRU_MT * S.ld_ih * 2, S.ld_ih,
              wih + (size_t)gt * H * P, P, P, k0_ih, kr_ih, GRU_MT, u0, H,
              true);
    gru_stage(smem + S.wh + gt * GRU_MT * S.ld_hh * 2, S.ld_hh,
              whh + (size_t)gt * H * PH, PH, PH, k0_hh, kr_hh, GRU_MT, u0, H,
              true);
  }
  mg::tc::cp_async_commit();
  // the epilogue's output (unit j, row n) of this thread: its biases now,
  // its h[l] beside the staging
  static_assert(GRU_UC * GRU_NB <= GRU_TC_THREADS, "one output a thread");
  const int ul = threadIdx.x / GRU_NB, n = threadIdx.x % GRU_NB;
  const int j = u0 + rank * GRU_UC + ul;
  const bool out_live = threadIdx.x < GRU_UC * GRU_NB && n < nr && j < H;
  float bi[3] = {}, bh[3] = {};
  if (out_live)
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      bi[gt] = bih[gt * H + j];
      bh[gt] = bhh[gt * H + j];
    }
  // x is the previous layer's output
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float hp = out_live ? mg::to_f(h[(size_t)(r0 + n) * H + j]) : 0.f;
  gru_stage(smem + S.xs, S.ld_ih, x, in, in, k0_ih, kr_ih, GRU_NB, r0, B,
            in % 8 == 0);
  gru_stage(smem + S.hs, S.ld_hh, h, H, H, k0_hh, kr_hh, GRU_NB, r0, B,
            H % 8 == 0);
  mg::tc::cp_async_commit();
  mg::tc::cp_async_wait_all();
  __syncthreads();

  // warp w: tile w % 3 (gate) of W_ih (w < 3) or W_hh, its k16 steps in
  // order, for the n8 tiles of the block's live rows
  const bool hh = warp >= 3;
  const int gate = warp % 3;
  const int ld = hh ? S.ld_hh : S.ld_ih;
  const int nsteps = hh ? ns_hh : ns_ih;
  const bf16* wt = reinterpret_cast<const bf16*>(
      smem + (hh ? S.wh : S.wi) + gate * GRU_MT * ld * 2);
  const bf16* bt = reinterpret_cast<const bf16*>(smem + (hh ? S.hs : S.xs));
  const int nb = (nr + 7) / 8;
  float acc[GRU_NB / 8][4];
#pragma unroll
  for (int jt = 0; jt < GRU_NB / 8; ++jt)
    acc[jt][0] = acc[jt][1] = acc[jt][2] = acc[jt][3] = 0.f;
  for (int st = 0; st < nsteps; ++st) {
    uint32_t af[4];
    mg::tc::ldsm_x4(af, mg::tc::smem_u32(wt + (lane & 15) * ld + 16 * st
                                         + 8 * (lane >> 4)));
#pragma unroll
    for (int jt = 0; jt < GRU_NB / 8; ++jt) {
      if (jt < nb) {
        uint32_t bf[2];
        ldsm_x2(bf, mg::tc::smem_u32(bt + (8 * jt + (lane & 7)) * ld + 16 * st
                                     + 8 * ((lane >> 3) & 1)));
        mg::tc::mma(acc[jt], af, bf[0], bf[1]);
      }
    }
  }

  // the partial sums to the CTA that owns each unit: unit u (rows g and
  // g + 8 of the tile) to CTA u / GRU_UC, slot [rank][warp][u % UC][row]
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int u = g + 8 * hf;
    float* dst = cluster.map_shared_rank(
        reinterpret_cast<float*>(smem + S.part), u / GRU_UC);
    dst += ((rank * GRU_TC_WARPS + warp) * GRU_UC + u % GRU_UC) * GRU_NB;
#pragma unroll
    for (int jt = 0; jt < GRU_NB / 8; ++jt)
      if (jt < nb)
        *reinterpret_cast<float2*>(dst + 8 * jt + 2 * t4) =
            make_float2(acc[jt][2 * hf], acc[jt][2 * hf + 1]);
  }
  cluster.sync();

  // the epilogue of this CTA's units: the partials in rank order
  const float* part = reinterpret_cast<const float*>(smem + S.part);
  if (out_live) {
    float ai[3], ah[3];
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      float si = 0.f, sh = 0.f;
#pragma unroll
      for (int rk = 0; rk < GRU_NC; ++rk) {
        si += part[((rk * GRU_TC_WARPS + gt) * GRU_UC + ul) * GRU_NB + n];
        sh += part[((rk * GRU_TC_WARPS + 3 + gt) * GRU_UC + ul) * GRU_NB + n];
      }
      ai[gt] = mg::round_to<bf16>(si + bi[gt]);
      ah[gt] = mg::round_to<bf16>(sh + bh[gt]);
    }
    const float rg = sigmoidf_(ai[0] + ah[0]);
    const float zg = sigmoidf_(ai[1] + ah[1]);
    const float ng = tanhf(ai[2] + rg * ah[2]);
    hout[(size_t)(r0 + n) * H + j] = mg::from_f<bf16>((1.f - zg) * ng + zg * hp);
  }
}

// Shared memory of the tensor-core body's blocks for a layer input of
// `in` columns (the largest of a step: both matrices' K ranges).
inline int gru_tc_smem(int in, int H) {
  return GruSmem(gru_kr((in + 7) / 8 * 8), gru_kr((H + 7) / 8 * 8)).bytes;
}

// TC picks the body: the tensor-core kernel (bf16 only) or the CUDA-core
// one. By default the dtype picks it.
template <typename T, bool TC = std::is_same<T, __nv_bfloat16>::value>
int launch_step(int num_layers, const void* x, int in, const void* h,
                void* hout, const void* const* wih, const void* const* whh,
                const void* const* bih, const void* const* bhh, int B, int H,
                cudaStream_t stream) {
  const int PH = (H + 7) / 8 * 8;
  cudaError_t err;
  if constexpr (TC) {
    static_assert(std::is_same<T, __nv_bfloat16>::value,
                  "the tensor-core body takes bf16");
    const int smem = gru_tc_smem(in > H ? in : H, H);
    if ((err = cudaFuncSetAttribute(gru_layer_tc_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem)) != cudaSuccess)
      return (int)err;
    // programmatic dependent launch (each layer stages its weights before
    // it waits for the previous one) and a cluster of GRU_NC CTAs
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[0].val.programmaticStreamSerializationAllowed = 1;
    attrs[1].id = cudaLaunchAttributeClusterDimension;
    attrs[1].val.clusterDim.x = GRU_NC;
    attrs[1].val.clusterDim.y = 1;
    attrs[1].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(GRU_NC * ((H + GRU_MT - 1) / GRU_MT),
                       (B + GRU_NB - 1) / GRU_NB);
    cfg.blockDim = dim3(GRU_TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
    for (int li = 0; li < num_layers; ++li) {
      const int in_l = li == 0 ? in : H;
      const bf16* xl = li == 0 ? static_cast<const bf16*>(x)
                               : static_cast<const bf16*>(hout)
                                     + (size_t)(li - 1) * B * H;
      err = cudaLaunchKernelEx(
          &cfg, gru_layer_tc_kernel, xl, in_l, (in_l + 7) / 8 * 8,
          static_cast<const bf16*>(h) + (size_t)li * B * H,
          static_cast<bf16*>(hout) + (size_t)li * B * H,
          static_cast<const bf16*>(wih[li]), static_cast<const bf16*>(whh[li]),
          static_cast<const float*>(bih[li]), static_cast<const float*>(bhh[li]),
          B, H, PH);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
  } else {
    const dim3 grid((H + GRU_WARPS - 1) / GRU_WARPS,
                    (B + GRU_ROWS - 1) / GRU_ROWS);
    for (int li = 0; li < num_layers; ++li) {
      const int in_l = li == 0 ? in : H;
      const int P = (in_l + 7) / 8 * 8;
      const size_t smem = (size_t)GRU_ROWS * (P + PH) * sizeof(float);
      if (smem > 48 * 1024) {  // above the default: opt in (up to 227 KB)
        err = cudaFuncSetAttribute(gru_layer_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
      const T* xl = li == 0 ? static_cast<const T*>(x)
                            : static_cast<const T*>(hout) + (size_t)(li - 1) * B * H;
      gru_layer_kernel<T><<<grid, GRU_WARPS * 32, smem, stream>>>(
          xl, in_l, P, static_cast<const T*>(h) + (size_t)li * B * H,
          static_cast<T*>(hout) + (size_t)li * B * H,
          static_cast<const T*>(wih[li]), static_cast<const T*>(whh[li]),
          static_cast<const float*>(bih[li]), static_cast<const float*>(bhh[li]),
          B, H, PH);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
}

}  // namespace

// x: [B, in] layer-0 input in the model dtype; h: [L, B, H] hidden in the
// model dtype; hout: [L, B, H] the new hidden (a separate buffer: every
// layer reads its own h[l] and the layer below's hout); wih[l]: [3H, P_l]
// with P_0 = round_up(in, 8) and P_l = round_up(H, 8) above, whh[l]:
// [3H, round_up(H, 8)], rows zero-padded, in the model dtype; bih[l],
// bhh[l]: [3H] f32. Returns the first non-zero CUDA error of the L
// launches (or of raising their shared-memory limit), else 0.
extern "C" int mg_gru_step(int is_bf16, int num_layers, const void* x,
                           int in, const void* h, void* hout,
                           const void* const* wih, const void* const* whh,
                           const void* const* bih, const void* const* bhh,
                           int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_step<__nv_bfloat16>(num_layers, x, in, h, hout, wih, whh,
                                      bih, bhh, B, H, s);
  return launch_step<float>(num_layers, x, in, h, hout, wih, whh, bih, bhh,
                            B, H, s);
}
