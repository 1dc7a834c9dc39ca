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
// are packed (layer 0's input is 308 wide for EventMelodyRNN), so a
// warp reads every row with 16-byte loads, neighbouring lanes on
// neighbouring addresses.
//
// Design for this card: one launch per layer (the layers depend on each
// other), on the current stream. A block of GRU_WARPS warps stages the
// x and h[l] rows of up to GRU_ROWS batch rows in shared memory as f32
// (zero-padded to the packed width); each warp owns one hidden unit j
// and computes its six dot products (rows j, H + j, 2H + j of both
// matrices) for every staged batch row, reduces them across the warp
// and applies the gate epilogue in registers, so gi and gh never touch
// device memory. Larger batches take more blocks along grid.y; each
// re-reads the layer's weights, from L2 after the first.
//
// What bounds it: at full width (H 512, 3 layers, in 308 or 512, B <= 64)
// the step must read the weights once, 8.8-9.4 MB in bf16 (2.6-2.8 us at
// 3.35 TB/s) and does 2 * B * 3H * (in + H) * L operations, far below the
// card's rate: bytes bound it. The weights fit in the 50 MB L2, so a
// decode loop reads them from L2 after the first step. The three
// launches and the host's work between steps cost more than the bytes;
// one persistent launch or a CUDA graph is the next step.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int GRU_WARPS = 4;  // hidden units per block, one per warp
constexpr int GRU_ROWS = 8;   // batch rows staged per block

__device__ __forceinline__ float sigmoidf_(float v) {
  return 1.0f / (1.0f + expf(-v));
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
  for (int i = threadIdx.x; i < GRU_ROWS * P; i += blockDim.x) {
    const int r = i / P, k = i % P;
    xs[i] = (r < nr && k < in) ? mg::to_f(x[(size_t)(r0 + r) * in + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < GRU_ROWS * PH; i += blockDim.x) {
    const int r = i / PH, k = i % PH;
    hs[i] = (r < nr && k < H) ? mg::to_f(h[(size_t)(r0 + r) * H + k]) : 0.f;
  }
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

template <typename T>
int launch_step(int num_layers, const void* x, int in, const void* h,
                void* hout, const void* const* wih, const void* const* whh,
                const void* const* bih, const void* const* bhh, int B, int H,
                cudaStream_t stream) {
  const int PH = (H + 7) / 8 * 8;
  const dim3 grid((H + GRU_WARPS - 1) / GRU_WARPS,
                  (B + GRU_ROWS - 1) / GRU_ROWS);
  for (int li = 0; li < num_layers; ++li) {
    const int in_l = li == 0 ? in : H;
    const int P = (in_l + 7) / 8 * 8;
    const size_t smem = (size_t)GRU_ROWS * (P + PH) * sizeof(float);
    cudaError_t err;
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
