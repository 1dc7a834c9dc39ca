// Helpers shared by the port's hand-written kernels (sm_90a).
//
// Every kernel computes in f32 and stores in the model dtype T (float or
// __nv_bfloat16). `round_to<T>` is the model-dtype round trip the JAX
// kernels write as `y.astype(io_dtype).astype(jnp.float32)`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mg {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Eight consecutive elements as f32. `p` must be 16-byte aligned.
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; `red` holds one float per warp. Every thread of
// the block must call them, and gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // `red` may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  return s;
}
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return m;
}

}  // namespace mg
