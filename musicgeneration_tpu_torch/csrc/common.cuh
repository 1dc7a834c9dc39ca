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
// weight-only int8 values (exact in f32)
__device__ __forceinline__ float to_f(signed char v) { return (float)v; }

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

// Eight consecutive elements as loaded (16 bytes of bf16, 32 of f32),
// widened to f32 only where they are used, so a batch of loads in flight
// holds half the registers in bf16. `p` must be 16-byte aligned.
template <typename T>
struct Raw8;
template <>
struct Raw8<float> {
  float4 a, b;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 a;
};
__device__ __forceinline__ Raw8<float> load_raw8(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {q[0], q[1]};
}
__device__ __forceinline__ Raw8<__nv_bfloat16> load_raw8(
    const __nv_bfloat16* p) {
  return {*reinterpret_cast<const uint4*>(p)};
}
__device__ __forceinline__ void widen8(const Raw8<float>& r, float* o) {
  o[0] = r.a.x; o[1] = r.a.y; o[2] = r.a.z; o[3] = r.a.w;
  o[4] = r.b.x; o[5] = r.b.y; o[6] = r.b.z; o[7] = r.b.w;
}
__device__ __forceinline__ void widen8(const Raw8<__nv_bfloat16>& r,
                                       float* o) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// Eight consecutive elements as f32. `p` must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* o) {
  widen8(load_raw8(p), o);
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
