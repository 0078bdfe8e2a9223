// Weighted temporal composite (paper §V.C) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/composite.py:
// composite_fwd / _composite_kernel.
//
//   out[h,w,c] = sum_t w[t,h,w] * x[t,h,w,c] / (sum_t w[t,h,w] + eps)
//
// Sums are f32 whatever the input type; the output takes the images' type,
// rounded to nearest.  Images are f32 or bf16; weights are f32 or the
// images' type.
//
// What bounds it: memory.  Every input byte is read once and each image
// element costs one multiply-add, about 0.5 flop per byte in f32, far below
// the card's ridge point.  The design keeps the bytes to that minimum and
// the loads wide:
// * one thread owns one (h, w) pixel and walks t = 0..T-1 in order, with
//   num[C] and den in registers: no [T,H,W,C] intermediate, no shared
//   memory, no atomics, and a fixed summation order, so the result is
//   deterministic run to run;
// * neighbouring threads own neighbouring pixels, so a warp's weight loads
//   are 128 contiguous bytes and, for C == 4, its image loads one 16 B (f32)
//   or 8 B (bf16) vector per thread over 512 or 256 contiguous bytes;
// * the t loop is unrolled so several loads per thread are in flight;
// * the tail pixel block is masked, so any H and W are accepted (the
//   Pallas kernel needed H % block_h == 0);
// * offsets are 64-bit: [64, 4096, 4096, 4] holds more than 2^31 elements.
// A TMA-fed, pipelined version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 8;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int C>
__device__ __forceinline__ void load_pixel(const T* __restrict__ p,
                                           float (&v)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = to_f32(p[c]);
}

// C == 4: the pixel's channels in one vector load (address checked by host).
__device__ __forceinline__ void load_pixel4(const float* __restrict__ p,
                                            float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_pixel4(
    const __nv_bfloat16* __restrict__ p, float (&v)[4]) {
  // bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <typename T, typename WT, int C, bool kVec>
__global__ void __launch_bounds__(kThreads)
    composite_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                     T* __restrict__ out, int64_t steps, int64_t pixels,
                     float eps) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= pixels) return;

  float num[C];
#pragma unroll
  for (int c = 0; c < C; ++c) num[c] = 0.0f;
  float den = 0.0f;

  const T* xp = x + p * C;
  const WT* wp = w + p;
  const int64_t x_step = pixels * C;
#pragma unroll 4
  for (int64_t t = 0; t < steps; ++t) {
    const float wt = to_f32(wp[t * pixels]);
    float v[C];
    if constexpr (kVec) {
      load_pixel4(xp + t * x_step, v);
    } else {
      load_pixel<T, C>(xp + t * x_step, v);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) num[c] = fmaf(wt, v[c], num[c]);
    den += wt;
  }

  const float d = den + eps;  // IEEE division below: no fast math
  T* op = out + p * C;
#pragma unroll
  for (int c = 0; c < C; ++c) op[c] = from_f32<T>(num[c] / d);
}

template <typename T, typename WT, int C>
void launch_c(const void* x, const void* w, void* out, int64_t steps,
              int64_t pixels, bool vec, float eps, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  T* op = static_cast<T*>(out);
  if constexpr (C == 4) {
    if (vec) {
      composite_kernel<T, WT, 4, true>
          <<<blocks, kThreads, 0, stream>>>(xp, wp, op, steps, pixels, eps);
      return;
    }
  }
  composite_kernel<T, WT, C, false>
      <<<blocks, kThreads, 0, stream>>>(xp, wp, op, steps, pixels, eps);
}

template <typename T, typename WT>
cudaError_t launch_typed(const void* x, const void* w, void* out,
                         int64_t steps, int64_t pixels, int64_t channels,
                         bool vec, float eps, cudaStream_t stream) {
  switch (channels) {
    case 1: launch_c<T, WT, 1>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 2: launch_c<T, WT, 2>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 3: launch_c<T, WT, 3>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 4: launch_c<T, WT, 4>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 5: launch_c<T, WT, 5>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 6: launch_c<T, WT, 6>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 7: launch_c<T, WT, 7>(x, w, out, steps, pixels, vec, eps, stream); break;
    case 8: launch_c<T, WT, 8>(x, w, out, steps, pixels, vec, eps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// images x [steps, pixels, channels], weights w [steps, pixels], out
// [pixels, channels], all contiguous on the current device.  Returns the
// launch's cudaError_t (0 on success); it does not synchronise.
int repro_composite(const void* x, const void* w, void* out, int64_t steps,
                    int64_t pixels, int64_t channels, int x_dtype,
                    int w_dtype, float eps, void* stream) {
  if (pixels <= 0 || channels < 1 || channels > kMaxChannels || steps < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t vec_bytes = x_dtype == kF32 ? 16 : 8;
  const bool vec = channels == 4 &&
                   reinterpret_cast<uintptr_t>(x) % vec_bytes == 0;
  if (x_dtype == kF32 && w_dtype == kF32)
    return launch_typed<float, float>(x, w, out, steps, pixels, channels, vec,
                                      eps, s);
  if (x_dtype == kBF16 && w_dtype == kF32)
    return launch_typed<__nv_bfloat16, float>(x, w, out, steps, pixels,
                                              channels, vec, eps, s);
  if (x_dtype == kBF16 && w_dtype == kBF16)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(
        x, w, out, steps, pixels, channels, vec, eps, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
