// Cloud-masked temporal gradient accumulation (paper §V.B field
// segmentation) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/grad_mag.py:
// grad_mag_fwd / _grad_kernel.
//
// For images x [T,H,W,C] and valid v [T,H,W] (bool, one byte):
//   dx_c = (x[t,h,w+1,c] - x[t,h,w,c]) * (v[t,h,w] * v[t,h,w+1])
//   dy_c = (x[t,h+1,w,c] - x[t,h,w,c]) * (v[t,h,w] * v[t,h+1,w])
//   mag  = sqrt(sum_c dx_c^2 + sum_c dy_c^2 + eps)
//   grad_sum[h,w] = sum_t mag * v[t,h,w],  count[h,w] = sum_t v[t,h,w]
// A neighbour outside the frame counts as invalid, so its difference is 0.
// All arithmetic is f32 whatever the image type.
//
// What bounds it: memory.  Per pixel and timestep it reads 4C + 1 bytes
// (f32) and does about 8C + 8 operations, some 2 flop per byte, far below
// the card's ridge point.  The design keeps the bytes near that minimum:
// * no shifted copies: the TPU wrapper wrote four shifted copies of the
//   stack to HBM because BlockSpecs have no halo; here each thread reads
//   its own pixel and its east and south neighbours straight from the stack;
// * blocks are 32 pixels wide and 8 high, a warp owns 32 neighbouring
//   pixels of one row: its east loads fall in the cache lines its own loads
//   just brought in, and the south row is the next warp's (or the next
//   block's) own row, mostly found in L1 or L2;
// * valid stays one byte per pixel (the TPU wrapper widened it to the
//   images' type);
// * one thread owns one (h, w) and walks t = 0..T-1 in order with
//   grad_sum and count in registers: no atomics and a fixed order, so the
//   result is deterministic run to run;
// * C == 4 reads a pixel in one 16 B (f32) or 8 B (bf16) vector load;
// * offsets are 64-bit ([16, 6144, 6144, 4] holds 2.4e9 elements), the
//   grid is 1-D over blocks, and the ragged edge is masked, so any H and W
//   work (the Pallas kernel needed H % block_h == 0).
// Products and sums use the _rn intrinsics so nvcc does not contract them
// into fused multiply-adds: the rounding is that of the plain version's
// separate operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;
constexpr int kMaxChannels = 8;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int C, bool kVec>
__device__ __forceinline__ void load_pixel(const T* __restrict__ p,
                                           float (&v)[C]) {
  if constexpr (kVec && sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (kVec) {
    // bf16 -> f32 is exact: the bf16 bits are the high half of the f32.
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = to_f32(p[c]);
  }
}

template <typename T, int C, bool kVec>
__global__ void __launch_bounds__(kBlockW * kBlockH)
    grad_mag_kernel(const T* __restrict__ x, const uint8_t* __restrict__ valid,
                    float* __restrict__ grad_sum, float* __restrict__ count,
                    int64_t steps, int64_t height, int64_t width,
                    int64_t blocks_w, float eps) {
  const int64_t by = blockIdx.x / blocks_w;
  const int64_t bx = blockIdx.x - by * blocks_w;
  const int64_t h = by * kBlockH + threadIdx.y;
  const int64_t w = bx * kBlockW + threadIdx.x;
  if (h >= height || w >= width) return;

  const bool has_e = w + 1 < width;
  const bool has_s = h + 1 < height;
  const int64_t pixels = height * width;
  const int64_t p = h * width + w;
  const T* xp = x + p * C;
  const uint8_t* vp = valid + p;

  float gsum = 0.0f;
  float cnt = 0.0f;
#pragma unroll 2
  for (int64_t t = 0; t < steps; ++t) {
    const T* xt = xp + t * pixels * C;
    const uint8_t* vt = vp + t * pixels;
    const float v = vt[0] ? 1.0f : 0.0f;
    float a[C];
    load_pixel<T, C, kVec>(xt, a);

    float sx = 0.0f;
    if (has_e) {
      const float gate = __fmul_rn(v, vt[1] ? 1.0f : 0.0f);
      float e[C];
      load_pixel<T, C, kVec>(xt + C, e);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = __fmul_rn(__fsub_rn(e[c], a[c]), gate);
        sx = __fadd_rn(sx, __fmul_rn(d, d));
      }
    }
    float sy = 0.0f;
    if (has_s) {
      const float gate = __fmul_rn(v, vt[width] ? 1.0f : 0.0f);
      float s[C];
      load_pixel<T, C, kVec>(xt + width * C, s);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = __fmul_rn(__fsub_rn(s[c], a[c]), gate);
        sy = __fadd_rn(sy, __fmul_rn(d, d));
      }
    }
    // IEEE sqrt (no fast math): eps stays inside, so a valid pixel whose
    // neighbours are all invalid still adds sqrt(eps)
    const float mag = sqrtf(__fadd_rn(__fadd_rn(sx, sy), eps));
    gsum = __fadd_rn(gsum, __fmul_rn(mag, v));
    cnt = __fadd_rn(cnt, v);
  }
  grad_sum[p] = gsum;
  count[p] = cnt;
}

template <typename T, int C>
void launch_c(const void* x, const uint8_t* v, float* g, float* n,
              int64_t steps, int64_t height, int64_t width, bool vec,
              float eps, cudaStream_t stream) {
  const int64_t blocks_w = (width + kBlockW - 1) / kBlockW;
  const int64_t blocks_h = (height + kBlockH - 1) / kBlockH;
  const dim3 grid(static_cast<unsigned>(blocks_w * blocks_h));
  const dim3 block(kBlockW, kBlockH);
  const T* xp = static_cast<const T*>(x);
  if constexpr (C == 4) {
    if (vec) {
      grad_mag_kernel<T, 4, true><<<grid, block, 0, stream>>>(
          xp, v, g, n, steps, height, width, blocks_w, eps);
      return;
    }
  }
  grad_mag_kernel<T, C, false><<<grid, block, 0, stream>>>(
      xp, v, g, n, steps, height, width, blocks_w, eps);
}

template <typename T>
cudaError_t launch_typed(const void* x, const uint8_t* v, float* g, float* n,
                         int64_t steps, int64_t height, int64_t width,
                         int64_t channels, bool vec, float eps,
                         cudaStream_t s) {
  switch (channels) {
    case 1: launch_c<T, 1>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 2: launch_c<T, 2>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 3: launch_c<T, 3>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 4: launch_c<T, 4>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 5: launch_c<T, 5>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 6: launch_c<T, 6>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 7: launch_c<T, 7>(x, v, g, n, steps, height, width, vec, eps, s); break;
    case 8: launch_c<T, 8>(x, v, g, n, steps, height, width, vec, eps, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// images x [steps, height, width, channels] (f32 or bf16), valid
// [steps, height, width] one byte each (0 or 1), grad_sum and count
// [height, width] f32, all contiguous on the current device.  Returns the
// launch's cudaError_t (0 on success); it does not synchronise.
int repro_grad_mag(const void* x, const void* valid, void* grad_sum,
                   void* count, int64_t steps, int64_t height, int64_t width,
                   int64_t channels, int x_dtype, float eps, void* stream) {
  if (height <= 0 || width <= 0 || steps < 0 || channels < 1 ||
      channels > kMaxChannels)
    return cudaErrorInvalidValue;
  const int64_t blocks = ((width + kBlockW - 1) / kBlockW) *
                         ((height + kBlockH - 1) / kBlockH);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t vec_bytes = x_dtype == kF32 ? 16 : 8;
  const bool vec = channels == 4 &&
                   reinterpret_cast<uintptr_t>(x) % vec_bytes == 0;
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* g = static_cast<float*>(grad_sum);
  float* n = static_cast<float*>(count);
  if (x_dtype == kF32)
    return launch_typed<float>(x, v, g, n, steps, height, width, channels,
                               vec, eps, s);
  if (x_dtype == kBF16)
    return launch_typed<__nv_bfloat16>(x, v, g, n, steps, height, width,
                                       channels, vec, eps, s);
  return cudaErrorInvalidValue;
}

const char* repro_grad_mag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
