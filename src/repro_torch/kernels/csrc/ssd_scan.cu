// Mamba-2 SSD (state-space duality) chunked scan, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:
// ssd_scan_fwd / _ssd_kernel.
//
// For x [B,L,H,P], dt [B,L,H] f32, a [H] f32, b and c [B,L,H,N] and an
// optional d [H] f32 it writes y [B,L,H,P], contiguous, in x's type.  Per
// (batch, head), with the state S [N,P] in f32, it computes the recurrence
//   S_t = exp(a dt_t) S_{t-1} + dt_t b_t x_t^T,   y_t = c_t^T S_t + d x_t
// chunk by chunk, as _ssd_kernel does.  For a chunk of Q tokens with
// cum = the inclusive cumulative sum of a dt over the chunk:
//   W[i,j] = (c_i . b_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i    = sum_j W[i,j] x_j + exp(cum_i) c_i^T S_in + d x_i
//   S_out  = exp(cum_Q) S_in + sum_j (b_j exp(cum_Q - cum_j) dt_j) x_j^T
// Every input is widened to f32 and every product and sum is f32; y is
// rounded to x's type once.  The D-skip is added in f32 before that
// rounding, the semantics of the plain ref.ssd_scan / ssd_scan_chunked
// (which the JAX package runs off the TPU); its Pallas route rounds y to
// bf16 first.  Both sit within the bf16 tolerance.  W's upper triangle is
// selected to 0, never multiplied by a 0/1 mask: there the exponent is
// positive and exp() may be inf.  The kernel's Q is 64 (the TPU's 128);
// the result does not depend on Q beyond rounding.
//
// What bounds it: at the serving path's layer (x [4,2048,80,64] bf16, b and
// c broadcast from [4,2048,128]) it moves 175 MB and does 5.4e10 FLOP
// counted at Q = 128 as full products: by bytes 0.05 ms, by operations
// 0.05 ms on the tensor cores but 0.8 ms on the f32 cores this first kernel
// uses.  The design keeps the f32 cores fed from shared memory:
// * one thread block owns one (batch, head, slice of PS = 32 columns of P)
//   and walks the chunks of its sequence in order, S [N, PS] in shared
//   memory.  On the TPU the chunk axis was a sequential grid dimension
//   carrying S in VMEM; blocks on Hopper run in no order, so nothing
//   crosses blocks, and there are no atomics: a run is deterministic.  The
//   columns of S are independent along P, so a P slice needs only its own
//   columns of x and S; the slices of one head repeat the c.b product and
//   the decay, which buys twice the blocks (640 at the serving layer) and
//   two blocks an SM;
// * 256 threads, four phases a chunk, each a register tile over shared
//   memory: W (4 rows x 4 columns a thread, N-long dot products), y (4
//   rows x PS/16 columns: Q-long W x plus N-long c S), b scaled by
//   exp(cum_Q - cum_j) dt_j in place (the TPU kernel's b * dec_to_end), and
//   S (4 rows of N at a time x PS/16 columns: a Q-long sum).  b and c rows
//   are padded by one word so that the 16 rows a half-warp reads fall in
//   16 banks;
// * the cumulative sum of a dt is one warp's shuffle scan;
// * b and c are read through their element strides, stride 0 along H
//   included: the model hands over b and c expanded from [B,L,N] to every
//   head, which are not copied (copies would move 2 x 168 MB a layer for
//   4 MB of data); x and dt through theirs; stride 1 along P and N;
// * any L >= 1: the last chunk is masked (dt = 0 and x, b, c = 0 past L,
//   so those tokens add nothing, and no row past L is written); the TPU
//   kernel needed L to be a multiple of its chunk.  All offsets are 64-bit.
// It takes P in {16, 32, 64, 128} and N in {8, 16, 128}.  Shared memory is
// dynamic (108 KB at N = 128), set with cudaFuncSetAttribute; the launch's
// error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // Q: tokens per chunk
constexpr int kThreads = 256;  // 16 x 16: tx = tid & 15, ty = tid >> 4
constexpr int kRows = 4;       // rows of W and y a thread owns: kChunk / 16
constexpr int kStateRows = 4;  // rows of S a thread updates at a time
constexpr int kPitchW = kChunk + 1;

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Strides {
  int64_t b, l, h;  // elements; the stride along the last dimension is 1
};

__host__ __device__ constexpr size_t smem_floats(int n, int ps) {
  return 2 * static_cast<size_t>(kChunk) * (n + 1)  // c, b
         + static_cast<size_t>(kChunk) * ps         // x
         + static_cast<size_t>(kChunk) * kPitchW    // W
         + static_cast<size_t>(n) * ps              // S
         + 4 * kChunk;                              // cum, dt, f, total
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dskip,
                    T* __restrict__ y, int64_t seq, int heads, int dim_p,
                    int dim_n, Strides xs, Strides dts, int64_t a_stride,
                    Strides bs, Strides cs, int64_t d_stride) {
  constexpr int kCols = PS / 16;  // columns of y and S a thread owns
  const int pitch_n = dim_n + 1;
  extern __shared__ float smem[];
  float* c_s = smem;                          // [Q][N + 1]
  float* b_s = c_s + kChunk * pitch_n;        // [Q][N + 1]
  float* x_s = b_s + kChunk * pitch_n;        // [Q][PS]
  float* w_s = x_s + kChunk * PS;             // [Q][Q + 1]
  float* s_s = w_s + kChunk * kPitchW;        // [N][PS]
  float* cum_s = s_s + dim_n * PS;            // [Q]
  float* dt_s = cum_s + kChunk;               // [Q]
  float* f_s = dt_s + kChunk;                 // [Q]: exp(cum_Q - cum_j) dt_j
  float* total_s = f_s + kChunk;              // [1]: cum_Q

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const float a_h = a[h * a_stride];
  const float d_h = dskip != nullptr ? dskip[h * d_stride] : 0.0f;
  const T* xp = x + bb * xs.b + h * xs.h + p0;
  const float* dtp = dt + bb * dts.b + h * dts.h;
  const T* bp = bm + bb * bs.b + h * bs.h;
  const T* cp = cm + bb * cs.b + h * cs.h;
  const int64_t y_row = static_cast<int64_t>(heads) * dim_p;
  T* yp = y + bb * seq * y_row + static_cast<int64_t>(h) * dim_p + p0;

  for (int e = tid; e < dim_n * PS; e += kThreads) s_s[e] = 0.0f;

  const int64_t chunks = (seq + kChunk - 1) / kChunk;
  for (int64_t z = 0; z < chunks; ++z) {
    const int64_t l0 = z * kChunk;
    const int rows = static_cast<int>(seq - l0 < kChunk ? seq - l0 : kChunk);

    // -- load the chunk: b, c, x widened to f32; zero past L ---------------
    for (int e = tid; e < kChunk * dim_n; e += kThreads) {
      const int r = e / dim_n;
      const int n = e - r * dim_n;
      const int64_t l = l0 + r;
      const bool ok = r < rows;
      b_s[r * pitch_n + n] = ok ? to_f32(bp[l * bs.l + n]) : 0.0f;
      c_s[r * pitch_n + n] = ok ? to_f32(cp[l * cs.l + n]) : 0.0f;
    }
    for (int e = tid; e < kChunk * PS; e += kThreads) {
      const int r = e / PS;
      const int p = e - r * PS;
      x_s[e] = r < rows ? to_f32(xp[(l0 + r) * xs.l + p]) : 0.0f;
    }
    // warp 0: dt, cum (inclusive scan of a dt, two tokens a lane), f, total
    if (tid < 32) {
      const int r0 = 2 * tid;
      const int r1 = r0 + 1;
      const float dt0 = r0 < rows ? dtp[(l0 + r0) * dts.l] : 0.0f;
      const float dt1 = r1 < rows ? dtp[(l0 + r1) * dts.l] : 0.0f;
      const float v0 = a_h * dt0;
      const float v1 = a_h * dt1;
      float incl = v0 + v1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      const float cum0 = excl + v0;
      const float cum1 = incl;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      cum_s[r0] = cum0;
      cum_s[r1] = cum1;
      dt_s[r0] = dt0;
      dt_s[r1] = dt1;
      f_s[r0] = expf(total - cum0) * dt0;
      f_s[r1] = expf(total - cum1) * dt1;
      if (tid == 0) total_s[0] = total;
    }
    __syncthreads();

    // -- W[i,j] = (c_i . b_j) exp(cum_i - cum_j) dt_j, j <= i ---------------
    // rows i = ty*4 + r, columns j = tx + 16*s
    {
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < dim_n; ++n) {
        float cv[kRows], bv[4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          cv[r] = c_s[(ty * kRows + r) * pitch_n + n];
#pragma unroll
        for (int s = 0; s < 4; ++s) bv[s] = b_s[(tx + 16 * s) * pitch_n + n];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(cv[r], bv[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ty * kRows + r;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int j = tx + 16 * s;
          w_s[i * kPitchW + j] =
              j <= i ? acc[r][s] * expf(cum_s[i] - cum_s[j]) * dt_s[j] : 0.0f;
        }
      }
    }
    __syncthreads();

    // -- y_i = sum_j W[i,j] x_j + exp(cum_i) c_i^T S_in + d x_i -------------
    // rows i = ty*4 + r, columns p = tx + 16*s
    {
      float intra[kRows][kCols], inter[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int s = 0; s < kCols; ++s) intra[r][s] = inter[r][s] = 0.0f;
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        float wv[kRows], xv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          wv[r] = w_s[(ty * kRows + r) * kPitchW + j];
#pragma unroll
        for (int s = 0; s < kCols; ++s) xv[s] = x_s[j * PS + tx + 16 * s];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int s = 0; s < kCols; ++s)
            intra[r][s] = fmaf(wv[r], xv[s], intra[r][s]);
      }
#pragma unroll 4
      for (int n = 0; n < dim_n; ++n) {
        float cv[kRows], sv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          cv[r] = c_s[(ty * kRows + r) * pitch_n + n];
#pragma unroll
        for (int s = 0; s < kCols; ++s) sv[s] = s_s[n * PS + tx + 16 * s];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int s = 0; s < kCols; ++s)
            inter[r][s] = fmaf(cv[r], sv[s], inter[r][s]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ty * kRows + r;
        if (i >= rows) continue;
        const float e = expf(cum_s[i]);
#pragma unroll
        for (int s = 0; s < kCols; ++s) {
          const int p = tx + 16 * s;
          float v = intra[r][s] + e * inter[r][s];
          if (dskip != nullptr) v += d_h * x_s[i * PS + p];
          store(yp + (l0 + i) * y_row + p, v);
        }
      }
    }
    // b_j *= exp(cum_Q - cum_j) dt_j for the state update (b is not read
    // again in this chunk before the barrier)
    for (int e = tid; e < kChunk * dim_n; e += kThreads) {
      const int r = e / dim_n;
      const int n = e - r * dim_n;
      b_s[r * pitch_n + n] *= f_s[r];
    }
    __syncthreads();

    // -- S = exp(cum_Q) S + sum_j b'_j x_j^T --------------------------------
    // rows n = ty + 16*k, columns p = tx + 16*s
    {
      const float decay = expf(total_s[0]);
      for (int k0 = 0; 16 * k0 < dim_n; k0 += kStateRows) {
        float acc[kStateRows][kCols];
        bool live[kStateRows];
#pragma unroll
        for (int k = 0; k < kStateRows; ++k) {
          live[k] = ty + 16 * (k0 + k) < dim_n;
#pragma unroll
          for (int s = 0; s < kCols; ++s) acc[k][s] = 0.0f;
        }
#pragma unroll 8
        for (int j = 0; j < kChunk; ++j) {
          float bv[kStateRows], xv[kCols];
#pragma unroll
          for (int k = 0; k < kStateRows; ++k)
            bv[k] = live[k] ? b_s[j * pitch_n + ty + 16 * (k0 + k)] : 0.0f;
#pragma unroll
          for (int s = 0; s < kCols; ++s) xv[s] = x_s[j * PS + tx + 16 * s];
#pragma unroll
          for (int k = 0; k < kStateRows; ++k)
#pragma unroll
            for (int s = 0; s < kCols; ++s)
              acc[k][s] = fmaf(bv[k], xv[s], acc[k][s]);
        }
#pragma unroll
        for (int k = 0; k < kStateRows; ++k) {
          if (!live[k]) continue;
          const int n = ty + 16 * (k0 + k);
#pragma unroll
          for (int s = 0; s < kCols; ++s) {
            float* sp = s_s + n * PS + tx + 16 * s;
            *sp = decay * *sp + acc[k][s];
          }
        }
      }
    }
    __syncthreads();  // S, b and x are read before the next chunk's loads
  }
}

template <typename T, int PS>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d, void* y,
                   int64_t batch, int64_t seq, int heads, int dim_p,
                   int dim_n, Strides xs, Strides dts, int64_t a_stride,
                   Strides bs, Strides cs, int64_t d_stride,
                   cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, PS>;
  const size_t bytes = sizeof(float) * smem_floats(dim_n, PS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(dim_p / PS),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), d, static_cast<T*>(y), seq, heads, dim_p,
      dim_n, xs, dts, a_stride, bs, cs, d_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* a,
                         const void* b, const void* c, const float* d,
                         void* y, int64_t batch, int64_t seq, int heads,
                         int dim_p, int dim_n, Strides xs, Strides dts,
                         int64_t a_stride, Strides bs, Strides cs,
                         int64_t d_stride, cudaStream_t s) {
  if (dim_p % 32 == 0)
    return launch<T, 32>(x, dt, a, b, c, d, y, batch, seq, heads, dim_p,
                         dim_n, xs, dts, a_stride, bs, cs, d_stride, s);
  return launch<T, 16>(x, dt, a, b, c, d, y, batch, seq, heads, dim_p, dim_n,
                       xs, dts, a_stride, bs, cs, d_stride, s);
}

bool supported_p(int64_t p) {
  return p == 16 || p == 32 || p == 64 || p == 128;
}

bool supported_n(int64_t n) { return n == 8 || n == 16 || n == 128; }

}  // namespace

extern "C" {

// x [batch, seq, heads, dim_p] (0 f32, 1 bf16), dt [batch, seq, heads] f32,
// a [heads] f32, b and c [batch, seq, heads, dim_n] of x's type, d [heads]
// f32 or null, all on the current device and read through the given
// element strides (batch, sequence, head; 1 along dim_p and dim_n; b and c
// may have stride 0 along heads).  y [batch, seq, heads, dim_p], contiguous,
// x's type.  Returns the launch's cudaError_t (0 on success); it does not
// synchronise.
int repro_ssd_scan(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d, void* y,
                   int64_t batch, int64_t seq, int64_t heads, int64_t dim_p,
                   int64_t dim_n, int64_t x_sb, int64_t x_sl, int64_t x_sh,
                   int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                   int64_t a_stride, int64_t b_sb, int64_t b_sl, int64_t b_sh,
                   int64_t c_sb, int64_t c_sl, int64_t c_sh, int64_t d_stride,
                   int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535 || !supported_p(dim_p) || !supported_n(dim_n))
    return cudaErrorInvalidValue;
  const Strides xs{x_sb, x_sl, x_sh}, dts{dt_sb, dt_sl, dt_sh},
      bs{b_sb, b_sl, b_sh}, cs{c_sb, c_sl, c_sh};
  const int hh = static_cast<int>(heads);
  const int p = static_cast<int>(dim_p);
  const int n = static_cast<int>(dim_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_typed<float>(x, dt, a, b, c, d, y, batch, seq, hh, p, n,
                               xs, dts, a_stride, bs, cs, d_stride, s);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16>(x, dt, a, b, c, d, y, batch, seq, hh,
                                       p, n, xs, dts, a_stride, bs, cs,
                                       d_stride, s);
  return cudaErrorInvalidValue;
}

const char* repro_ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
