// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fwd / _attn_kernel.
//
// For q [B,Hq,Sq,D] and k, v [B,Hkv,Sk,D] (Hq a multiple of Hkv; query
// head h reads kv head h / (Hq/Hkv)) it writes o [B,Hq,Sq,D], contiguous,
// in q's type:
//   s[i,j] = (q_i . k_j) * scale              scale = D^-1/2 by default
//   masked where j >= Sk, or (causal) j > i + Sk - Sq   (right-aligned)
//   o_i    = sum_j softmax_j(s[i,:]) v_j
// with an online softmax in f32 (running max m, running sum l, output
// accumulator acc), as _attn_kernel does: every input is widened to f32,
// every product and sum is f32, and the output is rounded to q's type once
// (round to nearest even).  There is no TF32 and no tensor-core path: the
// f32 case is held to 3e-5.
//
// What bounds it: operations.  Causal attention at the serving path's
// [4,32,2048,128] bf16 does 1.4e11 FLOP over 1.7e8 bytes, some 800 FLOP a
// byte, far above the card's ridge point.  This first kernel runs them on
// the f32 cores (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16);
// the design keeps those cores fed from shared memory:
// * one thread block owns one (b, hq, tile of 64 query rows) and walks the
//   key tiles itself, with m, l and acc in registers.  On the TPU the key
//   axis was a sequential grid dimension carrying them in VMEM scratch;
//   blocks on Hopper run in no order, so nothing crosses blocks.  The sum
//   order is fixed and there are no atomics: a prefill is deterministic;
// * 256 threads: a thread owns 4 query rows and, of each 64-key tile, 4
//   score columns (16 scores: 8 shared-memory loads feed 16 FMAs) and D/16
//   output columns.  The 16 threads that share a row are one half-warp, so
//   the row max and row sum are shuffle reductions, no shared memory;
// * the Q tile stays in shared memory for the whole walk; K and V tiles
//   are loaded once per tile and widened to f32 there.  Q and K rows are
//   padded by one word so that the 16 key columns a half-warp reads fall in
//   16 banks;
// * the key tiles are walked from 0 upward and the walk stops at the last
//   tile any row of the block can see (the causal skip of _attn_kernel's
//   pl.when).  Walking upward matters: masked scores are -1e30, as in the
//   TPU kernel, and every row (Sq <= Sk) sees key 0 in the first tile, so
//   its running max is a real score before any wholly masked tile comes;
//   a masked score's probability is set to 0 outright besides;
// * heavy query tiles (late rows see more keys) are launched first;
// * any Sq and Sk: the ragged tails are masked (the TPU kernel needed the
//   block sizes to divide them); q, k and v are read through their element
//   strides (the model hands over transposed views, which are not copied),
//   with stride 1 along D; all offsets are 64-bit.
// l == 0 (no key seen) divides by 1, as _attn_kernel's guard does.
// Causal with Sq > Sk is refused by the wrapper: rows would see no key.
// Shared memory is dynamic (209 KiB at D = 256), set per instantiation with
// cudaFuncSetAttribute; the launch's error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // kBlockQ / (kThreads / 16)
constexpr int kColsPerThread = 4;  // kBlockK / 16
constexpr float kNegInf = -1e30f;  // _attn_kernel's NEG_INF

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Strides {
  int64_t b, h, s;  // elements; the stride along D is 1
};

// Copies rows [row0, row0 + kBlockQ or kBlockK) of one head into shared
// memory as f32 with a row pitch of `pitch` floats; rows at or past `rows`
// are zero.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int pitch,
                                          const T* __restrict__ src,
                                          int64_t row_stride, int64_t row0,
                                          int64_t rows) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const int64_t row = row0 + r;
    dst[r * pitch + d] =
        row < rows ? to_f32(src[row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int heads_q, int group, int64_t seq_q,
                           int64_t seq_k, Strides qs, Strides ks, Strides vs,
                           int causal, float scale) {
  constexpr int kPitchQK = D + 1;
  constexpr int kPitchP = kBlockK + 1;
  constexpr int kOutCols = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                           // [kBlockQ][D + 1]
  float* k_s = q_s + kBlockQ * kPitchQK;       // [kBlockK][D + 1]
  float* v_s = k_s + kBlockK * kPitchQK;       // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;              // [kBlockQ][kBlockK + 1]

  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group: rows ty*4 .. ty*4+3
  const int64_t q_tile = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int64_t q0 = q_tile * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads_q;
  const int h = bh - b * heads_q;
  const int hk = h / group;
  const int64_t offset = seq_k - seq_q;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  // keys this block can see: all of them, or (causal) up to its last row's
  int64_t k_end = seq_k;
  if (causal) {
    const int64_t last_row = min64(q0 + kBlockQ, seq_q) - 1;
    k_end = min64(seq_k, last_row + offset + 1);
  }
  const int64_t k_tiles = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  load_tile<T, D, kBlockQ>(q_s, kPitchQK, qp, qs.s, q0, seq_q);

  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.0f;
  }

  for (int64_t t = 0; t < k_tiles; ++t) {
    const int64_t k0 = t * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D, kBlockK>(k_s, kPitchQK, kp, ks.s, k0, seq_k);
    load_tile<T, D, kBlockK>(v_s, D, vp, vs.s, k0, seq_k);
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16*j of this tile
    float s[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = q_s[(ty * kRowsPerThread + i) * kPitchQK + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = k_s[(tx + 16 * j) * kPitchQK + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      const int64_t q_pos = q0 + r + offset;
      bool ok[kColsPerThread];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int64_t k_pos = k0 + tx + 16 * j;
        ok[j] = k_pos < seq_k && (!causal || k_pos <= q_pos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      row_max = half_warp_max(row_max);
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        row_sum += p;
        p_s[r * kPitchP + tx + 16 * j] = p;
      }
      row_sum = half_warp_sum(row_sum);
      l[i] = corr * l[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // a row's P is written and read by one half-warp

    // acc += P V: output columns tx + 16*c
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = p_s[(ty * kRowsPerThread + i) * kPitchP + kk];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const float vv = v_s[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* op = out + static_cast<int64_t>(bh) * seq_q * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = q0 + ty * kRowsPerThread + i;
    if (row >= seq_q) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kOutCols; ++c)
      store(op + row * D + tx + 16 * c, acc[i][c] / l_safe);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D +
                          kBlockQ * (kBlockK + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t batch, int heads_q, int group, int64_t seq_q,
                   int64_t seq_k, Strides qs, Strides ks, Strides vs,
                   int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((seq_q + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(batch * heads_q));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads_q, group, seq_q,
      seq_k, qs, ks, vs, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(int64_t head_dim, const void* q, const void* k,
                         const void* v, void* out, int64_t batch, int heads_q,
                         int group, int64_t seq_q, int64_t seq_k, Strides qs,
                         Strides ks, Strides vs, int causal, float scale,
                         cudaStream_t s) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, out, batch, heads_q, group, seq_q, seq_k,
                           qs, ks, vs, causal, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, out, batch, heads_q, group, seq_q, seq_k,
                           qs, ks, vs, causal, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, batch, heads_q, group, seq_q, seq_k,
                           qs, ks, vs, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, heads_q, group, seq_q, seq_k,
                            qs, ks, vs, causal, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, out, batch, heads_q, group, seq_q, seq_k,
                            qs, ks, vs, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [batch, heads_q, seq_q, head_dim], k and v [batch, heads_kv, seq_k,
// head_dim], all of one type (0 f32, 1 bf16) on the current device, read
// through the given element strides (batch, head, sequence; 1 along
// head_dim).  out [batch, heads_q, seq_q, head_dim], contiguous, same type.
// Returns the launch's cudaError_t (0 on success); it does not synchronise.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int64_t batch, int64_t heads_q,
                          int64_t heads_kv, int64_t seq_q, int64_t seq_k,
                          int64_t head_dim, int64_t q_sb, int64_t q_sh,
                          int64_t q_ss, int64_t k_sb, int64_t k_sh,
                          int64_t k_ss, int64_t v_sb, int64_t v_sh,
                          int64_t v_ss, int dtype, int causal, float scale,
                          void* stream) {
  if (batch <= 0 || heads_q <= 0 || heads_kv <= 0 || heads_q % heads_kv ||
      seq_q <= 0 || seq_k < 0 || (causal && seq_q > seq_k))
    return cudaErrorInvalidValue;
  if (batch * heads_q > 65535 || (seq_q + kBlockQ - 1) / kBlockQ > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const int hq = static_cast<int>(heads_q);
  const int group = static_cast<int>(heads_q / heads_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_typed<float>(head_dim, q, k, v, out, batch, hq, group,
                               seq_q, seq_k, qs, ks, vs, causal, scale, s);
  if (dtype == kBF16)
    return launch_typed<__nv_bfloat16>(head_dim, q, k, v, out, batch, hq,
                                       group, seq_q, seq_k, qs, ks, vs,
                                       causal, scale, s);
  return cudaErrorInvalidValue;
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
