// Grouped-query flash attention, backward, for Hopper (sm_90a).
//
// The JAX package has no backward kernel: off the TPU, jax.value_and_grad
// (repro/train/train_step.py:66) differentiates the plain attention that
// repro/kernels/ops.py:47-50 picks there.  This is the backward of
// csrc/flash_attention.cu's forward (which replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py: flash_attention_fwd / _attn_kernel),
// so that training on the card runs the hand-written forward and has a
// gradient for it.
//
// For q [B,Hq,Sq,D], k and v [B,Hkv,Sk,D] (read through their strides, as
// the forward reads them; query head h reads kv head h / (Hq/Hkv)), the
// forward's o and the incoming gradient do [B,Hq,Sq,D] (contiguous), and
// the forward's row log-sum-exp lse [B,Hq,Sq] (f32, natural log):
//   s_ij  = scale q_i . k_j, masked where j >= Sk or (causal) j > i + Sk - Sq
//   P_ij  = exp(s_ij - lse_i)          (recomputed; 0 where masked)
//   D_i   = sum_d do_id o_id           (written to delta [B,Hq,Sq] f32)
//   dP_ij = do_i . v_j,  dS_ij = P_ij (dP_ij - D_i)   (f32)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in group} sum_i dS_ij q_i
//   dv_j  = sum_{h in group} sum_i P_ij do_i
// dq, dk and dv are written contiguous in the inputs' type.  Two kernels run
// one after the other on the stream, with no atomics, so the result is
// deterministic:
// * the dq kernel: one block per (b, hq, tile of query rows).  It first
//   computes D for its rows (and writes it), then walks the key tiles its
//   rows can see (the forward's causal skip);
// * the dkv kernel: one block per (b, hkv, tile of keys).  It walks the
//   group's query heads and, in each, the query tiles that can see its
//   keys, with dk and dv accumulating in registers: the sum over the group
//   stays inside the block.
//
// What bounds it: operations.  The five products (S, dP, dV, dK, dQ) are
// 10 D FLOP per visible (query, key) pair; at the training layer, [2, 32,
// 4096, 128] bf16 with Hkv 8, causal, 6.9e11 FLOP over 0.4 GB.  The design
// is the simple one; S and dP are computed in both kernels (14 D FLOP a
// pair in all).
//
// bf16 at D <= 128 (flash_bwd_*_kernel_bf16): the bf16 tensor cores through
// mma.sync m16n8k16 with f32 accumulation.  Four warps, 16 rows each, over
// tiles of 64 x 64; Q, dO, K and V tiles in shared memory (rows padded by
// 16 bytes against bank conflicts, loaded 16 bytes a thread); P and dS are
// rounded to bf16 as the A operand of the dV, dK and dQ products (the
// accumulator fragment of two 8-column tiles is the A fragment of one
// 16-deep step).  No TMA, no wgmma, no pipelining: later work.
//
// f32 at every D, and bf16 at D = 256 (flash_bwd_*_kernel_f32<T, D>): the
// f32 cores, 256 threads, operands widened to f32 in shared memory (rows
// padded by one word); tiles of 64 (32 at D = 256, for registers and shared
// memory).  Each thread owns R = tile/16 rows, R columns of a score tile
// and D/16 output columns; the 16 threads of a row are one half-warp.
//
// Shared memory is dynamic, set per instantiation; each launch's error is
// returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2E = 1.4426950408889634f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, h, s;  // elements; the stride along D is 1
};

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// whether query row `row` sees key `key` (both in range checked)
__device__ __forceinline__ bool visible(int64_t row, int64_t key,
                                        int64_t seq_q, int64_t seq_k,
                                        int causal) {
  return row < seq_q && key < seq_k && (!causal || key <= row + seq_k - seq_q);
}

// ---------------------------------------------------------------------------
// f32 cores (f32 at every D; bf16 at D = 256)
// ---------------------------------------------------------------------------
constexpr int kF32Threads = 256;

template <int D>
struct F32Tile {
  static constexpr int kT = D == 256 ? 32 : 64;  // rows and columns
  static constexpr int kR = kT / 16;             // rows (and columns) a thread
  static constexpr int kOut = D / 16;            // output columns a thread
  static constexpr int kPitch = D + 1;
  static constexpr int kPitchS = kT + 1;
};

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [row0, row0 + kRows) of one head into shared memory as f32, row
// pitch `pitch`; rows at or past `rows` are zero
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_f32(float* __restrict__ dst, int pitch,
                                         const T* __restrict__ src,
                                         int64_t row_stride, int64_t row0,
                                         int64_t rows) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * D; e += kF32Threads) {
    const int r = e / D;
    const int d = e - r * D;
    const int64_t row = row0 + r;
    dst[r * pitch + d] = row < rows ? to_f(src[row * row_stride + d]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ o,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            T* __restrict__ dq, float* __restrict__ delta,
                            int heads_q, int group, int64_t seq_q,
                            int64_t seq_k, Strides qs, Strides ks,
                            Strides vs, int causal, float scale) {
  using F = F32Tile<D>;
  constexpr int kT = F::kT, kR = F::kR, kOut = F::kOut;
  constexpr int kP = F::kPitch, kPS = F::kPitchS;
  extern __shared__ float smem[];
  float* q_s = smem;              // [kT][D + 1]
  float* do_s = q_s + kT * kP;    // [kT][D + 1]
  float* k_s = do_s + kT * kP;    // [kT][D + 1]
  float* v_s = k_s + kT * kP;     // [kT][D + 1]
  float* ds_s = v_s + kT * kP;    // [kT][kT + 1]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kT;
  const int bh = blockIdx.y;
  const int b = bh / heads_q;
  const int h = bh - b * heads_q;
  const int hk = h / group;
  const int64_t offset = seq_k - seq_q;
  const int64_t row_base = static_cast<int64_t>(bh) * seq_q;

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;

  load_f32<T, D, kT>(q_s, kP, qp, qs.s, q0, seq_q);
  load_f32<T, D, kT>(do_s, kP, dout + row_base * D, D, q0, seq_q);
  __syncthreads();

  // D_i of this thread's rows, from o as the forward rounded it
  float lse_r[kR], delta_r[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int r = ty * kR + i;
    const int64_t row = q0 + r;
    float part = 0.0f;
    if (row < seq_q) {
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const int col = tx + 16 * c;
        part += do_s[r * kP + col] * to_f(o[(row_base + row) * D + col]);
      }
    }
    part = half_warp_sum(part);
    delta_r[i] = part;
    lse_r[i] = row < seq_q ? lse[row_base + row] : 0.0f;
    if (tx == 0 && row < seq_q) delta[row_base + row] = part;
  }

  int64_t k_end = seq_k;
  if (causal) k_end = min64(seq_k, min64(q0 + kT, seq_q) - 1 + offset + 1);
  const int64_t k_tiles = k_end > 0 ? (k_end + kT - 1) / kT : 0;

  float acc[kR][kOut];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;

  for (int64_t t = 0; t < k_tiles; ++t) {
    const int64_t k0 = t * kT;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    load_f32<T, D, kT>(k_s, kP, kp, ks.s, k0, seq_k);
    load_f32<T, D, kT>(v_s, kP, vp, vs.s, k0, seq_k);
    __syncthreads();

    float s[kR][kR], dp[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kR], dov[kR], kv[kR], vv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        qv[i] = q_s[(ty * kR + i) * kP + d];
        dov[i] = do_s[(ty * kR + i) * kP + d];
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        kv[j] = k_s[(tx + 16 * j) * kP + d];
        vv[j] = v_s[(tx + 16 * j) * kP + d];
      }
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = ty * kR + i;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int64_t key = k0 + tx + 16 * j;
        const float p = visible(q0 + r, key, seq_q, seq_k, causal)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.0f;
        ds_s[r * kPS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncwarp();  // a row's dS is written and read by one half-warp

    // acc += dS K: output columns tx + 16 c
#pragma unroll 4
    for (int kk = 0; kk < kT; ++kk) {
      float dsv[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) dsv[i] = ds_s[(ty * kR + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float kval = k_s[kk * kP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < kR; ++i) acc[i][c] = fmaf(dsv[i], kval, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int64_t row = q0 + ty * kR + i;
    if (row >= seq_q) continue;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      dq[(row_base + row) * D + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_kernel_f32(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv,
                             int heads_q, int heads_kv, int group,
                             int64_t seq_q, int64_t seq_k, Strides qs,
                             Strides ks, Strides vs, int causal,
                             float scale) {
  using F = F32Tile<D>;
  constexpr int kT = F::kT, kR = F::kR, kOut = F::kOut;
  constexpr int kP = F::kPitch, kPS = F::kPitchS;
  extern __shared__ float smem[];
  float* k_s = smem;              // [kT][D + 1]
  float* v_s = k_s + kT * kP;     // [kT][D + 1]
  float* q_s = v_s + kT * kP;     // [kT][D + 1]
  float* do_s = q_s + kT * kP;    // [kT][D + 1]
  float* p_s = do_s + kT * kP;    // [kT][kT + 1]
  float* ds_s = p_s + kT * kPS;   // [kT][kT + 1]
  float* lse_s = ds_s + kT * kPS; // [kT]
  float* dl_s = lse_s + kT;       // [kT]

  const int tx = threadIdx.x & 15;  // query columns tx + 16 j
  const int ty = threadIdx.x >> 4;  // key rows ty * kR + i
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kT;
  const int bh = blockIdx.y;
  const int b = bh / heads_kv;
  const int hk = bh - b * heads_kv;
  const int64_t offset = seq_k - seq_q;

  load_f32<T, D, kT>(k_s, kP, k + b * ks.b + hk * ks.h, ks.s, k0, seq_k);
  load_f32<T, D, kT>(v_s, kP, v + b * vs.b + hk * vs.h, vs.s, k0, seq_k);

  // the first query row that sees key k0
  const int64_t q_first = causal ? max64(0, k0 - offset) : 0;
  const int64_t qt_begin = q_first / kT;
  const int64_t qt_end = (seq_q + kT - 1) / kT;

  float dk_acc[kR][kOut], dv_acc[kR][kOut];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kOut; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const int64_t row_base = (static_cast<int64_t>(b) * heads_q + h) * seq_q;
    const T* qp = q + b * qs.b + h * qs.h;
    for (int64_t qt = qt_begin; qt < qt_end; ++qt) {
      const int64_t q0 = qt * kT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_f32<T, D, kT>(q_s, kP, qp, qs.s, q0, seq_q);
      load_f32<T, D, kT>(do_s, kP, dout + row_base * D, D, q0, seq_q);
      for (int e = threadIdx.x; e < kT; e += kF32Threads) {
        const int64_t row = q0 + e;
        lse_s[e] = row < seq_q ? lse[row_base + row] : 0.0f;
        dl_s[e] = row < seq_q ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();

      float s[kR][kR], dp[kR][kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[kR], vv[kR], qv[kR], dov[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          kv[i] = k_s[(ty * kR + i) * kP + d];
          vv[i] = v_s[(ty * kR + i) * kP + d];
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          qv[j] = q_s[(tx + 16 * j) * kP + d];
          dov[j] = do_s[(tx + 16 * j) * kP + d];
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int r = ty * kR + i;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int qi = tx + 16 * j;
          const float p = visible(q0 + qi, k0 + r, seq_q, seq_k, causal)
                              ? expf(s[i][j] * scale - lse_s[qi])
                              : 0.0f;
          p_s[r * kPS + qi] = p;
          ds_s[r * kPS + qi] = p * (dp[i][j] - dl_s[qi]);
        }
      }
      __syncwarp();  // a key row's P and dS are written and read by one
                     // half-warp

      // dv += P^T dO, dk += dS^T Q: output columns tx + 16 c
#pragma unroll 4
      for (int qq = 0; qq < kT; ++qq) {
        float pv[kR], dsv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          pv[i] = p_s[(ty * kR + i) * kPS + qq];
          dsv[i] = ds_s[(ty * kR + i) * kPS + qq];
        }
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          const float dov = do_s[qq * kP + tx + 16 * c];
          const float qv = q_s[qq * kP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int64_t key = k0 + ty * kR + i;
    if (key >= seq_k) continue;
    const int64_t base = (static_cast<int64_t>(bh) * seq_k + key) * D;
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      dk[base + tx + 16 * c] = from_f<T>(dk_acc[i][c] * scale);
      dv[base + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta,
                       int64_t batch, int heads_q, int heads_kv, int group,
                       int64_t seq_q, int64_t seq_k, Strides qs, Strides ks,
                       Strides vs, int causal, float scale,
                       cudaStream_t stream) {
  using F = F32Tile<D>;
  constexpr int kT = F::kT;
  constexpr size_t dq_bytes =
      sizeof(float) * (4 * kT * F::kPitch + kT * F::kPitchS);
  constexpr size_t dkv_bytes =
      sizeof(float) * (4 * kT * F::kPitch + 2 * kT * F::kPitchS + 2 * kT);
  auto dq_kernel = flash_bwd_dq_kernel_f32<T, D>;
  auto dkv_kernel = flash_bwd_dkv_kernel_f32<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const dim3 grid_q(static_cast<unsigned>((seq_q + kT - 1) / kT),
                    static_cast<unsigned>(batch * heads_q));
  dq_kernel<<<grid_q, kF32Threads, dq_bytes, stream>>>(
      qt, kt, vt, static_cast<const T*>(o), dot, lse, static_cast<T*>(dq),
      delta, heads_q, group, seq_q, seq_k, qs, ks, vs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(static_cast<unsigned>((seq_k + kT - 1) / kT),
                    static_cast<unsigned>(batch * heads_kv));
  dkv_kernel<<<grid_k, kF32Threads, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      heads_q, heads_kv, group, seq_q, seq_k, qs, ks, vs, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 tensor cores (mma.sync), D <= 128
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;  // four warps, 16 rows each
constexpr int kMmaTile = 64;

template <int D>
struct MmaTile {
  static constexpr int kPitch = D + 8;  // bf16 elements: rows 16-byte padded
  static constexpr int kTileElems = kMmaTile * kPitch;
  static constexpr size_t kSmemBytes =
      4 * kTileElems * sizeof(__nv_bfloat16) + 2 * kMmaTile * sizeof(float);
  static_assert(D % 16 == 0 && D <= 128, "head_dim");
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c[16 x 8] += a[16 x 16] b[16 x 8]: bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows r0.., depth k0.. of a row-major tile x[row][k]
template <int P>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* x, int r0, int k0,
                                       int g, int t) {
  a[0] = ld32(x + (r0 + g) * P + k0 + 2 * t);
  a[1] = ld32(x + (r0 + g + 8) * P + k0 + 2 * t);
  a[2] = ld32(x + (r0 + g) * P + k0 + 8 + 2 * t);
  a[3] = ld32(x + (r0 + g + 8) * P + k0 + 8 + 2 * t);
}

// The B fragment (depth k0.., columns n0..) where B(k, n) = x[n][k]
template <int P>
__device__ __forceinline__ void b_frag_nk(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* x, int n0,
                                          int k0, int g, int t) {
  b0 = ld32(x + (n0 + g) * P + k0 + 2 * t);
  b1 = ld32(x + (n0 + g) * P + k0 + 8 + 2 * t);
}

// The B fragment (depth k0.., columns n0..) where B(k, n) = x[k][n]
template <int P>
__device__ __forceinline__ void b_frag_kn(uint32_t& b0, uint32_t& b1,
                                          const __nv_bfloat16* x, int k0,
                                          int n0, int g, int t) {
  const __nv_bfloat16* c = x + n0 + g;
  b0 = pack2(c[(k0 + 2 * t) * P], c[(k0 + 2 * t + 1) * P]);
  b1 = pack2(c[(k0 + 2 * t + 8) * P], c[(k0 + 2 * t + 9) * P]);
}

// The 16 x 16 A fragments of a warp's 16 x 64 f32 accumulator tiles
// (eight 16 x 8 n-tiles), rounded to bf16: k-step kk is n-tiles 2kk, 2kk+1
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4][4],
                                         const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_f2(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_f2(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_f2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_f2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// rows [row0, row0 + 64) of one head into a padded bf16 tile, 16 bytes a
// thread; rows at or past `rows` are zero.  src and row_stride are 16-byte
// aligned (the wrapper checks q, k and v; o and do are contiguous).
template <int D>
__device__ __forceinline__ void load_bf16(__nv_bfloat16* __restrict__ dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          int64_t row_stride, int64_t row0,
                                          int64_t rows) {
  constexpr int kChunks = D / 8;
  constexpr int kP = MmaTile<D>::kPitch;
#pragma unroll 4
  for (int e = threadIdx.x; e < kMmaTile * kChunks; e += kMmaThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const int64_t row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < rows)
      val = *reinterpret_cast<const uint4*>(src + row * row_stride + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * kP + 8 * c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             __nv_bfloat16* __restrict__ dq,
                             float* __restrict__ delta, int heads_q,
                             int group, int64_t seq_q, int64_t seq_k,
                             Strides qs, Strides ks, Strides vs, int causal,
                             float scale) {
  using M = MmaTile<D>;
  constexpr int kP = M::kPitch;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + M::kTileElems;
  __nv_bfloat16* k_s = do_s + M::kTileElems;
  __nv_bfloat16* v_s = k_s + M::kTileElems;
  float* dl_s = reinterpret_cast<float*>(v_s + M::kTileElems);
  float* lse_s = dl_s + kMmaTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t q0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kMmaTile;
  const int bh = blockIdx.y;
  const int b = bh / heads_q;
  const int h = bh - b * heads_q;
  const int hk = h / group;
  const int64_t offset = seq_k - seq_q;
  const int64_t row_base = static_cast<int64_t>(bh) * seq_q;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;

  load_bf16<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, seq_q);
  load_bf16<D>(do_s, dout + row_base * D, D, q0, seq_q);
  __syncthreads();

  // D_i of the warp's 16 rows, D spread over the lanes
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * warp + rr;
    const int64_t row = q0 + r;
    float part = 0.0f;
    if (row < seq_q)
      for (int d = lane; d < D; d += 32)
        part += __bfloat162float(do_s[r * kP + d]) *
                __bfloat162float(o[(row_base + row) * D + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      dl_s[r] = part;
      lse_s[r] = row < seq_q ? lse[row_base + row] * kLog2E : 0.0f;
      if (row < seq_q) delta[row_base + row] = part;
    }
  }
  __syncwarp();
  // this thread's rows: 16 warp + g and + 8
  const float dl[2] = {dl_s[16 * warp + g], dl_s[16 * warp + g + 8]};
  const float lse2[2] = {lse_s[16 * warp + g], lse_s[16 * warp + g + 8]};
  const float scale_log2 = scale * kLog2E;

  int64_t k_end = seq_k;
  if (causal)
    k_end = min64(seq_k, min64(q0 + kMmaTile, seq_q) - 1 + offset + 1);
  const int64_t k_tiles = k_end > 0 ? (k_end + kMmaTile - 1) / kMmaTile : 0;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int64_t tile = 0; tile < k_tiles; ++tile) {
    const int64_t k0 = tile * kMmaTile;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_bf16<D>(k_s, kp, ks.s, k0, seq_k);
    load_bf16<D>(v_s, vp, vs.s, k0, seq_k);
    __syncthreads();

    // S = Q K^T and dP = dO V^T over the warp's 16 rows and 64 keys
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      a_frag<kP>(aq, q_s, 16 * warp, 16 * kk, g, t);
      a_frag<kP>(ado, do_s, 16 * warp, 16 * kk, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        b_frag_nk<kP>(b0, b1, k_s, 8 * j, 16 * kk, g, t);
        mma16816(s[j], aq, b0, b1);
        b_frag_nk<kP>(b0, b1, v_s, 8 * j, 16 * kk, g, t);
        mma16816(dp[j], ado, b0, b1);
      }
    }
    // dS = P (dP - D), P recomputed from the forward's log-sum-exp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int64_t row = q0 + 16 * warp + g + 8 * r;
        const int64_t key = k0 + 8 * j + 2 * t + (e & 1);
        const float p = visible(row, key, seq_q, seq_k, causal)
                            ? exp2f(s[j][e] * scale_log2 - lse2[r])
                            : 0.0f;
        dp[j][e] = p * (dp[j][e] - dl[r]);
      }
    uint32_t ds_a[4][4];
    acc_to_a(ds_a, dp);
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        b_frag_kn<kP>(b0, b1, k_s, 16 * kk, 8 * n, g, t);
        mma16816(acc[n], ds_a[kk], b0, b1);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = q0 + 16 * warp + g + 8 * r;
    if (row >= seq_q) continue;
    __nv_bfloat16* rp = dq + (row_base + row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(rp + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int heads_q,
                              int heads_kv, int group, int64_t seq_q,
                              int64_t seq_k, Strides qs, Strides ks,
                              Strides vs, int causal, float scale) {
  using M = MmaTile<D>;
  constexpr int kP = M::kPitch;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + M::kTileElems;
  __nv_bfloat16* q_s = v_s + M::kTileElems;
  __nv_bfloat16* do_s = q_s + M::kTileElems;
  float* lse_s = reinterpret_cast<float*>(do_s + M::kTileElems);
  float* dl_s = lse_s + kMmaTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kMmaTile;
  const int bh = blockIdx.y;
  const int b = bh / heads_kv;
  const int hk = bh - b * heads_kv;
  const int64_t offset = seq_k - seq_q;
  const float scale_log2 = scale * kLog2E;

  load_bf16<D>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, seq_k);
  load_bf16<D>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, seq_k);

  const int64_t q_first = causal ? max64(0, k0 - offset) : 0;
  const int64_t qt_begin = q_first / kMmaTile;
  const int64_t qt_end = (seq_q + kMmaTile - 1) / kMmaTile;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.0f;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const int64_t row_base = (static_cast<int64_t>(b) * heads_q + h) * seq_q;
    const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
    for (int64_t qt = qt_begin; qt < qt_end; ++qt) {
      const int64_t q0 = qt * kMmaTile;
      __syncthreads();  // the previous tile's Q and dO are no longer read
      load_bf16<D>(q_s, qp, qs.s, q0, seq_q);
      load_bf16<D>(do_s, dout + row_base * D, D, q0, seq_q);
      for (int e = threadIdx.x; e < kMmaTile; e += kMmaThreads) {
        const int64_t row = q0 + e;
        lse_s[e] = row < seq_q ? lse[row_base + row] * kLog2E : 0.0f;
        dl_s[e] = row < seq_q ? delta[row_base + row] : 0.0f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T over the warp's 16 keys, 64 queries
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        a_frag<kP>(ak, k_s, 16 * warp, 16 * kk, g, t);
        a_frag<kP>(av, v_s, 16 * warp, 16 * kk, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t b0, b1;
          b_frag_nk<kP>(b0, b1, q_s, 8 * j, 16 * kk, g, t);
          mma16816(s[j], ak, b0, b1);
          b_frag_nk<kP>(b0, b1, do_s, 8 * j, 16 * kk, g, t);
          mma16816(dp[j], av, b0, b1);
        }
      }
      // P^T and dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = k0 + 16 * warp + g + 8 * (e >> 1);
          const int qi = 8 * j + 2 * t + (e & 1);
          const float p = visible(q0 + qi, key, seq_q, seq_k, causal)
                              ? exp2f(s[j][e] * scale_log2 - lse_s[qi])
                              : 0.0f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dl_s[qi]);
        }
      uint32_t p_a[4][4], ds_a[4][4];
      acc_to_a(p_a, s);
      acc_to_a(ds_a, dp);
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          b_frag_kn<kP>(b0, b1, do_s, 16 * kk, 8 * n, g, t);
          mma16816(dv_acc[n], p_a[kk], b0, b1);
          b_frag_kn<kP>(b0, b1, q_s, 16 * kk, 8 * n, g, t);
          mma16816(dk_acc[n], ds_a[kk], b0, b1);
        }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t key = k0 + 16 * warp + g + 8 * r;
    if (key >= seq_k) continue;
    const int64_t base = (static_cast<int64_t>(bh) * seq_k + key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * n) =
          __floats2bfloat162_rn(dk_acc[n][2 * r] * scale,
                                dk_acc[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * n) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        int64_t batch, int heads_q, int heads_kv, int group,
                        int64_t seq_q, int64_t seq_k, Strides qs, Strides ks,
                        Strides vs, int causal, float scale,
                        cudaStream_t stream) {
  using M = MmaTile<D>;
  auto dq_kernel = flash_bwd_dq_kernel_bf16<D>;
  auto dkv_kernel = flash_bwd_dkv_kernel_bf16<D>;
  const int bytes = static_cast<int>(M::kSmemBytes);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const dim3 grid_q(static_cast<unsigned>((seq_q + kMmaTile - 1) / kMmaTile),
                    static_cast<unsigned>(batch * heads_q));
  dq_kernel<<<grid_q, kMmaThreads, bytes, stream>>>(
      qt, kt, vt, static_cast<const bf*>(o), dot, lse, static_cast<bf*>(dq),
      delta, heads_q, group, seq_q, seq_k, qs, ks, vs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(static_cast<unsigned>((seq_k + kMmaTile - 1) / kMmaTile),
                    static_cast<unsigned>(batch * heads_kv));
  dkv_kernel<<<grid_k, kMmaThreads, bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      heads_q, heads_kv, group, seq_q, seq_k, qs, ks, vs, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int64_t batch,
                   int heads_q, int heads_kv, int group, int64_t seq_q,
                   int64_t seq_k, Strides qs, Strides ks, Strides vs,
                   int causal, float scale, cudaStream_t s) {
  if (dtype == kF32)
    return launch_f32<float, D>(q, k, v, o, dout, lse, dq, dk, dv, delta,
                                batch, heads_q, heads_kv, group, seq_q, seq_k,
                                qs, ks, vs, causal, scale, s);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  if constexpr (D <= 128)
    return launch_bf16<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, batch,
                          heads_q, heads_kv, group, seq_q, seq_k, qs, ks, vs,
                          causal, scale, s);
  else
    return launch_f32<__nv_bfloat16, D>(q, k, v, o, dout, lse, dq, dk, dv,
                                        delta, batch, heads_q, heads_kv,
                                        group, seq_q, seq_k, qs, ks, vs,
                                        causal, scale, s);
}

}  // namespace

extern "C" {

// q [batch, heads_q, seq_q, head_dim], k and v [batch, heads_kv, seq_k,
// head_dim] read through the given element strides (batch, head, sequence;
// 1 along head_dim), as the forward reads them; o and dout [batch, heads_q,
// seq_q, head_dim] contiguous; lse f32 [batch, heads_q, seq_q] from the
// forward.  All of one type (0 f32, 1 bf16) on the current device; for
// bf16 every base pointer and stride is a multiple of 16 bytes (the
// wrapper checks).  Writes dq [batch, heads_q, seq_q, head_dim] and dk, dv
// [batch, heads_kv, seq_k, head_dim], contiguous, same type, and delta f32
// [batch, heads_q, seq_q] (scratch the wrapper allocates).  Two kernels on
// the stream; returns the first launch error (0 on success); it does not
// synchronise.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, int64_t batch, int64_t heads_q,
                              int64_t heads_kv, int64_t seq_q, int64_t seq_k,
                              int64_t head_dim, int64_t q_sb, int64_t q_sh,
                              int64_t q_ss, int64_t k_sb, int64_t k_sh,
                              int64_t k_ss, int64_t v_sb, int64_t v_sh,
                              int64_t v_ss, int dtype, int causal, float scale,
                              void* stream) {
  if (batch <= 0 || heads_q <= 0 || heads_kv <= 0 || heads_q % heads_kv ||
      seq_q <= 0 || seq_k <= 0 || (causal && seq_q > seq_k))
    return cudaErrorInvalidValue;
  if (batch * heads_q > 65535 || seq_q > 0x7fffffffLL * 32 ||
      seq_k > 0x7fffffffLL * 32)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const int hq = static_cast<int>(heads_q);
  const int hkv = static_cast<int>(heads_kv);
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
#define REPRO_BWD_CASE(D)                                                    \
  case D:                                                                    \
    return launch<D>(dtype, q, k, v, o, dout, lse_f, dq, dk, dv, delta_f,    \
                     batch, hq, hkv, group, seq_q, seq_k, qs, ks, vs, causal, \
                     scale, s);
  switch (head_dim) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD_CASE
}

const char* repro_flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
