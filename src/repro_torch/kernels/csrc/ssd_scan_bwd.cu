// Mamba-2 SSD (state-space duality) chunked scan, backward, for Hopper
// (sm_90a).
//
// The JAX package has no backward kernel for the SSD: off the TPU,
// jax.value_and_grad (repro/train/train_step.py:66) differentiates the
// plain ref.ssd_scan_chunked / ref.ssd_scan that repro/kernels/ops.py:86-102
// picks there.  This is the backward of csrc/ssd_scan.cu's forward (which
// replaces the Pallas TPU kernel repro/kernels/ssd_scan.py: ssd_scan_fwd /
// _ssd_kernel), so that mamba and jamba train on the card through the
// hand-written forward and have a gradient for it.  Its plain version is
// repro_torch/kernels/ref.py:ssd_scan_bwd, which states the equations.
//
// For x [B,L,H,P], dt [B,L,H] f32, a [H] f32, b and c [B,L,G,N] (G = 1:
// one group shared by every head; G = H: one per head), an optional d [H]
// f32 and the output's gradient dy [B,L,H,P], it writes dx [B,L,H,P] in
// x's type, ddt [B,L,H] f32, da [H] f32, db and dc [B,L,G,N] in x's type
// (summed over the heads of a group) and dd [H] f32, all contiguous.  Per
// chunk of Q = 64 tokens (cum the inclusive cumulative sum of a dt, T =
// cum_Q, L_ij = exp(cum_i - cum_j) for j <= i, else 0, CB_ij = c_i . b_j,
// W = CB o L o dt_j, e_i = exp(cum_i), g_j = exp(T - cum_j), f_j = g_j dt_j)
// and with dS the gradient of the state leaving the chunk:
//   dW_ij  = dy_i . x_j  (j <= i),   dCB = dW o L o dt_j
//   dx_j   = sum_i W_ij dy_i + f_j (dS^T b_j) + d dy_j
//   dc_i   = sum_j dCB_ij b_j + e_i (S_in dy_i)
//   db_j   = sum_i dCB_ij c_i + f_j (dS x_j)
//   df_j   = x_j . (dS^T b_j)
//   dS_in  = exp(T) dS + sum_i (e_i c_i) dy_i^T
//   d(cum)_i = sum_j dW_ij W_ij - sum_k dW_ki W_ki + e_i c_i . (S_in dy_i)
//              - f_i df_i  (+ exp(T) <S_in, dS> + sum_j f_j df_j at i = Q)
//   ds_t   = sum_{i >= t} d(cum)_i,  ddt_t = a ds_t + g_t df_t
//            + sum_i dW_it CB_it L_it,  da = sum dt_t ds_t,  dd = sum dy.x
// W's and every decay's upper triangle is selected to 0, never multiplied
// by a 0/1 mask: there the exponent is positive and exp() may be inf.  Any
// L >= 1: the last chunk is masked (dt = 0 and x, b, c, dy = 0 past L,
// which add nothing).  P in {16, 32, 64, 128}, N in {8, 16, 128}.
//
// What bounds it: at the mamba2-2.7b training layer (x [2,4096,80,64], N
// 128, b and c one group) the function needs, per token and head, 2 (Q +
// 1)(P + N) FLOP on the causal pairs of a chunk of Q = 64 and 10 N P for
// the state terms, 7.0e10 (0.071 ms on the bf16 tensor cores, 1.05 ms on
// the f32 cores; a smaller chunk needs fewer); it reads x, dy, dt, b, c
// and writes dx, ddt, db, dc once, 0.27 GB (0.079 ms at 3.35 TB/s), which
// bounds it in bf16.  This kernel does more products than that: full
// Q x Q tiles, 2 H (3 Q^2 N + 2 Q^2 P + 4 Q N P) FLOP a chunk, 8.6e10.
// This first version is simple and right, not fast: one thread block
// walks the chunks of one (batch, head, slice of up to 64 columns of P),
// so the card holds B H (P / 64) blocks, and the states and per-head
// partial sums go through device memory.  Three steps, one launch each
// (four kernels):
//
// (a) ssd_bwd_states_kernel recomputes the state entering every chunk into
//     an f32 workspace [B,H,L/Q,N,P] (671 MB at the mamba training layer),
//     walking the chunks forward as the forward kernel does.
// (b) ssd_bwd_kernel walks the chunks from the last to the first with dS
//     [N, slice] in shared memory and, per chunk, the products above as
//     block-wide register-tiled matrix products over f32 tiles in shared
//     memory.  It writes dx, and per (batch, head, slice) partials of ddt,
//     db, dc, da and dd into f32 workspaces.  Columns of P are independent
//     in the recurrence of dS, so slices of P need nothing of each other;
//     their partial sums over P are added in (c).
// (c) ssd_bwd_reduce_*_kernel add the partials in a fixed order: db and dc
//     over the slices and the heads of each group, ddt over the slices, da
//     and dd over the batch and the slices.  No float atomics anywhere:
//     the six gradients are bit-identical from run to run.
//
// The products.  bf16: the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 sums).  x, dy, b and c are bf16 inputs and enter as they are; the
// operands that are not inputs (W, dCB, S_in, dS, b f in the state
// recompute and c e in dS_in) are split into hi = bf16(v) and lo = bf16(v -
// hi), each its own MMA: one rounding of these misses the 2e-2 gate, as in
// the forward (tests/test_torch_ssd_bwd.py holds a plain model of this
// arithmetic).  Fragments are built from the f32 tiles with plain loads
// (rows padded by one word), not ldmatrix.  f32: the f32 cores (fmaf over a
// 16 x 16 thread grid), held to 5e-4.
//
// Each chunk's tiles are loaded in batches of up to 8 (bf16) or 16 (f32)
// loads a thread, all issued before the batch's first store to shared
// memory, bf16 read as 16-bit integers and widened after (load_tile): with
// one block of 8 warps an SM, loads issued one at a time left the walk
// waiting on memory for half its time.  The bf16 walk at N = 128 runs at
// 255 registers and spills 112 bytes.
// Shared memory is dynamic (208 KB at P = 64, N = 128: one block an SM;
// 92 KB at N = 16: two in bf16), set with cudaFuncSetAttribute; each
// launch's error is returned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;         // tokens per chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPitchQ = kQ + 1;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, l, h;  // elements; the stride along the last dimension is 1
};

// An input element as the loads take it (its bits; bf16 as a 16-bit
// integer) and its f32 value.  The conversion is integer arithmetic: the
// intrinsic's inline assembly is volatile, and kept each load waiting for
// the conversion of the one before it.
template <typename T>
struct Bits {
  using type = float;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};
__device__ __forceinline__ float bits_to_f32(float v) { return v; }
__device__ __forceinline__ float bits_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ===========================================================================
// Block-wide products C[M, NN] = sum_k A(i, k) B(k, j) over K, where A and B
// are functors of f32 values (tiles in shared memory, read through any
// indices, so transposes and per-row scales cost nothing).  Each engine
// fixes which outputs a thread owns; every thread calls each member.
// ===========================================================================

// f32: the f32 cores.  A thread (tx, ty) of the 16 x 16 grid owns rows
// ty + 16 r and columns tx + 16 s.
struct FmaEngine {
  template <int M, int NN>
  struct Acc {
    static constexpr int R = (M + 15) / 16;
    static constexpr int C = (NN + 15) / 16;
    float v[R][C];
  };

  template <int M, int NN>
  static __device__ __forceinline__ void zero(Acc<M, NN>& acc) {
#pragma unroll
    for (int r = 0; r < Acc<M, NN>::R; ++r)
#pragma unroll
      for (int s = 0; s < Acc<M, NN>::C; ++s) acc.v[r][s] = 0.0f;
  }

  // acc += A B over k < K (SA, SB: whether the operand is split; the f32
  // cores take every operand whole)
  template <int M, int NN, int K, bool SA, bool SB, typename FA, typename FB>
  static __device__ __forceinline__ void product(Acc<M, NN>& acc, FA fa,
                                                 FB fb) {
    using A = Acc<M, NN>;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float av[A::R], bv[A::C];
#pragma unroll
      for (int r = 0; r < A::R; ++r) {
        const int i = ty + 16 * r;
        av[r] = i < M ? fa(i, k) : 0.0f;
      }
#pragma unroll
      for (int s = 0; s < A::C; ++s) {
        const int j = tx + 16 * s;
        bv[s] = j < NN ? fb(k, j) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < A::R; ++r)
#pragma unroll
        for (int s = 0; s < A::C; ++s)
          acc.v[r][s] = fmaf(av[r], bv[s], acc.v[r][s]);
    }
  }

  // fn(i, j, v1, v2) for every owned output; where row_out is not null,
  // row_out[i] = sum_j of what fn returns (a fixed order: the owner's
  // columns in order, then a shuffle tree over the 16 owners of the row).
  // Ends with a barrier.
  template <int M, int NN, typename Fn>
  static __device__ __forceinline__ void epilogue(const Acc<M, NN>& a1,
                                                  const Acc<M, NN>& a2,
                                                  float* row_out, float*,
                                                  Fn fn) {
    using A = Acc<M, NN>;
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int r = 0; r < A::R; ++r) {
      const int i = ty + 16 * r;
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < A::C; ++s) {
        const int j = tx + 16 * s;
        if (i < M && j < NN) sum += fn(i, j, a1.v[r][s], a2.v[r][s]);
      }
      if (row_out != nullptr) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (tx == 0 && i < M) row_out[i] = sum;
      }
    }
    __syncthreads();
  }
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}
// v0, v1 -> hi = bf16(v), lo = bf16(v - hi), packed as pack_bf16
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// d += a b: a the 16x16 A fragment, (b0, b1) the 16x8 B fragment
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: the tensor cores.  The output is cut into 16 x 8 tiles; warp w owns
// row block w % RB (RB = M / 16 row blocks, 1, 2, 4 or 8) and, of its
// column tiles, every WPR-th from w / RB.  In a tile, lane (g = lane / 4,
// q = lane % 4) owns rows g, g + 8 and columns 2q, 2q + 1 (mma.sync's
// accumulator layout).
struct MmaEngine {
  template <int M, int NN>
  struct Acc {
    static constexpr int RB = (M + 15) / 16;
    static_assert(kWarps % RB == 0, "row blocks must divide the warps");
    static constexpr int WPR = kWarps / RB;
    static constexpr int CT = ((NN + 7) / 8 + WPR - 1) / WPR;
    float v[CT][4];
  };

  template <int M, int NN>
  static __device__ __forceinline__ void zero(Acc<M, NN>& acc) {
#pragma unroll
    for (int t = 0; t < Acc<M, NN>::CT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[t][e] = 0.0f;
  }

  template <int M, int NN, int K, bool SA, bool SB, typename FA, typename FB>
  static __device__ __forceinline__ void product(Acc<M, NN>& acc, FA fa,
                                                 FB fb) {
    using A = Acc<M, NN>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int rb = warp % A::RB, cw = warp / A::RB;
    const int r0 = 16 * rb + g, r1 = r0 + 8;
    auto av = [&](int i, int k) { return i < M && k < K ? fa(i, k) : 0.0f; };
    auto bv = [&](int k, int j) { return k < K ? fb(k, j) : 0.0f; };
#pragma unroll 1
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int k = k0 + 2 * q;
      uint32_t ah[4], al[4];
      if constexpr (SA) {
        split_bf16(av(r0, k), av(r0, k + 1), ah[0], al[0]);
        split_bf16(av(r1, k), av(r1, k + 1), ah[1], al[1]);
        split_bf16(av(r0, k + 8), av(r0, k + 9), ah[2], al[2]);
        split_bf16(av(r1, k + 8), av(r1, k + 9), ah[3], al[3]);
      } else {
        ah[0] = pack_bf16(av(r0, k), av(r0, k + 1));
        ah[1] = pack_bf16(av(r1, k), av(r1, k + 1));
        ah[2] = pack_bf16(av(r0, k + 8), av(r0, k + 9));
        ah[3] = pack_bf16(av(r1, k + 8), av(r1, k + 9));
      }
#pragma unroll
      for (int t = 0; t < A::CT; ++t) {
        const int ct = cw + A::WPR * t;
        if (8 * ct >= NN) continue;
        const int j = 8 * ct + g;
        if constexpr (SB) {
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16(bv(k, j), bv(k + 1, j), bh0, bl0);
          split_bf16(bv(k + 8, j), bv(k + 9, j), bh1, bl1);
          mma(acc.v[t], ah, bh0, bh1);
          mma(acc.v[t], ah, bl0, bl1);
        } else {
          const uint32_t b0 = pack_bf16(bv(k, j), bv(k + 1, j));
          const uint32_t b1 = pack_bf16(bv(k + 8, j), bv(k + 9, j));
          mma(acc.v[t], ah, b0, b1);
          if constexpr (SA) mma(acc.v[t], al, b0, b1);
        }
      }
    }
  }

  // as FmaEngine::epilogue; the row sums go through red [kWarps][M]: a
  // warp's columns in order, a shuffle tree over the four lanes of a row,
  // then the WPR warps of the row block in order
  template <int M, int NN, typename Fn>
  static __device__ __forceinline__ void epilogue(const Acc<M, NN>& a1,
                                                  const Acc<M, NN>& a2,
                                                  float* row_out, float* red,
                                                  Fn fn) {
    using A = Acc<M, NN>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
    const int rb = warp % A::RB, cw = warp / A::RB;
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < A::CT; ++t) {
      const int ct = cw + A::WPR * t;
      if (8 * ct >= NN) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * rb + g + 8 * (e >> 1);
        const int j = 8 * ct + 2 * q + (e & 1);
        if (i < M) sum[e >> 1] += fn(i, j, a1.v[t][e], a2.v[t][e]);
      }
    }
    if (row_out != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        const int i = 16 * rb + g + 8 * h;
        if (q == 0 && i < M) red[cw * M + i] = sum[h];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < M; i += kThreads) {
        float v = 0.0f;
        for (int w = 0; w < A::WPR; ++w) v += red[w * M + i];
        row_out[i] = v;
      }
    }
    __syncthreads();
  }
};

template <typename T>
struct EngineOf;
template <>
struct EngineOf<float> {
  using type = FmaEngine;
};
template <>
struct EngineOf<__nv_bfloat16> {
  using type = MmaEngine;
};

template <typename T>
struct BwdArgs {
  const T* x;
  const float* dt;
  const float* a;
  const T* b;
  const T* c;
  const float* d;  // null: no D-skip
  const T* dy;
  float* states;   // [B, H, chunks, N, P] f32
  T* dx;           // [B, L, H, P]
  float* part_b;   // [B, L, H, slices, N] f32
  float* part_c;
  float* part_dt;  // [B, L, H, slices] f32
  float* part_a;   // [B, H, slices] f32
  float* part_d;
  int64_t seq, chunks;
  int heads, groups, slices, dim_p;
  Strides xs, dts, bs, cs, dys;
  int64_t a_stride, d_stride;
};

// warp 0: cum (inclusive scan of a dt, two tokens a lane), e = exp(cum),
// g = exp(T - cum), f = g dt, T; dt_s holds the chunk's dt (0 past L)
__device__ __forceinline__ void chunk_decays(float a_h, const float* dt_s,
                                             float* cum_s, float* e_s,
                                             float* g_s, float* f_s,
                                             float* total_s) {
  const int lane = threadIdx.x & 31;
  const int r0 = 2 * lane, r1 = r0 + 1;
  const float dt0 = dt_s[r0], dt1 = dt_s[r1];
  const float v0 = a_h * dt0, v1 = a_h * dt1;
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0f;
  const float cum0 = excl + v0;
  const float cum1 = incl;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  cum_s[r0] = cum0;
  cum_s[r1] = cum1;
  e_s[r0] = expf(cum0);
  e_s[r1] = expf(cum1);
  g_s[r0] = expf(total - cum0);
  g_s[r1] = expf(total - cum1);
  f_s[r0] = g_s[r0] * dt0;
  f_s[r1] = g_s[r1] * dt1;
  if (lane == 0) total_s[0] = total;
}

// ROWS x W values of a row-major source (row r at src + r * stride; rows
// past `rows` read as zeros) into f32 shared memory with row pitch PITCH.
// Each thread issues all its loads before its first store, so a block has
// up to (ROWS W / 256) loads a thread in flight (with 8 warps an SM, one
// load at a time left the walk waiting on memory).
template <int ROWS, int W, int PITCH, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int rows) {
  using B = typename Bits<T>::type;
  constexpr int kCount = ROWS * W;
  constexpr int kPer = (kCount + kThreads - 1) / kThreads;
  // at most kBatch loads a thread in flight: in bf16, 16 or all of them
  // held the walk's registers past 255 (more spills) and ran slower, 4 too
  constexpr int kMaxBatch = sizeof(B) == 2 ? 8 : 16;
  constexpr int kBatch = kPer < kMaxBatch ? kPer : kMaxBatch;
  const B* bits = reinterpret_cast<const B*>(src);
#pragma unroll
  for (int i0 = 0; i0 < kPer; i0 += kBatch) {
    B v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (i0 + i) * kThreads;
      const int r = e / W;
      v[i] = (kCount % kThreads == 0 || e < kCount) && r < rows
                 ? bits[r * stride + e % W]
                 : B(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = threadIdx.x + (i0 + i) * kThreads;
      if (kCount % kThreads == 0 || e < kCount)
        dst[(e / W) * PITCH + e % W] = bits_to_f32(v[i]);
    }
  }
}

// rows [Q][W] of a [B, L, H, ·] input (element strides st) at token l0 into
// f32 shared memory with row pitch PITCH; zeros past L
template <int W, int PITCH, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          Strides st, int64_t l0, int rows) {
  load_tile<kQ, W, PITCH>(dst, src + l0 * st.l, st.l, rows);
}

// Shared memory of the two walks, in floats
template <int PS, int N>
struct Smem {
  static constexpr int kPX = PS + 1;  // row pitch of x, dy, S, dS
  static constexpr int kPN = N + 1;   // row pitch of b, c
  static constexpr int kX = 0;
  static constexpr int kDy = kX + kQ * kPX;
  static constexpr int kB = kDy + kQ * kPX;
  static constexpr int kC = kB + kQ * kPN;
  static constexpr int kSin = kC + kQ * kPN;
  static constexpr int kDs = kSin + N * kPX;
  static constexpr int kW = kDs + N * kPX;
  static constexpr int kDcb = kW + kQ * kPitchQ;
  static constexpr int kVec = kDcb + kQ * kPitchQ;
  // vectors of Q: dt, cum, e, g, f, row sums of dW o W, df, S_in dy . c
  static constexpr int kRed = kVec + 8 * kQ;    // [kWarps][max(Q, N)]
  static constexpr int kCol = kRed + kWarps * (N > kQ ? N : kQ);
  static constexpr int kMisc = kCol + 2 * kWarps * kQ;  // column partials
  static constexpr int kFloats = kMisc + 4 * kWarps;
  // the state recompute: b, x, S and the vectors
  static constexpr int kStatesFloats = kQ * kPN + kQ * kPX + N * kPX + 8 * kQ;
};

// blocks an SM the walks ask ptxas to allow: two where their shared memory
// lets two in (N <= 16), so that one block's loads overlap the other's
// products, in bf16 (the f32 walk would spill in the 128 registers that
// leaves a thread); one at N = 128 (208 KB)
template <typename T, int N>
constexpr int kMinBlocks =
    N <= 16 && sizeof(T) == sizeof(__nv_bfloat16) ? 2 : 1;

// (a) S entering each chunk -> states[b, h, z, :, slice]
template <typename T, int PS, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, N>)
    ssd_bwd_states_kernel(const BwdArgs<T> args) {
  using E = typename EngineOf<T>::type;
  using S = Smem<PS, N>;
  extern __shared__ float sm[];
  float* b_s = sm;                                // [Q][N + 1]
  float* x_s = b_s + kQ * S::kPN;                 // [Q][PS + 1]
  float* st_s = x_s + kQ * S::kPX;                // [N][PS + 1]
  float* dt_s = st_s + N * S::kPX;
  float* cum_s = dt_s + kQ;
  float* e_s = cum_s + kQ;
  float* g_s = e_s + kQ;
  float* f_s = g_s + kQ;
  float* total_s = f_s + kQ;

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int grp = args.groups == 1 ? 0 : h;
  const float a_h = args.a[h * args.a_stride];
  const T* xp = args.x + bb * args.xs.b + h * args.xs.h + p0;
  const float* dtp = args.dt + bb * args.dts.b + h * args.dts.h;
  const T* bp = args.b + bb * args.bs.b + grp * args.bs.h;
  const int64_t P = args.dim_p;
  float* out = args.states +
               (bb * args.heads + h) * args.chunks * N * P + p0;

  for (int e = threadIdx.x; e < N * PS; e += kThreads)
    st_s[(e / PS) * S::kPX + e % PS] = 0.0f;

  for (int64_t z = 0; z < args.chunks; ++z) {
    const int64_t l0 = z * kQ;
    const int rows = static_cast<int>(
        args.seq - l0 < kQ ? args.seq - l0 : kQ);
    load_rows<N, S::kPN>(b_s, bp, args.bs, l0, rows);
    load_rows<PS, S::kPX>(x_s, xp, args.xs, l0, rows);
    for (int r = threadIdx.x; r < kQ; r += kThreads)
      dt_s[r] = r < rows ? dtp[(l0 + r) * args.dts.l] : 0.0f;
    __syncthreads();
    // the state entering chunk z out, 16-byte rows of PS columns
    float* oz = out + z * N * P;
    for (int e = threadIdx.x; e < N * PS; e += kThreads) {
      const int n = e / PS, p = e - n * PS;
      oz[n * P + p] = st_s[n * S::kPX + p];
    }
    if (threadIdx.x < 32)
      chunk_decays(a_h, dt_s, cum_s, e_s, g_s, f_s, total_s);
    __syncthreads();
    // S = exp(T) S + sum_j (b_j f_j) x_j^T
    typename E::template Acc<N, PS> acc;
    E::zero(acc);
    E::template product<N, PS, kQ, true, false>(
        acc, [&](int n, int j) { return b_s[j * S::kPN + n] * f_s[j]; },
        [&](int j, int p) { return x_s[j * S::kPX + p]; });
    const float decay = expf(total_s[0]);
    E::epilogue(acc, acc, nullptr, nullptr,
                [&](int n, int p, float v, float) {
                  float* sp = st_s + n * S::kPX + p;
                  *sp = decay * *sp + v;
                  return 0.0f;
                });
  }
}

// (b) the reverse walk
template <typename T, int PS, int N>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, N>)
    ssd_bwd_kernel(const BwdArgs<T> args) {
  using E = typename EngineOf<T>::type;
  using S = Smem<PS, N>;
  extern __shared__ float sm[];
  float* x_s = sm + S::kX;        // [Q][PS + 1]
  float* dy_s = sm + S::kDy;      // [Q][PS + 1]
  float* b_s = sm + S::kB;        // [Q][N + 1]
  float* c_s = sm + S::kC;        // [Q][N + 1]
  float* sin_s = sm + S::kSin;    // [N][PS + 1]: S entering the chunk
  float* ds_s = sm + S::kDs;      // [N][PS + 1]: dS leaving it
  float* w_s = sm + S::kW;        // [Q][Q + 1]: CB, then W
  float* dcb_s = sm + S::kDcb;    // [Q][Q + 1]: dW, then dCB
  float* dt_s = sm + S::kVec;
  float* cum_s = dt_s + kQ;
  float* e_s = cum_s + kQ;
  float* g_s = e_s + kQ;
  float* f_s = g_s + kQ;
  float* rowm_s = f_s + kQ;       // sum_j dW_ij W_ij
  float* df_s = rowm_s + kQ;      // x_j . (dS^T b_j)
  float* vin_s = df_s + kQ;       // c_i . (S_in dy_i)
  float* red_s = sm + S::kRed;
  float* colm_s = sm + S::kCol;   // [kWarps][Q] partial column sums of M
  float* colg_s = colm_s + kWarps * kQ;  // ... of dW o CB o L
  float* misc_s = sm + S::kMisc;  // [0]: T, [1 + w]: warp partials

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x;
  const int p0 = slice * PS;
  const int h = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int grp = args.groups == 1 ? 0 : h;
  const float a_h = args.a[h * args.a_stride];
  const bool has_d = args.d != nullptr;
  const float d_h = has_d ? args.d[h * args.d_stride] : 0.0f;
  const T* xp = args.x + bb * args.xs.b + h * args.xs.h + p0;
  const T* dyp = args.dy + bb * args.dys.b + h * args.dys.h + p0;
  const float* dtp = args.dt + bb * args.dts.b + h * args.dts.h;
  const T* bp = args.b + bb * args.bs.b + grp * args.bs.h;
  const T* cp = args.c + bb * args.cs.b + grp * args.cs.h;
  const int64_t P = args.dim_p;
  const float* states = args.states +
                        (bb * args.heads + h) * args.chunks * N * P + p0;
  const int64_t dx_row = static_cast<int64_t>(args.heads) * P;
  T* dxp = args.dx + bb * args.seq * dx_row + h * P + p0;
  // partial rows: [B, L, H, slices, ·]
  const int64_t hs = static_cast<int64_t>(args.heads) * args.slices;
  const int64_t part_row0 = bb * args.seq * hs + h * args.slices + slice;

  for (int e = tid; e < N * PS; e += kThreads)
    ds_s[(e / PS) * S::kPX + e % PS] = 0.0f;
  float da_acc = 0.0f, dd_acc = 0.0f;

  for (int64_t z = args.chunks - 1; z >= 0; --z) {
    const int64_t l0 = z * kQ;
    const int rows = static_cast<int>(
        args.seq - l0 < kQ ? args.seq - l0 : kQ);
    // ---- load the chunk; zeros past L ------------------------------------
    load_rows<PS, S::kPX>(x_s, xp, args.xs, l0, rows);
    load_rows<PS, S::kPX>(dy_s, dyp, args.dys, l0, rows);
    load_rows<N, S::kPN>(b_s, bp, args.bs, l0, rows);
    load_rows<N, S::kPN>(c_s, cp, args.cs, l0, rows);
    for (int r = tid; r < kQ; r += kThreads)
      dt_s[r] = r < rows ? dtp[(l0 + r) * args.dts.l] : 0.0f;
    load_tile<N, PS, S::kPX>(sin_s, states + z * N * P, P, N);
    __syncthreads();
    if (warp == 0)
      chunk_decays(a_h, dt_s, cum_s, e_s, g_s, f_s, misc_s);
    // ---- CB = c b^T and dW = dy x^T --------------------------------------
    {
      typename E::template Acc<kQ, kQ> cb, dw;
      E::zero(cb);
      E::zero(dw);
      E::template product<kQ, kQ, N, false, false>(
          cb, [&](int i, int k) { return c_s[i * S::kPN + k]; },
          [&](int k, int j) { return b_s[j * S::kPN + k]; });
      E::template product<kQ, kQ, PS, false, false>(
          dw, [&](int i, int k) { return dy_s[i * S::kPX + k]; },
          [&](int k, int j) { return x_s[j * S::kPX + k]; });
      E::epilogue(cb, dw, nullptr, nullptr,
                  [&](int i, int j, float v1, float v2) {
                    w_s[i * kPitchQ + j] = v1;
                    dcb_s[i * kPitchQ + j] = v2;
                    return 0.0f;
                  });
    }
    // ---- W, dCB, and the sums of M = dW o W and dW o CB o L --------------
    // warp w: rows 8w..8w+7; lane: columns lane and lane + 32
    {
      float cm[2] = {0.0f, 0.0f}, cg[2] = {0.0f, 0.0f};
      for (int r = 0; r < kQ / kWarps; ++r) {
        const int i = warp * (kQ / kWarps) + r;
        const float ci = cum_s[i];
        float rm = 0.0f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          float* wp = w_s + i * kPitchQ + j;
          float* dp = dcb_s + i * kPitchQ + j;
          float wv = 0.0f, dcb = 0.0f, m = 0.0f, gt = 0.0f;
          if (j <= i) {
            const float l = expf(ci - cum_s[j]);
            const float cbl = *wp * l;
            const float dwv = *dp;
            wv = cbl * dt_s[j];
            dcb = dwv * l * dt_s[j];
            m = dwv * wv;
            gt = dwv * cbl;
          }
          *wp = wv;
          *dp = dcb;
          rm += m;
          cm[u] += m;
          cg[u] += gt;
        }
        rm = warp_sum(rm);
        if (lane == 0) rowm_s[i] = rm;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        colm_s[warp * kQ + lane + 32 * u] = cm[u];
        colg_s[warp * kQ + lane + 32 * u] = cg[u];
      }
    }
    __syncthreads();
    // ---- dx = W^T dy + f (b dS) + d dy; df_j = x_j . (b dS)_j --------------
    {
      typename E::template Acc<kQ, PS> v1, v2;
      E::zero(v1);
      E::zero(v2);
      E::template product<kQ, PS, kQ, true, false>(
          v1, [&](int j, int i) { return w_s[i * kPitchQ + j]; },
          [&](int i, int p) { return dy_s[i * S::kPX + p]; });
      E::template product<kQ, PS, N, false, true>(
          v2, [&](int j, int n) { return b_s[j * S::kPN + n]; },
          [&](int n, int p) { return ds_s[n * S::kPX + p]; });
      E::epilogue(v1, v2, df_s, red_s,
                  [&](int j, int p, float u1, float u2) {
                    const float dyv = dy_s[j * S::kPX + p];
                    const float xv = x_s[j * S::kPX + p];
                    if (j < rows)
                      dxp[(l0 + j) * dx_row + p] =
                          from_f32<T>(u1 + f_s[j] * u2 + d_h * dyv);
                    dd_acc += dyv * xv;
                    return xv * u2;
                  });
    }
    // ---- dc = dCB b + e (dy S_in^T); vin_i = c_i . (dy S_in^T)_i -----------
    {
      typename E::template Acc<kQ, N> v1, v2;
      E::zero(v1);
      E::zero(v2);
      E::template product<kQ, N, kQ, true, false>(
          v1, [&](int i, int j) { return dcb_s[i * kPitchQ + j]; },
          [&](int j, int n) { return b_s[j * S::kPN + n]; });
      E::template product<kQ, N, PS, false, true>(
          v2, [&](int i, int p) { return dy_s[i * S::kPX + p]; },
          [&](int p, int n) { return sin_s[n * S::kPX + p]; });
      float* part = args.part_c + part_row0 * N;
      E::epilogue(v1, v2, vin_s, red_s,
                  [&](int i, int n, float u1, float u2) {
                    if (i < rows)
                      part[(l0 + i) * hs * N + n] = u1 + e_s[i] * u2;
                    return c_s[i * S::kPN + n] * u2;
                  });
    }
    // ---- db = dCB^T c + f (x dS^T) --------------------------------------
    {
      typename E::template Acc<kQ, N> v1, v2;
      E::zero(v1);
      E::zero(v2);
      E::template product<kQ, N, kQ, true, false>(
          v1, [&](int j, int i) { return dcb_s[i * kPitchQ + j]; },
          [&](int i, int n) { return c_s[i * S::kPN + n]; });
      E::template product<kQ, N, PS, false, true>(
          v2, [&](int j, int p) { return x_s[j * S::kPX + p]; },
          [&](int p, int n) { return ds_s[n * S::kPX + p]; });
      float* part = args.part_b + part_row0 * N;
      E::epilogue(v1, v2, nullptr, nullptr,
                  [&](int j, int n, float u1, float u2) {
                    if (j < rows)
                      part[(l0 + j) * hs * N + n] = u1 + f_s[j] * u2;
                    return 0.0f;
                  });
    }
    // ---- dS_in = exp(T) dS + (e c)^T dy, and <S_in, dS> --------------------
    // (every read of dS above is behind the epilogues' barriers; each
    // element is read and written by its one owner)
    float sds = 0.0f;
    {
      typename E::template Acc<N, PS> v1;
      E::zero(v1);
      E::template product<N, PS, kQ, true, false>(
          v1, [&](int n, int i) { return c_s[i * S::kPN + n] * e_s[i]; },
          [&](int i, int p) { return dy_s[i * S::kPX + p]; });
      const float decay = expf(misc_s[0]);
      E::epilogue(v1, v1, nullptr, nullptr,
                  [&](int n, int p, float u1, float) {
                    float* dp = ds_s + n * S::kPX + p;
                    sds += sin_s[n * S::kPX + p] * *dp;
                    *dp = decay * *dp + u1;
                    return 0.0f;
                  });
    }
    sds = warp_sum(sds);
    if (lane == 0) misc_s[1 + warp] = sds;
    __syncthreads();
    // ---- d(cum), its reverse cumulative sum, ddt and da: warp 0 ----------
    if (warp == 0) {
      const float total = misc_s[0];
      float sin_ds = 0.0f;
      for (int w = 0; w < kWarps; ++w) sin_ds += misc_s[1 + w];
      // lane owns rows 2 lane and 2 lane + 1
      float dcum[2], fdf = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        float colm = 0.0f;
        for (int w = 0; w < kWarps; ++w) colm += colm_s[w * kQ + i];
        const float fd = f_s[i] * df_s[i];
        dcum[u] = rowm_s[i] - colm + e_s[i] * vin_s[i] - fd;
        fdf += fd;
      }
      fdf = warp_sum(fdf);
      if (lane == 31) dcum[1] += expf(total) * sin_ds + fdf;
      // ds_t = sum_{i >= t} dcum_i: an inclusive scan from the top lane down
      float pair = dcum[0] + dcum[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float above = incl - pair;  // rows past 2 lane + 1
      const float ds1 = above + dcum[1];
      const float ds0 = ds1 + dcum[0];
      float* part = args.part_dt + part_row0;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        const float ds = u ? ds1 : ds0;
        float colg = 0.0f;
        for (int w = 0; w < kWarps; ++w) colg += colg_s[w * kQ + i];
        if (i < rows)
          part[(l0 + i) * hs] = a_h * ds + g_s[i] * df_s[i] + colg;
        da_acc += dt_s[i] * ds;
      }
    }
    __syncthreads();
  }

  // da over the chunks (warp 0's lanes), dd over the chunks and the block
  const int64_t head_part = (bb * args.heads + h) * args.slices + slice;
  if (warp == 0) {
    da_acc = warp_sum(da_acc);
    if (lane == 0) args.part_a[head_part] = da_acc;
  }
  dd_acc = warp_sum(dd_acc);
  if (lane == 0) misc_s[1 + warp] = dd_acc;
  __syncthreads();
  if (tid == 0) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += misc_s[1 + w];
    args.part_d[head_part] = v;
  }
}

// (c) db, dc [B, L, G, N] = sum over the group's heads and the slices
template <typename T>
__global__ void ssd_bwd_reduce_bc_kernel(const float* __restrict__ part_b,
                                         const float* __restrict__ part_c,
                                         T* __restrict__ db,
                                         T* __restrict__ dc, int64_t rows,
                                         int heads, int groups, int slices,
                                         int dim_n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t total = rows * groups * dim_n;  // rows = B L
  if (e >= total) return;
  const int n = static_cast<int>(e % dim_n);
  const int64_t rg = e / dim_n;
  const int grp = static_cast<int>(rg % groups);
  const int64_t row = rg / groups;
  const int per = heads / groups;
  const int64_t hs = static_cast<int64_t>(heads) * slices;
  const int64_t base = (row * hs + static_cast<int64_t>(grp) * per * slices) *
                       dim_n + n;
  float sb = 0.0f, sc = 0.0f;
  for (int k = 0; k < per * slices; ++k) {
    sb += part_b[base + k * dim_n];
    sc += part_c[base + k * dim_n];
  }
  db[e] = from_f32<T>(sb);
  dc[e] = from_f32<T>(sc);
}

// ddt [B, L, H] = sum over the slices
__global__ void ssd_bwd_reduce_dt_kernel(const float* __restrict__ part,
                                         float* __restrict__ ddt,
                                         int64_t count, int slices) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e >= count) return;
  float v = 0.0f;
  for (int s = 0; s < slices; ++s) v += part[e * slices + s];
  ddt[e] = v;
}

// da, dd [H] = sum over the batch and the slices
__global__ void ssd_bwd_reduce_heads_kernel(const float* __restrict__ part_a,
                                            const float* __restrict__ part_d,
                                            float* __restrict__ da,
                                            float* __restrict__ dd,
                                            int64_t batch, int heads,
                                            int slices) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads) return;
  float sa = 0.0f, sd = 0.0f;
  for (int64_t b = 0; b < batch; ++b)
    for (int s = 0; s < slices; ++s) {
      const int64_t k = (b * heads + h) * slices + s;
      sa += part_a[k];
      sd += part_d[k];
    }
  da[h] = sa;
  if (dd != nullptr) dd[h] = sd;
}

template <typename T, int PS, int N>
cudaError_t launch(const BwdArgs<T>& args, int64_t batch, T* db, T* dc,
                   float* ddt, float* da, float* dd, cudaStream_t stream) {
  using S = Smem<PS, N>;
  const dim3 grid(static_cast<unsigned>(args.slices),
                  static_cast<unsigned>(args.heads),
                  static_cast<unsigned>(batch));
  auto states = ssd_bwd_states_kernel<T, PS, N>;
  const int states_bytes = S::kStatesFloats * 4;
  cudaError_t err = cudaFuncSetAttribute(
      states, cudaFuncAttributeMaxDynamicSharedMemorySize, states_bytes);
  if (err != cudaSuccess) return err;
  states<<<grid, kThreads, states_bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto walk = ssd_bwd_kernel<T, PS, N>;
  const int bytes = S::kFloats * 4;
  err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  walk<<<grid, kThreads, bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = batch * args.seq;
  const int64_t bc = rows * args.groups * N;
  ssd_bwd_reduce_bc_kernel<T><<<static_cast<unsigned>((bc + 255) / 256), 256,
                                0, stream>>>(args.part_b, args.part_c, db, dc,
                                             rows, args.heads, args.groups,
                                             args.slices, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t dts = rows * args.heads;
  ssd_bwd_reduce_dt_kernel<<<static_cast<unsigned>((dts + 255) / 256), 256,
                             0, stream>>>(args.part_dt, ddt, dts,
                                          args.slices);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_heads_kernel<<<(args.heads + 127) / 128, 128, 0, stream>>>(
      args.part_a, args.part_d, da, dd, batch, args.heads, args.slices);
  return cudaGetLastError();
}

template <typename T, int PS>
cudaError_t launch_n(const BwdArgs<T>& args, int64_t batch, int dim_n, T* db,
                     T* dc, float* ddt, float* da, float* dd,
                     cudaStream_t s) {
  if (dim_n == 8) return launch<T, PS, 8>(args, batch, db, dc, ddt, da, dd, s);
  if (dim_n == 16)
    return launch<T, PS, 16>(args, batch, db, dc, ddt, da, dd, s);
  return launch<T, PS, 128>(args, batch, db, dc, ddt, da, dd, s);
}

template <typename T>
cudaError_t launch_typed(const BwdArgs<T>& args, int64_t batch, int dim_n,
                         void* db, void* dc, float* ddt, float* da,
                         float* dd, cudaStream_t s) {
  T* dbt = static_cast<T*>(db);
  T* dct = static_cast<T*>(dc);
  switch (args.dim_p) {
    case 16: return launch_n<T, 16>(args, batch, dim_n, dbt, dct, ddt, da, dd, s);
    case 32: return launch_n<T, 32>(args, batch, dim_n, dbt, dct, ddt, da, dd, s);
    default: return launch_n<T, 64>(args, batch, dim_n, dbt, dct, ddt, da, dd, s);
  }
}

bool supported_p(int64_t p) {
  return p == 16 || p == 32 || p == 64 || p == 128;
}

bool supported_n(int64_t n) { return n == 8 || n == 16 || n == 128; }

// column slices of P the walk takes, one block each: P / 64 from P = 128
int slices_of(int64_t dim_p) {
  return dim_p > 64 ? static_cast<int>(dim_p / 64) : 1;
}

}  // namespace

extern "C" {

// x [batch, seq, heads, dim_p] and dy (0 f32, 1 bf16), dt [batch, seq,
// heads] f32, a [heads] f32, b and c [batch, seq, groups, dim_n] of x's
// type (groups 1 or heads; stride 0 along the group axis allowed), d
// [heads] f32 or null, all on the current device and read through the
// given element strides (batch, sequence, head; 1 along dim_p and dim_n).
// Writes dx [batch, seq, heads, dim_p] (x's type), ddt [batch, seq, heads]
// f32, da [heads] f32, db and dc [batch, seq, groups, dim_n] (x's type)
// and, where d is given, dd [heads] f32, all contiguous.  f32 workspaces
// the wrapper allocates (S = dim_p / 64 from dim_p = 128, else 1): states
// [batch, heads, ceil(seq / 64), dim_n, dim_p], part_b and part_c [batch,
// seq, heads, S, dim_n], part_dt [batch, seq, heads, S], part_a and part_d
// [batch, heads, S].  Launches five kernels on the stream; returns the
// first launch error (0 on success); it does not synchronise.
int repro_ssd_scan_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* d,
                       const void* dy, void* dx, float* ddt, float* da,
                       void* db, void* dc, float* dd, float* states,
                       float* part_b, float* part_c, float* part_dt,
                       float* part_a, float* part_d, int64_t batch,
                       int64_t seq, int64_t heads, int64_t groups,
                       int64_t dim_p, int64_t dim_n, int64_t x_sb,
                       int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                       int64_t dt_sl, int64_t dt_sh, int64_t a_stride,
                       int64_t b_sb, int64_t b_sl, int64_t b_sh,
                       int64_t c_sb, int64_t c_sl, int64_t c_sh,
                       int64_t d_stride, int64_t dy_sb, int64_t dy_sl,
                       int64_t dy_sh, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535 || (groups != 1 && groups != heads) ||
      !supported_p(dim_p) || !supported_n(dim_n) || (d == nullptr) !=
      (dd == nullptr))
    return cudaErrorInvalidValue;
  const int64_t chunks = (seq + kQ - 1) / kQ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slices = slices_of(dim_p);
  const Strides xs{x_sb, x_sl, x_sh}, dts{dt_sb, dt_sl, dt_sh},
      bs{b_sb, b_sl, b_sh}, cs{c_sb, c_sl, c_sh}, dys{dy_sb, dy_sl, dy_sh};
  if (dtype == kF32) {
    const BwdArgs<float> args{
        static_cast<const float*>(x), dt, a, static_cast<const float*>(b),
        static_cast<const float*>(c), d, static_cast<const float*>(dy),
        states, static_cast<float*>(dx), part_b, part_c, part_dt, part_a,
        part_d, seq, chunks, static_cast<int>(heads),
        static_cast<int>(groups), slices, static_cast<int>(dim_p), xs, dts,
        bs, cs, dys, a_stride, d_stride};
    return launch_typed(args, batch, static_cast<int>(dim_n), db, dc, ddt, da,
                        dd, s);
  }
  if (dtype != kBF16) return cudaErrorInvalidValue;
  const BwdArgs<__nv_bfloat16> args{
      static_cast<const __nv_bfloat16*>(x), dt, a,
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), d,
      static_cast<const __nv_bfloat16*>(dy), states,
      static_cast<__nv_bfloat16*>(dx), part_b, part_c, part_dt, part_a,
      part_d, seq, chunks, static_cast<int>(heads), static_cast<int>(groups),
      slices, static_cast<int>(dim_p), xs, dts, bs, cs, dys, a_stride,
      d_stride};
  return launch_typed(args, batch, static_cast<int>(dim_n), db, dc, ddt, da,
                      dd, s);
}

const char* repro_ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
