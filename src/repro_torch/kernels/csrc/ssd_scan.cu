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
// chunk by chunk, as _ssd_kernel does.  For a chunk of Q = 64 tokens with
// cum = the inclusive cumulative sum of a dt over the chunk:
//   W[i,j] = (c_i . b_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i    = sum_j W[i,j] x_j + exp(cum_i) c_i^T S_in + d x_i
//   S_out  = exp(cum_Q) S_in + sum_j (b_j exp(cum_Q - cum_j) dt_j) x_j^T
// Products are summed in f32 and y is rounded to x's type once, after the
// D-skip is added in f32: the semantics of the plain ref.ssd_scan /
// ssd_scan_chunked (which the JAX package runs off the TPU); its Pallas
// route rounds y to bf16 first.  W's upper triangle is selected to 0, never
// multiplied by a 0/1 mask: there the exponent is positive and exp() may be
// inf.  The kernels' Q is 64 (the TPU's 128); the result does not depend on
// Q beyond rounding.  Blocks on Hopper run in no order, so where the TPU
// carried S across a sequential grid axis in VMEM, one thread block walks
// the chunks of its (batch, head) in order.  Nothing crosses blocks and
// there are no atomics: a run is deterministic.  b and c are read through
// their element strides, stride 0 along H included: the model hands over
// b and c expanded from [B,L,N] to every head, which are not copied (copies
// would move 2 x 168 MB a layer for 4 MB of data); x and dt through theirs;
// stride 1 along P and N.  Any L >= 1: the last chunk is masked (dt = 0 and
// x, b, c = 0 past L, so those tokens add nothing, and no row past L is
// written).  All offsets are 64-bit.  P in {16, 32, 64, 128}, N in
// {8, 16, 128}.
//
// What bounds it: at the serving path's layer (x [4,2048,80,64] bf16, b and
// c one group broadcast from [4,2048,128]) it moves 175 MB, 0.05 ms at
// 3.35 TB/s.  Its products, over the causal pairs with c.b once per group,
// are 2.7e10 FLOP: 0.03 ms on the bf16 tensor cores, 0.4 ms on the f32
// cores.  Two paths:
//
// bf16: the tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums).
// * ssd_scan_kernel_cb computes CB = C B^T once per (batch, chunk, group)
//   in f32: ngroups 1 makes it the same product for every head.  Only the
//   ten 16x16 blocks on or below the diagonal are computed and stored,
//   packed: [B, L/Q, G, 10, 16, 16], 10 KB a tile, 1.3 MB at the serving
//   layer, which stays in L2 for the scan.
// * ssd_scan_kernel_bf16 runs one block of P/16 warps per (batch, head).
//   Warp w owns 16 columns of P, and every product is computed transposed,
//   with those columns as the MMA's rows: y^T = S^T C'^T + X^T W^T and
//   S^T += X'^T B.  The state S^T [16, N] of a warp stays in f32 in its
//   accumulator registers across chunks; its fragment is already the A
//   operand of the next chunk's c.S.  Nothing about S crosses warps.
// * Operands that are not inputs are split into two bf16 terms, hi =
//   bf16(v) and lo = bf16(v - hi), each its own MMA: S (in c.S), W (built
//   from CB in f32, the decay and dt, then split), and x scaled by
//   exp(cum_Q - cum_j) dt_j (in the state update; scaling x in registers
//   leaves b as it was loaded).  One bf16 rounding of these misses the
//   2e-2 elementwise gate by up to 5x at N = 128 (tests/test_torch_ssd.py
//   holds a plain model of this arithmetic).  x, b and c are bf16 inputs
//   and enter as they are.
// * W x skips the six 16x16 blocks wholly above the diagonal.
// * A two-stage ring of cp.async copies: while chunk z computes, x, b, c
//   and dt of chunk z+1 are in flight, and chunk z+1's CB tile is fetched
//   once W of chunk z is built.  Tiles in shared memory are XOR-swizzled by
//   16-byte chunk so that ldmatrix and stmatrix hit distinct banks; y is
//   staged through the warp's own columns of the x tile (stmatrix) and
//   written in 16-byte stores.  104 KB of shared memory at P = 64, N = 128:
//   two blocks an SM.  cp.async needs 16-byte base pointers and
//   batch/sequence/head strides for x, b and c, which the wrapper checks.
// * Per chunk, three barriers: the ring has landed; cum, exp(cum) and the
//   state weights of the chunk (one warp's shuffle scan) are written; W is
//   built.
//
// f32: the f32 cores (ssd_scan_kernel_f32), held to 5e-4, which TF32 would
// not meet.
// * one thread block owns one (batch, head, slice of PS = 32 columns of P)
//   and walks the chunks of its sequence in order, S [N, PS] in shared
//   memory.  The columns of S are independent along P, so a P slice needs
//   only its own columns of x and S; the slices of one head repeat the c.b
//   product and the decay, which buys twice the blocks and two blocks an
//   SM;
// * 256 threads, four phases a chunk, each a register tile over shared
//   memory: W (4 rows x 4 columns a thread, N-long dot products), y (4
//   rows x PS/16 columns: Q-long W x plus N-long c S), b scaled by
//   exp(cum_Q - cum_j) dt_j in place (the TPU kernel's b * dec_to_end), and
//   S (4 rows of N at a time x PS/16 columns: a Q-long sum).  b and c rows
//   are padded by one word so that the 16 rows a half-warp reads fall in
//   16 banks;
// * the cumulative sum of a dt is one warp's shuffle scan.
// Shared memory is dynamic (108 KB at N = 128).
//
// Shared memory above 48 KB is set with cudaFuncSetAttribute; each launch's
// error is returned to the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;  // Q: tokens per chunk, both paths

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, l, h;  // elements; the stride along the last dimension is 1
};

// ===========================================================================
// f32: the f32 cores
// ===========================================================================
constexpr int kThreads = 256;  // 16 x 16: tx = tid & 15, ty = tid >> 4
constexpr int kRows = 4;       // rows of W and y a thread owns: kChunk / 16
constexpr int kStateRows = 4;  // rows of S a thread updates at a time
constexpr int kPitchW = kChunk + 1;

__host__ __device__ constexpr size_t smem_floats(int n, int ps) {
  return 2 * static_cast<size_t>(kChunk) * (n + 1)  // c, b
         + static_cast<size_t>(kChunk) * ps         // x
         + static_cast<size_t>(kChunk) * kPitchW    // W
         + static_cast<size_t>(n) * ps              // S
         + 4 * kChunk;                              // cum, dt, f, total
}

template <int PS>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel_f32(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const float* __restrict__ bm,
                        const float* __restrict__ cm,
                        const float* __restrict__ dskip,
                        float* __restrict__ y, int64_t seq, int heads,
                        int dim_p, int dim_n, Strides xs, Strides dts,
                        int64_t a_stride, Strides bs, Strides cs,
                        int64_t d_stride) {
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
  const float* xp = x + bb * xs.b + h * xs.h + p0;
  const float* dtp = dt + bb * dts.b + h * dts.h;
  const float* bp = bm + bb * bs.b + h * bs.h;
  const float* cp = cm + bb * cs.b + h * cs.h;
  const int64_t y_row = static_cast<int64_t>(heads) * dim_p;
  float* yp = y + bb * seq * y_row + static_cast<int64_t>(h) * dim_p + p0;

  for (int e = tid; e < dim_n * PS; e += kThreads) s_s[e] = 0.0f;

  const int64_t chunks = (seq + kChunk - 1) / kChunk;
  for (int64_t z = 0; z < chunks; ++z) {
    const int64_t l0 = z * kChunk;
    const int rows = static_cast<int>(seq - l0 < kChunk ? seq - l0 : kChunk);

    // -- load the chunk; zero past L ---------------
    for (int e = tid; e < kChunk * dim_n; e += kThreads) {
      const int r = e / dim_n;
      const int n = e - r * dim_n;
      const int64_t l = l0 + r;
      const bool ok = r < rows;
      b_s[r * pitch_n + n] = ok ? bp[l * bs.l + n] : 0.0f;
      c_s[r * pitch_n + n] = ok ? cp[l * cs.l + n] : 0.0f;
    }
    for (int e = tid; e < kChunk * PS; e += kThreads) {
      const int r = e / PS;
      const int p = e - r * PS;
      x_s[e] = r < rows ? xp[(l0 + r) * xs.l + p] : 0.0f;
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
          yp[(l0 + i) * y_row + p] = v;
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

// ===========================================================================
// bf16: the tensor cores
// ===========================================================================
constexpr int kTriBlocks = 10;  // 16x16 blocks of [Q,Q] on or below the diagonal
constexpr int kCbFloats = kTriBlocks * 256;  // one packed CB tile
constexpr int kCbThreads = 128;              // 4 warps, 16 rows of c each

// ten blocks (m, k), k <= m, packed row by row: index m (m + 1) / 2 + k
__host__ __device__ constexpr int tri_index(int m, int k) {
  return m * (m + 1) / 2 + k;
}
__device__ __forceinline__ int tri_row(int blk) {
  return blk >= 6 ? 3 : blk >= 3 ? 2 : blk >= 1 ? 1 : 0;
}

struct ScanArgs {
  const __nv_bfloat16* x;
  const float* dt;
  const float* a;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  const float* d;   // null: no D-skip
  const float* cb;  // [B, chunks, groups, kCbFloats], from ssd_scan_kernel_cb
  __nv_bfloat16* y;
  int64_t seq, chunks;
  int heads, groups;  // groups: 1 (b and c shared by every head) or heads
  Strides xs, dts, bs, cs;
  int64_t a_stride, d_stride;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}
__device__ __forceinline__ void stsm_x4_t(uint32_t addr,
                                          const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// d += a b: a the 16x16 A fragment, (b0, b1) the 16x8 B fragment
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
// v0, v1 -> hi = bf16(v), lo = bf16(v - hi), packed as pack_bf16
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

// fn(k) for k = tid, tid + THREADS, ... < COUNT: a loop of fixed trip count
template <int COUNT, int THREADS, typename Fn>
__device__ __forceinline__ void for_each(int tid, Fn&& fn) {
#pragma unroll
  for (int i = 0; i < (COUNT + THREADS - 1) / THREADS; ++i) {
    const int k = tid + i * THREADS;
    if (COUNT % THREADS == 0 || k < COUNT) fn(k);
  }
}

// The shared address of 16-byte chunk `ch` of row `r` in a tile whose rows
// hold CPR chunks.  Chunks are XORed with the row (mod 8) so that the 8
// rows one ldmatrix phase reads fall in distinct banks (where CPR >= 8).
template <int CPR>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int ch) {
  constexpr int kMask = (CPR < 8 ? CPR : 8) - 1;
  return base + static_cast<uint32_t>(r * CPR + (ch ^ (r & kMask))) * 16;
}
// The same for half `hh` of row `r` of packed 16x16 bf16 block `blk` (32-byte
// rows): rows 4-7 of each 8 swap their halves.
__device__ __forceinline__ uint32_t tri_addr(uint32_t base, int blk, int r,
                                             int hh) {
  return base + static_cast<uint32_t>(blk * 512 + r * 32 +
                                      ((hh ^ (r >> 2)) & 1) * 16);
}

// CB = C B^T of one (chunk, group, batch): [Q,Q] f32, the ten blocks on or
// below the diagonal.  Warp w computes rows 16w..16w+15.  N = 8 is padded
// to the MMA's k of 16 with zeros.
template <int N>
__global__ void __launch_bounds__(kCbThreads)
    ssd_scan_kernel_cb(const __nv_bfloat16* __restrict__ bm,
                       const __nv_bfloat16* __restrict__ cm,
                       float* __restrict__ cb, int64_t seq, int64_t chunks,
                       int groups, Strides bs, Strides cs) {
  constexpr int kNK = N < 16 ? 16 : N;
  constexpr int kCC = kNK / 8;  // 16-byte chunks a row in shared memory
  constexpr int kBC = N / 8;    // of which loaded
  __shared__ __align__(128) unsigned char smem[2 * kChunk * kNK * 2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;
  const int64_t z = blockIdx.x;
  const int grp = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t l0 = z * kChunk;
  const int rows = static_cast<int>(seq - l0 < kChunk ? seq - l0 : kChunk);
  const __nv_bfloat16* cp = cm + bb * cs.b + grp * cs.h;
  const __nv_bfloat16* bp = bm + bb * bs.b + grp * bs.h;
  const uint32_t c_s = smem_u32(smem);
  const uint32_t b_s = c_s + kChunk * kNK * 2;

  for (int k = tid; k < kChunk * kCC; k += kCbThreads) {
    const int r = k / kCC;
    const int ch = k - r * kCC;
    uint4 vc = make_uint4(0, 0, 0, 0), vb = vc;
    if (ch < kBC && r < rows) {
      vc = *reinterpret_cast<const uint4*>(cp + (l0 + r) * cs.l + ch * 8);
      vb = *reinterpret_cast<const uint4*>(bp + (l0 + r) * bs.l + ch * 8);
    }
    *reinterpret_cast<uint4*>(smem + (tile_addr<kCC>(c_s, r, ch) - c_s)) = vc;
    *reinterpret_cast<uint4*>(smem + (tile_addr<kCC>(b_s, r, ch) - c_s)) = vb;
  }
  __syncthreads();

  float* out = cb + ((bb * chunks + z) * groups + grp) * kCbFloats;
  const int m = warp;
  for (int kb = 0; kb <= m; ++kb) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kNK / 16; ++kk) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, tile_addr<kCC>(c_s, 16 * m + rr + 8 * (mi & 1),
                                 2 * kk + (mi >> 1)));
      ldsm_x4(bf, tile_addr<kCC>(b_s, 16 * kb + rr + 8 * (mi >> 1),
                                 2 * kk + (mi & 1)));
      mma(acc[0], af, bf[0], bf[1]);
      mma(acc[1], af, bf[2], bf[3]);
    }
    float* o = out + tri_index(m, kb) * 256;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      *reinterpret_cast<float2*>(o + g * 16 + 8 * t + 2 * q) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(o + (g + 8) * 16 + 8 * t + 2 * q) =
          make_float2(acc[t][2], acc[t][3]);
    }
  }
}

// Shared memory of ssd_scan_kernel_bf16, in bytes: two stages of (x, b, c,
// dt), the CB tile, W hi and lo, and cum, exp(cum), the state weights and
// cum_Q.
template <int P, int N>
struct ScanSmem {
  static constexpr int kNK = N < 16 ? 16 : N;  // c's row, padded to the k of 16
  static constexpr int kX = kChunk * P * 2;
  static constexpr int kB = kChunk * N * 2;
  static constexpr int kC = kChunk * kNK * 2;
  static constexpr int kStage = kX + kB + kC + kChunk * 4;
  static constexpr int kCb = 2 * kStage;
  static constexpr int kWhi = kCb + kCbFloats * 4;
  static constexpr int kWlo = kWhi + kTriBlocks * 512;
  static constexpr int kVec = kWlo + kTriBlocks * 512;
  static constexpr int kBytes = kVec + 3 * kChunk * 4 + 16;
};

template <int P, int N>
__global__ void __launch_bounds__(2 * P)
    ssd_scan_kernel_bf16(const ScanArgs args) {
  using Smem = ScanSmem<P, N>;
  constexpr int kThr = 2 * P;  // P/16 warps
  constexpr int kNK = Smem::kNK;
  constexpr int kNT = N / 8;   // 8-column tiles of S^T
  constexpr int kXC = P / 8;   // 16-byte chunks a row: x, b, c
  constexpr int kBC = N / 8;
  constexpr int kCC = kNK / 8;
  extern __shared__ __align__(128) unsigned char sm[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;  // ldmatrix: matrix, row
  const int h = blockIdx.x;
  const int64_t bb = blockIdx.y;
  const int grp = args.groups == 1 ? 0 : h;
  const float a_h = args.a[h * args.a_stride];
  const bool has_d = args.d != nullptr;
  const float d_h = has_d ? args.d[h * args.d_stride] : 0.0f;
  const __nv_bfloat16* xp = args.x + bb * args.xs.b + h * args.xs.h;
  const float* dtp = args.dt + bb * args.dts.b + h * args.dts.h;
  const __nv_bfloat16* bp = args.b + bb * args.bs.b + h * args.bs.h;
  const __nv_bfloat16* cp = args.c + bb * args.cs.b + h * args.cs.h;
  const float* cbp =
      args.cb + (bb * args.chunks * args.groups + grp) * kCbFloats;
  const int64_t cb_step = static_cast<int64_t>(args.groups) * kCbFloats;
  const int64_t y_row = static_cast<int64_t>(args.heads) * P;
  const int p0 = 16 * warp;
  __nv_bfloat16* yp = args.y + bb * args.seq * y_row +
                      static_cast<int64_t>(h) * P + p0;
  const uint32_t sbase = smem_u32(sm);
  float* cum_s = reinterpret_cast<float*>(sm + Smem::kVec);
  float* e_s = cum_s + kChunk;      // exp(cum_i)
  float* f_s = e_s + kChunk;        // exp(cum_Q - cum_j) dt_j
  float* total_s = f_s + kChunk;    // cum_Q
  const float* cb_s = reinterpret_cast<const float*>(sm + Smem::kCb);

  // chunk z of x, b, c (bf16) and dt into stage st; zeros past L
  auto load_chunk = [&](int st, int64_t z) {
    const int64_t l0 = z * kChunk;
    const int rows = static_cast<int>(
        args.seq - l0 < kChunk ? args.seq - l0 : kChunk);
    const uint32_t xs = sbase + st * Smem::kStage;
    const uint32_t bs = xs + Smem::kX;
    const uint32_t cs = bs + Smem::kB;
    const uint32_t ds = cs + Smem::kC;
    for_each<kChunk * kXC, kThr>(tid, [&](int k) {
      const int r = k / kXC, ch = k % kXC;
      const bool ok = r < rows;
      cp_async16(tile_addr<kXC>(xs, r, ch),
                 xp + (ok ? (l0 + r) * args.xs.l + ch * 8 : 0), ok);
    });
    for_each<kChunk * kBC, kThr>(tid, [&](int k) {
      const int r = k / kBC, ch = k % kBC;
      const bool ok = r < rows;
      cp_async16(tile_addr<kBC>(bs, r, ch),
                 bp + (ok ? (l0 + r) * args.bs.l + ch * 8 : 0), ok);
      cp_async16(tile_addr<kCC>(cs, r, ch),
                 cp + (ok ? (l0 + r) * args.cs.l + ch * 8 : 0), ok);
    });
    for_each<kChunk, kThr>(tid, [&](int k) {
      const bool ok = k < rows;
      cp_async4(ds + 4 * k, dtp + (ok ? (l0 + k) * args.dts.l : 0), ok);
    });
  };
  auto load_cb = [&](int64_t z) {
    const float* src = cbp + z * cb_step;
    for_each<kCbFloats / 4, kThr>(tid, [&](int k) {
      cp_async16(sbase + Smem::kCb + 16 * k, src + 4 * k, true);
    });
  };

  if constexpr (N < 16) {  // c's padding columns stay 0 (S's are 0 too)
    for (int r = tid; r < 2 * kChunk; r += kThr) {
      const uint32_t cs = sbase + (r / kChunk) * Smem::kStage + Smem::kX +
                          Smem::kB;
      *reinterpret_cast<uint4*>(
          sm + (tile_addr<kCC>(cs, r % kChunk, 1) - sbase)) =
          make_uint4(0, 0, 0, 0);
    }
  }

  float S[kNT][4];  // S^T [16 columns of P, N], f32, across chunks
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int v = 0; v < 4; ++v) S[t][v] = 0.0f;

  load_chunk(0, 0);
  load_cb(0);
  cp_async_commit();

  for (int64_t z = 0; z < args.chunks; ++z) {
    const int st = static_cast<int>(z & 1);
    const int64_t l0 = z * kChunk;
    const int rows = static_cast<int>(
        args.seq - l0 < kChunk ? args.seq - l0 : kChunk);
    const uint32_t xs = sbase + st * Smem::kStage;
    const uint32_t bs = xs + Smem::kX;
    const uint32_t cs = bs + Smem::kB;
    const float* dt_s =
        reinterpret_cast<const float*>(sm + (cs - sbase) + Smem::kC);

    // (1) chunk z and its CB tile have landed, and every warp is done with
    // chunk z-1: its stage may be refilled
    cp_async_wait_all();
    __syncthreads();
    if (z + 1 < args.chunks) load_chunk(st ^ 1, z + 1);
    cp_async_commit();

    // warp 0: cum (inclusive scan of a dt, two tokens a lane), exp(cum),
    // the state weights exp(cum_Q - cum_j) dt_j, cum_Q
    if (warp == 0) {
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
      f_s[r0] = expf(total - cum0) * dt0;
      f_s[r1] = expf(total - cum1) * dt1;
      if (lane == 0) total_s[0] = total;
    }
    // (2)
    __syncthreads();

    // W[i,j] = CB[i,j] exp(cum_i - cum_j) dt_j for j <= i, else 0, in f32,
    // then split into bf16 hi and lo; four columns a step
    for_each<kTriBlocks * 64, kThr>(tid, [&](int k) {
      const int blk = k >> 6, w = k & 63;
      const int r = w >> 2, col = 4 * (w & 3);
      const int m = tri_row(blk);
      const int i = 16 * m + r;
      const int j = 16 * (blk - tri_index(m, 0)) + col;
      const float4 v =
          *reinterpret_cast<const float4*>(cb_s + blk * 256 + r * 16 + col);
      const float4 cj = *reinterpret_cast<const float4*>(cum_s + j);
      const float4 dj = *reinterpret_cast<const float4*>(dt_s + j);
      const float ci = cum_s[i];
      const float w0 = j <= i ? v.x * expf(ci - cj.x) * dj.x : 0.0f;
      const float w1 = j + 1 <= i ? v.y * expf(ci - cj.y) * dj.y : 0.0f;
      const float w2 = j + 2 <= i ? v.z * expf(ci - cj.z) * dj.z : 0.0f;
      const float w3 = j + 3 <= i ? v.w * expf(ci - cj.w) * dj.w : 0.0f;
      uint2 hi, lo;
      split_bf16(w0, w1, hi.x, lo.x);
      split_bf16(w2, w3, hi.y, lo.y);
      const uint32_t off =
          tri_addr(0, blk, r, col >> 3) + 2 * static_cast<uint32_t>(col & 7);
      *reinterpret_cast<uint2*>(sm + Smem::kWhi + off) = hi;
      *reinterpret_cast<uint2*>(sm + Smem::kWlo + off) = lo;
    });
    // (3) W is built; the CB buffer is free for chunk z+1
    __syncthreads();
    if (z + 1 < args.chunks) load_cb(z + 1);
    cp_async_commit();

    // ---- warp w: columns p0..p0+15 of P ---------------------------------
    // x^T as A fragments [16 columns, 16 tokens], one per 16 tokens
    uint32_t xa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm_x4_t(xa[kk], tile_addr<kXC>(xs, 16 * kk + rr + 8 * (mi >> 1),
                                       2 * warp + (mi & 1)));

    // y^T = exp(cum) * (S^T c^T) + x^T W^T: 8 tiles of 8 tokens
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[t][v] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kNK / 16; ++kk) {
      uint32_t sh[4], sl[4];  // S^T [16, 16 of N] as hi + lo A fragments
      split_bf16(S[2 * kk][0], S[2 * kk][1], sh[0], sl[0]);
      split_bf16(S[2 * kk][2], S[2 * kk][3], sh[1], sl[1]);
      if constexpr (kNT > 1) {
        split_bf16(S[2 * kk + 1][0], S[2 * kk + 1][1], sh[2], sl[2]);
        split_bf16(S[2 * kk + 1][2], S[2 * kk + 1][3], sh[3], sl[3]);
      } else {
        sh[2] = sh[3] = sl[2] = sl[3] = 0u;
      }
      uint32_t cf[4][4];  // c [16 tokens, 16 of N] as two B fragments
#pragma unroll
      for (int m = 0; m < 4; ++m)
        ldsm_x4(cf[m], tile_addr<kCC>(cs, 16 * m + rr + 8 * (mi >> 1),
                                      2 * kk + (mi & 1)));
      // hi into all eight tiles, then lo: no MMA waits on the one before
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma(acc[2 * m], sh, cf[m][0], cf[m][1]);
        mma(acc[2 * m + 1], sh, cf[m][2], cf[m][3]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma(acc[2 * m], sl, cf[m][0], cf[m][1]);
        mma(acc[2 * m + 1], sl, cf[m][2], cf[m][3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float2 ev = *reinterpret_cast<const float2*>(e_s + 8 * t + 2 * q);
      acc[t][0] *= ev.x;
      acc[t][1] *= ev.y;
      acc[t][2] *= ev.x;
      acc[t][3] *= ev.y;
    }
    // x^T W^T over the blocks on or below the diagonal: for each 16 tokens
    // j, the row blocks m >= kb, hi into all then lo
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      uint32_t wh[4][4], wl[4][4];
      const int r = rr + 8 * (mi >> 1);
#pragma unroll
      for (int m = kb; m < 4; ++m) {
        const uint32_t off = tri_addr(0, tri_index(m, kb), r, mi & 1);
        ldsm_x4(wh[m], sbase + Smem::kWhi + off);
        ldsm_x4(wl[m], sbase + Smem::kWlo + off);
      }
#pragma unroll
      for (int m = kb; m < 4; ++m) {
        mma(acc[2 * m], xa[kb], wh[m][0], wh[m][1]);
        mma(acc[2 * m + 1], xa[kb], wh[m][2], wh[m][3]);
      }
#pragma unroll
      for (int m = kb; m < 4; ++m) {
        mma(acc[2 * m], xa[kb], wl[m][0], wl[m][1]);
        mma(acc[2 * m + 1], xa[kb], wl[m][2], wl[m][3]);
      }
    }
    if (has_d) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 x0 = unpack_bf16(xa[kk][2 * hh]);      // column g
          const float2 x1 = unpack_bf16(xa[kk][2 * hh + 1]);  // column g + 8
          float* o = acc[2 * kk + hh];
          o[0] += d_h * x0.x;
          o[1] += d_h * x0.y;
          o[2] += d_h * x1.x;
          o[3] += d_h * x1.y;
        }
    }
    // y: rounded once, transposed into this warp's own columns of the x
    // tile (read above, and by no other warp), then 16-byte rows out
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t r4[4] = {pack_bf16(acc[2 * t][0], acc[2 * t][1]),
                              pack_bf16(acc[2 * t][2], acc[2 * t][3]),
                              pack_bf16(acc[2 * t + 1][0], acc[2 * t + 1][1]),
                              pack_bf16(acc[2 * t + 1][2], acc[2 * t + 1][3])};
      stsm_x4_t(tile_addr<kXC>(xs, 16 * t + rr + 8 * (mi >> 1),
                               2 * warp + (mi & 1)),
                r4);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int k = lane + 32 * it;
      const int r = k >> 1, hh = k & 1;
      if (r < rows) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            sm + (tile_addr<kXC>(xs, r, 2 * warp + hh) - sbase));
        *reinterpret_cast<uint4*>(yp + (l0 + r) * y_row + 8 * hh) = v;
      }
    }

    // S^T = exp(cum_Q) S^T + (x^T diag(exp(cum_Q - cum) dt)) b, the scaled
    // x split into hi and lo
    const float decay = expf(total_s[0]);
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v) S[t][v] *= decay;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 f0 = *reinterpret_cast<const float2*>(f_s + 16 * kk + 2 * q);
      const float2 f1 =
          *reinterpret_cast<const float2*>(f_s + 16 * kk + 8 + 2 * q);
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float2 xv = unpack_bf16(xa[kk][v]);
        const float2 fv = v < 2 ? f0 : f1;
        split_bf16(xv.x * fv.x, xv.y * fv.y, ph[v], pl[v]);
      }
      if constexpr (kNT == 1) {
        uint32_t bf[2];  // b [16 tokens, 8] as one B fragment
        ldsm_x2_t(bf, tile_addr<kBC>(bs, 16 * kk + rr + 8 * (mi & 1), 0));
        mma(S[0], ph, bf[0], bf[1]);
        mma(S[0], pl, bf[0], bf[1]);
      } else {
        // 32 columns of N at a time: hi into four tiles, then lo
        constexpr int kPair = kNT >= 4 ? 2 : 1;
#pragma unroll
        for (int t4 = 0; t4 < kNT / 2; t4 += kPair) {
          uint32_t bf[kPair][4];  // b [16 tokens, 16 of N]: two B fragments
#pragma unroll
          for (int u = 0; u < kPair; ++u)
            ldsm_x4_t(bf[u], tile_addr<kBC>(bs, 16 * kk + rr + 8 * (mi & 1),
                                            2 * (t4 + u) + (mi >> 1)));
#pragma unroll
          for (int u = 0; u < kPair; ++u) {
            mma(S[2 * (t4 + u)], ph, bf[u][0], bf[u][1]);
            mma(S[2 * (t4 + u) + 1], ph, bf[u][2], bf[u][3]);
          }
#pragma unroll
          for (int u = 0; u < kPair; ++u) {
            mma(S[2 * (t4 + u)], pl, bf[u][0], bf[u][1]);
            mma(S[2 * (t4 + u) + 1], pl, bf[u][2], bf[u][3]);
          }
        }
      }
    }
  }
}

template <int PS>
cudaError_t launch_f32(const float* x, const float* dt, const float* a,
                       const float* b, const float* c, const float* d,
                       float* y, int64_t batch, int64_t seq, int heads,
                       int dim_p, int dim_n, Strides xs, Strides dts,
                       int64_t a_stride, Strides bs, Strides cs,
                       int64_t d_stride, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel_f32<PS>;
  const size_t bytes = sizeof(float) * smem_floats(dim_n, PS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(dim_p / PS),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, bytes, stream>>>(x, dt, a, b, c, d, y, seq, heads,
                                            dim_p, dim_n, xs, dts, a_stride,
                                            bs, cs, d_stride);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_bf16(const ScanArgs& args, float* cb, int64_t batch,
                        cudaStream_t stream) {
  const dim3 cb_grid(static_cast<unsigned>(args.chunks),
                     static_cast<unsigned>(args.groups),
                     static_cast<unsigned>(batch));
  ssd_scan_kernel_cb<N><<<cb_grid, kCbThreads, 0, stream>>>(
      args.b, args.c, cb, args.seq, args.chunks,
      args.groups, args.bs, args.cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = ssd_scan_kernel_bf16<P, N>;
  const int bytes = ScanSmem<P, N>::kBytes;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(args.heads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, 2 * P, bytes, stream>>>(args);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_bf16_n(const ScanArgs& args, float* cb, int64_t batch,
                          int dim_n, cudaStream_t s) {
  if (dim_n == 8) return launch_bf16<P, 8>(args, cb, batch, s);
  if (dim_n == 16) return launch_bf16<P, 16>(args, cb, batch, s);
  return launch_bf16<P, 128>(args, cb, batch, s);
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
// x's type.  bf16 only: cb is f32 scratch of batch * ceil(seq / 64) *
// groups * 2560 floats, and groups is 1 where b and c are the same for
// every head (read at head 0), else heads; x, b and c need 16-byte base
// pointers and strides.  Returns the first launch error (0 on success); it
// does not synchronise.
int repro_ssd_scan(const void* x, const float* dt, const float* a,
                   const void* b, const void* c, const float* d, void* y,
                   float* cb, int64_t batch, int64_t seq, int64_t heads,
                   int64_t groups, int64_t dim_p, int64_t dim_n, int64_t x_sb,
                   int64_t x_sl, int64_t x_sh, int64_t dt_sb, int64_t dt_sl,
                   int64_t dt_sh, int64_t a_stride, int64_t b_sb,
                   int64_t b_sl, int64_t b_sh, int64_t c_sb, int64_t c_sl,
                   int64_t c_sh, int64_t d_stride, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535 || !supported_p(dim_p) || !supported_n(dim_n))
    return cudaErrorInvalidValue;
  const Strides xs{x_sb, x_sl, x_sh}, dts{dt_sb, dt_sl, dt_sh},
      bs{b_sb, b_sl, b_sh}, cs{c_sb, c_sl, c_sh};
  const int hh = static_cast<int>(heads);
  const int p = static_cast<int>(dim_p);
  const int n = static_cast<int>(dim_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const float* xf = static_cast<const float*>(x);
    const float* bf = static_cast<const float*>(b);
    const float* cf = static_cast<const float*>(c);
    float* yf = static_cast<float*>(y);
    if (p % 32 == 0)
      return launch_f32<32>(xf, dt, a, bf, cf, d, yf, batch, seq, hh, p, n,
                            xs, dts, a_stride, bs, cs, d_stride, s);
    return launch_f32<16>(xf, dt, a, bf, cf, d, yf, batch, seq, hh, p, n, xs,
                          dts, a_stride, bs, cs, d_stride, s);
  }
  if (dtype != kBF16 || cb == nullptr || (groups != 1 && groups != heads))
    return cudaErrorInvalidValue;
  const int64_t chunks = (seq + kChunk - 1) / kChunk;
  if (chunks > 0x7fffffff) return cudaErrorInvalidValue;
  const ScanArgs args{static_cast<const __nv_bfloat16*>(x),
                      dt,
                      a,
                      static_cast<const __nv_bfloat16*>(b),
                      static_cast<const __nv_bfloat16*>(c),
                      d,
                      cb,
                      static_cast<__nv_bfloat16*>(y),
                      seq,
                      chunks,
                      hh,
                      static_cast<int>(groups),
                      xs,
                      dts,
                      bs,
                      cs,
                      a_stride,
                      d_stride};
  switch (p) {
    case 16: return launch_bf16_n<16>(args, cb, batch, n, s);
    case 32: return launch_bf16_n<32>(args, cb, batch, n, s);
    case 64: return launch_bf16_n<64>(args, cb, batch, n, s);
    default: return launch_bf16_n<128>(args, cb, batch, n, s);
  }
}

const char* repro_ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
