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
//   lse_i  = log sum_j exp(s[i,j])            (only where lse != nullptr)
// with an online softmax in f32 (running max m, running sum l, output
// accumulator acc), as _attn_kernel does.  l == 0 (no key seen) divides by
// 1, as _attn_kernel's guard does.  Causal with Sq > Sk is refused by the
// wrapper: rows would see no key.  The sum order is fixed and there are no
// atomics: a prefill is deterministic.  All offsets are 64-bit.
//
// What bounds it: operations.  Causal attention at the serving path's
// [4,32,2048,128] bf16 does 1.4e11 FLOP over 1.7e8 bytes, some 800 FLOP a
// byte, far above the card's ridge point.  Two instantiations:
//
// bf16 (flash_attention_kernel_bf16): the bf16 tensor cores (989 TFLOP/s),
// fed by the Tensor Memory Accelerator (TMA).
// * A thread block owns one (b, hq, tile of 128 query rows) and runs three
//   warpgroups.  The producer warpgroup gives up registers (setmaxnreg) and
//   one of its threads issues every copy: the Q tile once, then K_j and V_j
//   into a two-stage ring in shared memory, each stage with a "full"
//   mbarrier per tensor (TMA completes its bytes there) and an "empty"
//   mbarrier the consumers arrive at.  Two consumer warpgroups take the
//   registers and own 64 query rows each.  Key tiles are 128 keys (64 at
//   D = 256, so the ring fits in shared memory).
// * Tiles land 128-byte swizzled (64- or 32-byte where a row is shorter),
//   in chunks of 64 columns.  The tensor maps are 4-D over [B, H, S, D] with
//   the tensors' real strides, so transposed views are read as they are;
//   TMA fills rows past Sq or Sk with zeros.  The maps are encoded on the
//   host for each call (cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point, so no -lcuda) and passed as
//   __grid_constant__ parameters.
// * S = Q K^T is wgmma m64n{block_k}k16 with both operands in shared memory
//   (D/16 steps), accumulated in f32 registers.  The softmax works on that
//   fragment: a row is spread over the 4 threads of a quad, so its max is
//   2 shuffles; exp2f with log2(e) folded into the scale; the mask is
//   applied only on tiles that cross the causal diagonal or the ragged Sk
//   edge, and a masked probability is 0 outright.  The running sum stays
//   per thread and is reduced over the quad once, at the end.
// * O += P V: P is rounded to bf16 in registers, where the S fragment is
//   already the layout of wgmma's A operand from registers; V is read from
//   shared memory as an MN-major B operand (the transpose bit).  O stays in
//   f32 registers, rescaled by each tile's correction; at the end it is
//   divided by l and rounded to bf16 once.
// * Key tiles are walked from 0 upward and the walk stops at the last tile
//   any row of the block can see (the causal skip of _attn_kernel's
//   pl.when).  Masked scores are -1e30, as in the TPU kernel, and every
//   row (Sq <= Sk) sees key 0 in the first tile.  Heavy (late) query tiles
//   are launched first.
//
// f32 (flash_attention_kernel_f32): the f32 cores (67 TFLOP/s), held to
// 3e-5, which TF32 cannot meet.  One thread block owns a (b, hq, tile of 64
// query rows); 256 threads, each with 4 query rows and, of each 64-key
// tile, 4 score columns and D/16 output columns; Q, K and V tiles widened
// in shared memory (rows padded by one word against bank conflicts); the
// 16 threads of a row are one half-warp, so row max and sum are shuffles.
// Every product and sum is f32, and the output is rounded once.
//
// Shared memory is dynamic, set per instantiation with
// cudaFuncSetAttribute; the launch's error is returned to the caller.  The
// mbarrier, TMA and wgmma helpers and the tensor-map encoding live in
// hopper.cuh, shared with the backward (flash_attention_bwd.cu).

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // _attn_kernel's NEG_INF
constexpr float kLog2E = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, h, s;  // elements; the stride along D is 1
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// ---------------------------------------------------------------------------
// f32: the f32 cores
// ---------------------------------------------------------------------------
constexpr int kF32BlockQ = 64;
constexpr int kF32BlockK = 64;
constexpr int kF32Threads = 256;
constexpr int kRowsPerThread = 4;  // kF32BlockQ / (kF32Threads / 16)
constexpr int kColsPerThread = 4;  // kF32BlockK / 16

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

// Copies rows [row0, row0 + kRows) of one head into shared memory with a
// row pitch of `pitch` floats; rows at or past `rows` are zero.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, int pitch,
                                          const float* __restrict__ src,
                                          int64_t row_stride, int64_t row0,
                                          int64_t rows) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * D; e += kF32Threads) {
    const int r = e / D;
    const int d = e - r * D;
    const int64_t row = row0 + r;
    dst[r * pitch + d] = row < rows ? src[row * row_stride + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_attention_kernel_f32(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse, int heads_q,
                               int group, int64_t seq_q, int64_t seq_k,
                               Strides qs, Strides ks, Strides vs, int causal,
                               float scale) {
  constexpr int kPitchQK = D + 1;
  constexpr int kPitchP = kF32BlockK + 1;
  constexpr int kOutCols = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                           // [kF32BlockQ][D + 1]
  float* k_s = q_s + kF32BlockQ * kPitchQK;    // [kF32BlockK][D + 1]
  float* v_s = k_s + kF32BlockK * kPitchQK;    // [kF32BlockK][D]
  float* p_s = v_s + kF32BlockK * D;           // [kF32BlockQ][kF32BlockK + 1]

  const int tx = threadIdx.x & 15;  // column group
  const int ty = threadIdx.x >> 4;  // row group: rows ty*4 .. ty*4+3
  const int64_t q_tile = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int64_t q0 = q_tile * kF32BlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads_q;
  const int h = bh - b * heads_q;
  const int hk = h / group;
  const int64_t offset = seq_k - seq_q;

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  // keys this block can see: all of them, or (causal) up to its last row's
  int64_t k_end = seq_k;
  if (causal) {
    const int64_t last_row = min64(q0 + kF32BlockQ, seq_q) - 1;
    k_end = min64(seq_k, last_row + offset + 1);
  }
  const int64_t k_tiles =
      k_end > 0 ? (k_end + kF32BlockK - 1) / kF32BlockK : 0;

  load_tile<D, kF32BlockQ>(q_s, kPitchQK, qp, qs.s, q0, seq_q);

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
    const int64_t k0 = t * kF32BlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D, kF32BlockK>(k_s, kPitchQK, kp, ks.s, k0, seq_k);
    load_tile<D, kF32BlockK>(v_s, D, vp, vs.s, k0, seq_k);
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
    for (int kk = 0; kk < kF32BlockK; ++kk) {
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

  float* op = out + static_cast<int64_t>(bh) * seq_q * D;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int64_t row = q0 + ty * kRowsPerThread + i;
    if (row >= seq_q) continue;
    const float l_safe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kOutCols; ++c)
      op[row * D + tx + 16 * c] = acc[i][c] / l_safe;
    // m and l are the row's (reduced over the half-warp); natural log
    if (lse != nullptr && tx == 0)
      lse[static_cast<int64_t>(bh) * seq_q + row] =
          l[i] > 0.0f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* lse, int64_t batch, int heads_q,
                       int group,
                       int64_t seq_q, int64_t seq_k, Strides qs, Strides ks,
                       Strides vs, int causal, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_attention_kernel_f32<D>;
  constexpr size_t bytes =
      sizeof(float) * (2 * kF32BlockQ * (D + 1) + kF32BlockK * D +
                       kF32BlockQ * (kF32BlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((seq_q + kF32BlockQ - 1) / kF32BlockQ),
      static_cast<unsigned>(batch * heads_q));
  kernel<<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, heads_q,
      group, seq_q, seq_k, qs, ks, vs, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
constexpr int kBlockQ = 128;          // query rows of a block
constexpr int kConsumerRows = 64;     // query rows of a consumer warpgroup
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 64 : 128;
  static constexpr int kRowElems = D < 64 ? D : 64;  // columns of a chunk
  static constexpr int kRowBytes = 2 * kRowElems;     // = the swizzle span
  static constexpr int kChunks = D / kRowElems;
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKVBytes = kBlockK * D * 2;
  static constexpr int kBarrierOffset = kQBytes + 4 * kKVBytes;
  // Q, two stages of K and V, seven barriers, and room to align to 1024
  static constexpr int kSmemBytes = kBarrierOffset + 64 + 1024;
  // wgmma descriptor layout type (hopper.cuh: layout_for)
  static constexpr uint64_t kLayout = layout_for(kRowBytes);
  static_assert(D % 16 == 0 && D <= 256, "head_dim");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// The online-softmax step on one tile's scores s (this thread's part of
// the m64n{block_k} fragment: element 4j + 2r + e is row r's column
// 8j + 2*quad_lane + e).  Scales s into the log2 domain, masks (kMask),
// updates m and the thread's partial l, returns each row's correction in
// corr and leaves P in s.
template <int kCols, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kCols / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             float scale_log2, int64_t k0,
                                             int col0, int64_t q_pos0,
                                             int64_t seq_k, int causal) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * scale_log2;
    if (kMask) {
      const int64_t key = k0 + col0 + 8 * (i >> 2) + (i & 1);
      const int64_t q_pos = q_pos0 + 8 * r;
      if (key >= seq_k || (causal && key > q_pos)) x = kNegInf;
    }
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) {
    const int r = (i >> 1) & 1;
    const float p = (kMask && s[i] == kNegInf) ? 0.0f : exp2f(s[i] - m[r]);
    s[i] = p;
    sum[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// kLse: write the row log-sum-exp (training); serving's instantiation has
// no code for it
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel_bf16(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ lse, int heads_q,
                                int group, int seq_q, int seq_k, int causal,
                                float scale_log2) {
  using T = Tile<D>;
  constexpr int kBlockK = T::kBlockK;
  constexpr int kRowBytes = T::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + T::kQBytes;  // K0, K1, V0, V1
  const uint32_t bars = base + T::kBarrierOffset;  // seven 8-byte mbarriers
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8 + 8 * st; };
  auto full_v = [&](int st) { return bars + 24 + 8 * st; };
  auto empty = [&](int st) { return bars + 40 + 8 * st; };
  auto k_stage = [&](int st) { return kv_s + st * T::kKVBytes; };
  auto v_stage = [&](int st) { return kv_s + (2 + st) * T::kKVBytes; };

  const int q_tile = gridDim.x - 1 - blockIdx.x;  // heavy tiles first
  const int q0 = q_tile * kBlockQ;
  const int bh = blockIdx.y;
  const int b = bh / heads_q;
  const int h = bh - b * heads_q;
  const int offset = seq_k - seq_q;

  // keys this block can see: all of them, or (causal) up to its last row's
  int k_end = seq_k;
  if (causal) {
    const int last_row = (q0 + kBlockQ < seq_q ? q0 + kBlockQ : seq_q) - 1;
    k_end = seq_k < last_row + offset + 1 ? seq_k : last_row + offset + 1;
  }
  const int k_tiles = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int hk = h / group;
      mbar_expect_tx(full_q, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_s + c * kBlockQ * kRowBytes, &q_map, c * T::kRowElems, q0,
                 h, b, full_q);
      for (int t = 0; t < k_tiles; ++t) {
        const int st = t & 1;
        // tile t - 2 used this stage: wait until both consumers are done
        if (t >= 2) mbar_wait(empty(st), ((t >> 1) & 1) ^ 1);
        mbar_expect_tx(full_k(st), T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(k_stage(st) + c * kBlockK * kRowBytes, &k_map,
                   c * T::kRowElems, t * kBlockK, hk, b, full_k(st));
        mbar_expect_tx(full_v(st), T::kKVBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(v_stage(st) + c * kBlockK * kRowBytes, &v_map,
                   c * T::kRowElems, t * kBlockK, hk, b, full_v(st));
      }
    }
  } else {
    // consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int col0 = 2 * (lane & 3);
    // this thread's rows: row0 and row0 + 8 of the block's output
    const int row0 = q0 + cw * kConsumerRows + 16 * warp + (lane >> 2);
    const int64_t q_pos0 = static_cast<int64_t>(row0) + offset;
    const int first_pos = q0 + cw * kConsumerRows + offset;
    const uint32_t q_a = q_s + cw * kConsumerRows * kRowBytes;
    constexpr uint32_t kSbo = 8 * kRowBytes;  // 8 rows of a chunk
    constexpr int kStepsPerChunk = kRowBytes / 32;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(full_q, 0);
    for (int t = 0; t < k_tiles; ++t) {
      const int st = t & 1;
      const uint32_t parity = (t >> 1) & 1;
      const int k0 = t * kBlockK;

      // S = Q K^T
      mbar_wait(full_k(st), parity);
      float s[kBlockK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / kStepsPerChunk;
        const int w = kk % kStepsPerChunk;
        const uint64_t da = make_desc(
            q_a + c * kBlockQ * kRowBytes + 32 * w, 16, kSbo, T::kLayout);
        const uint64_t db = make_desc(
            k_stage(st) + c * kBlockK * kRowBytes + 32 * w, 16, kSbo,
            T::kLayout);
        wgmma_ss<kBlockK>(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      float corr[2];
      const bool mask = k0 + kBlockK > seq_k ||
                        (causal && k0 + kBlockK - 1 > first_pos);
      if (mask)
        softmax_tile<kBlockK, true>(s, m, l, corr, scale_log2, k0, col0,
                                    q_pos0, seq_k, causal);
      else
        softmax_tile<kBlockK, false>(s, m, l, corr, scale_log2, k0, col0,
                                     q_pos0, seq_k, causal);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P as wgmma A fragments: k-step kk holds columns 16 kk .. 16 kk + 15
      uint32_t p[kBlockK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(full_v(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        // keys 16 kk .. 16 kk + 15 of the V tile; N spans the chunks
        const uint64_t db =
            make_desc(v_stage(st) + 16 * kk * kRowBytes,
                      kBlockK * kRowBytes, kSbo, T::kLayout);
        if constexpr (D == 256) {
          wgmma_rs<128>(o, p[kk], db);
          wgmma_rs<128>(o + 64, p[kk],
                        db + ((2 * kBlockK * kRowBytes) >> 4));
        } else {
          wgmma_rs<(D < 128 ? D : 128)>(o, p[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // o / l, rounded to bf16 once
    float l_tot[2], l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_tot[r] = quad_sum(l[r]);
      l_safe[r] = l_tot[r] == 0.0f ? 1.0f : l_tot[r];
    }
    __nv_bfloat16* op = out + static_cast<int64_t>(bh) * seq_q * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= seq_q) continue;
      __nv_bfloat16* rp = op + static_cast<int64_t>(row) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / l_safe[r], o[4 * j + 2 * r + 1] / l_safe[r]);
        *reinterpret_cast<__nv_bfloat162*>(rp + 8 * j) = v2;
      }
    }
    // the row log-sum-exp, natural log: m is in the log2 domain of the
    // scaled scores and the same on the row's quad
    if constexpr (kLse) {
      if ((lane & 3) == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < seq_q)
            lse[static_cast<int64_t>(bh) * seq_q + row] =
                l_tot[r] > 0.0f ? (m[r] + log2f(l_tot[r])) * kLn2
                                : -INFINITY;
        }
      }
    }
  }
}

// A 4-D bf16 map over [batch, heads, rows, head_dim] with the given element
// strides, boxes of (row_elems, box_rows) and the tile's swizzle.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int64_t batch, int64_t heads,
            int64_t rows, Strides st, uint32_t box_rows) {
  return encode_bf16_4d(map, ptr, D, batch, heads, rows, st.b, st.h, st.s,
                        Tile<D>::kRowElems, box_rows);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* lse, int64_t batch, int heads_q,
                        int64_t heads_kv, int group, int64_t seq_q,
                        int64_t seq_k, Strides qs, Strides ks, Strides vs,
                        int causal, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  if (seq_q > 0x7fffffff - kBlockQ || seq_k > 0x7fffffff - T::kBlockK)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!encode<D>(&q_map, q, batch, heads_q, seq_q, qs, kBlockQ) ||
      !encode<D>(&k_map, k, batch, heads_kv, seq_k, ks, T::kBlockK) ||
      !encode<D>(&v_map, v, batch, heads_kv, seq_k, vs, T::kBlockK))
    return cudaErrorInvalidValue;
  auto kernel = &flash_attention_kernel_bf16<D, false>;
  if (lse != nullptr) kernel = &flash_attention_kernel_bf16<D, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((seq_q + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(batch * heads_q));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, heads_q,
      group, static_cast<int>(seq_q), static_cast<int>(seq_k), causal,
      scale * kLog2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* out, float* lse, int64_t batch, int heads_q,
                   int64_t heads_kv, int group, int64_t seq_q, int64_t seq_k,
                   Strides qs, Strides ks, Strides vs, int causal,
                   float scale, cudaStream_t s) {
  if (dtype == kF32)
    return launch_f32<D>(q, k, v, out, lse, batch, heads_q, group, seq_q,
                         seq_k, qs, ks, vs, causal, scale, s);
  if (dtype == kBF16)
    return launch_bf16<D>(q, k, v, out, lse, batch, heads_q, heads_kv, group,
                          seq_q, seq_k, qs, ks, vs, causal, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q [batch, heads_q, seq_q, head_dim], k and v [batch, heads_kv, seq_k,
// head_dim], all of one type (0 f32, 1 bf16) on the current device, read
// through the given element strides (batch, head, sequence; 1 along
// head_dim).  For bf16 the base pointers and strides must be multiples of
// 16 bytes (TMA); the wrapper checks.  out [batch, heads_q, seq_q,
// head_dim], contiguous, same type.  lse, when not null: f32 [batch,
// heads_q, seq_q], each row's log-sum-exp of its scaled scores (natural
// log), the backward's input; serving passes null.  Returns the launch's
// cudaError_t (0 on success); it does not synchronise.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, void* lse, int64_t batch,
                          int64_t heads_q, int64_t heads_kv, int64_t seq_q,
                          int64_t seq_k,
                          int64_t head_dim, int64_t q_sb, int64_t q_sh,
                          int64_t q_ss, int64_t k_sb, int64_t k_sh,
                          int64_t k_ss, int64_t v_sb, int64_t v_sh,
                          int64_t v_ss, int dtype, int causal, float scale,
                          void* stream) {
  if (batch <= 0 || heads_q <= 0 || heads_kv <= 0 || heads_q % heads_kv ||
      seq_q <= 0 || seq_k < 0 || (causal && seq_q > seq_k))
    return cudaErrorInvalidValue;
  if (batch * heads_q > 65535 || (seq_q + 63) / 64 > 0x7fffffff)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const int hq = static_cast<int>(heads_q);
  const int group = static_cast<int>(heads_q / heads_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, out, lse_f, batch, hq, heads_kv,
                        group, seq_q, seq_k, qs, ks, vs, causal, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, out, lse_f, batch, hq, heads_kv,
                        group, seq_q, seq_k, qs, ks, vs, causal, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, out, lse_f, batch, hq, heads_kv,
                        group, seq_q, seq_k, qs, ks, vs, causal, scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, out, lse_f, batch, hq, heads_kv,
                         group, seq_q, seq_k, qs, ks, vs, causal, scale, s);
    case 256:
      return launch<256>(dtype, q, k, v, out, lse_f, batch, hq, heads_kv,
                         group, seq_q, seq_k, qs, ks, vs, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
