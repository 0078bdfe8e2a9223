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
//   D_i   = sum_d do_id o_id           (written to delta, f32)
//   dP_ij = do_i . v_j,  dS_ij = P_ij (dP_ij - D_i)   (f32)
//   dq_i  = scale sum_j dS_ij k_j
//   dk_j  = scale sum_{h in group} sum_i dS_ij q_i
//   dv_j  = sum_{h in group} sum_i P_ij do_i
// dq, dk and dv are written contiguous in the inputs' type.
//
// What bounds it: operations.  The five products (S, dP, dV, dK, dQ) are
// 10 D FLOP per visible (query, key) pair; at the training layer, [2, 32,
// 4096, 128] bf16 with Hkv 8, causal, 6.9e11 FLOP over 0.4 GB.
//
// bf16 (flash_bwd_kernel_bf16<D>, D in {16, 32, 64, 128, 256}): the bf16
// tensor cores through wgmma, fed by TMA, built from the forward's parts
// (hopper.cuh).  Three launches on the stream:
// * flash_bwd_prep_kernel: delta = rowsum(dO o O) in f32 and the forward's
//   lse times log2(e) (lse2), into rows padded to a multiple of 64 (a
//   padded row gets lse2 = +inf and delta = 0, so its P is exactly 0), and
//   zeroes the f32 workspace dq_acc [B,Hq,Sq_pad,D];
// * flash_bwd_kernel_bf16: one block per (b, KV head, tile of 128 keys; 64
//   at D = 256); grid.y is the key tile, so every head's tile 0 (under
//   causal masking the longest walk: it sees every query tile) is
//   scheduled first.  Two warpgroups, 256 threads; thread 0 also issues
//   every copy: K and V once, then, with TMA into a two-stage ring, the Q
//   and dO tiles (64 query rows) with their lse2 and delta rows (1-D bulk
//   copies), for each query head of the KV head's group and, in each, each
//   query tile that can see the block's keys; it refills a stage once all
//   eight warps have released it.  (A producer warpgroup with setmaxnreg,
//   as the forward has, left ptxas allocating the consumers in the 168
//   registers of a 384-thread launch: it spilled at D = 128 and D = 256
//   and serialized every wgmma.)  dK and dV stay
//   in f32 registers for the whole walk, so the sum over the GQA group
//   stays in the block and dk, dv are deterministic.  Each step:
//     S^T = K Q^T, then dP^T = V dO^T   (SS, both K-major, m64n64)
//     P^T = exp2(S^T scale log2e - lse2), dS^T = P^T (dP^T - delta)  (f32)
//     P^T, dS^T to shared memory as bf16 (128-byte swizzled rows of 64
//       queries)
//     dV += P^T dO, dK += dS^T Q       (A K-major from shared memory, B
//                                       MN-major: the transpose bit)
//     dQ  = dS K                       (A = dS^T read MN-major, B = K
//                                       MN-major)
//   S and dP are computed once per visible pair: 10 D FLOP a pair (the
//   f32 path below computes them in both of its kernels, 14 D).  The mask
//   is applied only on tiles that cross the causal diagonal or the ragged
//   Sk edge; query rows past Sq have lse2 = +inf (and zero Q, dO rows from
//   TMA), so their P is 0.
//   D <= 128: the two warpgroups own 64 keys each.  dQ, D = 128: each
//   warpgroup takes half of D over the block's 128 keys (dS^T is
//   double-buffered and a named barrier joins the warpgroups); D <= 64:
//   each its own 64 keys and all of D (a half of a narrower row would start
//   inside a swizzle row), two partial tiles.  A warpgroup stages its dQ
//   tile (f32, in fragment order) in shared memory and one thread adds it
//   to dq_acc with cp.reduce.async.bulk .add.f32: one bulk reduce per tile,
//   not one atomic per element.  Registers at D = 128: 128 of dK and dV,
//   32 of S^T and 32 of dP^T, then 32 of dQ (ptxas: 250 used, no spill).
//   D = 256: dK and dV of 64 keys would take 256 registers a thread, so
//   the warpgroups split D instead (128 columns each of dK, dV and dQ, 128
//   registers of dK and dV), on 64-key tiles.  Warpgroup 0 computes S^T,
//   warpgroup 1 dP^T (each once, 64 x 64 over D = 256); warpgroup 1 hands
//   dP^T over in shared memory (f32), warpgroup 0 writes P^T and dS^T
//   (bf16, swizzled) and both run their halves of dV, dK and dQ.  Shared
//   memory: K and V 64 KB, two stages of Q and dO 128 KB, P^T, dS^T and the
//   dP^T hand-over 32 KB: 226 KB of the 227, so the ring keeps two stages
//   and dQ is added from registers with float2 atomics (red.global.add.v2,
//   256 contiguous bytes a warp in dq_acc's fragment order).
// * flash_bwd_post_kernel: dq = bf16(dq_acc * scale), contiguous.
// Determinism: dk and dv are summed in a fixed order and are identical
// from run to run.  dq's partial tiles are added to dq_acc in the order
// the blocks reach them, which varies: its last bits may differ between
// two runs (chip_smoke.py reports the spread).
//
// f32 (flash_bwd_*_kernel_f32<D>): held to 3e-5, which needs the f32
// cores.  Two kernels, no atomics, deterministic: a dq kernel (one block
// per (b, hq, tile of query rows), which first writes delta for its rows)
// and a dk/dv kernel (one block per (b, hkv, tile of keys) walking the
// group's query heads).  256 threads, operands widened to f32 in shared
// memory (rows padded by one word); tiles of 64 (32 at D = 256, for
// registers and shared memory).  Each thread owns R = tile/16 rows, R
// columns of a score tile and D/16 output columns; the 16 threads of a row
// are one half-warp.  S and dP are computed in both kernels.
//
// Shared memory is dynamic, set per instantiation; each launch's error is
// returned to the caller.

#include "hopper.cuh"

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

// whether query row `row` sees key `key` (both in range checked)
__device__ __forceinline__ bool visible(int64_t row, int64_t key,
                                        int64_t seq_q, int64_t seq_k,
                                        int causal) {
  return row < seq_q && key < seq_k && (!causal || key <= row + seq_k - seq_q);
}

// ---------------------------------------------------------------------------
// f32: the f32 cores
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
template <int D, int kRows>
__device__ __forceinline__ void load_f32(float* __restrict__ dst, int pitch,
                                         const float* __restrict__ src,
                                         int64_t row_stride, int64_t row0,
                                         int64_t rows) {
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * D; e += kF32Threads) {
    const int r = e / D;
    const int d = e - r * D;
    const int64_t row = row0 + r;
    dst[r * pitch + d] = row < rows ? (src[row * row_stride + d]) : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_kernel_f32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ o,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dq, float* __restrict__ delta,
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

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;

  load_f32<D, kT>(q_s, kP, qp, qs.s, q0, seq_q);
  load_f32<D, kT>(do_s, kP, dout + row_base * D, D, q0, seq_q);
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
        part += do_s[r * kP + col] * (o[(row_base + row) * D + col]);
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
    load_f32<D, kT>(k_s, kP, kp, ks.s, k0, seq_k);
    load_f32<D, kT>(v_s, kP, vp, vs.s, k0, seq_k);
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
      dq[(row_base + row) * D + tx + 16 * c] = (acc[i][c] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_kernel_f32(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
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

  load_f32<D, kT>(k_s, kP, k + b * ks.b + hk * ks.h, ks.s, k0, seq_k);
  load_f32<D, kT>(v_s, kP, v + b * vs.b + hk * vs.h, vs.s, k0, seq_k);

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
    const float* qp = q + b * qs.b + h * qs.h;
    for (int64_t qt = qt_begin; qt < qt_end; ++qt) {
      const int64_t q0 = qt * kT;
      __syncthreads();  // the previous tile's Q, dO, P and dS are read
      load_f32<D, kT>(q_s, kP, qp, qs.s, q0, seq_q);
      load_f32<D, kT>(do_s, kP, dout + row_base * D, D, q0, seq_q);
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
      dk[base + tx + 16 * c] = (dk_acc[i][c] * scale);
      dv[base + tx + 16 * c] = (dv_acc[i][c]);
    }
  }
}

template <int D>
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
  auto dq_kernel = flash_bwd_dq_kernel_f32<D>;
  auto dkv_kernel = flash_bwd_dkv_kernel_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dq_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dkv_bytes));
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const dim3 grid_q(static_cast<unsigned>((seq_q + kT - 1) / kT),
                    static_cast<unsigned>(batch * heads_q));
  dq_kernel<<<grid_q, kF32Threads, dq_bytes, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dot, lse,
      static_cast<float*>(dq), delta, heads_q, group, seq_q, seq_k, qs, ks,
      vs, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k(static_cast<unsigned>((seq_k + kT - 1) / kT),
                    static_cast<unsigned>(batch * heads_kv));
  dkv_kernel<<<grid_k, kF32Threads, dkv_bytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), heads_q, heads_kv, group, seq_q, seq_k, qs,
      ks, vs, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
constexpr int kBlockM = 64;          // query rows of a step
// two warpgroups; thread 0 also issues the copies (no producer
// warpgroup: with 256 threads a thread may use 255 registers)
constexpr int kThreads = 256;
constexpr int kConsumerWarps = 8;
constexpr int kPrepThreads = 256;    // one warp a row
constexpr int kPostThreads = 256;
constexpr int kRowsBytes = 2 * kBlockM * 4;  // a stage's lse2 and delta rows

template <int D>
struct BwdTile {
  // D = 256: the warpgroups split D over 64-key tiles; else they split 128
  // keys
  static constexpr bool kSplitD = D == 256;
  static constexpr int kBlockN = kSplitD ? 64 : 128;
  static constexpr int kRowElems = D < 64 ? D : 64;  // columns of a chunk
  static constexpr int kRowBytes = 2 * kRowElems;     // = the swizzle span
  static constexpr int kChunks = D / kRowElems;
  static constexpr uint64_t kLayout = layout_for(kRowBytes);
  static constexpr int kQBytes = kBlockM * D * 2;     // a Q or dO tile
  static constexpr int kKVBytes = kBlockN * D * 2;    // K or V
  // a [keys][64 queries] bf16 tile, 128-byte rows
  static constexpr int kTBytes = kBlockN * kBlockM * 2;
  // dQ: D <= 64, each warpgroup's partial over its own 64 keys, all of D
  // (both are added to dq_acc); D = 128, each warpgroup half of D over the
  // block's 128 keys (a half of a narrower row would start inside a
  // swizzle row); D = 256, half of D over the block's 64 keys.  kDqN: the
  // columns of a warpgroup's dQ tile (a dq_acc tile is 64 rows of them)
  static constexpr bool kDqByKeys = D <= 64;
  static constexpr int kDqN = kSplitD ? 128 : (D == 128 ? 64 : D);
  static constexpr int kDqBytes = kBlockM * kDqN * 4;
  // byte offsets from the 1024-aligned base: K, V, two stages of Q, two of
  // dO, scratch (D <= 128: P^T and two dS^T tiles; D = 256: P^T, dS^T and
  // the f32 dP^T hand-over), D <= 128: each warpgroup's dQ tile staged for
  // the bulk reduce-add, two stages of lse2 and delta rows, barriers
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + 2 * kQBytes;
  static constexpr int kScratch = kDO + 2 * kQBytes;
  static constexpr int kScratchBytes = kSplitD ? 32768 : 3 * kTBytes;
  static constexpr int kDqStage = kScratch + kScratchBytes;
  static constexpr int kRows = kDqStage + (kSplitD ? 0 : 2 * kDqBytes);
  static constexpr int kBars = kRows + 2 * kRowsBytes;
  static constexpr int kSmemBytes = kBars + 64 + 1024;
  static_assert(D % 16 == 0 && D <= 256, "head_dim");
  static_assert(!kSplitD || 2 * kTBytes + kBlockN * kBlockM * 4 == 32768,
                "scratch");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// A 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits until at most n of this warpgroup's committed wgmma groups are
// pending.
template <int n>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}

// Named barrier `id` over the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// Named barrier `id` over one warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A descriptor `bytes` further into shared memory (the start address is
// the low field, in 16-byte units; no carry leaves it).
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// dst[i] += src[i] over `bytes` (a multiple of 16, both 16-byte aligned),
// f32, from shared to global memory by the TMA unit, as one bulk group.
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], both from shared memory, with the
// transpose bits kTA, kTB (1: MN-major).  accumulate == 0 overwrites d.
template <int N, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REGS8
        ", %8, %9, p, 1, 1, %11, %12;\n}\n"
        : ACC8(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " REGS16
        ", %16, %17, p, 1, 1, %19, %20;\n}\n"
        : ACC16(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : ACC32(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
  } else {
    static_assert(N == 128, "wgmma_ss_t: N");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
        ", %64, %65, p, 1, 1, %67, %68;\n}\n"
        : ACC64(d, 0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(kTA), "n"(kTB));
  }
}

// X^T = A B^T over the block's K or V rows `a` (64 rows from `a`, chunks
// `a_chunk` bytes apart) and a Q or dO stage: the m64n64 fragment of a
// 64-row by 64-query tile, both operands K-major (D / 16 steps).
template <int D>
__device__ __forceinline__ void product_t(float (&x)[32], uint32_t a,
                                          uint32_t a_chunk, uint32_t b) {
  using T = BwdTile<D>;
  constexpr uint32_t kSbo = 8 * T::kRowBytes;
  constexpr int kStepsPerChunk = T::kRowBytes / 32;
  const uint64_t da = make_desc(a, 16, kSbo, T::kLayout);
  const uint64_t db = make_desc(b, 16, kSbo, T::kLayout);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / kStepsPerChunk;
    const int w = kk % kStepsPerChunk;
    wgmma_ss<64>(x, desc_at(da, c * a_chunk + 32 * w),
                 desc_at(db, c * kBlockM * T::kRowBytes + 32 * w), kk > 0);
  }
  wgmma_commit();
}

// P^T from S^T in place: element 4j + 2r + e of the fragment is key row
// (frow + 8r) and query column 8j + col0 + e of the tile.  lse2 is the
// stage's row (log2 domain); kMask zeroes what the mask hides.
template <bool kMask>
__device__ __forceinline__ void probabilities(float (&s)[32],
                                              const float* lse2,
                                              float scale_log2, int key0,
                                              int q0, int col0, int seq_k,
                                              int causal, int offset) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
    for (int i = 4 * j; i < 4 * j + 4; ++i) {
      float p = exp2f(s[i] * scale_log2 - ((i & 1) ? l2.y : l2.x));
      if (kMask) {
        const int key = key0 + 8 * ((i >> 1) & 1);
        const int q = q0 + 8 * j + col0 + (i & 1);
        if (key >= seq_k || (causal && key > q + offset)) p = 0.0f;
      }
      s[i] = p;
    }
  }
}

// dS^T = P^T (dP^T - delta) in place in dp, same fragment as above
__device__ __forceinline__ void grad_scores(float (&dp)[32],
                                            const float (&p)[32],
                                            const float* delta, int col0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
    for (int i = 4 * j; i < 4 * j + 4; ++i)
      dp[i] = p[i] * (dp[i] - ((i & 1) ? d2.y : d2.x));
  }
}

// The fragment rounded to bf16 as wgmma A fragments: k-step kk holds query
// columns 16 kk .. 16 kk + 15 (the forward's P, flash_attention.cu)
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// Stores A fragments as rows of a [keys][64 queries] bf16 tile with
// 128-byte rows, 128-byte swizzled (16-byte unit u of row r at u ^ (r & 7)):
// this thread's rows are `row` and row + 8.  Conflict-free.
__device__ __forceinline__ void store_t_tile(uint32_t tile, int row,
                                             int quad,
                                             const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int rr = row + 8 * (r & 1);
      const int unit = 2 * kk + (r >> 1);
      st_shared_u32(tile + rr * 128 + ((unit ^ (rr & 7)) << 4) + 4 * quad,
                    a[kk][r]);
    }
}

// dq_acc holds each 64-row dQ tile of a warpgroup's kDqN columns in
// fragment order: element i of consumer thread t at (i / 2) * 256 + 2 t +
// i % 2, so a thread's pairs are float2s and a warp's are 256 contiguous
// bytes (flash_bwd_post_kernel undoes the order).  dst is the tile.
template <int N>
__device__ __forceinline__ void store_frag_f32(float* dst,
                                               const float (&x)[N / 2],
                                               int tid) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    *reinterpret_cast<float2*>(dst + (i / 2) * 256 + 2 * tid) =
        make_float2(x[i], x[i + 1]);
}

template <int N>
__device__ __forceinline__ void add_frag_f32(float* dst,
                                             const float (&x)[N / 2],
                                             int tid) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2)
    atomicAdd(reinterpret_cast<float2*>(dst + (i / 2) * 256 + 2 * tid),
              make_float2(x[i], x[i + 1]));
}

// Writes this thread's part of an m64n{N} f32 fragment (key rows row and
// row + 8, columns col + 8j + e) times `scale` as bf16; keys past Sk are
// skipped.
template <int N>
__device__ __forceinline__ void store_kv(__nv_bfloat16* out,
                                         const float (&x)[N / 2],
                                         int64_t row_base, int key, int seq_k,
                                         int col, int head_dim, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key + 8 * r >= seq_k) continue;
    __nv_bfloat16* p = out + (row_base + key + 8 * r) * head_dim + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) = __floats2bfloat162_rn(
          x[4 * j + 2 * r] * scale, x[4 * j + 2 * r + 1] * scale);
  }
}

// delta and lse2 for every padded row (one warp a row), and dq_acc zeroed
// (it is as many rows of D)
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ lse2,
                          float* __restrict__ delta,
                          float* __restrict__ dq_acc, int64_t rows,
                          int seq_q, int seq_q_pad) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (kPrepThreads / 32) +
      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t bh = r / seq_q_pad;
  const int m = static_cast<int>(r - bh * seq_q_pad);
  // dq_acc's rows are padded too: zero a row's worth at its place
#pragma unroll
  for (int d = 4 * lane; d < D; d += 128)
    *reinterpret_cast<float4*>(dq_acc + r * D + d) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (m >= seq_q) {
    if (lane == 0) {
      lse2[r] = INFINITY;
      delta[r] = 0.0f;
    }
    return;
  }
  const int64_t src = (bh * seq_q + m) * D;
  float part = 0.0f;
#pragma unroll
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(o + src + d));
    const float2 g = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(dout + src + d));
    part = fmaf(a.x, g.x, part);
    part = fmaf(a.y, g.y, part);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) {
    delta[r] = part;
    lse2[r] = lse[bh * seq_q + m] * kLog2E;
  }
}

// dq = bf16(dq_acc * scale): one pair of columns a thread, read in
// dq_acc's fragment order (coalesced); padded rows are dropped
template <int D>
__global__ void __launch_bounds__(kPostThreads)
    flash_bwd_post_kernel(const float* __restrict__ dq_acc,
                          __nv_bfloat16* __restrict__ dq, int64_t pairs,
                          int seq_q, int seq_q_pad, float scale) {
  constexpr int kN = BwdTile<D>::kDqN;
  constexpr int kTilePairs = kBlockM * kN / 2;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kPostThreads +
                   threadIdx.x;
       p < pairs; p += static_cast<int64_t>(gridDim.x) * kPostThreads) {
    const int64_t tile = p / kTilePairs;  // (bh, m tile, column chunk)
    const int in_tile = static_cast<int>(p - tile * kTilePairs);
    const int half_i = in_tile / 128;     // fragment element i / 2
    const int t = in_tile % 128;          // consumer thread
    const int lane = t & 31;
    const int row = 16 * (t >> 5) + (lane >> 2) + 8 * (half_i & 1);
    const int col = 8 * (half_i >> 1) + 2 * (lane & 3);
    const int chunk = static_cast<int>(tile % (D / kN));
    const int64_t row_tile = tile / (D / kN);  // bh * m_tiles + m tile
    const int m_tiles = seq_q_pad / kBlockM;
    const int64_t bh = row_tile / m_tiles;
    const int q = static_cast<int>(row_tile - bh * m_tiles) * kBlockM + row;
    if (q >= seq_q) continue;
    const float2 x = reinterpret_cast<const float2*>(dq_acc)[p];
    *reinterpret_cast<__nv_bfloat162*>(
        dq + (bh * seq_q + q) * D + chunk * kN + col) =
        __floats2bfloat162_rn(x.x * scale, x.y * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel_bf16(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          float* __restrict__ dq_acc,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int heads_q,
                          int heads_kv, int group, int seq_q, int seq_k,
                          int seq_q_pad, int causal, float scale_log2,
                          float scale) {
  using T = BwdTile<D>;
  constexpr int kBlockN = T::kBlockN;
  constexpr int kRowBytes = T::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t bars = base + T::kBars;
  const uint32_t full_kv = bars;
  auto full_q = [&](int st) { return bars + 8 + 8 * st; };
  auto full_do = [&](int st) { return bars + 24 + 8 * st; };
  auto empty = [&](int st) { return bars + 40 + 8 * st; };
  auto q_stage = [&](int st) { return base + T::kQ + st * T::kQBytes; };
  auto do_stage = [&](int st) { return base + T::kDO + st * T::kQBytes; };
  // a stage's rows: lse2 [64] then delta [64]
  auto rows_at = [&](int st) { return T::kRows + st * kRowsBytes; };

  const int n0 = blockIdx.y * kBlockN;  // tile 0 first: the longest walk
  const int bhk = blockIdx.x;
  const int b = bhk / heads_kv;
  const int hk = bhk - b * heads_kv;
  const int offset = seq_k - seq_q;
  // the query tiles that can see the block's keys: all, or (causal) from
  // the one holding the first row that sees key n0
  const int m_first =
      causal ? (n0 - offset > 0 ? n0 - offset : 0) / kBlockM : 0;
  const int m_tiles = (seq_q + kBlockM - 1) / kBlockM;
  const int per_head = m_tiles - m_first;
  const int steps = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(full_q(st), 1);
      mbar_init(full_do(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: K and V once, then step `it`'s Q and dO
  // tiles with their lse2 and delta rows into stage it % 2
  auto issue = [&](int it) {
    const int hh = it / per_head;
    const int m0 = (m_first + it - hh * per_head) * kBlockM;
    const int h = hk * group + hh;
    const int64_t row =
        (static_cast<int64_t>(b) * heads_q + h) * seq_q_pad + m0;
    const int st = it & 1;
    mbar_expect_tx(full_q(st), T::kQBytes + kRowsBytes / 2);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(q_stage(st) + c * kBlockM * kRowBytes, &q_map,
               c * T::kRowElems, m0, h, b, full_q(st));
    bulk_load(base + rows_at(st), lse2 + row, kRowsBytes / 2, full_q(st));
    mbar_expect_tx(full_do(st), T::kQBytes + kRowsBytes / 2);
    for (int c = 0; c < T::kChunks; ++c)
      tma_load(do_stage(st) + c * kBlockM * kRowBytes, &do_map,
               c * T::kRowElems, m0, h, b, full_do(st));
    bulk_load(base + rows_at(st) + kRowsBytes / 2, delta + row,
              kRowsBytes / 2, full_do(st));
  };
  // after step it: once both warpgroups are done with its stage (all
  // eight warps arrived), refill it with step it + 2; warp 0 then
  // reconverges before its next wgmma
  auto refill = [&](int it) {
    if (threadIdx.x == 0 && it + 2 < steps) {
      mbar_wait(empty(it & 1), (it >> 1) & 1);
      issue(it + 2);
    }
    __syncwarp();
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(full_kv, 2 * T::kKVBytes);
    for (int c = 0; c < T::kChunks; ++c) {
      tma_load(base + T::kK + c * kBlockN * kRowBytes, &k_map,
               c * T::kRowElems, n0, hk, b, full_kv);
      tma_load(base + T::kV + c * kBlockN * kRowBytes, &v_map,
               c * T::kRowElems, n0, hk, b, full_kv);
    }
    issue(0);
    if (steps > 1) issue(1);
  }

  // the warpgroup, made provably warp-uniform (a shuffle from lane 0):
  // otherwise ptxas treats the branches on it as divergent and serializes
  // the wgmmas in them
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  constexpr int kDqN = T::kDqN;
  const int cw = wg;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad = lane & 3;
  const int col0 = 2 * quad;
  const int frow = 16 * warp + (lane >> 2);  // fragment rows frow, frow + 8
  constexpr uint32_t kSbo = 8 * kRowBytes;
  constexpr uint32_t kChunkN = kBlockN * kRowBytes;  // a K or V chunk
  constexpr uint32_t kChunkM = kBlockM * kRowBytes;  // a Q or dO chunk
  const int64_t kv_base = static_cast<int64_t>(bhk) * seq_k;
  // this step's dQ tile in dq_acc: (b, h) row block, m tile, column chunk
  auto dq_tile = [&](int hh, int m0, int chunk) {
    const int64_t bh = static_cast<int64_t>(b) * heads_q + hk * group + hh;
    return dq_acc + (bh * seq_q_pad + m0) * D + chunk * kBlockM * kDqN;
  };

  mbar_wait(full_kv, 0);
  if constexpr (!T::kSplitD) {
    // warpgroup cw owns keys nw .. nw + 63, all of D; its dQ is column
    // chunk dq_chunk over all 128 keys (D = 128) or all columns over its
    // own keys (D <= 64)
    const int nw = n0 + 64 * cw;
    const uint32_t k_a = base + T::kK + 64 * cw * kRowBytes;
    const uint32_t v_a = base + T::kV + 64 * cw * kRowBytes;
    const int dq_chunk = T::kDqByKeys ? 0 : cw;
    constexpr int kDqKeys = T::kDqByKeys ? 64 : kBlockN;
    const uint32_t dq_rows = T::kDqByKeys ? 64 * cw : 0;  // first dS^T row
    const uint32_t stage = base + T::kDqStage + cw * T::kDqBytes;
    const uint32_t p_t = base + T::kScratch;  // P^T [128 keys][64 queries]
    float* const stage_ptr =
        reinterpret_cast<float*>(base_ptr + T::kDqStage + cw * T::kDqBytes);
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    for (int it = 0; it < steps; ++it) {
      const int hh = it / per_head;
      const int m0 = (m_first + it - hh * per_head) * kBlockM;
      const int st = it & 1;
      const uint32_t parity = (it >> 1) & 1;
      const float* rows =
          reinterpret_cast<const float*>(base_ptr + rows_at(st));

      // S^T -> P^T, then dP^T -> dS^T, each written to shared memory as
      // bf16 (P^T: this warpgroup's rows; dS^T double-buffered, as at
      // D = 128 the other warpgroup may still read the previous step's).
      // dV, dK and dQ read them from there.
      const uint32_t ds_t =
          base + T::kScratch + (1 + (it & 1)) * T::kTBytes;
      // D <= 64 has the registers to run dP^T's product beside S^T's
      float s[32], dp[32];
      mbar_wait(full_q(st), parity);
      product_t<D>(s, k_a, kChunkN, q_stage(st));
      if constexpr (D <= 64) {
        mbar_wait(full_do(st), parity);
        product_t<D>(dp, v_a, kChunkN, do_stage(st));
        wgmma_wait_group<1>();
      } else {
        wgmma_wait_all();
      }
      fence_regs(s);
      if (nw + 64 > seq_k || (causal && nw + 63 > m0 + offset))
        probabilities<true>(s, rows, scale_log2, nw + frow, m0, col0, seq_k,
                            causal, offset);
      else
        probabilities<false>(s, rows, scale_log2, nw + frow, m0, col0,
                             seq_k, causal, offset);
      uint32_t a[4][4];
      to_a_frags(a, s);
      store_t_tile(p_t, 64 * cw + frow, quad, a);

      if constexpr (D > 64) {
        mbar_wait(full_do(st), parity);
        product_t<D>(dp, v_a, kChunkN, do_stage(st));
      }
      wgmma_wait_all();
      fence_regs(dp);
      grad_scores(dp, s, rows + kBlockM, col0);
      to_a_frags(a, dp);
      store_t_tile(ds_t, 64 * cw + frow, quad, a);
      fence_proxy_async();
      // the barrier (over both warpgroups where dQ reads both halves of
      // dS^T) also tells the warpgroup that its previous bulk reduce-add
      // has read the staged dQ tile
      if (tid == 0) bulk_wait_read();
      if constexpr (T::kDqByKeys)
        warpgroup_sync(1 + cw);
      else
        consumers_sync(5);

      // dV += P^T dO, dK += dS^T Q over this warpgroup's 64 keys (A
      // K-major, k-step kk is queries 16 kk .. +15; B MN-major), then
      // dQ = dS K over the block's 128 keys
      {
        const uint64_t ap = make_desc(p_t + 64 * cw * 128, 16, 1024, 1);
        const uint64_t ads = make_desc(ds_t + 64 * cw * 128, 16, 1024, 1);
        const uint64_t bdo =
            make_desc(do_stage(st), kChunkM, kSbo, T::kLayout);
        const uint64_t bq = make_desc(q_stage(st), kChunkM, kSbo, T::kLayout);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_t<D, 0, 1>(dv_acc, desc_at(ap, 32 * kk),
                              desc_at(bdo, 16 * kk * kRowBytes), 1);
          wgmma_ss_t<D, 0, 1>(dk_acc, desc_at(ads, 32 * kk),
                              desc_at(bq, 16 * kk * kRowBytes), 1);
        }
      }
      {
        float dq[kDqN / 2];
        // A: dS [64 queries x 16 keys] read MN-major from dS^T rows
        // dq_rows + 16 kk ..; B: K rows dq_rows + 16 kk .., columns of
        // chunk dq_chunk, MN-major
        const uint64_t da =
            make_desc(ds_t + dq_rows * 128, T::kTBytes, 1024, 1);
        const uint64_t db =
            make_desc(base + T::kK + dq_chunk * kChunkN + dq_rows * kRowBytes,
                      kChunkN, kSbo, T::kLayout);
#pragma unroll
        for (int kk = 0; kk < kDqKeys / 16; ++kk)
          wgmma_ss_t<kDqN, 1, 1>(dq, desc_at(da, 16 * kk * 128),
                                 desc_at(db, 16 * kk * kRowBytes), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq);
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(st));
        // stage the tile in fragment order, then one thread adds it to
        // dq_acc with the TMA unit
        store_frag_f32<kDqN>(stage_ptr, dq, tid);
        fence_proxy_async();
        warpgroup_sync(3 + cw);
        if (tid == 0)
          bulk_reduce_add(dq_tile(hh, m0, dq_chunk), stage, T::kDqBytes);
      }
      refill(it);
    }
    if (tid == 0) bulk_wait();
    store_kv<D>(dk, dk_acc, kv_base, nw + frow, seq_k, col0, D, scale);
    store_kv<D>(dv, dv_acc, kv_base, nw + frow, seq_k, col0, D, 1.0f);
  } else {
    // D = 256: warpgroup cw owns columns 128 cw .. 128 cw + 127 of dK, dV
    // and dQ, for all 64 keys
    const int col_base = 128 * cw;
    const uint32_t p_t = base + T::kScratch;      // P^T, bf16
    const uint32_t ds_t = p_t + T::kTBytes;       // dS^T, bf16
    float* handover = reinterpret_cast<float*>(base_ptr + T::kScratch +
                                               2 * T::kTBytes);  // dP^T
    const uint32_t half = 2 * cw * kChunkN;       // column chunk 2 cw of K
    const uint32_t half_m = 2 * cw * kChunkM;     // of a Q or dO stage
    float dk_acc[64], dv_acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    for (int it = 0; it < steps; ++it) {
      const int hh = it / per_head;
      const int m0 = (m_first + it - hh * per_head) * kBlockM;
      const int st = it & 1;
      const uint32_t parity = (it >> 1) & 1;
      const float* rows =
          reinterpret_cast<const float*>(base_ptr + rows_at(st));

      float x[32];  // S^T (warpgroup 0) or dP^T (warpgroup 1)
      if (cw == 0) {
        mbar_wait(full_q(st), parity);
        product_t<D>(x, base + T::kK, kChunkN, q_stage(st));
      } else {
        mbar_wait(full_do(st), parity);
        product_t<D>(x, base + T::kV, kChunkN, do_stage(st));
      }
      wgmma_wait_all();
      fence_regs(x);
      if (cw == 1) {
        // hand dP^T over (the previous step's reads of it are done: the
        // other warpgroup passed barrier 2 after them)
#pragma unroll
        for (int i = 0; i < 32; ++i) handover[i * 128 + tid] = x[i];
        consumers_sync(1);
        consumers_sync(2);
      } else {
        if (n0 + 64 > seq_k || (causal && n0 + 63 > m0 + offset))
          probabilities<true>(x, rows, scale_log2, n0 + frow, m0, col0,
                              seq_k, causal, offset);
        else
          probabilities<false>(x, rows, scale_log2, n0 + frow, m0, col0,
                               seq_k, causal, offset);
        consumers_sync(1);
        mbar_wait(full_do(st), parity);  // the delta row
        float dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = handover[i * 128 + tid];
        grad_scores(dp, x, rows + kBlockM, col0);
        uint32_t a[4][4];
        to_a_frags(a, x);
        store_t_tile(p_t, frow, quad, a);
        to_a_frags(a, dp);
        store_t_tile(ds_t, frow, quad, a);
        fence_proxy_async();
        consumers_sync(2);
      }
      mbar_wait(full_q(st), parity);
      mbar_wait(full_do(st), parity);

      // this warpgroup's half: dV += P^T dO, dK += dS^T Q (A K-major from
      // P^T, dS^T; B MN-major, 128 columns over two chunks), dQ = dS K
      float dq[64];
      {
        const uint64_t ap = make_desc(p_t, 16, 1024, 1);
        const uint64_t ads = make_desc(ds_t, 16, 1024, 1);
        const uint64_t bdo =
            make_desc(do_stage(st) + half_m, kChunkM, kSbo, T::kLayout);
        const uint64_t bq =
            make_desc(q_stage(st) + half_m, kChunkM, kSbo, T::kLayout);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t k_off = 16 * kk * kRowBytes;
          wgmma_ss_t<128, 0, 1>(dv_acc, desc_at(ap, 32 * kk),
                                desc_at(bdo, k_off), 1);
          wgmma_ss_t<128, 0, 1>(dk_acc, desc_at(ads, 32 * kk),
                                desc_at(bq, k_off), 1);
        }
        const uint64_t adq = make_desc(ds_t, T::kTBytes, 1024, 1);
        const uint64_t bk =
            make_desc(base + T::kK + half, kChunkN, kSbo, T::kLayout);
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          wgmma_ss_t<128, 1, 1>(dq, desc_at(adq, 16 * kk * 128),
                                desc_at(bk, 16 * kk * kRowBytes), kk > 0);
        wgmma_commit();
      }
      wgmma_wait_all();
      fence_regs(dq);
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      // no room to stage dQ for a bulk add: float2 atomics, 256
      // contiguous bytes a warp
      add_frag_f32<128>(dq_tile(hh, m0, cw), dq, tid);
      refill(it);
    }
    store_kv<128>(dk, dk_acc, kv_base, n0 + frow, seq_k, col_base + col0, D,
                  scale);
    store_kv<128>(dv, dv_acc, kv_base, n0 + frow, seq_k, col_base + col0, D,
                  1.0f);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        float* dq_acc, float* lse2, int64_t batch,
                        int heads_q, int heads_kv, int group, int64_t seq_q,
                        int64_t seq_k, Strides qs, Strides ks, Strides vs,
                        int causal, float scale, cudaStream_t stream) {
  using T = BwdTile<D>;
  const int64_t seq_q_pad = (seq_q + kBlockM - 1) / kBlockM * kBlockM;
  if (seq_q_pad > 0x7fffffff || seq_k > 0x7fffffff - T::kBlockN ||
      (seq_k + T::kBlockN - 1) / T::kBlockN > 65535 ||
      batch * heads_kv > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map, do_map;
  const uint32_t cols = T::kRowElems;
  if (!encode_bf16_4d(&q_map, q, D, batch, heads_q, seq_q, qs.b, qs.h, qs.s,
                      cols, kBlockM) ||
      !encode_bf16_4d(&k_map, k, D, batch, heads_kv, seq_k, ks.b, ks.h, ks.s,
                      cols, T::kBlockN) ||
      !encode_bf16_4d(&v_map, v, D, batch, heads_kv, seq_k, vs.b, vs.h, vs.s,
                      cols, T::kBlockN) ||
      !encode_bf16_4d(&do_map, dout, D, batch, heads_q, seq_q,
                      heads_q * seq_q * D, seq_q * D, D, cols, kBlockM))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;

  const int64_t rows = batch * heads_q * seq_q_pad;
  const int64_t prep_blocks = (rows + kPrepThreads / 32 - 1) /
                              (kPrepThreads / 32);
  flash_bwd_prep_kernel<D><<<static_cast<unsigned>(prep_blocks),
                             kPrepThreads, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, lse2,
      delta, dq_acc, rows, static_cast<int>(seq_q),
      static_cast<int>(seq_q_pad));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kernel = &flash_bwd_kernel_bf16<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads_kv),
                  static_cast<unsigned>((seq_k + T::kBlockN - 1) /
                                        T::kBlockN));
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      q_map, k_map, v_map, do_map, lse2, delta, dq_acc,
      static_cast<bf*>(dk), static_cast<bf*>(dv), heads_q, heads_kv, group,
      static_cast<int>(seq_q), static_cast<int>(seq_k),
      static_cast<int>(seq_q_pad), causal, scale * kLog2E, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t pairs = rows * D / 2;
  int64_t post_blocks = (pairs + kPostThreads - 1) / kPostThreads;
  if (post_blocks > (1 << 20)) post_blocks = 1 << 20;
  flash_bwd_post_kernel<D><<<static_cast<unsigned>(post_blocks),
                             kPostThreads, 0, stream>>>(
      dq_acc, static_cast<bf*>(dq), pairs, static_cast<int>(seq_q),
      static_cast<int>(seq_q_pad), scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, float* dq_acc,
                   float* lse2, int64_t batch, int heads_q, int heads_kv,
                   int group, int64_t seq_q, int64_t seq_k, Strides qs,
                   Strides ks, Strides vs, int causal, float scale,
                   cudaStream_t s) {
  if (dtype == kF32)
    return launch_f32<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, batch,
                         heads_q, heads_kv, group, seq_q, seq_k, qs, ks, vs,
                         causal, scale, s);
  if (dtype != kBF16 || dq_acc == nullptr || lse2 == nullptr)
    return cudaErrorInvalidValue;
  return launch_bf16<D>(q, k, v, o, dout, lse, dq, dk, dv, delta, dq_acc,
                        lse2, batch, heads_q, heads_kv, group, seq_q, seq_k,
                        qs, ks, vs, causal, scale, s);
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
// [batch, heads_kv, seq_k, head_dim], contiguous, same type.  Workspace the
// wrapper allocates: delta f32 [batch, heads_q, seq_q_pad] (seq_q rounded
// up to a multiple of 64) and, for bf16 only, lse2 f32 [batch, heads_q,
// seq_q_pad] and dq_acc f32 [batch, heads_q, seq_q, head_dim] (null for
// f32).  Launches two (f32) or three (bf16) kernels on the stream; returns
// the first launch error (0 on success); it does not synchronise.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* delta, void* dq_acc, void* lse2,
                              int64_t batch, int64_t heads_q,
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
  float* acc_f = static_cast<float*>(dq_acc);
  float* lse2_f = static_cast<float*>(lse2);
#define REPRO_BWD_CASE(D)                                                   \
  case D:                                                                   \
    return launch<D>(dtype, q, k, v, o, dout, lse_f, dq, dk, dv, delta_f,   \
                     acc_f, lse2_f, batch, hq, hkv, group, seq_q, seq_k, qs, \
                     ks, vs, causal, scale, s);
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
