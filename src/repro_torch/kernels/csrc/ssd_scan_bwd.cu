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
// and with S_in the state entering the chunk and dS the gradient of the
// state leaving it:
//   dW_ij  = dy_i . x_j  (j <= i),   dCB = dW o L o dt_j
//   dx_j   = sum_i W_ij dy_i + f_j (dS^T b_j) + d dy_j
//   dc_i   = sum_j dCB_ij b_j + e_i (S_in dy_i)
//   db_j   = sum_i dCB_ij c_i + f_j (dS x_j)
//   df_j   = x_j . (dS^T b_j)
//   d(cum)_i = sum_j dW_ij W_ij - sum_k dW_ki W_ki + e_i c_i . (S_in dy_i)
//              - f_i df_i  (+ exp(T) <S_in, dS> + sum_j f_j df_j at i = Q)
//   ds_t   = sum_{i >= t} d(cum)_i,  ddt_t = a ds_t + g_t df_t
//            + sum_i dW_it CB_it L_it,  da = sum dt_t ds_t,  dd = sum dy.x
// W's and every decay's upper triangle is selected to 0, never multiplied
// by a 0/1 mask: there the exponent is positive and exp() may be inf.  Any
// L >= 1: the last chunk is masked (dt = 0 and x, b, c, dy = 0 past L,
// which add nothing).  P in {16, 32, 64, 128}, N in {8, 16, 128}.
//
// The chunk-parallel form.  The recurrence carries only the [N, P] state:
// S_in(z+1) = exp(T_z) S_in(z) + S_loc(z), S_loc = sum_j (b_j f_j) x_j^T,
// and dS(z-1) = exp(T_z) dS(z) + C(z), C = sum_i (c_i e_i) dy_i^T.  All
// else in a chunk needs only S_in and dS.  So the steps run over every
// chunk at once (no block walks the sequence), one launch each:
//
// (1) ssd_bwd_chunk_states_kernel, one block of 8 warps per (batch, chunk,
//     tile of heads; the wrapper's tile is 8): for each head, the chunk's
//     decays (T_z into `totals`), S_loc and C as products over the chunk's
//     64 tokens, f32 into two workspaces [B, H, L/Q, N, P].
// (2) ssd_bwd_state_pass_kernel, elementwise over (batch, head, N P / 4):
//     walks the chunks forward, turning S_loc into S_in in place, and
//     backward, turning C into dS in place; float4 loads, two batches of
//     four chunks alternating in flight, f32 only, no products.
// (3) ssd_bwd_chunk_kernel, one block per (batch, chunk, tile of heads):
//     every per-chunk product above for each head of the tile, with S_in
//     and dS read from the workspaces; dx and ddt out, da and dd partials
//     per (batch, chunk, head).  With G = 1 c.b^T is the same for every
//     head: computed once a block and kept in registers; db and dc are
//     summed over the tile's heads in registers, in head order, and
//     written once per tile; with G = H each head's db and dc go straight
//     out.  The sums a head needs (rows and columns of dW o W, columns of
//     dW o CB o L, df, c . (S_in dy)) go to shared memory as per-warp
//     shares that warp 0 adds in a fixed order in its final scan: seven
//     barriers a head.
// (4) ssd_bwd_reduce_*_kernel add the partials in a fixed order: db and dc
//     over the head tiles (G = 1), da and dd over (batch, chunk).  No float
//     atomics anywhere: the six gradients are bit-identical run to run.
//
// Workspace (the wrapper's, f32): the two state buffers B H (L/Q) N P each
// (335 MB each at the mamba2-2.7b training layer, x [2,4096,80,64], N 128,
// one group), the db and dc sums per tile of 8 heads B L (H/8) N each (42
// MB each; none for G = H), T_z, and the da and dd partials: 755 MB there.
// The slice-by-slice design this replaces held 1.01 GB (its states 335 MB,
// its per-head db and dc partials 671 MB).
//
// Inside the blocks.  bf16: the tensor cores, mma.sync m16n8k16 (bf16
// operands, f32 sums), fed by ldmatrix from bf16 tiles in shared memory
// whose 16-byte chunks are XOR-swizzled by row, so that the eight rows one
// ldmatrix phase reads fall in distinct banks.  x, dy, b and c are bf16
// inputs and are copied in as they arrive (cp.async); the operands that
// are not inputs (W, dCB, S_in, dS, b f and c e) are stored as two bf16
// planes, hi = bf16(v) and lo = bf16(v - hi), each its own MMA: one
// rounding of these misses the 2e-3 relative-L2 gate
// (tests/test_torch_ssd_bwd.py holds a plain model of this arithmetic).
// Transposed operands (W^T, dCB^T, (b f)^T, (c e)^T, and B operands stored
// row-major) are read with ldmatrix.trans, so no tile is stored twice.
// f32: the f32 cores, a register tile of rows w + W r and column pairs
// 2 lane + 64 s a thread over f32 tiles (rows padded by one word), held to
// 5e-4.  One engine type per element type carries the tile layout, the
// product, the epilogue's coordinates and the fixed-order row and column
// sums, so both paths run the same kernels.
//
// Warps and blocks.  The per-chunk kernel keeps the tile's db and dc sums
// in registers (64 KB a block at N = 128), so it runs one block of 16
// warps an SM (128 registers a thread, none spilled), or of 8 warps with
// 255 registers where 16 would spill (f32; bf16 at P = N = 128).  135 KB of
// shared memory at P = 64, N = 128 in bf16: b, c, x, dy, S_in and dS hi +
// lo, one W/dCB buffer (W until dx is done, then dCB), the sums' shares;
// where S_in and dS do not both fit (f32 at P = N = 128) dS is loaded first
// and S_in after db.  The local-states kernel holds one split tile (b f,
// then c e) and, in bf16 up to N P = 128 x 64, runs two blocks of 8 warps
// an SM.
//
// What bounds it.  The function needs 0.265 GB of input and output at the
// training layer (0.0792 ms at 3.35 TB/s; its operations, 7.0e10, take
// 0.071 ms on the bf16 tensor cores).  This design also moves the f32
// states: written by (1), read and rewritten by (2), read by (3): 3.2 GB in
// all, 0.95 ms.  Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py; chip_smoke.py's ssd_bwd phase gives each kernel's
// time): ~2.0 ms a call against 6.7 for the slice-by-slice design; the
// state pass runs at ~2.8 TB/s, the per-chunk kernel (~0.9 ms) runs its
// products (1.2e11 FLOP with the hi + lo MMAs) at ~13 % of the bf16 peak
// and the local states at ~8 %.  Loading the next head's tiles under
// this head's products (a second stage, cp.async) moved the call by 0.7 %
// at the training layer and 4.7 % at jamba's, so it is not kept: neither
// load latency nor the MMA rate limits the per-chunk kernel, but its
// serial per-head phases, one block an SM.
//
// mma.sync, not wgmma: measured, the products run at 8-13 % of the bf16
// peak, so a faster instruction would not shorten the kernels; and
// mma.sync's 16-row warp tiles fit every product here, the [N, P] ones at
// N = 16 among them, which wgmma's 64-row warpgroup tiles would pad 4x.
//
// Each launch's error is returned; shared memory above 48 KB is set with
// cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;                 // tokens per chunk
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block may use
constexpr int kPassThreads = 256;      // the state pass
constexpr int kPassDepth = 4;          // chunks of loads in flight a thread

enum DType : int { kF32 = 0, kBF16 = 1 };

struct Strides {
  int64_t b, l, h;  // elements; the stride along the last dimension is 1
};

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// PTX: shared-memory copies, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ok false writes zeros and reads nothing
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

// every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// d += a b: a the 16x16 A fragment, (b0, b1) the 16x8 B fragment
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16 values
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// v0, v1 -> hi = bf16(v), lo = bf16(v - hi), two bf16 a register, v0 low
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0,
                                                  float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p,
                                                          float v0,
                                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// The byte offset of 16-byte chunk `ch` of row `r` in a bf16 tile of C
// columns.  Chunks are XORed with the row (mod 8, or mod the chunks a row
// where fewer) so that the 8 rows one ldmatrix phase reads fall in
// distinct banks.
template <int C>
__device__ __forceinline__ uint32_t chunk_off(int r, int ch) {
  constexpr int kCpr = C / 8;
  constexpr int kMask = (kCpr < 8 ? kCpr : 8) - 1;
  return static_cast<uint32_t>(r * kCpr + (ch ^ (r & kMask))) * 16;
}
template <int C>
__device__ __forceinline__ uint32_t elem_off(int r, int c) {
  return chunk_off<C>(r, c >> 3) + 2 * (c & 7);
}

// ===========================================================================
// The engines.  Each gives: Tile<C>, an operand of C columns in shared
// memory (one plane, or two for an operand split hi + lo); Acc<M, NN>, the
// outputs of an M x NN product a thread owns, as pairs of adjacent columns
// (pair(k), coord(k, i, j): row i, columns j and j + 1; false where the
// thread owns none); product<M, NN, K, AT, BT, AS, BS>(acc, A, B), acc +=
// A B over k < K, A [M, K] read from its tile as stored (AT false) or
// transposed (A(i, k) = tile[k][i]), B [K, NN] as stored or transposed
// (B(k, j) = tile[j][k]), AS and BS: the operand is split; row and column
// slots of the pairs and put_* / take_* to sum them in a fixed order;
// store2 / get2 of a pair of values in a tile; load_rows (an input tile from
// global memory).
// ===========================================================================

// bf16: the tensor cores, W warps.  The output is cut into 16 x 16 blocks
// (two 16 x 8 MMA tiles); warp w owns row block w % RB (RB = M / 16) and
// PPW adjacent column blocks from (w / RB) PPW.  In an MMA tile, lane (g =
// lane / 4, q = lane % 4) owns rows g, g + 8 and columns 2q, 2q + 1.
template <int W>
struct MmaEngine {
  static constexpr int kW = W, kT = 32 * W;  // warps, threads
  using Elem = __nv_bfloat16;
  static constexpr int kPlanes = 2;

  template <int C>
  __host__ __device__ static constexpr int plane(int rows) {
    return round128(rows * C * 2);
  }

  template <int C>
  struct Tile {
    unsigned char* hi;
    unsigned char* lo;  // the second plane of a split operand
  };
  template <int C>
  static __device__ __forceinline__ Tile<C> tile(unsigned char* base,
                                                 int rows) {
    return {base, base + plane<C>(rows)};
  }

  template <int M, int NN>
  struct Acc {
    static constexpr int RB = M / 16;
    static_assert(M % 16 == 0 && W % RB == 0, "row blocks");
    static constexpr int WPR = W / RB;  // warps a row block
    static constexpr int CP = NN / 16;       // column blocks
    static constexpr int PPW = (CP + WPR - 1) / WPR;
    static constexpr int kActive = (CP + PPW - 1) / PPW;  // warps with some
    static constexpr int kPairs = 4 * PPW;
    static constexpr int kRowSlots = 2;        // rows g, g + 8
    static constexpr int kColSlots = 2 * PPW;  // 8-column tiles
    static __device__ __forceinline__ int row_slot(int k) { return k & 1; }
    static __device__ __forceinline__ int col_slot(int k) { return k >> 1; }
    float v[PPW][2][4];
    __device__ __forceinline__ float* pair(int k) {
      return &v[k >> 2][(k >> 1) & 1][2 * (k & 1)];
    }
    static __device__ __forceinline__ bool coord(int k, int& i, int& j) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      const int cp = (warp / RB) * PPW + (k >> 2);
      i = 16 * (warp % RB) + (lane >> 2) + 8 * (k & 1);
      j = 16 * cp + 8 * ((k >> 1) & 1) + 2 * (lane & 3);
      return cp < CP;
    }
  };

  template <int M, int NN>
  static __device__ __forceinline__ void zero(Acc<M, NN>& acc) {
#pragma unroll
    for (int t = 0; t < Acc<M, NN>::PPW; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc.v[t][e >> 2][e & 3] = 0.0f;
  }

  template <int M, int NN, int K, bool AT, bool BT, bool AS, bool BS, int CA,
            int CB>
  static __device__ __forceinline__ void product(Acc<M, NN>& acc, Tile<CA> a,
                                                 Tile<CB> b) {
    using A = Acc<M, NN>;
    static_assert(K % 16 == 0 && !(AS && BS), "one split operand at most");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int mi = lane >> 3, rr = lane & 7;  // ldmatrix: matrix, its row
    const int rb = warp % A::RB;
    const int cp0 = (warp / A::RB) * A::PPW;
    if (cp0 >= A::CP) return;
    const uint32_t ah = smem_u32(a.hi), al = smem_u32(a.lo);
    const uint32_t bh = smem_u32(b.hi), bl = smem_u32(b.lo);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      // A [16 rows, 16 of k]: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
      const uint32_t ao =
          AT ? chunk_off<CA>(k0 + rr + 8 * (mi >> 1), 2 * rb + (mi & 1))
             : chunk_off<CA>(16 * rb + rr + 8 * (mi & 1), (k0 >> 3) + (mi >> 1));
      uint32_t fa[4], fl[4];
      if constexpr (AT) ldsm_x4_t(fa, ah + ao);
      else ldsm_x4(fa, ah + ao);
      if constexpr (AS) {
        if constexpr (AT) ldsm_x4_t(fl, al + ao);
        else ldsm_x4(fl, al + ao);
      }
#pragma unroll
      for (int t = 0; t < A::PPW; ++t) {
        const int n0 = 16 * (cp0 + t);
        if (A::CP % A::PPW != 0 && n0 >= NN) break;
        // B [16 of k, 16 columns] as two 16 x 8 fragments: fb[0..1] the
        // first 8 columns, fb[2..3] the next
        const uint32_t bo =
            BT ? chunk_off<CB>(n0 + rr + 8 * (mi >> 1), (k0 >> 3) + (mi & 1))
               : chunk_off<CB>(k0 + rr + 8 * (mi & 1), (n0 >> 3) + (mi >> 1));
        uint32_t fb[4];
        if constexpr (BT) ldsm_x4(fb, bh + bo);
        else ldsm_x4_t(fb, bh + bo);
        mma(acc.v[t][0], fa, fb[0], fb[1]);
        mma(acc.v[t][1], fa, fb[2], fb[3]);
        if constexpr (AS) {
          mma(acc.v[t][0], fl, fb[0], fb[1]);
          mma(acc.v[t][1], fl, fb[2], fb[3]);
        }
        if constexpr (BS) {
          uint32_t fc[4];
          if constexpr (BT) ldsm_x4(fc, bl + bo);
          else ldsm_x4_t(fc, bl + bo);
          mma(acc.v[t][0], fa, fc[0], fc[1]);
          mma(acc.v[t][1], fa, fc[2], fc[3]);
        }
      }
    }
  }

  // Fixed-order row and column sums of the outputs.  A thread adds its
  // pairs' shares into slots (row_slot, col_slot); put_rows / put_cols add
  // the lanes' slots (the four lanes of a row, the eight of a column) and
  // write each warp's sums to red (row_red / col_red floats); after a
  // barrier take_row / take_col add one row's or column's warps in order
  // (rows: the row block's warps; columns: the row blocks).
  template <int M, int NN>
  static __device__ __forceinline__ void put_rows(
      const float (&part)[Acc<M, NN>::kRowSlots], float* red) {
    using A = Acc<M, NN>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rb = warp % A::RB, cw = warp / A::RB;
    float p[2] = {part[0], part[1]};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 1);
      p[h] += __shfl_xor_sync(0xffffffffu, p[h], 2);
    }
    if (cw < A::kActive && (lane & 3) == 0) {
      red[cw * M + 16 * rb + (lane >> 2)] = p[0];
      red[cw * M + 16 * rb + (lane >> 2) + 8] = p[1];
    }
  }
  template <int M, int NN>
  __host__ __device__ static constexpr int row_red() {
    return Acc<M, NN>::kActive * M;
  }
  template <int M, int NN>
  static __device__ __forceinline__ float take_row(const float* red, int i) {
    float s = 0.0f;
    for (int w = 0; w < Acc<M, NN>::kActive; ++w) s += red[w * M + i];
    return s;
  }
  template <int M, int NN>
  static __device__ __forceinline__ void put_cols(
      const float2 (&part)[Acc<M, NN>::kColSlots], float* red) {
    using A = Acc<M, NN>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rb = warp % A::RB, cw = warp / A::RB;
#pragma unroll
    for (int c = 0; c < A::kColSlots; ++c) {
      float2 p = part[c];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        p.x += __shfl_xor_sync(0xffffffffu, p.x, off);
        p.y += __shfl_xor_sync(0xffffffffu, p.y, off);
      }
      const int cp = cw * A::PPW + (c >> 1);
      if (lane < 4 && cp < A::CP) {
        const int j = 16 * cp + 8 * (c & 1) + 2 * lane;
        red[rb * NN + j] = p.x;
        red[rb * NN + j + 1] = p.y;
      }
    }
  }
  template <int M, int NN>
  __host__ __device__ static constexpr int col_red() {
    return Acc<M, NN>::RB * NN;
  }
  template <int M, int NN>
  static __device__ __forceinline__ float take_col(const float* red, int j) {
    float s = 0.0f;
    for (int r = 0; r < Acc<M, NN>::RB; ++r) s += red[r * NN + j];
    return s;
  }

  // a pair of values (c even) into a split tile, hi and lo
  template <int C>
  static __device__ __forceinline__ void store2(Tile<C> t, int r, int c,
                                                float v0, float v1) {
    const uint32_t off = elem_off<C>(r, c);
    uint32_t hi, lo;
    split_bf16(v0, v1, hi, lo);
    *reinterpret_cast<uint32_t*>(t.hi + off) = hi;
    *reinterpret_cast<uint32_t*>(t.lo + off) = lo;
  }

  // a pair of an input tile (c even)
  template <int C>
  static __device__ __forceinline__ float2 get2(Tile<C> t, int r, int c) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(t.hi + elem_off<C>(r, c)));
  }

  // rows [0, rows) x columns [0, width) of a row-major bf16 source (row r
  // at src + r stride) into a [Q, C] tile, zeros elsewhere: cp.async where
  // the source's rows are 16-byte aligned (vec), else 2-byte loads
  template <int C>
  static __device__ __forceinline__ void load_rows(Tile<C> t, const Elem* src,
                                                   int64_t stride, int rows,
                                                   int width, bool vec) {
    constexpr int kCpr = C / 8;
    const uint32_t base = smem_u32(t.hi);
    for (int k = threadIdx.x; k < kQ * kCpr; k += kT) {
      const int r = k / kCpr, ch = k - r * kCpr;
      const bool ok = r < rows && ch * 8 < width;
      const Elem* s = src + (ok ? r * stride + ch * 8 : 0);
      if (vec) {
        cp_async16(base + chunk_off<C>(r, ch), s, ok);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (ok) {
          const uint16_t* e = reinterpret_cast<const uint16_t*>(s);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = static_cast<uint32_t>(e[2 * u]) |
                   (static_cast<uint32_t>(e[2 * u + 1]) << 16);
        }
        *reinterpret_cast<uint4*>(t.hi + chunk_off<C>(r, ch)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// f32: the f32 cores, W warps.  Thread (lane, warp) owns rows warp + W r
// and the column pairs 2 lane + 64 s.  Tiles are f32 with rows padded by one word.
template <int W>
struct FmaEngine {
  static constexpr int kW = W, kT = 32 * W;  // warps, threads
  using Elem = float;
  static constexpr int kPlanes = 1;

  template <int C>
  __host__ __device__ static constexpr int plane(int rows) {
    return round128(rows * (C + 1) * 4);
  }

  template <int C>
  struct Tile {
    float* p;
  };
  template <int C>
  static __device__ __forceinline__ Tile<C> tile(unsigned char* base, int) {
    return {reinterpret_cast<float*>(base)};
  }

  template <int M, int NN>
  struct Acc {
    static constexpr int R = M / W;
    static_assert(M % W == 0, "rows");
    static constexpr int S = (NN + 63) / 64;
    static constexpr int kPairs = R * S;
    static constexpr int kRowSlots = R;
    static constexpr int kColSlots = S;
    static __device__ __forceinline__ int row_slot(int k) { return k / S; }
    static __device__ __forceinline__ int col_slot(int k) { return k % S; }
    float v[R][S][2];
    __device__ __forceinline__ float* pair(int k) { return v[k / S][k % S]; }
    static __device__ __forceinline__ bool coord(int k, int& i, int& j) {
      i = (threadIdx.x >> 5) + W * (k / S);
      j = 2 * (threadIdx.x & 31) + 64 * (k % S);
      return j < NN;
    }
  };

  template <int M, int NN>
  static __device__ __forceinline__ void zero(Acc<M, NN>& acc) {
#pragma unroll
    for (int k = 0; k < Acc<M, NN>::kPairs; ++k)
      acc.pair(k)[0] = acc.pair(k)[1] = 0.0f;
  }

  template <int M, int NN, int K, bool AT, bool BT, bool AS, bool BS, int CA,
            int CB>
  static __device__ __forceinline__ void product(Acc<M, NN>& acc, Tile<CA> a,
                                                 Tile<CB> b) {
    using A = Acc<M, NN>;
    const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float av[A::R];
#pragma unroll
      for (int r = 0; r < A::R; ++r) {
        const int i = ty + W * r;
        av[r] = AT ? a.p[k * (CA + 1) + i] : a.p[i * (CA + 1) + k];
      }
#pragma unroll
      for (int s = 0; s < A::S; ++s) {
        const int j = 2 * tx + 64 * s;
        if (NN % 64 != 0 && j >= NN) continue;
        const float b0 = BT ? b.p[j * (CB + 1) + k] : b.p[k * (CB + 1) + j];
        const float b1 =
            BT ? b.p[(j + 1) * (CB + 1) + k] : b.p[k * (CB + 1) + j + 1];
#pragma unroll
        for (int r = 0; r < A::R; ++r) {
          acc.v[r][s][0] = fmaf(av[r], b0, acc.v[r][s][0]);
          acc.v[r][s][1] = fmaf(av[r], b1, acc.v[r][s][1]);
        }
      }
    }
  }

  // as MmaEngine's: a row is owned by one warp (its lanes' slots, then a
  // shuffle tree); a column by one lane of each warp (the warps in order)
  template <int M, int NN>
  static __device__ __forceinline__ void put_rows(
      const float (&part)[Acc<M, NN>::kRowSlots], float* red) {
#pragma unroll
    for (int r = 0; r < Acc<M, NN>::kRowSlots; ++r) {
      const float v = warp_sum(part[r]);
      if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) + W * r] = v;
    }
  }
  template <int M, int NN>
  __host__ __device__ static constexpr int row_red() {
    return M;
  }
  template <int M, int NN>
  static __device__ __forceinline__ float take_row(const float* red, int i) {
    return red[i];
  }
  template <int M, int NN>
  static __device__ __forceinline__ void put_cols(
      const float2 (&part)[Acc<M, NN>::kColSlots], float* red) {
    const int ty = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < Acc<M, NN>::kColSlots; ++s) {
      const int j = 2 * (threadIdx.x & 31) + 64 * s;
      if (j < NN) {
        red[ty * NN + j] = part[s].x;
        red[ty * NN + j + 1] = part[s].y;
      }
    }
  }
  template <int M, int NN>
  __host__ __device__ static constexpr int col_red() {
    return W * NN;
  }
  template <int M, int NN>
  static __device__ __forceinline__ float take_col(const float* red, int j) {
    float s = 0.0f;
    for (int w = 0; w < W; ++w) s += red[w * NN + j];
    return s;
  }

  template <int C>
  static __device__ __forceinline__ void store2(Tile<C> t, int r, int c,
                                                float v0, float v1) {
    t.p[r * (C + 1) + c] = v0;
    t.p[r * (C + 1) + c + 1] = v1;
  }

  template <int C>
  static __device__ __forceinline__ float2 get2(Tile<C> t, int r, int c) {
    return make_float2(t.p[r * (C + 1) + c], t.p[r * (C + 1) + c + 1]);
  }

  // as MmaEngine::load_rows, f32, all of a thread's loads before its stores
  template <int C>
  static __device__ __forceinline__ void load_rows(Tile<C> t, const Elem* src,
                                                   int64_t stride, int rows,
                                                   int width, bool) {
    constexpr int kPer = kQ * C / kT;
    constexpr int kBatch = kPer < 8 ? kPer : 8;  // loads in flight
#pragma unroll
    for (int u0 = 0; u0 < kPer; u0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = threadIdx.x + (u0 + u) * kT;
        const int r = e / C, c = e - r * C;
        v[u] = r < rows && c < width ? src[r * stride + c] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = threadIdx.x + (u0 + u) * kT;
        const int r = e / C, c = e - r * C;
        t.p[r * (C + 1) + c] = v[u];
      }
    }
  }

};

// rows [0, n) of the f32 [n, C] states at s0 (device or shared memory)
// into tile t0 (rows n..R-1 zero; split where the engine splits) and,
// where STORE1, of s1 into t1; returns this thread's share of <s0, s1> (0
// where s1 is null).  Loads go in batches of four float4 pairs, each batch
// before its stores.
template <class E, int R, int C, bool STORE1>
__device__ __forceinline__ float load_states(typename E::template Tile<C> t0,
                                             const float* s0,
                                             typename E::template Tile<C> t1,
                                             const float* s1, int n) {
  constexpr int kT = E::kT;
  constexpr int kVec = R * C / 4;
  constexpr int kPer = (kVec + kT - 1) / kT;
  constexpr int kBatch = kPer < 4 ? kPer : 4;  // float4 pairs in flight
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float dot = 0.0f;
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kBatch) {
    float4 v0[kBatch], v1[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (u0 + u) * kT;
      const bool ok = (kVec % kT == 0 || e < kVec) && e / (C / 4) < n;
      v0[u] = ok ? reinterpret_cast<const float4*>(s0)[e] : zero4;
      v1[u] = ok && s1 != nullptr ? reinterpret_cast<const float4*>(s1)[e]
                                  : zero4;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = threadIdx.x + (u0 + u) * kT;
      if (kVec % kT != 0 && e >= kVec) break;
      dot += v0[u].x * v1[u].x + v0[u].y * v1[u].y + v0[u].z * v1[u].z +
             v0[u].w * v1[u].w;
      const int r = e / (C / 4), c = 4 * (e - r * (C / 4));
      E::store2(t0, r, c, v0[u].x, v0[u].y);
      E::store2(t0, r, c + 2, v0[u].z, v0[u].w);
      if constexpr (STORE1) {
        E::store2(t1, r, c, v1[u].x, v1[u].y);
        E::store2(t1, r, c + 2, v1[u].z, v1[u].w);
      }
    }
  }
  return dot;
}

// the row sums over j of fn(k, i, j) (a float2: columns j, j + 1) for
// the outputs of an M x NN product, each warp's share into red (the
// engine's row_red floats): take_row after a barrier gives row i's sum
template <class E, int M, int NN, typename Fn>
__device__ __forceinline__ void put_row_sums(Fn fn, float* red) {
  using A = typename E::template Acc<M, NN>;
  float part[A::kRowSlots];
#pragma unroll
  for (int r = 0; r < A::kRowSlots; ++r) part[r] = 0.0f;
#pragma unroll
  for (int k = 0; k < A::kPairs; ++k) {
    int i, j;
    if (A::coord(k, i, j)) {
      const float2 v = fn(k, i, j);
      part[A::row_slot(k)] += v.x + v.y;
    }
  }
  E::template put_rows<M, NN>(part, red);
}

template <typename T, int W>
struct EngineOf;
template <int W>
struct EngineOf<float, W> {
  using type = FmaEngine<W>;
};
template <int W>
struct EngineOf<__nv_bfloat16, W> {
  using type = MmaEngine<W>;
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
  T* dx;           // [B, L, H, P]
  float* ddt;      // [B, L, H]
  T* db;           // [B, L, G, N]
  T* dc;
  float* states;   // [B, H, chunks, N, P]: S_loc, then S_in
  float* adj;      // [B, H, chunks, N, P]: C, then dS
  float* totals;   // [B, H, chunks]: T = cum_Q
  float* part_b;   // [B, L, tiles, N] (G = 1)
  float* part_c;
  float* part_a;   // [B, chunks, H]
  float* part_d;
  int64_t seq, chunks;
  int heads, groups, head_tile, tiles;
  Strides xs, dts, bs, cs, dys;
  int64_t a_stride, d_stride;
  bool dy_vec;     // dy's rows are 16-byte aligned (bf16 cp.async)
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

// head h's rows of the chunk: x and dy into their tiles, dt into dt_s (0
// past L; threads 0..Q-1), by cp.async where the engine copies so
template <class E, int P, typename T>
__device__ __forceinline__ void load_head(const BwdArgs<T>& args,
                                          typename E::template Tile<P> xt,
                                          typename E::template Tile<P> dyt,
                                          float* dt_s, int64_t bb, int h,
                                          int64_t l0, int rows) {
  E::load_rows(xt, args.x + bb * args.xs.b + h * args.xs.h + l0 * args.xs.l,
               args.xs.l, rows, P, true);
  E::load_rows(dyt,
               args.dy + bb * args.dys.b + h * args.dys.h + l0 * args.dys.l,
               args.dys.l, rows, P, args.dy_vec);
  const int r = threadIdx.x;
  if (r < kQ)
    cp_async4(smem_u32(dt_s + r),
              args.dt + bb * args.dts.b + h * args.dts.h +
                  (l0 + (r < rows ? r : 0)) * args.dts.l,
              r < rows);
}

// the N columns of b and c a head reads (G = 1: shared by every head)
template <class E, int NP, typename T>
__device__ __forceinline__ void load_bc(const BwdArgs<T>& args,
                                        typename E::template Tile<NP> bt,
                                        typename E::template Tile<NP> ct,
                                        int64_t bb, int grp, int64_t l0,
                                        int rows, int n) {
  E::load_rows(bt, args.b + bb * args.bs.b + grp * args.bs.h + l0 * args.bs.l,
               args.bs.l, rows, n, true);
  E::load_rows(ct, args.c + bb * args.cs.b + grp * args.cs.h + l0 * args.cs.l,
               args.cs.l, rows, n, true);
}

// ---------------------------------------------------------------------------
// (1) S_loc and C of every (batch, chunk, head)
// ---------------------------------------------------------------------------
// 8 warps; two blocks an SM in bf16 where a thread's share of the [N, P]
// outputs leaves it room in 128 registers (N P <= 128 x 64), else one
template <typename T, int P, int N>
struct StatesCfg {
  static constexpr int kW = 8;
  static constexpr int kNP = (N < 16 ? 16 : N) * P;
  static constexpr int kMinBlocks = sizeof(T) == 2 && kNP <= 128 * 64 ? 2 : 1;
};

template <class E, int P, int N>
struct StatesSmem {
  static constexpr int NP = N < 16 ? 16 : N;  // N = 8 padded to the k of 16
  static constexpr int kB = 0;
  static constexpr int kC = kB + E::template plane<NP>(kQ);
  static constexpr int kX = kC + E::template plane<NP>(kQ);
  static constexpr int kDy = kX + E::template plane<P>(kQ);
  static constexpr int kBf = kDy + E::template plane<P>(kQ);  // b f, then c e
  static constexpr int kVec = kBf + E::kPlanes * E::template plane<NP>(kQ);
  static constexpr int kBytes = kVec + 6 * kQ * 4;  // dt, cum, e, g, f, T
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(32 * StatesCfg<T, P, N>::kW,
                                  StatesCfg<T, P, N>::kMinBlocks)
    ssd_bwd_chunk_states_kernel(const BwdArgs<T> args) {
  using E = typename EngineOf<T, StatesCfg<T, P, N>::kW>::type;
  using S = StatesSmem<E, P, N>;
  constexpr int NP = S::NP;
  using Acc = typename E::template Acc<NP, P>;
  extern __shared__ __align__(128) unsigned char sm[];
  const auto bt = E::template tile<NP>(sm + S::kB, kQ);
  const auto ct = E::template tile<NP>(sm + S::kC, kQ);
  const auto xt = E::template tile<P>(sm + S::kX, kQ);
  const auto dyt = E::template tile<P>(sm + S::kDy, kQ);
  const auto ft = E::template tile<NP>(sm + S::kBf, kQ);
  float* dt_s = reinterpret_cast<float*>(sm + S::kVec);
  float* cum_s = dt_s + kQ;
  float* e_s = cum_s + kQ;
  float* g_s = e_s + kQ;
  float* f_s = g_s + kQ;
  float* total_s = f_s + kQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h0 = blockIdx.x * args.head_tile;
  const int h1 = min(args.heads, h0 + args.head_tile);
  const int64_t z = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t l0 = z * kQ;
  const int rows =
      static_cast<int>(args.seq - l0 < kQ ? args.seq - l0 : kQ);
  const bool shared_bc = args.groups == 1;
  if (shared_bc) load_bc<E, NP>(args, bt, ct, bb, 0, l0, rows, N);

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the previous head is done with the tiles
    if (!shared_bc) load_bc<E, NP>(args, bt, ct, bb, h, l0, rows, N);
    load_head<E, P>(args, xt, dyt, dt_s, bb, h, l0, rows);
    cp_async_wait_all();
    __syncthreads();
    const int64_t head = (bb * args.heads + h) * args.chunks + z;
    if (warp == 0) {
      chunk_decays(args.a[h * args.a_stride], dt_s, cum_s, e_s, g_s, f_s,
                   total_s);
      if (lane == 0) args.totals[head] = total_s[0];
    }
    // S_loc = (b f)^T x, then C = (c e)^T dy: [N, P] f32 out; b f and c e
    // take turns in one split tile
#pragma unroll 1
    for (int o = 0; o < 2; ++o) {
      __syncthreads();  // the decays are in; the first product is done
      for (int k = threadIdx.x; k < kQ * NP / 2; k += E::kT) {
        const int r = k / (NP / 2), c = 2 * (k - r * (NP / 2));
        const float2 v = E::get2(o == 0 ? bt : ct, r, c);
        const float w = (o == 0 ? f_s : e_s)[r];
        E::store2(ft, r, c, v.x * w, v.y * w);
      }
      __syncthreads();
      Acc s;
      E::zero(s);
      E::template product<NP, P, kQ, true, false, true, false>(
          s, ft, o == 0 ? xt : dyt);
      float* out = (o == 0 ? args.states : args.adj) + head * N * P;
#pragma unroll
      for (int k = 0; k < Acc::kPairs; ++k) {
        int i, j;
        if (Acc::coord(k, i, j) && i < N)
          store_pair(out + i * P + j, s.pair(k)[0], s.pair(k)[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (2) the state pass: S_loc -> S_in forward, C -> dS backward, in place
// ---------------------------------------------------------------------------
// One batch of kPassDepth chunks of a thread's walks: the forward walk's
// chunks z0.. and the backward walk's chunks Z-1-z0.. (loads, then stores)
struct PassBatch {
  float4 vs[kPassDepth], va[kPassDepth];
  float ts[kPassDepth], ta[kPassDepth];
};

__device__ __forceinline__ void pass_load(PassBatch& q, const float4* sp,
                                          const float4* ap, const float* tp,
                                          int64_t z0, int64_t chunks,
                                          int64_t np4) {
#pragma unroll
  for (int u = 0; u < kPassDepth; ++u) {
    const int64_t zf = z0 + u, zb = chunks - 1 - zf;
    if (zf < chunks) {
      q.vs[u] = sp[zf * np4];
      q.va[u] = ap[zb * np4];
      q.ts[u] = tp[zf];
      q.ta[u] = tp[zb];
    }
  }
}

__device__ __forceinline__ void pass_step(const PassBatch& q, float4* sp,
                                          float4* ap, float4& s, float4& d,
                                          int64_t z0, int64_t chunks,
                                          int64_t np4) {
#pragma unroll
  for (int u = 0; u < kPassDepth; ++u) {
    const int64_t zf = z0 + u, zb = chunks - 1 - zf;
    if (zf < chunks) {
      sp[zf * np4] = s;
      ap[zb * np4] = d;
      const float fs = expf(q.ts[u]), fa = expf(q.ta[u]);
      s = make_float4(fs * s.x + q.vs[u].x, fs * s.y + q.vs[u].y,
                      fs * s.z + q.vs[u].z, fs * s.w + q.vs[u].w);
      d = make_float4(fa * d.x + q.va[u].x, fa * d.y + q.va[u].y,
                      fa * d.z + q.va[u].z, fa * d.w + q.va[u].w);
    }
  }
}

// Each thread walks one float4 of one (batch, head)'s [N, P] through every
// chunk, both ways.  Two batches of loads alternate, so that one batch is
// in flight while the other is stored.
__global__ void __launch_bounds__(kPassThreads, 2)
    ssd_bwd_state_pass_kernel(float* __restrict__ states,
                              float* __restrict__ adj,
                              const float* __restrict__ totals,
                              int64_t count, int64_t chunks, int64_t np4) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(kPassThreads) +
                    threadIdx.x;
  if (e >= count) return;
  const int64_t bh = e / np4;
  const int64_t off = bh * chunks * np4 + (e - bh * np4);
  float4* sp = reinterpret_cast<float4*>(states) + off;
  float4* ap = reinterpret_cast<float4*>(adj) + off;
  const float* tp = totals + bh * chunks;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f), d = s;
  PassBatch qa, qb;
  pass_load(qa, sp, ap, tp, 0, chunks, np4);
  for (int64_t z0 = 0; z0 < chunks; z0 += 2 * kPassDepth) {
    pass_load(qb, sp, ap, tp, z0 + kPassDepth, chunks, np4);
    pass_step(qa, sp, ap, s, d, z0, chunks, np4);
    pass_load(qa, sp, ap, tp, z0 + 2 * kPassDepth, chunks, np4);
    pass_step(qb, sp, ap, s, d, z0 + kPassDepth, chunks, np4);
  }
}

// ---------------------------------------------------------------------------
// (3) the per-chunk products
// ---------------------------------------------------------------------------
// 16 warps, one block an SM; 8 (255 registers a thread) where the outputs a
// thread holds would not fit in 128: f32, and bf16 at P = N = 128
template <typename T, int P, int N>
struct ChunkCfg {
  static constexpr int kW =
      sizeof(T) == 2 && !(P == 128 && N == 128) ? 16 : 8;
};

template <class E, int P, int N>
struct ChunkSmem {
  static constexpr int NP = N < 16 ? 16 : N;
  static constexpr int kB = 0;
  static constexpr int kC = kB + E::template plane<NP>(kQ);
  static constexpr int kX = kC + E::template plane<NP>(kQ);
  static constexpr int kDy = kX + E::template plane<P>(kQ);
  static constexpr int kDs = kDy + E::template plane<P>(kQ);
  static constexpr int kW = kDs + E::kPlanes * E::template plane<P>(NP);
  static constexpr int kEnd = kW + E::kPlanes * E::template plane<kQ>(kQ);
  // the warps' shares of five sums, each read by warp 0 at the end of a
  // head: rowm and colm (dW o W over rows, columns), colg (dW o CB o L over
  // columns), df, vin
  static constexpr int kRedRowm = 0;
  static constexpr int kRedColm = kRedRowm + E::template row_red<kQ, kQ>();
  static constexpr int kRedColg = kRedColm + E::template col_red<kQ, kQ>();
  static constexpr int kRedDf = kRedColg + E::template col_red<kQ, kQ>();
  static constexpr int kRedVin = kRedDf + E::template row_red<kQ, P>();
  static constexpr int kRedFloats = kRedVin + E::template row_red<kQ, NP>();
  // dt, cum, e, g, f [Q]; the sums' shares; the per-warp shares of
  // <S_in, dS> and dd; T
  static constexpr int kVecBytes =
      (5 * kQ + kRedFloats + 2 * E::kW + 4) * 4;
  static constexpr int kSinBytes = E::kPlanes * E::template plane<P>(NP);
  // S_in beside dS where both fit, else in dS's place after db
  static constexpr bool kTwoS = kEnd + kSinBytes + kVecBytes <= kMaxSmem;
  static constexpr int kSin = kTwoS ? kEnd : kDs;
  static constexpr int kVec = kEnd + (kTwoS ? kSinBytes : 0);
  static constexpr int kBytes = kVec + kVecBytes;
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(32 * ChunkCfg<T, P, N>::kW, 1)
    ssd_bwd_chunk_kernel(const BwdArgs<T> args) {
  using E = typename EngineOf<T, ChunkCfg<T, P, N>::kW>::type;
  using S = ChunkSmem<E, P, N>;
  constexpr int NP = S::NP;
  using AccQQ = typename E::template Acc<kQ, kQ>;
  using AccQP = typename E::template Acc<kQ, P>;
  using AccQN = typename E::template Acc<kQ, NP>;
  extern __shared__ __align__(128) unsigned char sm[];
  const auto bt = E::template tile<NP>(sm + S::kB, kQ);
  const auto ct = E::template tile<NP>(sm + S::kC, kQ);
  const auto xt = E::template tile<P>(sm + S::kX, kQ);
  const auto dyt = E::template tile<P>(sm + S::kDy, kQ);
  const auto dst = E::template tile<P>(sm + S::kDs, NP);
  const auto sint = E::template tile<P>(sm + S::kSin, NP);
  const auto wt = E::template tile<kQ>(sm + S::kW, kQ);  // W, then dCB
  float* dt_s = reinterpret_cast<float*>(sm + S::kVec);
  float* cum_s = dt_s + kQ;
  float* e_s = cum_s + kQ;
  float* g_s = e_s + kQ;
  float* f_s = g_s + kQ;
  float* red_s = f_s + kQ;
  float* rowm_r = red_s + S::kRedRowm;  // sum_j dW_ij W_ij
  float* colm_r = red_s + S::kRedColm;  // sum_i dW_ij W_ij
  float* colg_r = red_s + S::kRedColg;  // sum_i dW_ij CB_ij L_ij
  float* df_r = red_s + S::kRedDf;      // x_j . (dS^T b_j)
  float* vin_r = red_s + S::kRedVin;    // c_i . (S_in dy_i)
  float* sds_s = red_s + S::kRedFloats;  // [W]
  float* dd_s = sds_s + E::kW;    // [W]
  float* total_s = dd_s + E::kW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ht = blockIdx.x;
  const int h0 = ht * args.head_tile;
  const int h1 = min(args.heads, h0 + args.head_tile);
  const int64_t z = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t l0 = z * kQ;
  const int rows =
      static_cast<int>(args.seq - l0 < kQ ? args.seq - l0 : kQ);
  const int H = args.heads;
  const bool shared_bc = args.groups == 1;
  const bool has_d = args.d != nullptr;

  AccQN db, dc;  // G = 1: the sums over the tile's heads
  E::zero(db);
  E::zero(dc);
  AccQQ cb;
  if (shared_bc) load_bc<E, NP>(args, bt, ct, bb, 0, l0, rows, N);

  for (int h = h0; h < h1; ++h) {
    const float a_h = args.a[h * args.a_stride];
    const float d_h = has_d ? args.d[h * args.d_stride] : 0.0f;
    const int64_t head = (bb * H + h) * args.chunks + z;
    const float* sin_g = args.states + head * N * P;
    __syncthreads();  // the previous head is done with every tile
    load_head<E, P>(args, xt, dyt, dt_s, bb, h, l0, rows);
    if (!shared_bc) load_bc<E, NP>(args, bt, ct, bb, h, l0, rows, N);
    float sds = load_states<E, NP, P, S::kTwoS>(
        dst, args.adj + head * N * P, sint, sin_g, N);
    sds = warp_sum(sds);
    if (lane == 0) sds_s[warp] = sds;
    cp_async_wait_all();
    __syncthreads();  // head h's loads have landed
    if (warp == 0) chunk_decays(a_h, dt_s, cum_s, e_s, g_s, f_s, total_s);
    __syncthreads();

    // ---- CB = c b^T (once a block for one group) and dW = dy x^T ---------
    if (!shared_bc || h == h0) {
      E::zero(cb);
      E::template product<kQ, kQ, NP, false, true, false, false>(cb, ct, bt);
    }
    AccQQ dw;
    E::zero(dw);
    E::template product<kQ, kQ, P, false, true, false, false>(dw, dyt, xt);
    // W into the tile; dCB replaces dW in registers; the sums of dW o W
    // over each row and column and of dW o CB o L over each column
    float rowm[AccQQ::kRowSlots];
    float2 colm[AccQQ::kColSlots], colg[AccQQ::kColSlots];
#pragma unroll
    for (int r = 0; r < AccQQ::kRowSlots; ++r) rowm[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < AccQQ::kColSlots; ++c)
      colm[c] = colg[c] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < AccQQ::kPairs; ++k) {
      int i, j;
      if (!AccQQ::coord(k, i, j)) continue;
      const float ci = cum_s[i];
      float wv[2], mv[2], gv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = j + u;
        const float l = jj <= i ? expf(ci - cum_s[jj]) : 0.0f;
        const float cbl = cb.pair(k)[u] * l;
        const float dwv = dw.pair(k)[u];
        wv[u] = cbl * dt_s[jj];
        mv[u] = dwv * wv[u];
        gv[u] = dwv * cbl;
        dw.pair(k)[u] = dwv * l * dt_s[jj];
      }
      E::store2(wt, i, j, wv[0], wv[1]);
      rowm[AccQQ::row_slot(k)] += mv[0] + mv[1];
      colm[AccQQ::col_slot(k)].x += mv[0];
      colm[AccQQ::col_slot(k)].y += mv[1];
      colg[AccQQ::col_slot(k)].x += gv[0];
      colg[AccQQ::col_slot(k)].y += gv[1];
    }
    E::template put_rows<kQ, kQ>(rowm, rowm_r);
    E::template put_cols<kQ, kQ>(colm, colm_r);
    E::template put_cols<kQ, kQ>(colg, colg_r);

    // ---- dx = W^T dy + f (b dS) + d dy; df = x . (b dS) -------------------
    {
      AccQP ax;
      E::zero(ax);
      E::template product<kQ, P, NP, false, false, false, true>(ax, bt, dst);
      put_row_sums<E, kQ, P>(
          [&](int k, int i, int j) {
            const float2 xv = E::get2(xt, i, j);
            return make_float2(xv.x * ax.pair(k)[0], xv.y * ax.pair(k)[1]);
          },
          df_r);
#pragma unroll
      for (int k = 0; k < AccQP::kPairs; ++k) {
        int i, j;
        if (AccQP::coord(k, i, j)) {
          ax.pair(k)[0] *= f_s[i];
          ax.pair(k)[1] *= f_s[i];
        }
      }
      __syncthreads();  // W is in its tile
      E::template product<kQ, P, kQ, true, false, true, false>(ax, wt, dyt);
      T* dxp = args.dx + ((bb * args.seq + l0) * H + h) * P;
      float dd = 0.0f;
#pragma unroll
      for (int k = 0; k < AccQP::kPairs; ++k) {
        int i, j;
        if (!AccQP::coord(k, i, j)) continue;
        const float2 yv = E::get2(dyt, i, j), xv = E::get2(xt, i, j);
        dd += yv.x * xv.x + yv.y * xv.y;
        if (i < rows)
          store_pair(dxp + static_cast<int64_t>(i) * H * P + j,
                     ax.pair(k)[0] + d_h * yv.x, ax.pair(k)[1] + d_h * yv.y);
      }
      dd = warp_sum(dd);
      if (lane == 0) dd_s[warp] = dd;
    }
    __syncthreads();  // W is read: dCB takes its place
#pragma unroll
    for (int k = 0; k < AccQQ::kPairs; ++k) {
      int i, j;
      if (AccQQ::coord(k, i, j))
        E::store2(wt, i, j, dw.pair(k)[0], dw.pair(k)[1]);
    }
    __syncthreads();

    // ---- db = dCB^T c + f (x dS^T) ----------------------------------------
    {
      AccQN u;
      E::zero(u);
      E::template product<kQ, NP, P, false, true, false, true>(u, xt, dst);
      if (!shared_bc) E::zero(db);
#pragma unroll
      for (int k = 0; k < AccQN::kPairs; ++k) {
        int i, j;
        if (AccQN::coord(k, i, j)) {
          db.pair(k)[0] = fmaf(f_s[i], u.pair(k)[0], db.pair(k)[0]);
          db.pair(k)[1] = fmaf(f_s[i], u.pair(k)[1], db.pair(k)[1]);
        }
      }
      E::template product<kQ, NP, kQ, true, false, true, false>(db, wt, ct);
    }
    if constexpr (!S::kTwoS) {  // S_in into dS's place
      __syncthreads();
      load_states<E, NP, P, false>(dst, sin_g, dst, nullptr, N);
      __syncthreads();
    }

    // ---- dc = dCB b + e (dy S_in^T); vin = c . (dy S_in^T) ---------------
    {
      AccQN u;
      E::zero(u);
      E::template product<kQ, NP, P, false, true, false, true>(u, dyt, sint);
      put_row_sums<E, kQ, NP>(
          [&](int k, int i, int j) {
            const float2 cv = E::get2(ct, i, j);
            return make_float2(cv.x * u.pair(k)[0], cv.y * u.pair(k)[1]);
          },
          vin_r);
      if (!shared_bc) E::zero(dc);
#pragma unroll
      for (int k = 0; k < AccQN::kPairs; ++k) {
        int i, j;
        if (AccQN::coord(k, i, j)) {
          dc.pair(k)[0] = fmaf(e_s[i], u.pair(k)[0], dc.pair(k)[0]);
          dc.pair(k)[1] = fmaf(e_s[i], u.pair(k)[1], dc.pair(k)[1]);
        }
      }
      E::template product<kQ, NP, kQ, false, false, true, false>(dc, wt, bt);
    }
    if (!shared_bc) {  // this head's db and dc out
      const int64_t row = static_cast<int64_t>(args.groups) * N;
      T* dbp = args.db + (bb * args.seq + l0) * row + h * N;
      T* dcp = args.dc + (bb * args.seq + l0) * row + h * N;
#pragma unroll
      for (int k = 0; k < AccQN::kPairs; ++k) {
        int i, j;
        if (AccQN::coord(k, i, j) && i < rows && j < N) {
          store_pair(dbp + i * row + j, db.pair(k)[0], db.pair(k)[1]);
          store_pair(dcp + i * row + j, dc.pair(k)[0], dc.pair(k)[1]);
        }
      }
    }

    // ---- d(cum), its reverse cumulative sum, ddt; da and dd: warp 0 -------
    __syncthreads();  // the sums' shares are in
    if (warp == 0) {
      float sin_ds = 0.0f, ddv = 0.0f;
      for (int w = 0; w < E::kW; ++w) {
        sin_ds += sds_s[w];
        ddv += dd_s[w];
      }
      // lane owns rows 2 lane and 2 lane + 1
      float dcum[2], df[2], colg[2], fdf = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        df[u] = E::template take_row<kQ, P>(df_r, i);
        colg[u] = E::template take_col<kQ, kQ>(colg_r, i);
        const float fd = f_s[i] * df[u];
        dcum[u] = E::template take_row<kQ, kQ>(rowm_r, i) -
                  E::template take_col<kQ, kQ>(colm_r, i) +
                  e_s[i] * E::template take_row<kQ, NP>(vin_r, i) - fd;
        fdf += fd;
      }
      fdf = warp_sum(fdf);
      if (lane == 31) dcum[1] += expf(total_s[0]) * sin_ds + fdf;
      // ds_t = sum_{i >= t} dcum_i: an inclusive scan from the top lane down
      const float pair = dcum[0] + dcum[1];
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += o;
      }
      const float above = incl - pair;  // rows past 2 lane + 1
      const float ds1 = above + dcum[1];
      const float ds0 = ds1 + dcum[0];
      float da = 0.0f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 2 * lane + u;
        const float ds = u ? ds1 : ds0;
        if (i < rows)
          args.ddt[(bb * args.seq + l0 + i) * H + h] =
              a_h * ds + g_s[i] * df[u] + colg[u];
        da += dt_s[i] * ds;
      }
      da = warp_sum(da);
      if (lane == 0) {
        const int64_t part = (bb * args.chunks + z) * H + h;
        args.part_a[part] = da;
        if (has_d) args.part_d[part] = ddv;
      }
    }
  }

  if (shared_bc) {  // the tile's sums of db and dc out
    const int64_t row = static_cast<int64_t>(args.tiles) * N;
    float* pb = args.part_b + (bb * args.seq + l0) * row + ht * N;
    float* pc = args.part_c + (bb * args.seq + l0) * row + ht * N;
#pragma unroll
    for (int k = 0; k < AccQN::kPairs; ++k) {
      int i, j;
      if (AccQN::coord(k, i, j) && i < rows && j < N) {
        store_pair(pb + i * row + j, db.pair(k)[0], db.pair(k)[1]);
        store_pair(pc + i * row + j, dc.pair(k)[0], dc.pair(k)[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (4) fixed-order sums of the partials
// ---------------------------------------------------------------------------
// db, dc [B, L, 1, N] = sum over the head tiles (G = 1)
template <typename T>
__global__ void ssd_bwd_reduce_bc_kernel(const float* __restrict__ part_b,
                                         const float* __restrict__ part_c,
                                         T* __restrict__ db,
                                         T* __restrict__ dc, int64_t rows,
                                         int tiles, int dim_n) {
  const int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (e >= rows * dim_n) return;  // rows = B L
  const int64_t row = e / dim_n;
  const int64_t base = row * tiles * dim_n + (e - row * dim_n);
  float sb = 0.0f, sc = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    sb += part_b[base + t * dim_n];
    sc += part_c[base + t * dim_n];
  }
  store_one(db + e, sb);
  store_one(dc + e, sc);
}

// da, dd [H] = sum over (batch, chunk)
__global__ void ssd_bwd_reduce_heads_kernel(const float* __restrict__ part_a,
                                            const float* __restrict__ part_d,
                                            float* __restrict__ da,
                                            float* __restrict__ dd,
                                            int64_t count, int heads) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= heads) return;
  float sa = 0.0f, sd = 0.0f;
  for (int64_t k = 0; k < count; ++k) {
    sa += part_a[k * heads + h];
    if (dd != nullptr) sd += part_d[k * heads + h];
  }
  da[h] = sa;
  if (dd != nullptr) dd[h] = sd;
}

template <typename T, int P, int N>
cudaError_t launch(const BwdArgs<T>& args, int64_t batch, float* da,
                   float* dd, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(args.tiles),
                  static_cast<unsigned>(args.chunks),
                  static_cast<unsigned>(batch));
  using ES = typename EngineOf<T, StatesCfg<T, P, N>::kW>::type;
  auto states = ssd_bwd_chunk_states_kernel<T, P, N>;
  const int states_bytes = StatesSmem<ES, P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      states, cudaFuncAttributeMaxDynamicSharedMemorySize, states_bytes);
  if (err != cudaSuccess) return err;
  states<<<grid, ES::kT, states_bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t np4 = static_cast<int64_t>(N) * P / 4;
  const int64_t count = batch * args.heads * np4;
  ssd_bwd_state_pass_kernel<<<
      static_cast<unsigned>((count + kPassThreads - 1) / kPassThreads),
      kPassThreads, 0, stream>>>(args.states, args.adj, args.totals, count,
                                 args.chunks, np4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  using EC = typename EngineOf<T, ChunkCfg<T, P, N>::kW>::type;
  auto chunk = ssd_bwd_chunk_kernel<T, P, N>;
  const int chunk_bytes = ChunkSmem<EC, P, N>::kBytes;
  err = cudaFuncSetAttribute(
      chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
  if (err != cudaSuccess) return err;
  chunk<<<grid, EC::kT, chunk_bytes, stream>>>(args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (args.groups == 1) {
    const int64_t bn = batch * args.seq * N;
    ssd_bwd_reduce_bc_kernel<T><<<static_cast<unsigned>((bn + 255) / 256),
                                  256, 0, stream>>>(
        args.part_b, args.part_c, args.db, args.dc, batch * args.seq,
        args.tiles, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_bwd_reduce_heads_kernel<<<(args.heads + 127) / 128, 128, 0, stream>>>(
      args.part_a, args.part_d, da, dd, batch * args.chunks, args.heads);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_n(const BwdArgs<T>& args, int64_t batch, int dim_n,
                     float* da, float* dd, cudaStream_t s) {
  if (dim_n == 8) return launch<T, P, 8>(args, batch, da, dd, s);
  if (dim_n == 16) return launch<T, P, 16>(args, batch, da, dd, s);
  return launch<T, P, 128>(args, batch, da, dd, s);
}

template <typename T>
cudaError_t launch_typed(const BwdArgs<T>& args, int64_t batch, int dim_p,
                         int dim_n, float* da, float* dd, cudaStream_t s) {
  switch (dim_p) {
    case 16: return launch_n<T, 16>(args, batch, dim_n, da, dd, s);
    case 32: return launch_n<T, 32>(args, batch, dim_n, da, dd, s);
    case 64: return launch_n<T, 64>(args, batch, dim_n, da, dd, s);
    default: return launch_n<T, 128>(args, batch, dim_n, da, dd, s);
  }
}

bool supported_p(int64_t p) {
  return p == 16 || p == 32 || p == 64 || p == 128;
}

bool supported_n(int64_t n) { return n == 8 || n == 16 || n == 128; }

// bf16 rows of a [batch, seq, heads, ·] tensor start on 16 bytes
bool rows_aligned16(const void* p, int64_t batch, int64_t seq, int64_t heads,
                    int64_t sb, int64_t sl, int64_t sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (batch == 1 || sb * 2 % 16 == 0) && (seq == 1 || sl * 2 % 16 == 0) &&
         (heads == 1 || sh * 2 % 16 == 0);
}

template <typename T>
int run(const void* x, const float* dt, const float* a, const void* b,
        const void* c, const float* d, const void* dy, void* dx, float* ddt,
        float* da, void* db, void* dc, float* dd, float* states, float* adj,
        float* totals, float* part_b, float* part_c, float* part_a,
        float* part_d, int64_t batch, int64_t seq, int64_t heads,
        int64_t groups, int64_t dim_p, int64_t dim_n, int64_t head_tile,
        Strides xs, Strides dts, int64_t a_stride, Strides bs, Strides cs,
        int64_t d_stride, Strides dys, cudaStream_t s) {
  const int64_t chunks = (seq + kQ - 1) / kQ;
  const BwdArgs<T> args{
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), d, static_cast<const T*>(dy),
      static_cast<T*>(dx), ddt, static_cast<T*>(db), static_cast<T*>(dc),
      states, adj, totals, part_b, part_c, part_a, part_d, seq, chunks,
      static_cast<int>(heads), static_cast<int>(groups),
      static_cast<int>(head_tile),
      static_cast<int>((heads + head_tile - 1) / head_tile), xs, dts, bs, cs,
      dys, a_stride, d_stride,
      rows_aligned16(dy, batch, seq, heads, dys.b, dys.l, dys.h)};
  return launch_typed(args, batch, static_cast<int>(dim_p),
                      static_cast<int>(dim_n), da, dd, s);
}

}  // namespace

extern "C" {

// x [batch, seq, heads, dim_p] and dy (0 f32, 1 bf16), dt [batch, seq,
// heads] f32, a [heads] f32, b and c [batch, seq, groups, dim_n] of x's
// type (groups 1 or heads; stride 0 along the group axis allowed), d
// [heads] f32 or null, all on the current device and read through the
// given element strides (batch, sequence, head; 1 along dim_p and dim_n);
// bf16 x, b and c need 16-byte base pointers and strides.  Writes dx
// [batch, seq, heads, dim_p] (x's type), ddt [batch, seq, heads] f32, da
// [heads] f32, db and dc [batch, seq, groups, dim_n] (x's type) and, where
// d is given, dd [heads] f32, all contiguous.  f32 workspaces the wrapper
// allocates (Z = ceil(seq / 64), tiles = ceil(heads / head_tile)): states
// and adj [batch, heads, Z, dim_n, dim_p], totals [batch, heads, Z],
// part_b and part_c [batch, seq, tiles, dim_n] (read only where groups is
// 1), part_a and part_d [batch, Z, heads].  Launches four kernels, five
// where groups is 1, on the stream; returns the first launch error (0 on
// success); it does not synchronise.
int repro_ssd_scan_bwd(const void* x, const float* dt, const float* a,
                       const void* b, const void* c, const float* d,
                       const void* dy, void* dx, float* ddt, float* da,
                       void* db, void* dc, float* dd, float* states,
                       float* adj, float* totals, float* part_b,
                       float* part_c, float* part_a, float* part_d,
                       int64_t batch, int64_t seq, int64_t heads,
                       int64_t groups, int64_t dim_p, int64_t dim_n,
                       int64_t head_tile, int64_t x_sb, int64_t x_sl,
                       int64_t x_sh, int64_t dt_sb, int64_t dt_sl,
                       int64_t dt_sh, int64_t a_stride, int64_t b_sb,
                       int64_t b_sl, int64_t b_sh, int64_t c_sb, int64_t c_sl,
                       int64_t c_sh, int64_t d_stride, int64_t dy_sb,
                       int64_t dy_sl, int64_t dy_sh, int dtype, void* stream) {
  const int64_t chunks = (seq + kQ - 1) / kQ;
  if (batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 ||
      chunks > 65535 || heads > 65535 || head_tile <= 0 ||
      (groups != 1 && groups != heads) || !supported_p(dim_p) ||
      !supported_n(dim_n) || (d == nullptr) != (dd == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides xs{x_sb, x_sl, x_sh}, dts{dt_sb, dt_sl, dt_sh},
      bs{b_sb, b_sl, b_sh}, cs{c_sb, c_sl, c_sh}, dys{dy_sb, dy_sl, dy_sh};
  if (dtype == kF32)
    return run<float>(x, dt, a, b, c, d, dy, dx, ddt, da, db, dc, dd, states,
                      adj, totals, part_b, part_c, part_a, part_d, batch, seq,
                      heads, groups, dim_p, dim_n, head_tile, xs, dts,
                      a_stride, bs, cs, d_stride, dys, s);
  if (dtype != kBF16) return cudaErrorInvalidValue;
  return run<__nv_bfloat16>(x, dt, a, b, c, d, dy, dx, ddt, da, db, dc, dd,
                            states, adj, totals, part_b, part_c, part_a,
                            part_d, batch, seq, heads, groups, dim_p, dim_n,
                            head_tile, xs, dts, a_stride, bs, cs, d_stride,
                            dys, s);
}

const char* repro_ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
