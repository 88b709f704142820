// Flash attention (online softmax), GQA-native, for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_pallas) together with its
// wrapper ops.py::flash_attention. For q (B, Hq, Sq, D) and k, v
// (B, Hkv, Skv, D), all contiguous and of one type (float32 or bfloat16):
//     o[b, h, i] = softmax_j(q[b, h, i] . k[b, h / (Hq/Hkv), j] * sm_scale) v[...]
// over the keys j < Skv that query i sees: every key, or with `causal`
// the keys j <= i + q_offset. The running max, the normalizer and the
// accumulator are float32, the normalizer is floored at 1e-30 as in the
// TPU kernel, and o takes q's type. The query head h reads KV head
// h / (Hq / Hkv) directly: no repeat is materialised. Key tiles strictly
// above the diagonal are never loaded, and query tiles are scheduled
// heaviest first under the causal mask.
//
// What bounds it: at the serving prefill shapes (B = 4, S = 1,819, causal;
// qwen3-1.7b Hq = 16, Hkv = 8, D = 128; zamba2-7b Hq = Hkv = 32, D = 112;
// minicpm3-4b's MLA latent, Hq = 40, Hkv = 1, D = 288; deepseek-v2-lite-16b's,
// Hq = 16, Hkv = 1, D = 576) the products of the visible (query, key) pairs
// are 54 / 95 / 305 / 244 GFLOP against 45 / 60 / 344 / 285 MB of q, k, v
// and o, so the bf16 tensor cores bound it: 0.055 / 0.096 / 0.309 / 0.247
// ms at 989 TFLOP/s, against 0.013 / 0.018 / 0.103 / 0.085 ms of memory
// traffic.
//
// The type picks the kernel; neither gives way to the other. Head dims up
// to 128 take flash_kernel_sm90 in bfloat16; D = 288 and D = 576 (MLA's
// latent: one KV head, the caller's sm_scale, and v = k when the caller
// passes k twice) take flash_kernel_sm90_wide and flash_kernel_sm90_split3,
// set out where they are defined.
//
// bfloat16, the serving path: flash_kernel_sm90. One CTA per (b * Hq + h,
// tile of 128 queries): two consumer warpgroups of 64 query rows each (the
// rows of one wgmma) and one producer warp. The producer loads the Q tile
// once, then keeps a ring of four stages of K and V tiles of 64 keys full
// by TMA: each stage lands on its own "full" mbarrier, and is refilled once
// all 256 consumer threads have arrived on its "empty" mbarrier. A
// consumer runs S = Q K^T as a chain of wgmma m64n64k16 with both operands
// in shared memory (K-major), the online softmax on S's accumulator
// fragment (each row's max and sum over the four lanes of a quad), rounds
// P to bfloat16 in registers, and accumulates O += P V in float32
// registers with P as the register A operand of wgmma m64nDPk16 (V
// MN-major in shared memory). Tile j's S is issued together with tile
// j - 1's P V, and tile j's softmax runs while the tensor cores work on
// that P V. CTAs take the heads in groups of 16, and inside a group the
// query tiles heaviest first: the K and V in flight stay in L2 (zamba2's
// 104 MB of K and V do not fit there) and the longest CTAs start first.
//   Where it could go wrong, and what the design does:
//   1. P in bfloat16. The TPU kernel keeps P in float32 for P.V; bf16
//      wgmma takes a bf16 A operand. The reference's chunked path rounds P
//      to the model type the same way (mha_chunked), and the normalizer
//      stays the sum of the float32 probabilities.
//   2. Head dims that do not fill 128-byte rows. Every shared-memory row
//      is padded to DP = 64 or 128 columns, in blocks of 64 (one 128-byte
//      swizzle span each), so one swizzle mode serves D = 16 ... 128. The
//      tensor maps span only D columns, so TMA fills the padding with
//      zeros without reading memory: Q.K^T stops at D (the zero columns
//      add nothing) and P.V runs at N = DP, the columns past D never
//      stored. D = 112 wastes 1/8 of P.V.
//   3. The ragged edges. The maps are 3-D over (B * H, S, D), so a tile
//      never reads the next head's rows: keys past Skv arrive as zeros and
//      are masked to -inf (a zero key would score 0 and take softmax
//      mass), query rows past Sq are computed and not stored. The causal
//      mask is applied only on tiles that cross the diagonal.
//   4. The swizzle and the descriptors agree by construction: TMA writes
//      CU_TENSOR_MAP_SWIZZLE_128B tiles at 1024-byte-aligned addresses and
//      the wgmma descriptors read layout type 128-byte swizzle (sm90.cuh).
//   5. The tensor map is a driver-API object; cuTensorMapEncodeTiled is
//      fetched through the runtime's driver entry point, so the library
//      links only the runtime. The maps are built per call on the host and
//      passed as __grid_constant__ parameters.
//   6. Registers. ptxas caps a CTA of 288 threads at 168 registers a
//      thread (one SM sub-partition holds three of its warps). With
//      128-key tiles the consumer needs ~196 (S 64, P 32 and O 64 floats
//      live at once), and ptxas serialized every wgmma for want of
//      registers (C7512), also with a producer warpgroup that raised the
//      consumers to 240 by setmaxnreg: CUDA 12.8's ptxas still allocated
//      168. 64-key tiles halve S and P and fit in 168 with no spill. A
//      CTA of two consumer warpgroups without a producer (256 threads,
//      128-key tiles, a CTA barrier before each refill) ran at about the
//      same speed.
//   What bounds it now: the tensor cores' work (Q.K^T and P.V) is on the
//   critical path and the softmax is hidden (PERF.md). Both products read
//   B from shared memory; by count, the 64-wide Q.K^T reads 4 KB of shared
//   memory per 32 tensor-core clocks, which is all of the SM's 128 bytes a
//   clock.
//   Registers per thread and spills: ptxas -v, printed by chip_smoke.py.
//
// float32: flash_kernel, the SIMT kernel. TF32 tensor cores keep about
// three decimal digits, which would put the float32 tolerance (2e-3) and
// the float32 decode-vs-prefill check (1e-3) in doubt, so float32 stays on
// the FMA units: one CTA of 128 threads per (b * Hq + h, tile of BQ
// queries), looping over tiles of 32 keys (16 at D = 288, 8 at 576) staged
// in shared memory. TPR threads (8; 4 at D = 16 and 112, 16 at 576) share
// one query row: each holds D/TPR
// of its dimensions (interleaved in 16-byte pieces, so the loads of one
// row hit distinct banks) for two query rows, scores 8 keys at a time,
// sums the partial dots with warp shuffles, and applies one online-softmax
// update per 8 keys. P stays float32 for P.V, as in the TPU kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "sm90.cuh"

namespace {

// --- float32: the SIMT kernel -------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRows = 2;        // query rows per thread
constexpr int kBlockK = 32;     // keys per shared-memory tile
constexpr int kChunk = 8;       // keys scored before one softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

template <int D>
struct Layout {
  // Threads per query row: the largest power of two up to 8 (16 above D =
  // 288, so a thread holds at most 36 of a row's dimensions) that divides
  // the row's D/4 16-byte pieces (4 at D = 16 and D = 112, 16 at 576, else
  // 8), so the partial dots of one row sum over aligned lanes by xor
  // shuffles.
  static constexpr int TPR_MAX = D > 288 ? 16 : 8;
  static constexpr int TPR = (D / 4) % TPR_MAX == 0 ? TPR_MAX
                             : (D / 4) % 8 == 0     ? 8
                             : (D / 4) % 4 == 0     ? 4
                             : (D / 4) % 2 == 0     ? 2
                                                    : 1;
  static constexpr int NV = D / (4 * TPR);              // 16-byte pieces per thread
  static constexpr int GROUPS = kThreads / TPR;         // row groups per CTA
  static constexpr int BQ = GROUPS * kRows;             // query rows per CTA
  // Keys per shared-memory tile: K and V tiles stay within the 48 KB of
  // static shared memory (36 KB at D = 288 and at D = 576).
  static constexpr int BK = D <= 128 ? kBlockK : D <= 288 ? kBlockK / 2 : kBlockK / 4;
  static_assert(D % (4 * TPR) == 0, "D must be a multiple of 16");
  static_assert(BK % kChunk == 0, "a key tile holds whole chunks");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int causal,
             int q_offset, float sm_scale) {
  using L = Layout<D>;
  constexpr int TPR = L::TPR, NV = L::NV, GROUPS = L::GROUPS, BQ = L::BQ, BK = L::BK;
  constexpr int DV = D / 4;     // 16-byte pieces per row

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int grp = tid / TPR;
  const int nq = gridDim.x;
  const int iq = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_lo = iq * BQ;

  const T* qbase = q + (size_t)bh * Sq * D;
  T* obase = o + (size_t)bh * Sq * D;
  const T* kbase = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vbase = v + ((size_t)b * Hkv + hk) * Skv * D;

  int row[kRows];
  float qr[kRows][NV * 4];
  float acc[kRows][NV * 4];
  float m[kRows], l[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    row[j] = q_lo + j * GROUPS + grp;
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int d0 = (c * TPR + part) * 4;
      const float4 x = row[j] < Sq ? load4(qbase + (size_t)row[j] * D + d0)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[j][c * 4 + 0] = x.x; qr[j][c * 4 + 1] = x.y;
      qr[j][c * 4 + 2] = x.z; qr[j][c * 4 + 3] = x.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][c * 4 + e] = 0.f;
    }
  }

  // Keys past kv_end are above the diagonal for every query of the tile.
  int kv_end = Skv;
  if (causal) kv_end = min(Skv, q_lo + BQ + q_offset);

  for (int kt = 0; kt < kv_end; kt += BK) {
    __syncthreads();                         // the previous tile is consumed
    for (int idx = tid; idx < BK * DV; idx += kThreads) {
      const int r = idx / DV, d0 = (idx % DV) * 4;
      const int key = kt + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key < Skv) {
        kx = load4(kbase + (size_t)key * D + d0);
        vx = load4(vbase + (size_t)key * D + d0);
      }
      *reinterpret_cast<float4*>(&ks[r][d0]) = kx;
      *reinterpret_cast<float4*>(&vs[r][d0]) = vx;
    }
    __syncthreads();
    const int n_keys = min(BK, kv_end - kt);

    for (int kc = 0; kc < n_keys; kc += kChunk) {
      float s[kRows][kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[j][jj] = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 kx = *reinterpret_cast<const float4*>(&ks[kc + jj][(c * TPR + part) * 4]);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            s[j][jj] = fmaf(qr[j][c * 4 + 0], kx.x, s[j][jj]);
            s[j][jj] = fmaf(qr[j][c * 4 + 1], kx.y, s[j][jj]);
            s[j][jj] = fmaf(qr[j][c * 4 + 2], kx.z, s[j][jj]);
            s[j][jj] = fmaf(qr[j][c * 4 + 3], kx.w, s[j][jj]);
          }
        }
      }
      // Sum the partial dot products over the TPR lanes of each row.
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj)
            s[j][jj] += __shfl_xor_sync(0xffffffffu, s[j][jj], off);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int last = causal ? row[j] + q_offset : Skv - 1;   // last key this row sees
        float m_new = m[j];
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int key = kt + kc + jj;
          s[j][jj] *= sm_scale;
          if (key < Skv && key <= last) m_new = fmaxf(m_new, s[j][jj]);
        }
        const float corr = __expf(m[j] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int key = kt + kc + jj;
          const float p = (key < Skv && key <= last) ? __expf(s[j][jj] - m_new) : 0.f;
          s[j][jj] = p;
          psum += p;
        }
        l[j] = l[j] * corr + psum;
        m[j] = m_new;
#pragma unroll
        for (int e = 0; e < NV * 4; ++e) acc[j][e] *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 vx = *reinterpret_cast<const float4*>(&vs[kc + jj][(c * TPR + part) * 4]);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            acc[j][c * 4 + 0] = fmaf(s[j][jj], vx.x, acc[j][c * 4 + 0]);
            acc[j][c * 4 + 1] = fmaf(s[j][jj], vx.y, acc[j][c * 4 + 1]);
            acc[j][c * 4 + 2] = fmaf(s[j][jj], vx.z, acc[j][c * 4 + 2]);
            acc[j][c * 4 + 3] = fmaf(s[j][jj], vx.w, acc[j][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (row[j] >= Sq) continue;
    const float denom = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int d0 = (c * TPR + part) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(obase + (size_t)row[j] * D + d0 + e, acc[j][c * 4 + e] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                         int Hq, int Hkv, int Sq, int Skv, int causal, int q_offset,
                         float sm_scale, cudaStream_t stream) {
  const int nq = (Sq + Layout<D>::BQ - 1) / Layout<D>::BQ;
  const dim3 grid(nq, B * Hq);
  flash_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* o, int B,
                       int Hq, int Hkv, int Sq, int Skv, int causal, int q_offset,
                       float sm_scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 32: return launch_typed<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 64: return launch_typed<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 96: return launch_typed<T, 96>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 112: return launch_typed<T, 112>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 128: return launch_typed<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 288: return launch_typed<T, 288>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 576: return launch_typed<T, 576>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --- bfloat16: wgmma tiles fed by a TMA ring ------------------------------------

constexpr int kBQ = 128;              // query rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 64;               // keys per K/V tile: S is one wgmma m64n64 chain
constexpr int kSN = kBK / 2;          // S accumulators per thread (m64 x kBK)
constexpr int kConsumers = 256;       // the two consumer warpgroups
constexpr int kThreadsSm90 = kConsumers + 32;   // and one producer warp
// A 128-byte-swizzled block: 64 bf16 columns of a tile's rows.
constexpr uint32_t kQBlockBytes = kBQ * 128, kKVBlockBytes = kBK * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHeadGroup = 16;        // heads whose CTAs are scheduled together

template <int D>
struct Sm90Tile {
  static constexpr int DP = D <= 64 ? 64 : 128;           // padded head dim
  static constexpr int kBlocks = DP / 64;                 // 128-byte swizzle blocks per row
  static constexpr int kStages = 4;                       // K/V tiles in the ring
  static constexpr uint32_t kQBytes = kBlocks * kQBlockBytes;
  static constexpr uint32_t kKVBytes = kBlocks * kKVBlockBytes;   // K or V of one stage
  // 1 KB of slack to align the tiles to 1,024 bytes, the tiles, the barriers
  // (Q's, and a full and an empty one per stage).
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKVBytes + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Issue S = Q K^T for one warpgroup's 64 query rows and kBK keys (k16
// steps up to D: the zero columns past D are skipped). Q and K are
// K-major; a k16 step moves 32 bytes inside a 128-byte row, four steps a
// 64-column block (QBLK bytes apart in the Q tile).
template <int D, uint32_t QBLK = kQBlockBytes>
__device__ __forceinline__ void issue_qk(float (&sc)[kSN], uint32_t q_rows, uint32_t k_s) {
  sm90::fence_operands(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t dq = sm90::desc_sw128(q_rows + (kk / 4) * QBLK + (kk % 4) * 32, 16, 1024);
    const uint64_t dk = sm90::desc_sw128(k_s + (kk / 4) * kKVBlockBytes + (kk % 4) * 32, 16, 1024);
    sm90::wgmma_m64n64k16_ss(sc, dq, dk, kk > 0);
  }
  sm90::wgmma_commit();
  sm90::fence_operands(sc);
}

// Issue O += P V: P (64 x kBK keys) from registers, V (keys, DP) MN-major,
// 16 keys (2,048 bytes) per k16 step.
template <int NO>
__device__ __forceinline__ void issue_pv(float (&acc)[NO], uint32_t (&pa)[kBK / 16][4],
                                         uint32_t v_s) {
  sm90::fence_operands(acc);
  sm90::fence_operands(pa);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = sm90::desc_sw128(v_s + kk * 16 * 128, kKVBlockBytes, 1024);
    if constexpr (NO == 64) sm90::wgmma_m64n128k16_rs(acc, pa[kk], dv, 1);
    else sm90::wgmma_m64n64k16_rs(acc, pa[kk], dv, 1);
  }
  sm90::wgmma_commit();
  sm90::fence_operands(acc);
  sm90::fence_operands(pa);
}

// Tile kt's online-softmax step on the S fragment: mask the keys past Skv
// and, causally, past each row's diagonal (only on tiles that reach them);
// fold the tile's row max into m (in units of log2), rescale l, and turn
// sc into probabilities. corr[r] is the factor for row r's accumulator.
// Each row lives in the 4 lanes of a quad: 2 columns each per 8.
struct SoftmaxTile {
  int Skv, causal, q_offset, q_lo, r0, c0;
  float scale_log2;

  __device__ __forceinline__ void operator()(float (&sc)[kSN], int kt, float (&m)[2],
                                             float (&l)[2], float (&corr)[2]) const {
    if (kt + kBK > Skv || (causal && kt + kBK - 1 > q_lo + q_offset)) {
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt + 8 * i + c0 + (e & 1);
          if (key >= Skv || (causal && key > r0 + 8 * (e >> 1) + q_offset))
            sc[4 * i + e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kSN; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      corr[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kSN; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
      l[r] += sc[i];
    }
  }
};

// P in bf16: the accumulator layout of keys 16 kk .. 16 kk + 15 is the A
// fragment of k16 step kk.
__device__ __forceinline__ void to_bf16(const float (&sc)[kSN], uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// CTA L's head row bh and query tile iq. The heads go in groups of
// kHeadGroup and, inside a group, the query tiles heaviest first under the
// causal mask: the CTAs in flight read the K and V of a few heads (they
// stay in L2) and the longest run first.
__device__ __forceinline__ void cta_tile(int L, int BH, int nq, int causal, int& bh, int& iq) {
  const int first = L / (kHeadGroup * nq) * kHeadGroup;
  const int g = min(kHeadGroup, BH - first);
  const int r = L - first * nq;
  bh = first + r % g;
  iq = causal ? nq - 1 - r / g : r / g;
}

template <int D>
__global__ void __launch_bounds__(kThreadsSm90, 1)
flash_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  int Hq, int Hkv, int Sq, int Skv, int nq, int causal, int q_offset,
                  float scale_log2) {
  using T = Sm90Tile<D>;
  constexpr int STAGES = T::kStages;
  constexpr int NO = T::DP / 2;         // O accumulators per thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_kv = s_q + T::kQBytes;       // stage s: K, then V
  const uint32_t bar_q = s_kv + STAGES * 2 * T::kKVBytes;
  const uint32_t bar_full = bar_q + 8;          // per stage: its K and V have landed
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // per stage: both consumers are done with it
  auto k_tile = [&](int j) { return s_kv + (j % STAGES) * 2 * T::kKVBytes; };
  auto full = [&](int j) { return bar_full + 8 * (j % STAGES); };
  auto empty = [&](int j) { return bar_empty + 8 * (j % STAGES); };

  const int tid = threadIdx.x;
  int bh, iq;
  cta_tile(blockIdx.x, (int)gridDim.x / nq, nq, causal, bh, iq);
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_lo = iq * kBQ;
  // Keys past kv_end are above the diagonal for every query of the tile.
  const int kv_end = causal ? min(Skv, q_lo + kBQ + q_offset) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warp: one thread loads Q, then keeps the ring of K/V
    // tiles full, refilling a stage once both consumers have released it.
    if (tid == kConsumers) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int blk = 0; blk < T::kBlocks; ++blk)
        sm90::tma_load_3d(s_q + blk * kQBlockBytes, &tq, bar_q, blk * 64, q_lo, bh);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= STAGES) sm90::mbar_wait(empty(j), (j / STAGES - 1) & 1);
        const uint32_t dk = k_tile(j), dv = dk + T::kKVBytes;
        sm90::mbar_expect_tx(full(j), 2 * T::kKVBytes);
#pragma unroll
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          sm90::tma_load_3d(dk + blk * kKVBlockBytes, &tk, full(j), blk * 64, j * kBK, bkv);
          sm90::tma_load_3d(dv + blk * kKVBlockBytes, &tv, full(j), blk * 64, j * kBK, bkv);
        }
      }
    }
  } else {
    // The consumer warpgroups, 64 query rows each. This thread's rows of the
    // accumulators: r0 and r0 + 8; its columns in each group of 8: c0, c0 + 1.
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = q_lo + 64 * wg + 16 * warp + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t q_rows = s_q + wg * 64 * 128;  // this warpgroup's rows of each Q block
    const SoftmaxTile softmax{Skv, causal, q_offset, q_lo, r0, c0, scale_log2};
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {-1e30f, -1e30f};  // running max of s * scale * log2(e)
    float l[2] = {0.f, 0.f};        // this thread's share of the normalizer
    float corr[2];
    float sc[kSN];                  // S of the current tile, then its probabilities
    uint32_t pa[kBK / 16][4];       // P of the tile before, bf16: P.V's A operand

    sm90::mbar_wait(bar_q, 0);
    sm90::mbar_wait(full(0), 0);
    issue_qk<D>(sc, q_rows, k_tile(0));
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    softmax(sc, 0, m, l, corr);
    to_bf16(sc, pa);
    // Tile j: issue S_j = Q K_j^T, then O += P_{j-1} V_{j-1}, and run tile
    // j's softmax while the tensor cores work on P_{j-1} V_{j-1}.
    for (int j = 1; j < n_tiles; ++j) {
      sm90::mbar_wait(full(j), (j / STAGES) & 1);
      issue_qk<D>(sc, q_rows, k_tile(j));
      issue_pv(acc, pa, k_tile(j - 1) + T::kKVBytes);
      sm90::wgmma_wait<1>();
      sm90::fence_operands(sc);
      softmax(sc, j * kBK, m, l, corr);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::mbar_arrive(empty(j - 1));
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
      to_bf16(sc, pa);
    }
    issue_pv(acc, pa, k_tile(n_tiles - 1) + T::kKVBytes);
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

    // o = acc / max(l, 1e-30), the rows below Sq and the columns below D.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* obase = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      if (8 * i >= D) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)row * D + 8 * i + c0) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv[r], acc[4 * i + 2 * r + 1] * inv[r]);
      }
    }
  }
}

// --- bfloat16 at head dims above 128: O's columns split across the warpgroups --

// MLA's latent attention (D = 288, one KV head). A 64-row O accumulator of
// 320 padded columns is 160 floats a thread, above what a 288-thread CTA
// may hold beside S and P (168 registers), and a 128-row Q tile with a
// K/V ring does not fit in shared memory. So a CTA takes 64 query rows,
// and its two consumer warpgroups split O's columns: warpgroup 0 forms S
// = Q K^T and the online softmax, keeps P in registers for its own O
// columns [0, 128) and publishes P (bf16) and the rows' rescale factors
// through shared memory; warpgroup 1 accumulates columns [128, 320) from
// that P, by wgmma with both operands in shared memory. P goes through
// two buffers, handed over by mbarriers (ready: warpgroup 0's 128 threads
// arrive, warpgroup 1 waits; freed: the other way round; a lost handover
// traps instead of hanging), so warpgroup 0's S of tile j + 1 runs while
// warpgroup 1's P V of tile j does. The Q tile is 40 KB; the ring 160 KB,
// as four stages of K when v is k (MLA passes its latent [c_kv | k_rope]
// as both) or two of K and V. The tiles are padded to 320 columns, TMA
// zero-filling past D, so P V runs 320 columns of which 288 are stored.
// Its time against its bound: PERF.md.
constexpr int kBQW = 64;                          // query rows per CTA
constexpr uint32_t kQWBlockBytes = kBQW * 128;    // one 64-column block of the Q tile
constexpr int kSplitN = 128;                      // warpgroup 0's O columns
constexpr int kWarpgroup = 128;

template <int D, bool SAME_KV>
struct WideTile {
  static constexpr int DP = (D + 63) / 64 * 64;             // padded head dim
  static constexpr int kBlocks = DP / 64;
  static constexpr int N1 = DP - kSplitN;                    // warpgroup 1's O columns
  static_assert(N1 == 192, "warpgroup 1 runs wgmma m64n192: 256 < D <= 320");
  static constexpr uint32_t kQBytes = kBlocks * kQWBlockBytes;
  static constexpr uint32_t kTileBytes = kBlocks * kKVBlockBytes;   // one K or V tile
  // When v is k one tile feeds both products: four stages of K; else two
  // stages of K and V. Either way 160 KB of ring.
  static constexpr int kStages = SAME_KV ? 4 : 2;
  static constexpr uint32_t kStageBytes = (SAME_KV ? 1 : 2) * kTileBytes;
  static constexpr uint32_t kPBytes = kBQW * kBK * 2;        // P of one tile, bf16
  // 1 KB of alignment slack, Q, the ring, two P tiles, two rows of rescale
  // factors and the rows' 1 / l, the barriers (Q's, a full and an empty
  // one per stage, a ready and a freed one per P tile, the final 1 / l's).
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 2 * kPBytes
                               + 3 * kBQW * 4 + 8 * (1 + 2 * kStages + 5);
};

// Issue O += P V for warpgroup 1: P (64 x kBK keys) K-major in shared
// memory (128-byte swizzled rows of 64 keys), V's columns [128, 320)
// MN-major, 16 keys per k16 step.
__device__ __forceinline__ void issue_pv_ss(float (&acc)[96], uint32_t p_s, uint32_t v_s) {
  sm90::fence_operands(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dp = sm90::desc_sw128(p_s + kk * 32, 16, 1024);
    const uint64_t dv = sm90::desc_sw128(v_s + kk * 16 * 128, kKVBlockBytes, 1024);
    sm90::wgmma_m64n192k16_ss(acc, dp, dv, 1);
  }
  sm90::wgmma_commit();
  sm90::fence_operands(acc);
}

template <int D, bool SAME_KV>
__global__ void __launch_bounds__(kThreadsSm90, 1)
flash_kernel_sm90_wide(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       int Hq, int Hkv, int Sq, int Skv, int nq, int causal, int q_offset,
                       float scale_log2) {
  using T = WideTile<D, SAME_KV>;
  constexpr int STAGES = T::kStages;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_kv = s_q + T::kQBytes;                  // stage s: K (then V)
  const uint32_t s_p = s_kv + STAGES * T::kStageBytes;     // P of tiles j % 2
  const uint32_t s_f = s_p + 2 * T::kPBytes;               // rescale[2][64], 1 / l[64]
  const uint32_t bar_q = s_f + 3 * kBQW * 4;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_ready = bar_empty + 8 * STAGES;   // per P tile: published
  const uint32_t bar_freed = bar_ready + 16;           // per P tile: read by warpgroup 1
  const uint32_t bar_final = bar_freed + 16;           // the rows' 1 / l are out
  uint8_t* const p_gen = smem_raw + (s_p - raw);
  float* const f_gen = reinterpret_cast<float*>(smem_raw + (s_f - raw));
  auto k_tile = [&](int j) { return s_kv + (j % STAGES) * T::kStageBytes; };
  auto v_tile = [&](int j) { return k_tile(j) + (SAME_KV ? 0 : T::kTileBytes); };
  auto full = [&](int j) { return bar_full + 8 * (j % STAGES); };
  auto empty = [&](int j) { return bar_empty + 8 * (j % STAGES); };

  const int tid = threadIdx.x;
  int bh, iq;
  cta_tile(blockIdx.x, (int)gridDim.x / nq, nq, causal, bh, iq);
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_lo = iq * kBQW;
  const int kv_end = causal ? min(Skv, q_lo + kBQW + q_offset) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(bar_full + 8 * s, 1);
      sm90::mbar_init(bar_empty + 8 * s, kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(bar_ready + 8 * i, kWarpgroup);
      sm90::mbar_init(bar_freed + 8 * i, kWarpgroup);
    }
    sm90::mbar_init(bar_final, kWarpgroup);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      if (!SAME_KV) sm90::tma_prefetch_map(&tv);
      sm90::mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int blk = 0; blk < T::kBlocks; ++blk)
        sm90::tma_load_3d(s_q + blk * kQWBlockBytes, &tq, bar_q, blk * 64, q_lo, bh);
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= STAGES) sm90::mbar_wait(empty(j), (j / STAGES - 1) & 1);
        sm90::mbar_expect_tx(full(j), T::kStageBytes);
#pragma unroll
        for (int blk = 0; blk < T::kBlocks; ++blk) {
          sm90::tma_load_3d(k_tile(j) + blk * kKVBlockBytes, &tk, full(j), blk * 64, j * kBK, bkv);
          if (!SAME_KV)
            sm90::tma_load_3d(v_tile(j) + blk * kKVBlockBytes, &tv, full(j), blk * 64, j * kBK,
                              bkv);
        }
      }
    }
    return;
  }

  // Both consumer warpgroups hold the same rows of the accumulators: this
  // thread's r and r + 8 of the tile, columns c0, c0 + 1 of each group of 8.
  // P tile j % 2 carries tile j: its handovers complete phase j / 2.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  __nv_bfloat16* const obase = o + (size_t)bh * Sq * D;
  float* const rescale = f_gen;               // [2][kBQW]
  float* const inv_l = f_gen + 2 * kBQW;      // [kBQW]

  if (wg == 0) {
    const SoftmaxTile softmax{Skv, causal, q_offset, q_lo, q_lo + r, c0, scale_log2};
    float acc[kSplitN / 2];
#pragma unroll
    for (int i = 0; i < kSplitN / 2; ++i) acc[i] = 0.f;
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    float corr[2];
    float sc[kSN];
    uint32_t pa[kBK / 16][4];

    // Hand tile j's P and rescale factors to warpgroup 1. A fragment
    // pa[kk][x] holds row r + 8 (x & 1), keys 16 kk + 8 (x >> 1) + c0, + 1;
    // the P tile is stored as TMA would store it (128-byte swizzle).
    auto publish = [&](int j) {
      uint8_t* const pt = p_gen + (j % 2) * T::kPBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = r + 8 * (x & 1);
          const int chunk = (2 * kk + (x >> 1)) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(pt + row * 128 + chunk * 16 + c0 * 2) = pa[kk][x];
        }
      if (lane % 4 == 0) {
        rescale[(j % 2) * kBQW + r] = corr[0];
        rescale[(j % 2) * kBQW + r + 8] = corr[1];
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar_ready + 8 * (j % 2));
    };

    sm90::mbar_wait(bar_q, 0);
    sm90::mbar_wait(full(0), 0);
    issue_qk<D, kQWBlockBytes>(sc, s_q, k_tile(0));
    sm90::wgmma_wait<0>();
    sm90::fence_operands(sc);
    softmax(sc, 0, m, l, corr);
    to_bf16(sc, pa);
    publish(0);
    for (int j = 1; j < n_tiles; ++j) {
      sm90::mbar_wait(full(j), (j / STAGES) & 1);
      issue_qk<D, kQWBlockBytes>(sc, s_q, k_tile(j));
      issue_pv(acc, pa, v_tile(j - 1));
      sm90::wgmma_wait<1>();
      sm90::fence_operands(sc);
      softmax(sc, j * kBK, m, l, corr);
      sm90::wgmma_wait<0>();
      sm90::fence_operands(acc);
      sm90::mbar_arrive(empty(j - 1));
#pragma unroll
      for (int i = 0; i < kSplitN / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      to_bf16(sc, pa);
      if (j >= 2) sm90::mbar_wait(bar_freed + 8 * (j % 2), ((j - 2) / 2) & 1);  // tile j - 2's P is read
      publish(j);
    }
    issue_pv(acc, pa, v_tile(n_tiles - 1));
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    sm90::mbar_arrive(empty(n_tiles - 1));

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.f / fmaxf(l[i], 1e-30f);
    }
    if (lane % 4 == 0) {
      inv_l[r] = inv[0];
      inv_l[r + 8] = inv[1];
    }
    sm90::mbar_arrive(bar_final);
#pragma unroll
    for (int i = 0; i < kSplitN / 8; ++i) {
      if (8 * i >= D) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q_lo + r + 8 * e;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)row * D + 8 * i + c0) =
              __floats2bfloat162_rn(acc[4 * i + 2 * e] * inv[e], acc[4 * i + 2 * e + 1] * inv[e]);
      }
    }
  } else {
    float acc[T::N1 / 2];
#pragma unroll
    for (int i = 0; i < T::N1 / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      sm90::mbar_wait(bar_ready + 8 * (j % 2), (j / 2) & 1);   // P_j and its rescale are out
      sm90::mbar_wait(full(j), (j / STAGES) & 1);
      const float f0 = rescale[(j % 2) * kBQW + r], f1 = rescale[(j % 2) * kBQW + r + 8];
      sm90::wgmma_wait<0>();                 // tile j - 1's P V (none before tile 0)
      sm90::fence_operands(acc);
      if (j > 0) {
        sm90::mbar_arrive(bar_freed + 8 * ((j - 1) % 2));
        sm90::mbar_arrive(empty(j - 1));
      }
#pragma unroll
      for (int i = 0; i < T::N1 / 2; ++i) acc[i] *= ((i >> 1) & 1) ? f1 : f0;
      issue_pv_ss(acc, s_p + (j % 2) * T::kPBytes, v_tile(j) + (kSplitN / 64) * kKVBlockBytes);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    sm90::mbar_arrive(empty(n_tiles - 1));

    sm90::mbar_wait(bar_final, 0);
    const float inv[2] = {inv_l[r], inv_l[r + 8]};
#pragma unroll
    for (int i = 0; i < T::N1 / 8; ++i) {
      const int col = kSplitN + 8 * i;
      if (col >= D) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q_lo + r + 8 * e;
        if (row < Sq)
          *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)row * D + col + c0) =
              __floats2bfloat162_rn(acc[4 * i + 2 * e] * inv[e], acc[4 * i + 2 * e + 1] * inv[e]);
      }
    }
  }
}

// --- bfloat16 at head dim 576: O's columns split across three warpgroups -------

// deepseek-v2-lite-16b's latent attention (D = 576: kv_lora_rank 512 +
// qk_rope_dim 64, one KV head). A 64-row Q tile and a 64-key K tile are 72
// KB each, so Q and a ring of two K stages (v = k) or one K + V stage take
// 216 KB of the 227; one P tile of 8 KB fits beside them, two do not. A
// 64-row O of 576 columns is 288 f32 registers a thread for one warpgroup:
// it is split across three, 192 columns (96 registers) each. A producer
// warp beside 384 consumer threads would put four warps on an SM
// sub-partition and cap every thread at 128 registers; without it three
// warps share one, and ptxas may give 168. So the CTA is the three
// consumer warpgroups alone, and one thread of warpgroup 0 issues the TMA
// loads. Warpgroup 0 forms S = Q K^T (wgmma m64n64k16, both operands in
// shared memory) and the online softmax, and publishes P (bf16, stored as
// TMA would store it) and the rows' rescale factors; every warpgroup then
// rescales its O columns and accumulates them by wgmma m64n192k16 with P
// and V in shared memory. One mbarrier says P_j is out (warpgroup 0's 128
// threads arrive), one that every warpgroup is done with P_j and with tile
// j's stage (all 384 arrive; it also frees the stage for the next load).
// Warpgroup 0's S of tile j + 1 runs while the others' P V of tile j does;
// with v apart (one stage) the next tile loads only after P V. Its time
// against its bound: PERF.md.
constexpr int kSplit3N = 192;                      // O columns per warpgroup
constexpr int kSplit3Threads = 3 * kWarpgroup;     // three consumer warpgroups

template <int D, bool SAME_KV>
struct Split3Tile {
  static_assert(D == 3 * kSplit3N, "three warpgroups of 192 columns");
  static constexpr int kBlocks = D / 64;
  static constexpr uint32_t kQBytes = kBlocks * kQWBlockBytes;
  static constexpr uint32_t kTileBytes = kBlocks * kKVBlockBytes;   // one K or V tile
  static constexpr int kStages = SAME_KV ? 2 : 1;
  static constexpr uint32_t kStageBytes = (SAME_KV ? 1 : 2) * kTileBytes;
  static constexpr uint32_t kPBytes = kBQW * kBK * 2;        // P of one tile, bf16
  // 1 KB of alignment slack, Q, the ring, the P tile, the rows' rescale
  // factors and 1 / l, the barriers (Q's, a full one per stage, ready,
  // freed, final).
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + kPBytes
                               + 2 * kBQW * 4 + 8 * (1 + kStages + 3);
  static_assert(kSmem <= 232448, "above the 227 KB a block may use");
};

template <int D, bool SAME_KV>
__global__ void __launch_bounds__(kSplit3Threads, 1)
flash_kernel_sm90_split3(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                         int Hq, int Hkv, int Sq, int Skv, int nq, int causal, int q_offset,
                         float scale_log2) {
  using T = Split3Tile<D, SAME_KV>;
  constexpr int STAGES = T::kStages;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_kv = s_q + T::kQBytes;                  // stage s: K (then V)
  const uint32_t s_p = s_kv + STAGES * T::kStageBytes;     // P of the current tile
  const uint32_t s_f = s_p + T::kPBytes;                   // rescale[64], 1 / l[64]
  const uint32_t bar_q = s_f + 2 * kBQW * 4;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_ready = bar_full + 8 * STAGES;        // P_j and its rescale are out
  const uint32_t bar_freed = bar_ready + 8;                // P_j and tile j's stage are read
  const uint32_t bar_final = bar_freed + 8;                // the rows' 1 / l are out
  uint8_t* const p_gen = smem_raw + (s_p - raw);
  float* const rescale = reinterpret_cast<float*>(smem_raw + (s_f - raw));
  float* const inv_l = rescale + kBQW;
  auto k_tile = [&](int j) { return s_kv + (j % STAGES) * T::kStageBytes; };
  auto v_tile = [&](int j) { return k_tile(j) + (SAME_KV ? 0 : T::kTileBytes); };
  auto full = [&](int j) { return bar_full + 8 * (j % STAGES); };

  const int tid = threadIdx.x;
  int bh, iq;
  cta_tile(blockIdx.x, (int)gridDim.x / nq, nq, causal, bh, iq);
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_lo = iq * kBQW;
  const int kv_end = causal ? min(Skv, q_lo + kBQW + q_offset) : Skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  // Tile j (K, and V when apart) into its stage, landing on full(j).
  auto load = [&](int j) {
    sm90::mbar_expect_tx(full(j), T::kStageBytes);
#pragma unroll
    for (int blk = 0; blk < T::kBlocks; ++blk) {
      sm90::tma_load_3d(k_tile(j) + blk * kKVBlockBytes, &tk, full(j), blk * 64, j * kBK, bkv);
      if (!SAME_KV)
        sm90::tma_load_3d(v_tile(j) + blk * kKVBlockBytes, &tv, full(j), blk * 64, j * kBK, bkv);
    }
  };

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) sm90::mbar_init(bar_full + 8 * s, 1);
    sm90::mbar_init(bar_ready, kWarpgroup);
    sm90::mbar_init(bar_freed, kSplit3Threads);
    sm90::mbar_init(bar_final, kWarpgroup);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::tma_prefetch_map(&tq);
    sm90::tma_prefetch_map(&tk);
    if (!SAME_KV) sm90::tma_prefetch_map(&tv);
    sm90::mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
    for (int blk = 0; blk < T::kBlocks; ++blk)
      sm90::tma_load_3d(s_q + blk * kQWBlockBytes, &tq, bar_q, blk * 64, q_lo, bh);
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load(j);
  }

  // Every warpgroup holds the same rows of the accumulators: this thread's
  // r and r + 8 of the tile, columns c0, c0 + 1 of each group of 8. The
  // ready and freed barriers complete phase j for tile j.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int col0 = kSplit3N * wg;             // this warpgroup's O columns
  float acc[kSplit3N / 2];
#pragma unroll
  for (int i = 0; i < kSplit3N / 2; ++i) acc[i] = 0.f;
  float inv0, inv1;                           // the rows' 1 / l

  if (wg == 0) {
    const SoftmaxTile softmax{Skv, causal, q_offset, q_lo, q_lo + r, c0, scale_log2};
    float m[2] = {-1e30f, -1e30f};
    float l[2] = {0.f, 0.f};
    float corr[2];
    float sc[kSN];

    // P_j in bf16 into the P tile, stored as TMA would store it (128-byte
    // swizzle): sc[8 kk + 2 x], + 1 hold row r + 8 (x & 1), keys 16 kk +
    // 8 (x >> 1) + c0, + 1. Then the rows' rescale factors; then arrive.
    auto publish = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = r + 8 * (x & 1);
          const int chunk = (2 * kk + (x >> 1)) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(p_gen + row * 128 + chunk * 16 + c0 * 2) =
              pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
        }
      if (lane % 4 == 0) {
        rescale[r] = corr[0];
        rescale[r + 8] = corr[1];
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(bar_ready);
    };
    // Once every warpgroup is done with tile j - 1 (its P and its stage),
    // refill that stage with tile j - 1 + STAGES (tile j when one stage).
    auto refill = [&](int j) {
      sm90::mbar_wait(bar_freed, (j - 1) & 1);
      if (tid == 0 && j - 1 + STAGES < n_tiles) load(j - 1 + STAGES);
    };

    // Tile j: S_j (behind P_{j-1} V_{j-1} on the tensor cores), the softmax,
    // P_j out once every warpgroup is done with P_{j-1}, then P_j V_j. ptxas
    // serializes this warpgroup's wgmma (remark C7515); issuing S_j with no
    // product in flight removes the remark but ran 8% slower (PERF.md).
    sm90::mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      if constexpr (STAGES == 1) {     // tile j loads where tile j - 1 was
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc);
        if (j > 0) {
          sm90::mbar_arrive(bar_freed);
          refill(j);
        }
      }
      sm90::mbar_wait(full(j), (j / STAGES) & 1);
      issue_qk<D, kQWBlockBytes>(sc, s_q, k_tile(j));
      sm90::wgmma_wait<0>();           // S_j, and P_{j-1} V_{j-1}
      sm90::fence_operands(sc);
      sm90::fence_operands(acc);
      if (STAGES > 1 && j > 0) sm90::mbar_arrive(bar_freed);
      softmax(sc, j * kBK, m, l, corr);
      if (STAGES > 1 && j > 0) refill(j);
      publish();
      sm90::mbar_wait(bar_ready, j & 1);
#pragma unroll
      for (int i = 0; i < kSplit3N / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      issue_pv_ss(acc, s_p, v_tile(j));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    inv0 = 1.f / fmaxf(l[0], 1e-30f);
    inv1 = 1.f / fmaxf(l[1], 1e-30f);
    if (lane % 4 == 0) {
      inv_l[r] = inv0;
      inv_l[r + 8] = inv1;
    }
    sm90::mbar_arrive(bar_final);
  } else {
    for (int j = 0; j < n_tiles; ++j) {
      sm90::wgmma_wait<0>();           // P_{j-1} V_{j-1} (none before tile 0)
      sm90::fence_operands(acc);
      if (j > 0) sm90::mbar_arrive(bar_freed);
      sm90::mbar_wait(bar_ready, j & 1);
      sm90::mbar_wait(full(j), (j / STAGES) & 1);
      const float f0 = rescale[r], f1 = rescale[r + 8];
#pragma unroll
      for (int i = 0; i < kSplit3N / 2; ++i) acc[i] *= ((i >> 1) & 1) ? f1 : f0;
      issue_pv_ss(acc, s_p, v_tile(j) + (col0 / 64) * kKVBlockBytes);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    sm90::mbar_wait(bar_final, 0);
    inv0 = inv_l[r];
    inv1 = inv_l[r + 8];
  }

  // o = acc / max(l, 1e-30): this warpgroup's 192 columns of the rows below Sq.
  __nv_bfloat16* const obase = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < kSplit3N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = q_lo + r + 8 * e;
      const float inv = e ? inv1 : inv0;
      if (row < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + (size_t)row * D + col0 + 8 * i + c0) =
            __floats2bfloat162_rn(acc[4 * i + 2 * e] * inv, acc[4 * i + 2 * e + 1] * inv);
    }
  }
}

// Codes past the runtime's own: the tensor map could not be made.
constexpr int kErrNoEncode = 20000;         // the driver has no cuTensorMapEncodeTiled
constexpr int kErrEncode = 10000;           // + the CUresult of cuTensorMapEncodeTiled

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over `heads` contiguous (rows, D) bf16 matrices, (D, rows, heads)
// innermost first, read in 128-byte-swizzled boxes of 64 columns x box_rows.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int D, int rows,
             int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)D * 2 * rows};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                int Sq, int Skv, int causal, int q_offset, float sm_scale, cudaStream_t stream) {
  if (Skv == 0)     // no key: the normalizer's floor gives 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * D * 2, stream);
  const int nq = (Sq + kBQ - 1) / kBQ;
  if ((long long)B * Hq * nq > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  int err = make_map(encode, &tq, q, D, Sq, B * Hq, kBQ);
  if (!err) err = make_map(encode, &tk, k, D, Skv, B * Hkv, kBK);
  if (!err) err = make_map(encode, &tv, v, D, Skv, B * Hkv, kBK);
  if (err) return err;
  constexpr int smem = Sm90Tile<D>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_kernel_sm90<D><<<B * Hq * nq, kThreadsSm90, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, nq, causal, q_offset,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

// D above 128 (MLA's latent): flash_kernel_sm90_wide, with one tile a
// stage for both products when v is k (the same memory), else two.
template <int D, bool SAME_KV>
int launch_wide_kernel(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                       void* o, int B, int Hq, int Hkv, int Sq, int Skv, int nq, int causal,
                       int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = WideTile<D, SAME_KV>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_sm90_wide<D, SAME_KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_kernel_sm90_wide<D, SAME_KV><<<B * Hq * nq, kThreadsSm90, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, nq, causal, q_offset,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90_wide(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Hkv, int Sq, int Skv, int causal, int q_offset, float sm_scale,
                     cudaStream_t stream) {
  if (Skv == 0)
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * D * 2, stream);
  const int nq = (Sq + kBQW - 1) / kBQW;
  if ((long long)B * Hq * nq > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  int err = make_map(encode, &tq, q, D, Sq, B * Hq, kBQW);
  if (!err) err = make_map(encode, &tk, k, D, Skv, B * Hkv, kBK);
  if (!err) err = make_map(encode, &tv, v, D, Skv, B * Hkv, kBK);
  if (err) return err;
  return k == v ? launch_wide_kernel<D, true>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, nq, causal,
                                              q_offset, sm_scale, stream)
                : launch_wide_kernel<D, false>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, nq, causal,
                                               q_offset, sm_scale, stream);
}

// D = 576: flash_kernel_sm90_split3, one tile a stage for both products
// when v is k (the same memory), else K and V.
template <int D, bool SAME_KV>
int launch_split3_kernel(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         void* o, int B, int Hq, int Hkv, int Sq, int Skv, int nq, int causal,
                         int q_offset, float sm_scale, cudaStream_t stream) {
  constexpr int smem = Split3Tile<D, SAME_KV>::kSmem;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel_sm90_split3<D, SAME_KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  flash_kernel_sm90_split3<D, SAME_KV><<<B * Hq * nq, kSplit3Threads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, nq, causal, q_offset,
      sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90_split3(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                       int Hkv, int Sq, int Skv, int causal, int q_offset, float sm_scale,
                       cudaStream_t stream) {
  if (Skv == 0)
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Hq * Sq * D * 2, stream);
  const int nq = (Sq + kBQW - 1) / kBQW;
  if ((long long)B * Hq * nq > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap tq, tk, tv;
  int err = make_map(encode, &tq, q, D, Sq, B * Hq, kBQW);
  if (!err) err = make_map(encode, &tk, k, D, Skv, B * Hkv, kBK);
  if (!err) err = make_map(encode, &tv, v, D, Skv, B * Hkv, kBK);
  if (err) return err;
  return k == v ? launch_split3_kernel<D, true>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, nq, causal,
                                                q_offset, sm_scale, stream)
                : launch_split3_kernel<D, false>(tq, tk, tv, o, B, Hq, Hkv, Sq, Skv, nq, causal,
                                                 q_offset, sm_scale, stream);
}

int launch_sm90_dim(int D, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                    int Hkv, int Sq, int Skv, int causal, int q_offset, float sm_scale,
                    cudaStream_t stream) {
  switch (D) {
    case 16: return launch_sm90<16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 32: return launch_sm90<32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 64: return launch_sm90<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 96: return launch_sm90<96>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 112: return launch_sm90<112>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 128: return launch_sm90<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 288: return launch_sm90_wide<288>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    case 576: return launch_sm90_split3<576>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; dtype 0 = float32 (the SIMT kernel), 1 = bfloat16
// (the wgmma kernel). Returns 0 on success, else a cudaError_t, or
// kErrEncode + a CUresult / kErrNoEncode when the tensor maps could not be
// made; an unsupported head dimension or type gives cudaErrorInvalidValue.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                           int q_offset, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, s);
  if (dtype == 1)
    return launch_sm90_dim(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  static char msg[96];
  if (code == kErrNoEncode) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (code >= kErrEncode) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)", code - kErrEncode);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
