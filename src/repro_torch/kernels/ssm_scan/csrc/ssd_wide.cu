// Chunked SSD scan, the wide route: head dims P and states N up to 1,024
// and chunks up to 512 steps (the xLSTM's mLSTM: P = 513, N = 512, Q =
// 512), for NVIDIA Hopper, sm_90a.
//
// Replaces, for the shapes that ssd_scan.cu's kernels refuse (P or N above
// 64, or a chunk above 128), the TPU kernel
// src/repro/kernels/ssm_scan/kernel.py (_ssd_kernel, launched by
// ssd_chunked_pallas) with its wrapper ops.py::ssd_chunked_scan. The
// function is the same as ssd_scan.cu's: per (batch b, head h) row, xdt
// (B, H, S, P) and loga (B, H, S), B and C (B, G, S, N) shared by the H / G
// heads of a group (head h reads group h / (H / G)), in chunks of Q steps
// with an (N x P) state carried from chunk to chunk:
//     cum    = inclusive cumsum of loga over the chunk, cum_Q its total
//     y      = ((C B^T) . L) xdt + (C . exp(cum)) S_prev,
//              L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//     S_next = exp(cum_Q) S_prev + (B . exp(cum_Q - cum))^T xdt
// y (B, H, S, P) and the final state (B, H, N, P), all float32, and the
// state after each chunk in the `states` scratch (B, H, nc, N, P). The
// last chunk may be ragged: its steps past S read as loga = 0 and xdt = b
// = c = 0, as the reference pads.
//
// What bounds it: at the xLSTM's prefill shape (B 4, H = G = 4, S 1,819,
// P 513, N 512, Q 512) the function needs 40.5 GFLOP of products (upper
// triangles skipped, no inter-chunk product into the first chunk) against
// ~256 MB moved once (xdt, y, B and C ~60 MB each, the final state 16.8
// MB): 0.0818 ms at the 495 TFLOP/s of the TF32 tensor cores, the bound
// that bench.py and chip_smoke.py report, against 0.076 ms at 3.35 TB/s.
// The products run in 3xTF32 (three TF32 products each, tf32x3.cuh: plain
// TF32 misses the 3e-3 tolerance), so their floor is three times the TF32
// bound, 0.2455 ms. A row's state is 1.05 MB and a chunk's C B^T 1 MB, far
// above the 227 KB of shared memory a block may use, and there are only B H
// = 16 rows for 132 SMs: every product is cut into independent 128 x 128
// output tiles (y's and the state's columns depend only on their own xdt
// column).
//
// Four launches of 256-thread CTAs (two warpgroups), in stream order:
//   1. wide_cum_kernel, per (row, chunk): cum in float64, by one warp's scan.
//   2. wide_cb_state_kernel: first C B^T, per (b, group, chunk, 128 x 128
//      tile on or below the diagonal), kept in device memory once per
//      (group, chunk); then every chunk's local state (B . exp(cum_Q -
//      cum))^T xdt, per (row, chunk, 128 rows of N, 128 columns of P), into
//      the `states` scratch. One launch, so that the state tiles fill the
//      last wave of C B^T's.
//   3. wide_chain_kernel, elementwise per (row, 4 entries of the state):
//      S_k = exp(cum_Q,k) S_{k-1} + local_k in chunk order, in place in
//      `states`, the last S_k also to the final state.
//   4. wide_out_kernel, per (row, chunk, 128 rows of y, 128 columns of P):
//      after the first chunk (C S_{k-1}) scaled by exp(cum_i), then the
//      chunk's own steps ((C B^T) . L) xdt up to the tile's diagonal.
// The 1-D grids run the P tiles of one (row, chunk) side by side, so the
// CTAs that share an operand run together and find it in L2.
//
// A product CTA holds a 128 x 128 tile in registers, each warpgroup 64
// rows, and runs k-blocks of 32 through two stages in shared memory: both
// operands land by cp.async (zero-filled outside the chunk) while the
// previous k-block's products run; A is scaled by its decay in place once
// it has landed; B is split into hi and lo K-major tiles with the 128-byte
// swizzle; each warpgroup forms its A fragments in registers (ldmatrix where
// A's rows run along k), splits them, and issues wgmma m64n128k8 in 3xTF32
// (A from registers, B from shared memory), two k-steps a commit group. Two
// CTAs share an SM (at most 128 registers a thread, ~110 KB of shared memory).
//
// The five things that held the first version (float32 FMA on 64 x 64
// tiles, four launches: 2.4719-2.5154 ms a scan, 30x the TF32 bound) back,
// and what this does:
//   - No tensor cores: every product is 3xTF32 on wgmma. A first cut on
//     mma.sync m16n8k8 ran at ~27% of the TF32 peak (1.30 ms a scan);
//     wgmma took it to 1.02 ms.
//   - Operand re-reads: 128 x 128 tiles, so a (group, chunk)'s C B^T and C
//     are read by 4 P tiles, not 9, and S_{k-1} per 128 rows of y, not 64;
//     tiles that share operands run side by side.
//   - Unaligned rows: the wrapper hands over xdt, B, C and y with every
//     row on 16 bytes (the mixer builds them so; anything else is copied),
//     so they land by 16-byte cp.async. The `states` scratch keeps its (N,
//     P) rows (P = 513 is not a multiple of 4): read a float at a time, and
//     written through shared memory so that each warp writes whole rows.
//   - Wasted columns: the tensor cores take P rounded down to a multiple of
//     8 (512 of 513); the other P % 8 columns (the mLSTM's normaliser) are
//     matrix-vector products on the CUDA cores of the first P tile's CTAs,
//     over the A tile they already stage, k split between the warpgroups.
//   - Serial state chain: the local states of all chunks are computed at
//     once (1,024 CTAs at the xLSTM's shape) and chained elementwise.
// Measured at the xLSTM's prefill shape on an NVIDIA H100 80GB HBM3 at a
// power limit of 700.00 W (bench.py --wide, in turns with the first
// version): 0.87-0.98 ms a scan against 2.48-2.62 ms. What is left is in
// the per-k-block staging (copy, decay, split) and its shared-memory
// traffic, which run beside the products of the other CTA on the SM and
// not under the products of their own.
//
// The decays: at the mLSTM's gates log f ~ -0.8 a step, so over a chunk of
// 512 cum falls to ~-400 and exp(cum) underflows to 0 for most steps. cum
// is summed in float64 and every exponent is a float64 difference, rounded
// to float32 only for expf: a float32 cum near -400 carries ~3e-5 of
// rounding into each decay, which put the chunk states 1.5e-5 (relative)
// from a float64 reference, against the plain version's 2.2e-6, and drove
// the bf16 xLSTM's decode further from a fresh prefill than the plain scan
// does (logits 0.247 of the largest against 0.078); in float64 the states
// are within 8.6e-7 and that drift is 0.036 (H100, PERF.md). A factorised
// decay exp(cum_i) exp(-cum_j) would give 0 x inf = NaN; here every decay
// is exp of a difference that is <= 0 where it is used:
// exp(cum_i - cum_j) only for j <= i (selected, never multiplied by a
// mask), exp(cum_Q - cum_t), exp(cum_i) and exp(cum_Q). expf (not __expf)
// returns 0 for arguments below ~-104 and the exact denormal above, so the
// normaliser column max(|n|, 1) reads the same value as in the plain
// version. The hi / lo split comes after the decay. Values outside the
// chunk (past S, or past Q in a partial tile) are zero-filled or selected
// to 0 before any product, so no unwritten scratch is ever used.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;     // eight warps: 4 (rows) x 2 (columns) of 32 x 64
constexpr int kBlocksPerSm = 2;   // product CTAs resident on one SM
constexpr int kTile = 128;        // output tile edge
constexpr int kKB = 32;           // depth of one k-block
constexpr int kLdR = kKB + 4;     // "rows" tiles s[r][k]: fragment loads on 32 banks (4 g + t)
constexpr int kLdC = kTile + 8;   // "cols" tiles s[k][r]: likewise (8 t + g)
constexpr int kRem = 8;           // columns of P past the tensor cores' part: at most 7
constexpr int kStages = 2;        // k-blocks in flight through shared memory
constexpr int kWgSteps = 2;       // k-steps of 8 in one wgmma commit group
constexpr int kMaxQ = 512;        // longest chunk
constexpr int kMaxDim = 1024;     // largest P and N
constexpr int kNoDiag = -(1 << 20);

// Floats of an operand tile in each layout, and of one k-block's stage (A,
// B, the remainder columns' B); bytes of a product kernel's stages.
template <bool kRows>
__host__ __device__ constexpr int tile_floats() { return kRows ? kTile * kLdR : kKB * kLdC; }
template <bool kRowsA, bool kRowsB>
__host__ __device__ constexpr int stage_floats() {
  return tile_floats<kRowsA>() + tile_floats<kRowsB>() + kKB * kRem;
}
// The stages, then B's hi and lo K-major tiles (1 KB aligned, 1 KB of slack).
constexpr int kSplit = 2 * kTile * kKB;
template <bool kRowsA, bool kRowsB>
__host__ __device__ constexpr int smem_bytes() {
  return (kStages * stage_floats<kRowsA, kRowsB>() + kSplit) * 4 + 1024;
}

struct Wide {
  const float* xdt;  long long xb, xh, xs;    // (B, H, S, P), rows on 16 bytes
  const float* loga; long long lb, lh, ls;    // (B, H, S)
  const float* bm;   long long bb, bg, bs;    // (B, G, S, N), rows on 16 bytes
  const float* cm;   long long cb, cg, cs;    // (B, G, S, N), rows on 16 bytes
  float* y;          long long yb, yh, ys;    // (B, H, S, P), rows on 16 bytes
  float* s_fin;      // (B, H, N, P)
  double* cum;       // (B H, nc, Q)
  float* cbm;        // (B G, nc, Q, ldq): C B^T, row i, column j, tiles on or below the diagonal
  float* states;     // (B H, nc, N, P): the state after each chunk
  int B, H, G, S, P, N, Q, nc;
  int hg;            // heads per group, H / G
  int p8;            // columns of P on the tensor cores: P rounded down to a multiple of 8
  int rem;           // the other P - p8 columns, on the CUDA cores
  int ldq;           // row stride of C B^T: Q rounded up to a multiple of 4
};

// cp.async of n (0-4) floats from src to 16 bytes at dst, the rest
// zero-filled (src is not read when n is 0); cp4 one float, or 0.
__device__ __forceinline__ void cp16(float* dst, const float* src, int n) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(4 * max(0, min(n, 4))));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Element (r, k) of a staged operand: r its row in the tile (m for A, n for
// B), k the contraction index within the k-block.
template <bool kRows>
__device__ __forceinline__ float elem(const float* s, int r, int k) {
  return kRows ? s[r * kLdR + k] : s[k * kLdC + r];
}

// This thread's four chunks of 4 floats of an operand tile: rows tiles
// (r, k .. k + 3), contiguous along k (eight threads a row), cols tiles
// (r .. r + 3, k), contiguous along r (a warp a k). f(dst, r, k) copies one
// chunk (dst in shared memory) or, after the copies landed, rescales it.
template <bool kRows, class F>
__device__ __forceinline__ void chunks(float* s, int k0, const F& f) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = threadIdx.x + kThreads * u;
    if (kRows)
      f(s + (e >> 3) * kLdR + (e & 7) * 4, e >> 3, k0 + (e & 7) * 4);
    else
      f(s + (e >> 5) * kLdC + (e & 31) * 4, (e & 31) * 4, k0 + (e >> 5));
  }
}

// Four 8 x 4 float blocks of a rows tile by one ldmatrix: lane l gives the
// address of row (l % 8) of block l / 8, and receives (row l / 4, column
// l % 4) of each block, the m16n8k8 fragment order.
__device__ __forceinline__ void ldsm4(const float* p, float (&v)[4]) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r0, r1, r2, r3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
  v[0] = __uint_as_float(r0);
  v[1] = __uint_as_float(r1);
  v[2] = __uint_as_float(r2);
  v[3] = __uint_as_float(r3);
}

// A's fragment of the m16 tile at row r, k-step column k8 (a0 .. a3): rows
// tiles by ldmatrix, cols tiles a float at a time (conflict-free: 8 t + g).
template <bool kRows>
__device__ __forceinline__ void frag_a(const float* s, int r, int k8, float (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (kRows) {
    ldsm4(s + (r + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdR + k8 + (lane >> 4) * 4, a);
  } else {
    a[0] = elem<kRows>(s, r + g, k8 + t);
    a[1] = elem<kRows>(s, r + g + 8, k8 + t);
    a[2] = elem<kRows>(s, r + g, k8 + t + 4);
    a[3] = elem<kRows>(s, r + g + 8, k8 + t + 4);
  }
}

// B's k-block, split into hi and lo K-major swizzled tiles for wgmma: warp
// w takes k in [4 w, 4 w + 4), lane (k % 4, r) columns n = 8 i + r; reads
// and writes each hit 32 banks.
template <bool kRows>
__device__ __forceinline__ void split_b(const float* raw, float* hi, float* lo) {
  const int lane = threadIdx.x & 31, r = lane >> 2;
  const int k = (threadIdx.x >> 5) * 4 + (lane & 3);
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int n = 8 * i + r, o = tf32x3::km_offset(n, k, kTile);
    uint32_t h, l;
    tf32x3::split(elem<kRows>(raw, n, k), h, l);
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
}

// A warpgroup's 64 x 128 tile += A B over k-steps ks0 .. ks0 + kWgSteps - 1
// of the staged k-block: A's hi / lo fragments (rows r0 .. r0 + 15 of this
// warp) are formed first, then the products are issued as one commit group
// with no branch among them (ptxas serializes them otherwise, C7513 /
// C7519), the small terms of 3xTF32 first, and waited for.
template <bool kRowsA>
__device__ __forceinline__ void wg_products(float (&acc)[64], const float* sa, int r0,
                                            const float* bhi, const float* blo, int ks0) {
  uint32_t h[kWgSteps][4], l[kWgSteps][4];
  uint64_t dh[kWgSteps], dl[kWgSteps];
#pragma unroll
  for (int u = 0; u < kWgSteps; ++u) {
    float a[4];
    frag_a<kRowsA>(sa, r0, (ks0 + u) * 8, a);
#pragma unroll
    for (int e = 0; e < 4; ++e) tf32x3::split(a[e], h[u][e], l[u][e]);
    dh[u] = tf32x3::desc_k8(bhi, kTile, 0, ks0 + u);
    dl[u] = tf32x3::desc_k8(blo, kTile, 0, ks0 + u);
  }
  tf32x3::fence_regs(acc);
#pragma unroll
  for (int u = 0; u < kWgSteps; ++u) {
    tf32x3::fence_regs(h[u]);
    tf32x3::fence_regs(l[u]);
    asm volatile("" : "+l"(dh[u]), "+l"(dl[u])::"memory");
  }
  tf32x3::wgmma_fence();
#pragma unroll
  for (int u = 0; u < kWgSteps; ++u) {
    tf32x3::wgmma_n128(acc, l[u], dh[u]);
    tf32x3::wgmma_n128(acc, h[u], dl[u]);
    tf32x3::wgmma_n128(acc, h[u], dh[u]);
  }
  tf32x3::wgmma_commit();
  tf32x3::wgmma_wait<0>();
  tf32x3::fence_regs(acc);
#pragma unroll
  for (int u = 0; u < kWgSteps; ++u) {
    tf32x3::fence_regs(h[u]);
    tf32x3::fence_regs(l[u]);
  }
}

// The remainder columns on the CUDA cores: thread (row r = tid % 128, half
// h = tid / 128) adds A row r times the staged remainder B (sr[k][c]) over
// k in [16 h, 16 h + 16) of the k-block into racc[c], c < rem; rem_sum
// adds the halves up. Rows tiles are read with a rotation of k by r / 8,
// so that a warp's loads hit 32 banks.
template <bool kRowsA>
__device__ __forceinline__ void rem_block(const float* sa, const float* sr,
                                          float (&racc)[kRem - 1], int rem) {
  const int r = threadIdx.x & (kTile - 1), k0 = (threadIdx.x >> 7) * (kKB / 2);
  const int rot = kRowsA ? (r >> 3) : 0;
#pragma unroll 4
  for (int kk = 0; kk < kKB / 2; ++kk) {
    const int k = k0 + ((kk + rot) & (kKB / 2 - 1));
    const float a = elem<kRowsA>(sa, r, k);
#pragma unroll
    for (int c = 0; c < kRem - 1; ++c)
      if (c < rem) racc[c] = fmaf(a, sr[k * kRem + c], racc[c]);
  }
}

// The two halves of racc added up through `scratch` (kTile * kRem floats of
// shared memory that no thread is using): afterwards threads tid < 128 hold
// row tid's sums. Every thread of the CTA calls it.
__device__ __forceinline__ void rem_sum(float* scratch, float (&racc)[kRem - 1], int rem) {
  const int r = threadIdx.x & (kTile - 1);
  if (threadIdx.x >= kTile)
    for (int c = 0; c < rem; ++c) scratch[r * kRem + c] = racc[c];
  __syncthreads();
  if (threadIdx.x < kTile)
    for (int c = 0; c < rem; ++c) racc[c] += scratch[r * kRem + c];
  __syncthreads();
}

struct Product {
  int k_end;    // the contraction's length
  int m_lim;    // rows of the tile inside the operand (the rest is zero)
  int n_lim;    // columns of the tile on the tensor cores
  int kdiag0;   // the tile's first row negated, for an A that is 0 where k > row; else kNoDiag
  int rem;      // remainder columns this CTA adds on the CUDA cores (0: none)
};

// Tiles of P on the tensor cores (one, for the remainder alone, if P < 8).
__host__ __device__ inline int tiles_p(const Wide& p) {
  return p.p8 > 0 ? (p.p8 + kTile - 1) / kTile : 1;
}

__device__ __forceinline__ float* align1k(float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024 - (a & 1023)) & 1023) / 4;
}

// acc (and, where pr.rem > 0, racc) += A B over the contraction, in
// k-blocks of 32 through two stages in shared memory: the next k-block's
// copies are in flight while this one's products run. la(dst, r, k) and
// lb copy one chunk of A and B (chunks), fixa(dst, r, k) rescales a chunk of
// A once its copy has landed (the decays), lr(dst, k, c) copies the
// remainder columns' B (c < pr.rem). Then B is split into hi and lo tiles
// and each warpgroup runs its 64 rows of the tile by wgmma, skipping a
// k-block whose A is 0 for all of them (rows past the operand, or wholly
// above the diagonal).
template <bool kRowsA, bool kRowsB, class LA, class LB, class FixA, class LR>
__device__ __forceinline__ void gemm(float* smem, float (&acc)[64], float (&racc)[kRem - 1],
                                     const Product& pr, const LA& la, const LB& lb,
                                     const FixA& fixa, const LR& lr) {
  constexpr int kA = tile_floats<kRowsA>(), kAB = kA + tile_floats<kRowsB>();
  constexpr int kSt = stage_floats<kRowsA, kRowsB>();
  float* bhi = align1k(smem + kStages * kSt);
  float* blo = bhi + kTile * kKB;
  const int nkb = (pr.k_end + kKB - 1) / kKB;
  const int rk = threadIdx.x >> 3, rc = threadIdx.x & (kRem - 1);
  const int wg = threadIdx.x >> 7, r0 = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;
  // Every thread commits one group per k-block (empty past the last), so
  // that waiting for all but the newest kStages - 1 groups lands k-block kb.
  auto issue = [&](int kb) {
    if (kb < nkb) {
      float* st = smem + (kb % kStages) * kSt;
      chunks<kRowsA>(st, kb * kKB, la);
      chunks<kRowsB>(st + kA, kb * kKB, lb);
      if (pr.rem > 0) lr(st + kAB + rk * kRem + rc, kb * kKB + rk, rc);
    }
    cp_commit();
  };
#pragma unroll
  for (int kb = 0; kb < kStages - 1; ++kb) issue(kb);
  for (int kb = 0; kb < nkb; ++kb) {
    issue(kb + kStages - 1);
    cp_wait<kStages - 1>();
    float* st = smem + (kb % kStages) * kSt;
    chunks<kRowsA>(st, kb * kKB, fixa);
    __syncthreads();                     // the k-block is in, every chunk fixed
    split_b<kRowsB>(st + kA, bhi, blo);
    __syncthreads();                     // B's hi and lo tiles are complete
    const bool live = wg * 64 < pr.m_lim &&
                      (pr.kdiag0 == kNoDiag || kb * kKB + pr.kdiag0 <= wg * 64 + 63);
    if (live) {
#pragma unroll
      for (int ks0 = 0; ks0 < kKB / 8; ks0 += kWgSteps)
        wg_products<kRowsA>(acc, st, r0, bhi, blo, ks0);
    }
    if (pr.rem > 0) rem_block<kRowsA>(st, st + kAB, racc, pr.rem);
    __syncthreads();                     // consumed before its stage and the tiles are refilled
  }
  cp_wait<0>();
}

__device__ __forceinline__ void zero(float (&acc)[64], float (&racc)[kRem - 1]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll
  for (int c = 0; c < kRem - 1; ++c) racc[c] = 0.f;
}

// This thread's rows of a 128-row tile (r, and r + 8) in the wgmma
// accumulator, and its first column of each n8 block (c0 + 8 j).
__device__ __forceinline__ int acc_row() {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int acc_col() { return 2 * (threadIdx.x & 3); }

// A chunk copier for an operand whose rows (index r, valid below r_lim)
// start at base + r * stride and run along k (valid below k_lim): rows
// tiles (4 values of k).
struct RowsCopy {
  const float* base;
  long long stride;
  int r_lim, k_lim;
  __device__ __forceinline__ void operator()(float* dst, int r, int k) const {
    const bool ok = r < r_lim && k < k_lim;
    cp16(dst, ok ? base + r * stride + k : base, ok ? k_lim - k : 0);
  }
};

// The same for an operand kept as cols tiles, whose rows run along k (valid
// below k_lim, at base + k * stride) and hold r contiguous (valid below
// r_lim). kAligned rows go 16 bytes at a time, others a float at a time.
template <bool kAligned>
struct ColsCopy {
  const float* base;
  long long stride;
  int r_lim, k_lim;
  __device__ __forceinline__ void operator()(float* dst, int r, int k) const {
    const bool ok = k < k_lim && r < r_lim;
    const float* src = ok ? base + k * stride + r : base;
    if (kAligned) {
      cp16(dst, src, ok ? r_lim - r : 0);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) cp4(dst + u, ok ? src + u : base, ok && r + u < r_lim);
    }
  }
};

// The remainder columns' B: rows along k at base + k * stride (valid below
// k_lim), columns c < rem from column p8.
struct RemCopy {
  const float* base;
  long long stride;
  int k_lim, rem;
  __device__ __forceinline__ void operator()(float* dst, int k, int c) const {
    const bool ok = k < k_lim && c < rem;
    cp4(dst, ok ? base + k * stride + c : base, ok);
  }
};

struct NoFix {
  __device__ __forceinline__ void operator()(float*, int, int) const {}
};
struct NoRem {
  __device__ __forceinline__ void operator()(float*, int, int) const {}
};

// 1. cum of one (row, chunk); steps past S add 0. One warp: each lane sums
// a run of consecutive steps, then the runs' totals are scanned by shuffles.
__global__ void __launch_bounds__(kThreads) wide_cum_kernel(Wide p) {
  __shared__ double s[kMaxQ];
  const int z = blockIdx.x / p.nc, k = blockIdx.x % p.nc;
  const int b = z / p.H, h = z % p.H;
  const int t0 = k * p.Q;
  const float* la = p.loga + b * p.lb + h * p.lh;
  for (int t = threadIdx.x; t < p.Q; t += kThreads)
    s[t] = t0 + t < p.S ? (double)la[(long long)(t0 + t) * p.ls] : 0.0;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (p.Q + 31) / 32, lo = lane * per;
    double run = 0.0;
    for (int u = 0; u < per && lo + u < p.Q; ++u) s[lo + u] = run += s[lo + u];
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    for (int u = 0; u < per && lo + u < p.Q; ++u) s[lo + u] += excl;
  }
  __syncthreads();
  double* out = p.cum + ((long long)z * p.nc + k) * p.Q;
  for (int t = threadIdx.x; t < p.Q; t += kThreads) out[t] = s[t];
}

// 2. C B^T of one (b, group, chunk) tile on or below the diagonal: rows i
// (C), columns j (B), contraction over N; only entries inside the chunk are
// written (those above the diagonal too, which nothing reads).
__device__ __forceinline__ void cb_tile(const Wide& p, int idx) {
  extern __shared__ __align__(16) float smem[];
  const int qt = (p.Q + kTile - 1) / kTile, tiles = qt * (qt + 1) / 2;
  const int tile = idx % tiles, zg = idx / tiles / p.nc;
  const int k = idx / tiles % p.nc, b = zg / p.G, g = zg % p.G;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= tile) ++it;
  const int jt = tile - it * (it + 1) / 2;
  const int i0 = it * kTile, j0 = jt * kTile, t0 = k * p.Q;
  const int qv = min(p.Q, p.S - t0);
  if (i0 >= qv) return;
  Product pr;
  pr.k_end = p.N;
  pr.m_lim = min(kTile, qv - i0);
  pr.n_lim = min(kTile, qv - j0);
  pr.kdiag0 = kNoDiag;
  pr.rem = 0;
  const RowsCopy lc{p.cm + b * p.cb + g * p.cg + (long long)(t0 + i0) * p.cs, p.cs, pr.m_lim,
                    p.N};
  const RowsCopy lb{p.bm + b * p.bb + g * p.bg + (long long)(t0 + j0) * p.bs, p.bs, pr.n_lim,
                    p.N};
  float acc[64], racc[kRem - 1];
  zero(acc, racc);
  gemm<true, true>(smem, acc, racc, pr, lc, lb, NoFix{}, NoRem{});
  const int r = acc_row();
  float* out = p.cbm + ((long long)zg * p.nc + k) * p.Q * p.ldq + (long long)i0 * p.ldq + j0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + acc_col();
    if (c >= pr.n_lim) continue;           // c even, so c + 1 < ldq
    if (r < pr.m_lim)
      *reinterpret_cast<float2*>(out + (long long)r * p.ldq + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < pr.m_lim)
      *reinterpret_cast<float2*>(out + (long long)(r + 8) * p.ldq + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// 3. The local state of one (row, chunk, N tile, P tile): (B . exp(cum_Q -
// cum))^T xdt over the chunk's steps, into the chunk's slot of `states`.
__device__ __forceinline__ void state_tile(const Wide& p, int idx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float w[kMaxQ];               // exp(cum_Q - cum_t), 0 past the chunk
  const int pt = tiles_p(p), nt = (p.N + kTile - 1) / kTile;
  const int ptile = idx % pt, zk = idx / pt / nt;
  const int z = zk / p.nc, k = zk % p.nc;
  const int b = z / p.H, h = z % p.H, g = h / p.hg;
  const int n0 = idx / pt % nt * kTile, p0 = ptile * kTile;
  const int t0 = k * p.Q, qv = min(p.Q, p.S - t0);
  const int N = p.N, P = p.P;
  const double* cum = p.cum + ((long long)z * p.nc + k) * p.Q;
  const double total = cum[p.Q - 1];
  for (int t = threadIdx.x; t < kMaxQ; t += kThreads)
    w[t] = t < qv ? expf((float)(total - cum[t])) : 0.f;
  __syncthreads();
  Product pr;
  pr.k_end = qv;
  pr.m_lim = min(kTile, N - n0);
  pr.n_lim = min(kTile, p.p8 - p0);
  pr.kdiag0 = kNoDiag;
  pr.rem = ptile == 0 ? p.rem : 0;
  const float* xrow = p.xdt + b * p.xb + h * p.xh + (long long)t0 * p.xs;
  const ColsCopy<true> la{p.bm + b * p.bb + g * p.bg + (long long)t0 * p.bs + n0, p.bs,
                          pr.m_lim, qv};
  const ColsCopy<true> lx{xrow + p0, p.xs, pr.n_lim, qv};
  const RemCopy lr{xrow + p.p8, p.xs, qv, pr.rem};
  auto fix = [&](float* d, int, int t) {   // A^T[t][n] = B[t][n] exp(cum_Q - cum_t)
    float4 v = *reinterpret_cast<float4*>(d);
    const float wt = w[t];
    *reinterpret_cast<float4*>(d) = make_float4(v.x * wt, v.y * wt, v.z * wt, v.w * wt);
  };
  float acc[64], racc[kRem - 1];
  zero(acc, racc);
  gemm<false, false>(smem, acc, racc, pr, la, lx, fix, lr);

  // The tile goes out through shared memory (the stages are free), so that
  // each warp writes whole rows: the rows of `states` (P floats) do not
  // start on 8 bytes, and the accumulators' own order would write them in
  // scattered halves of sectors.
  float* st = p.states + ((long long)z * p.nc + k) * N * P + (long long)n0 * P;
  if (pr.rem > 0) rem_sum(smem, racc, pr.rem);
  float* tile = smem + kTile * kRem;       // kTile x kLdC, after rem_sum's scratch
  const int r = acc_row();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + acc_col();
    *reinterpret_cast<float2*>(tile + r * kLdC + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(tile + (r + 8) * kLdC + c) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < pr.m_lim; row += kThreads / 32)
#pragma unroll
    for (int u = 0; u < kTile / 32; ++u) {
      const int c = lane + 32 * u;
      if (c < pr.n_lim) st[(long long)row * P + p0 + c] = tile[row * kLdC + c];
    }
  const int rr = threadIdx.x;
  if (pr.rem > 0 && rr < pr.m_lim)
    for (int c = 0; c < pr.rem; ++c) st[(long long)rr * P + p.p8 + c] = racc[c];
}

// 2 and 3 in one launch, so that the state tiles fill the last wave of the
// C B^T tiles: CTAs below n_cb take a C B^T tile, the others a state tile.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) wide_cb_state_kernel(Wide p,
                                                                                int n_cb) {
  if ((int)blockIdx.x < n_cb)
    cb_tile(p, blockIdx.x);
  else
    state_tile(p, blockIdx.x - n_cb);
}

// 4. The chain: per row, S_k = exp(cum_Q,k) S_{k-1} + local_k in chunk
// order, four entries a thread, in place; the last to the final state.
__global__ void __launch_bounds__(kThreads) wide_chain_kernel(Wide p) {
  const int z = blockIdx.y;
  const long long np = (long long)p.N * p.P;
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= np) return;
  const double* cum = p.cum + (long long)z * p.nc * p.Q + p.Q - 1;
  float* st = p.states + (long long)z * p.nc * np + e;
  float* fin = p.s_fin + (long long)z * np + e;
  const bool vec = (np & 3) == 0 && (reinterpret_cast<uintptr_t>(p.states) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(p.s_fin) & 15) == 0;
  const int m = (int)min(4LL, np - e);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < p.nc; ++k, st += np) {
    const float a = expf((float)cum[(long long)k * p.Q]);
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(st);
      s[0] = fmaf(a, s[0], v.x);
      s[1] = fmaf(a, s[1], v.y);
      s[2] = fmaf(a, s[2], v.z);
      s[3] = fmaf(a, s[3], v.w);
      *reinterpret_cast<float4*>(st) = make_float4(s[0], s[1], s[2], s[3]);
    } else {
      for (int u = 0; u < m; ++u) st[u] = s[u] = fmaf(a, s[u], st[u]);
    }
  }
  if (vec) {
    *reinterpret_cast<float4*>(fin) = make_float4(s[0], s[1], s[2], s[3]);
  } else {
    for (int u = 0; u < m; ++u) fin[u] = s[u];
  }
}

// 5. y of one (row, chunk, 128 rows, P tile).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) wide_out_kernel(Wide p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double cum_s[kMaxQ];
  const int pt = tiles_p(p), qt = (p.Q + kTile - 1) / kTile;
  const int ptile = blockIdx.x % pt, zk = blockIdx.x / pt / qt;
  const int z = zk / p.nc, k = zk % p.nc;
  const int b = z / p.H, h = z % p.H, g = h / p.hg;
  const int i0 = blockIdx.x / pt % qt * kTile, p0 = ptile * kTile;
  const int t0 = k * p.Q, qv = min(p.Q, p.S - t0);
  if (i0 >= qv) return;                    // rows past S: nothing to write
  const int N = p.N, P = p.P;
  const double* cum = p.cum + ((long long)z * p.nc + k) * p.Q;
  for (int t = threadIdx.x; t < p.Q; t += kThreads) cum_s[t] = cum[t];
  __syncthreads();
  Product pr;
  pr.m_lim = min(kTile, qv - i0);
  pr.n_lim = min(kTile, p.p8 - p0);
  pr.rem = ptile == 0 ? p.rem : 0;
  const float* xrow = p.xdt + b * p.xb + h * p.xh + (long long)t0 * p.xs;
  float acc[64], racc[kRem - 1];
  zero(acc, racc);
  const int r = acc_row();
  const int rr = threadIdx.x & (kTile - 1);    // the remainder's row

  if (k > 0) {                             // (C S_{k-1}) exp(cum_i)
    const float* prev = p.states + ((long long)z * p.nc + k - 1) * N * P;
    pr.k_end = N;
    pr.kdiag0 = kNoDiag;
    const RowsCopy lc{p.cm + b * p.cb + g * p.cg + (long long)(t0 + i0) * p.cs, p.cs,
                      pr.m_lim, N};
    const ColsCopy<false> ls{prev + p0, P, pr.n_lim, N};   // rows of P floats
    const RemCopy lr{prev + p.p8, P, N, pr.rem};
    gemm<true, false>(smem, acc, racc, pr, lc, ls, NoFix{}, lr);
    const float e0 = r < pr.m_lim ? expf((float)cum_s[i0 + r]) : 0.f;
    const float e1 = r + 8 < pr.m_lim ? expf((float)cum_s[i0 + r + 8]) : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[4 * j] *= e0;
      acc[4 * j + 1] *= e0;
      acc[4 * j + 2] *= e1;
      acc[4 * j + 3] *= e1;
    }
    const float er = rr < pr.m_lim ? expf((float)cum_s[i0 + rr]) : 0.f;
#pragma unroll
    for (int c = 0; c < kRem - 1; ++c) racc[c] *= er;
  }

  // ((C B^T) . L) xdt over key steps j up to the tile's last row.
  pr.k_end = min(i0 + kTile, qv);
  pr.kdiag0 = -i0;
  const RowsCopy lm{p.cbm + ((long long)(b * p.G + g) * p.nc + k) * p.Q * p.ldq +
                        (long long)i0 * p.ldq, p.ldq, pr.m_lim, qv};
  const ColsCopy<true> lx{xrow + p0, p.xs, pr.n_lim, qv};
  const RemCopy lr{xrow + p.p8, p.xs, qv, pr.rem};
  const int m_lim = pr.m_lim;
  auto fix = [&](float* d, int ri, int j) {  // (C B^T)[i][j] exp(cum_i - cum_j), j <= i
    const int i = i0 + ri;
    const bool in = ri < m_lim;
    const double ci = in ? cum_s[i] : 0.0;
    float4 v = *reinterpret_cast<float4*>(d);
    // Selected, never multiplied by a mask: above the diagonal exp overflows,
    // and entries outside the chunk were never written.
    v.x = in && j <= i && j < qv ? v.x * expf((float)(ci - cum_s[j])) : 0.f;
    v.y = in && j + 1 <= i && j + 1 < qv ? v.y * expf((float)(ci - cum_s[j + 1])) : 0.f;
    v.z = in && j + 2 <= i && j + 2 < qv ? v.z * expf((float)(ci - cum_s[j + 2])) : 0.f;
    v.w = in && j + 3 <= i && j + 3 < qv ? v.w * expf((float)(ci - cum_s[j + 3])) : 0.f;
    *reinterpret_cast<float4*>(d) = v;
  };
  gemm<true, false>(smem, acc, racc, pr, lm, lx, fix, lr);

  float* yrow = p.y + b * p.yb + h * p.yh + (long long)(t0 + i0) * p.ys;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + acc_col();
    if (c >= pr.n_lim) continue;
    if (r < pr.m_lim)
      *reinterpret_cast<float2*>(yrow + (long long)r * p.ys + p0 + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < pr.m_lim)
      *reinterpret_cast<float2*>(yrow + (long long)(r + 8) * p.ys + p0 + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (pr.rem > 0) {
    rem_sum(smem, racc, pr.rem);
    if (threadIdx.x < pr.m_lim)
      for (int c = 0; c < pr.rem; ++c) yrow[(long long)rr * p.ys + p.p8 + c] = racc[c];
  }
}

bool aligned16(const void* ptr, const long long* strides, int n) {
  if (reinterpret_cast<uintptr_t>(ptr) & 15) return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] & 3) return false;
  return true;
}

}  // namespace

extern "C" {

// Launch the four kernels on `stream`. dims: B, H, G, S, P, N, Q (Q <= S,
// Q <= 512, P and N <= 1,024). strides (elements): xdt b, h, s; loga b, h,
// s; b b, g, s; c b, g, s; y b, h, s; the last dims of xdt, b, c and y are
// contiguous and their rows start on 16 bytes (every pointer 16-byte
// aligned, every stride a multiple of 4). Scratch, with nc = ceil(S / Q):
// cum B H nc Q doubles, cb B G nc Q ldq floats (ldq = Q rounded up to a
// multiple of 4), states
// B H nc N P floats (the state after each chunk, read back by the tests).
// Returns the cudaError_t of the launches (0 = success); a shape or
// alignment the kernels cannot take gives cudaErrorInvalidValue.
int ssd_wide_launch(const void* xdt, const void* loga, const void* b, const void* c, void* y,
                    void* s_fin, void* cum, void* cb, void* states,
                    const long long* dims, const long long* strides, void* stream) {
  Wide p;
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.G = (int)dims[2];
  p.S = (int)dims[3];
  p.P = (int)dims[4];
  p.N = (int)dims[5];
  p.Q = (int)dims[6];
  if (p.B <= 0 || p.H <= 0 || p.G <= 0 || p.H % p.G != 0 || p.S <= 0 || p.Q <= 0 ||
      p.Q > p.S || p.Q > kMaxQ || p.P <= 0 || p.P > kMaxDim || p.N <= 0 || p.N > kMaxDim)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(xdt, strides, 3) || !aligned16(b, strides + 6, 3) ||
      !aligned16(c, strides + 9, 3) || !aligned16(y, strides + 12, 3))
    return (int)cudaErrorInvalidValue;
  p.nc = (p.S + p.Q - 1) / p.Q;
  p.hg = p.H / p.G;
  p.p8 = p.P / 8 * 8;
  p.rem = p.P - p.p8;
  p.ldq = (p.Q + 3) / 4 * 4;
  p.xdt = static_cast<const float*>(xdt);
  p.loga = static_cast<const float*>(loga);
  p.bm = static_cast<const float*>(b);
  p.cm = static_cast<const float*>(c);
  p.y = static_cast<float*>(y);
  p.s_fin = static_cast<float*>(s_fin);
  p.cum = static_cast<double*>(cum);
  p.cbm = static_cast<float*>(cb);
  p.states = static_cast<float*>(states);
  p.xb = strides[0]; p.xh = strides[1]; p.xs = strides[2];
  p.lb = strides[3]; p.lh = strides[4]; p.ls = strides[5];
  p.bb = strides[6]; p.bg = strides[7]; p.bs = strides[8];
  p.cb = strides[9]; p.cg = strides[10]; p.cs = strides[11];
  p.yb = strides[12]; p.yh = strides[13]; p.ys = strides[14];

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const void* products[2] = {(const void*)wide_cb_state_kernel, (const void*)wide_out_kernel};
  constexpr int kCb = smem_bytes<true, true>(), kState = smem_bytes<false, false>();
  const int smem[2] = {kCb > kState ? kCb : kState, smem_bytes<true, false>()};
  for (int i = 0; i < 2; ++i)
    if ((err = cudaFuncSetAttribute(products[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem[i])) != cudaSuccess)
      return (int)err;
  const unsigned qt = (p.Q + kTile - 1) / kTile, nt = (p.N + kTile - 1) / kTile;
  const unsigned pt = tiles_p(p);
  const unsigned rows = (unsigned)(p.B * p.H), groups = (unsigned)(p.B * p.G);
  const long long np = (long long)p.N * p.P;
  wide_cum_kernel<<<rows * p.nc, kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned n_cb = qt * (qt + 1) / 2 * groups * p.nc;
  wide_cb_state_kernel<<<n_cb + pt * nt * rows * p.nc, kThreads, smem[0], st>>>(p, (int)n_cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wide_chain_kernel<<<dim3((unsigned)((np + 4 * kThreads - 1) / (4 * kThreads)), rows),
                      kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wide_out_kernel<<<pt * qt * rows * p.nc, kThreads, smem[1], st>>>(p);
  return (int)cudaGetLastError();
}

const char* ssd_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
