// Chunked SSD scan (Mamba2's selective state-space prefill) for NVIDIA
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssd_kernel, launched by ssd_chunked_pallas) together with its wrapper
// ops.py::ssd_chunked_scan. Per (batch b, head h) row, with xdt (B, H, S, P)
// and loga (B, H, S) at any strides, and B, C (B, G, S, N) shared by the
// H / G heads of a group (Mamba2's n_groups; zamba2 has G = 1; head h reads
// group h / (H / G)), it walks the row in chunks of Q steps with an (N x P)
// state S carried from chunk to chunk:
//     cum    = inclusive cumsum of loga over the chunk, cum_Q its total
//     y      = ((C B^T) . L) xdt + (C . exp(cum)) S_prev,
//              L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//     S_next = exp(cum_Q) S_prev + (B . exp(cum_Q - cum))^T xdt
// and writes y (B, H, S, P) at any strides (the mixer's (B, S, H, P)) and
// the final state (B, H, N, P), all float32. The TPU kernel's 3-D form is
// the case B = 1, G = H. The last chunk may be ragged: its steps past S
// read as loga = 0 and xdt = b = c = 0, as the reference pads.
//
// What bounds it: at zamba2's prefill shape (B 4, H 112, S 1,819,
// N = P = 64, Q 128) the function moves 431.6 MB once (xdt and y 208.6 MB
// each, the per-batch B and C 3.7 MB, loga 3.3 MB, the final state 7.3 MB):
// 0.129 ms at 3.35 TB/s, against ~20 GFLOP of products with C B^T formed
// once per (batch, chunk), 0.041 ms at the 495 TFLOP/s TF32 rate. Bytes
// bound it, so every SM has to be kept streaming.
//
// Design: the chunkwise decomposition of the SSD paper (Dao & Gu 2024,
// §6-7), in two launches of 256-thread CTAs (two warpgroups), each CTA one
// chunk of up to eight heads of one group ("a head group"):
//   1. ssd_chunk_state_kernel. The first B G nc CTAs form C B^T of one
//      (b, group, chunk) on and below the diagonal (mma.sync) and keep it
//      in device memory (3.7 MB at zamba2's shape), in the register order
//      that launch 2's products read. The others take the chunk's local
//      state (B . exp(cum_Q - cum))^T xdt of each of their heads, then
//      chain along the sequence: each waits until the CTA of the previous
//      chunk (same head group) has published that head's state S_{k-1},
//      adds exp(cum_Q) S_{k-1} and writes S_k, published (a release, then
//      a count) after its next head's tiles are in. Each (head group,
//      chunk) has a count of its own, the heads whose S_k are out, written
//      only by that chunk's CTA and read only by the next chunk's, so that
//      a wait on head j of chunk k - 1 passes only once that head is out,
//      whatever the other chunks have done. CTAs take their work
//      in the order of an atomic ticket, chunk-major, so that the CTA a
//      chain waits for always started earlier: no CTA waits on one that is
//      not running, and at zamba2's shape the previous chunk's CTA started
//      56 tickets before, usually long done.
//   2. ssd_chunk_out_kernel, per (b, chunk, head group): y of each head
//      from the stored C B^T, the decay, xdt, C and S_{k-1}; warpgroup w
//      computes rows [64 w, 64 w + 64) of y, all 64 columns.
// At zamba2's shape that is 840 CTAs a launch, each streaming eight heads,
// against the 448 serial rows of the first version (one 256-thread CTA per
// row, 183 KB of shared memory, one CTA per SM, ~3.4 waves: 4.07 ms on an
// H100 SXM, against 0.90 ms for these two).
//
// The four things that held the first version back, and what this does:
//   - Too little parallel work: chunk-parallel CTAs (840 at zamba2's
//     shape); only the state's N x P combine is sequential along the
//     chunks, and it is chained between CTAs, not looped inside one.
//   - Loads not overlapped with compute: the next head's xdt (and in
//     launch 2 its S_{k-1}) lands by cp.async (16 bytes a thread,
//     zero-filled past the ragged edge) while this head computes; the
//     group's rows (B, or C and C B^T) are loaded once per CTA.
//   - FMA units and full tiles: the products run on the tensor cores in
//     split precision (3xTF32: a = a_hi + a_lo, a b ~ a_hi b_hi + a_hi b_lo
//     + a_lo b_hi; plain TF32 keeps ~3 digits and missed 3e-3 by ~75x at
//     zamba2's shape on an H100). The state and output products are wgmma
//     (TF32, m64n32k8 / m64n64k8): B (xdt, S_{k-1}) from K-major hi / lo
//     tiles in shared memory that each head's rows are split into, A (B^T
//     scaled by the decay, C, and the decay-masked C B^T) formed in
//     registers. Only the 16 x 8 blocks of C B^T on or below the diagonal
//     are formed (72 of 128 at Q = 128), and each 64-row tile of y runs
//     its k-steps only up to its diagonal. The masked decay is a
//     selection: above the diagonal exp(cum_i - cum_j) overflows at
//     Mamba2's decay (cum falls by ~100 over a chunk) and is never used.
//   - B and C broadcast to every head: B and C are read per group in
//     place, C B^T is formed once per (batch, group, chunk), xdt and y keep
//     the mixer's layout (no transposed or broadcast copies).
// What this does not do yet: xdt is read twice (launches 1 and 2), the
// chunk states make a round trip through device memory (110 MB each way at
// zamba2's shape), and within a CTA the per-head phases (splitting the
// tiles, forming A, the products, the stores) run one after the other:
// one CTA per SM (225 KB of shared memory in launch 2) leaves nothing to
// overlap them with but the other warpgroup.
//
// mma.sync m16n8k8 and wgmma TF32 fragments (per warp, g = lane / 4,
// t = lane % 4): A (16 x 8, row) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B (8 x 8, col) b0 (k t, n g), b1 (k t + 4, n g); C/D
// per 8 columns c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
// 2t + 1). Launch 2's intra-chunk product takes C B^T straight from launch
// 1's accumulators, in their order: its k index is permuted (k = t is
// column 2t, k = t + 4 is column 2t + 1), and xdt's rows are stored in the
// same permuted order, which leaves the sum unchanged. Shared-memory rows
// read by fragment loads are padded so that each load hits 32 banks: a
// row stride = 4 (mod 8) where the lanes' rows go with g (A), = 8 or 24
// (mod 32) where they go with t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;   // split precision, K-major swizzled tiles, wgmma sync

constexpr int kThreads = 256;      // two warpgroups per CTA
constexpr int kMaxQ = 128;         // longest chunk: eight 16-row blocks
constexpr int kMaxN = 64;          // largest state: one 64-row M tile of the state product
constexpr int kP = 64;             // head dim the kernels take (the wrapper pads a smaller one)
constexpr int kHeads = 8;          // heads of one group per CTA

struct Scan {
  const float* xdt;  long long xb, xh, xs;    // (B, H, S, P), p contiguous
  const float* loga; long long lb, lh, ls;    // (B, H, S)
  const float* bm;   long long bb, bg, bs;    // (B, G, S, N), n contiguous
  const float* cm;   long long cb, cg, cs;    // (B, G, S, N), n contiguous
  float* y;          long long yb, yh, ys;    // (B, H, S, P), p contiguous
  float* s_fin;      // (B, H, N, P)
  float* cbt;        // (B, G, nc, QB (QB + 1), 32, 4): C B^T blocks on and below the diagonal
  float* states;     // (B, H, nc, N, P): the state after each chunk
  int* sync;         // [0] the ticket counter; [1 + ((b G + g) nhg + hg) nc + k] heads of chunk k published
  int B, H, G, S, N, Q, nc;
  int hg;            // heads per group, H / G
  int nhg;           // head groups per group, ceil(hg / kHeads)
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int round32(int x) { return (x + 31) / 32 * 32; }

// Shared memory, in floats, of launch 1's CTAs (C B^T, or state) and of
// launch 2's, each with 256 floats of slack to align the wgmma tiles to
// 1,024 bytes.
__host__ __device__ inline int smem_state_floats(int Q, int N) {
  const int qp = round16(Q);
  const int cb = 2 * qp * (N + 4);
  const int st = 256 + 2 * kP * round32(qp) + 2 * qp * (kMaxN + 4) + kHeads * qp + kHeads;
  return cb > st ? cb : st;
}
__host__ __device__ inline int smem_out_floats(int Q, int N) {
  const int qp = round16(Q), qb = qp / 16;
  return 256 + 2 * kP * round32(qp) + 2 * kP * round32(N) + qp * (N + 4) +
         qb * (qb + 1) * 128 + qp * (kP + 4) + N * (kP + 8) + kHeads * qp;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows [0, rows) of `width` floats (a multiple of 4) into dst (row stride
// ld); rows at or past `valid` are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long stride,
                                          int rows, int valid, int width) {
  const int per_row = width / 4;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx - r * per_row) * 4;
    const bool ok = r < valid;
    cp16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split(a[u], ah[u], al[u]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// D (64 x 64, f32) += A (64 x 8, tf32, registers) B (8 x 64, tf32, shared, K-major).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 32, f32) += A (64 x 8, tf32, registers) B (8 x 32, tf32, shared, K-major).
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The three products of one k-step: d += a (b_hi + b_lo) in 3xTF32, the
// small terms first.
__device__ __forceinline__ void wgmma3(float (&d)[16], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t bh, uint64_t bl) {
  wgmma_n32(d, al, bh);
  wgmma_n32(d, ah, bl);
  wgmma_n32(d, ah, bh);
}
__device__ __forceinline__ void wgmma3(float (&d)[32], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint64_t bh, uint64_t bl) {
  wgmma_n64(d, al, bh);
  wgmma_n64(d, ah, bl);
  wgmma_n64(d, ah, bh);
}

// The products of k-steps s0 .. s0 + kSteps - 1 (those below `steps`) into
// acc, a warpgroup's 64 x 32 or 64 x 64 tile: make(s, a_hi,
// a_lo) forms step s's A fragments in registers and desc(s, b_hi, b_lo) its
// B descriptors, all before the fence; then every product is issued in one
// commit group, with no branch among them, and waited for. ptxas keeps such
// a stage asynchronous; a register defined by another instruction inside
// it, or a product behind a branch, makes it serialize the products
// (C7513, C7519). Steps past `steps` add 0; the other warpgroup's A
// fragments are formed while these products run.
template <int kSteps, int kAcc, class Make, class Desc>
__device__ __forceinline__ void products(int s0, int steps, float (&acc)[kAcc], Make make,
                                         Desc desc) {
  uint32_t h[kSteps][4], l[kSteps][4];
  uint64_t dh[kSteps], dl[kSteps];
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (s0 + u < steps) {
      make(s0 + u, h[u], l[u]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) h[u][i] = l[u][i] = 0u;
    }
    desc(min(s0 + u, steps - 1), dh[u], dl[u]);
  }
  fence_regs(acc);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    fence_regs(h[u]);
    fence_regs(l[u]);
    asm volatile("" : "+l"(dh[u]), "+l"(dl[u])::"memory");
  }
  wgmma_fence();
#pragma unroll
  for (int u = 0; u < kSteps; ++u) wgmma3(acc, h[u], l[u], dh[u], dl[u]);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    fence_regs(h[u]);
    fence_regs(l[u]);
  }
}

// The position of row j of a k-step among its 8 values of k: the k index of
// the products that read C B^T from launch 1's accumulators is permuted
// (k = t is row 2t, k = t + 4 is row 2t + 1), and B is stored to match.
__device__ __forceinline__ int row_of_k(int k) {
  return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
}

// K-major hi and lo tiles (kP rows, one per column p; K values of k, a
// multiple of 4) from the row-major src (row r = k, or row_of_k(k) when
// `permute`, stride lds). Warp w takes k in [4q, 4q + 4) for q = w, w + 8,
// ..., lane (e, r) value k = 4q + e of rows p = 8i + r, i < 8: 32 banks on
// both sides.
__device__ void to_kmajor(float* hi, float* lo, const float* src, int lds, int K, bool permute) {
  const int warp = threadIdx.x / 32, e = threadIdx.x % 4, r = (threadIdx.x / 4) % 8;
  for (int q = warp; q < K / 4; q += kThreads / 32) {
    const int k = 4 * q + e;
    const float* row = src + (permute ? row_of_k(k) : k) * lds + r;
#pragma unroll
    for (int i = 0; i < kP / 8; ++i) {
      const float x = row[8 * i];
      const int o = km_offset(8 * i + r, k, kP);
      const float h = tf32_hi(x);
      hi[o] = h;
      lo[o] = x - h;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
}

// Inclusive cumsum of the chunk's loga over qp steps (0 past `valid`), by
// one warp: each lane sums a run of consecutive steps, then the runs'
// totals are scanned with shuffles. cum[qp - 1] is cum_Q.
__device__ void chunk_cumsum(float* cum, const float* lr, long long ls, int valid, int qp) {
  const int lane = threadIdx.x % 32;
  const int per = (qp + 31) / 32;           // at most 4 steps a lane
  const int lo = lane * per;
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int t = lo + u;
    if (u < per) run += (t < valid) ? lr[t * ls] : 0.f;
    v[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < per && lo + u < qp) cum[lo + u] = v[u] + excl;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Release: the CTA's writes (ordered before this thread's by a barrier),
// then the count of the chunk's heads whose state is out. Called a head
// late, when the writes have drained, so that the fence costs little.
__device__ __forceinline__ void publish(int* count, int heads) {
  __threadfence();
  atomicExch(count, heads);
}

__device__ __forceinline__ float* align1k(float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024 - (a & 1023)) & 1023) / 4;
}

// C B^T of one (b, group, chunk) on and below the diagonal, by mma.sync:
// block (rb, kb) of 16 rows and 8 columns, kb <= 2 rb + 1, goes to slot
// rb (rb + 1) + kb as each lane's four accumulators. Warps w and w + 4 own
// row blocks w and 7 - w and take the even and the odd column blocks.
__device__ void cb_tile(const Scan& p, float* smem, int b, int g, int k) {
  const int qp = round16(p.Q), N = p.N, ld = N + 4, qb = qp / 16;
  const int t0 = k * p.Q, valid = min(p.Q, p.S - t0);
  float* cs = smem;                 // (qp, N + 4) C rows
  float* bs = cs + qp * ld;         // (qp, N + 4) B rows
  load_rows(cs, ld, p.cm + b * p.cb + g * p.cg + t0 * p.cs, p.cs, qp, valid, N);
  load_rows(bs, ld, p.bm + b * p.bb + g * p.bg + t0 * p.bs, p.bs, qp, valid, N);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int w4 = warp % 4, half = warp / 4;
  float4* out = reinterpret_cast<float4*>(p.cbt) +
                (((long long)b * p.G + g) * p.nc + k) * (qb * (qb + 1)) * 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rb = r == 0 ? w4 : 7 - w4;
    if (rb >= qb) continue;
    const int i0 = rb * 16 + gq;
    for (int kb = half; kb <= 2 * rb + 1; kb += 2) {
      const int j0 = kb * 8 + gq;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < N / 8; ++ks) {
        const int n0 = ks * 8 + tq;
        const float a[4] = {cs[i0 * ld + n0], cs[(i0 + 8) * ld + n0], cs[i0 * ld + n0 + 4],
                            cs[(i0 + 8) * ld + n0 + 4]};
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_a(a, ah, al);
        split(bs[j0 * ld + n0], bh[0], bl[0]);
        split(bs[j0 * ld + n0 + 4], bh[1], bl[1]);
        mma3(acc, ah, al, bh, bl);
      }
      out[(rb * (rb + 1) + kb) * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

// The states after chunk k of the heads h0 .. h0 + nh - 1 of group g. Per
// head: the local state (B . exp(cum_Q - cum))^T xdt (64 x kP; warpgroup w
// takes columns [32 w, 32 w + 32), A = B^T scaled from registers, B = xdt
// from the K-major tiles) goes to the head's slot of `states`; once the
// previous chunk's CTA has counted head j out (its count of chunk k - 1
// has reached j + 1), the slot becomes S_k = exp(cum_Q) S_{k-1} + local,
// counted out (chunk k's count set to j + 1) after the next head's tiles.
__device__ void state_tile(const Scan& p, float* smem, int b, int g, int hgi, int k) {
  const int qp = round16(p.Q), N = p.N, ldb = kMaxN + 4, ldx = kP + 4;
  const int t0 = k * p.Q, valid = min(p.Q, p.S - t0);
  const int h0 = g * p.hg + hgi * kHeads, nh = min(kHeads, p.hg - hgi * kHeads);
  float* xhi = align1k(smem);       // (kP rows, qp k) K-major xdt, hi
  float* xlo = xhi + kP * round32(qp);  // and lo
  float* bs = xlo + kP * round32(qp);   // (qp, 68) B rows; columns N..64 zero
  float* xs = bs + qp * ldb;        // (qp, 68) the next head's xdt rows as they land
  float* wdec = xs + qp * ldx;      // (kHeads, qp) exp(cum_Q - cum) per head
  float* tot = wdec + kHeads * qp;  // (kHeads,) cum_Q per head
  int* done = p.sync + 1 + (((long long)b * p.G + g) * p.nhg + hgi) * p.nc + k;
  const int* ready = done - 1;      // chunk k - 1's count (read only when k > 0)

  const float* xr = p.xdt + b * p.xb + t0 * p.xs;
  load_rows(bs, ldb, p.bm + b * p.bb + g * p.bg + t0 * p.bs, p.bs, qp, valid, N);
  load_rows(xs, ldx, xr + h0 * p.xh, p.xs, qp, valid, kP);
  cp_commit();
  for (int idx = threadIdx.x; idx < qp * (kMaxN - N); idx += kThreads)
    bs[(idx / (kMaxN - N)) * ldb + N + idx % (kMaxN - N)] = 0.f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  if (warp < nh) {                  // warp j: cum and the decay of head j
    float* cum = wdec + warp * qp;
    chunk_cumsum(cum, p.loga + b * p.lb + (h0 + warp) * p.lh + t0 * p.ls, p.ls, valid, qp);
    __syncwarp();
    const float total = cum[qp - 1];
    __syncwarp();
    for (int t = lane; t < qp; t += 32) cum[t] = expf(total - cum[t]);
    if (lane == 0) tot[warp] = total;
  }
  cp_wait<0>();
  __syncthreads();

  const int wg = warp / 4, n0 = (warp % 4) * 16 + gq;
  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    const float* wd = wdec + j * qp;
    float* cur = p.states + (((long long)b * p.H + h) * p.nc + k) * N * kP;
    to_kmajor(xhi, xlo, xs, ldx, qp, true);
    __syncthreads();                // head j's xdt tiles are in; xs is free
    if (threadIdx.x == 0 && j > 0) publish(done, j);   // heads 0 .. j - 1 of S_k are out
    if (j + 1 < nh) load_rows(xs, ldx, xr + (h + 1) * p.xh, p.xs, qp, valid, kP);
    cp_commit();

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    auto make = [&](int ks, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
      const int ta = ks * 8 + 2 * tq;          // k = t is row 2t, k = t + 4 row 2t + 1
      const float wa = wd[ta], wb = wd[ta + 1];
      const float a[4] = {bs[ta * ldb + n0] * wa, bs[ta * ldb + n0 + 8] * wa,
                          bs[(ta + 1) * ldb + n0] * wb, bs[(ta + 1) * ldb + n0 + 8] * wb};
      split_a(a, hh, ll);
    };
    auto desc = [&](int ks, uint64_t& dh, uint64_t& dl) {
      dh = desc_k8(xhi, kP, wg * 32, ks);
      dl = desc_k8(xlo, kP, wg * 32, ks);
    };
    products<kMaxQ / 16>(0, qp / 8, acc, make, desc);
    products<kMaxQ / 16>(kMaxQ / 16, qp / 8, acc, make, desc);
    fence_regs(acc);
    if (k > 0) {
      if (threadIdx.x == 0) {
        // S_{k-1} of head j is out once chunk k - 1 counts j + 1 heads. A
        // chain that never completes is a fault: trap (the launch fails)
        // rather than hang the card.
        for (long long spins = 0; ld_acquire(ready) <= j; ++spins) {
          if (spins > (1ll << 26)) __trap();
          __nanosleep(64);
        }
      }
      __syncthreads();
      // S_k = exp(cum_Q) S_{k-1} + local, at this thread's accumulators.
      const float a = expf(tot[j]);
      const float* prev = cur - (long long)N * kP;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int pc = wg * 32 + nb * 8 + 2 * tq;
        float2 q0 = make_float2(0.f, 0.f), q1 = q0;
        if (n0 < N) q0 = __ldcg(reinterpret_cast<const float2*>(prev + n0 * kP + pc));
        if (n0 + 8 < N) q1 = __ldcg(reinterpret_cast<const float2*>(prev + (n0 + 8) * kP + pc));
        acc[4 * nb] = fmaf(a, q0.x, acc[4 * nb]);
        acc[4 * nb + 1] = fmaf(a, q0.y, acc[4 * nb + 1]);
        acc[4 * nb + 2] = fmaf(a, q1.x, acc[4 * nb + 2]);
        acc[4 * nb + 3] = fmaf(a, q1.y, acc[4 * nb + 3]);
      }
    }
    float* fin = p.s_fin + ((long long)b * p.H + h) * N * kP;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int pc = wg * 32 + nb * 8 + 2 * tq;
      const float2 v0 = make_float2(acc[4 * nb], acc[4 * nb + 1]);
      const float2 v1 = make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
      if (n0 < N) *reinterpret_cast<float2*>(cur + n0 * kP + pc) = v0;
      if (n0 + 8 < N) *reinterpret_cast<float2*>(cur + (n0 + 8) * kP + pc) = v1;
      if (k == p.nc - 1) {
        if (n0 < N) *reinterpret_cast<float2*>(fin + n0 * kP + pc) = v0;
        if (n0 + 8 < N) *reinterpret_cast<float2*>(fin + (n0 + 8) * kP + pc) = v1;
      }
    }
    cp_wait<0>();
    __syncthreads();                // head j's S_k is written; head j + 1's xdt landed
  }
  if (threadIdx.x == 0) publish(done, nh);
}

// Launch 1: CTAs take tickets; the first B G nc form C B^T, the others the
// chunk states, chunk-major (chunk, b, group, head group).
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_state_kernel(Scan p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const long long n_cb = (long long)p.B * p.G * p.nc;
  long long t = ticket;
  if (t < n_cb) {
    const int g = t % p.G, k = (t / p.G) % p.nc, b = t / ((long long)p.G * p.nc);
    cb_tile(p, smem, b, g, k);
  } else {
    t -= n_cb;
    const int hgi = t % p.nhg;
    t /= p.nhg;
    const int g = t % p.G;
    t /= p.G;
    const int b = t % p.B, k = t / p.B;
    state_tile(p, smem, b, g, hgi, k);
  }
}

// Launch 2: y of the heads of one (b, chunk, head group). C and C B^T are
// loaded once; each head's xdt and S_{k-1} land while the previous head
// computes, then go to K-major hi / lo tiles. Warpgroup w computes columns
// [32 w, 32 w + 32) of y for both 64-row M tiles: first (C S_{k-1}) scaled
// by exp(cum_i), then the decay-masked C B^T (from registers) times xdt,
// the M tile's k-steps up to its diagonal.
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_out_kernel(Scan p) {
  extern __shared__ __align__(16) float smem[];
  long long t = blockIdx.x;
  const int hgi = t % p.nhg;
  t /= p.nhg;
  const int g = t % p.G;
  t /= p.G;
  const int k = t % p.nc, b = t / p.nc;
  const int qp = round16(p.Q), N = p.N, qb = qp / 16, nblk = qb * (qb + 1);
  const int ldc = N + 4, lds = kP + 8, ldx = kP + 4;
  const int t0 = k * p.Q, valid = min(p.Q, p.S - t0);
  const int h0 = g * p.hg + hgi * kHeads, nh = min(kHeads, p.hg - hgi * kHeads);
  float* xhi = align1k(smem);       // (kP rows, qp k) K-major xdt, hi
  float* xlo = xhi + kP * round32(qp);  // and lo
  float* shi = xlo + kP * round32(qp);  // (kP rows, N k) K-major S_{k-1}, hi
  float* slo = shi + kP * round32(N);   // and lo
  float* cs = slo + kP * round32(N);    // (qp, N + 4) C rows
  float* cbs = cs + qp * ldc;       // (nblk, 32, 4) C B^T blocks
  float* xs = cbs + nblk * 128;     // (qp, kP + 4) the next head's xdt rows as they land
  float* ss = xs + qp * ldx;        // (N, kP + 8) and its S_{k-1}
  float* cums = ss + N * lds;       // (kHeads, qp) cum per head

  const float* xr = p.xdt + b * p.xb + t0 * p.xs;
  const long long hrow = (long long)b * p.H;
  auto load_head = [&](int j) {     // head j's xdt and S_{k-1} rows into xs, ss
    const int h = h0 + j;
    load_rows(xs, ldx, xr + h * p.xh, p.xs, qp, valid, kP);
    if (k > 0) load_rows(ss, lds, p.states + ((hrow + h) * p.nc + k - 1) * N * kP, kP, N, N, kP);
  };
  load_rows(cs, ldc, p.cm + b * p.cb + g * p.cg + t0 * p.cs, p.cs, qp, valid, N);
  {
    const float* src = p.cbt + (((long long)b * p.G + g) * p.nc + k) * nblk * 128;
    for (int idx = threadIdx.x; idx < nblk * 32; idx += kThreads)
      cp16(cbs + idx * 4, src + idx * 4, true);
  }
  load_head(0);
  cp_commit();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  if (warp < nh)
    chunk_cumsum(cums + warp * qp, p.loga + b * p.lb + (h0 + warp) * p.lh + t0 * p.ls, p.ls,
                 valid, qp);
  const int wg = warp / 4, w4 = warp % 4;
  const float4* cb4 = reinterpret_cast<const float4*>(cbs);
  cp_wait<0>();
  __syncthreads();

  for (int j = 0; j < nh; ++j) {
    const int h = h0 + j;
    const float* cum = cums + j * qp;
    to_kmajor(xhi, xlo, xs, ldx, qp, true);
    if (k > 0) to_kmajor(shi, slo, ss, lds, N, false);
    __syncthreads();                // head j's tiles are in; xs, ss are free
    if (j + 1 < nh) load_head(j + 1);
    cp_commit();

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const int m = wg;               // this warpgroup's M tile: rows [64 m, 64 m + 64)
    if (64 * m < qp) {
      const int i0 = 64 * m + 16 * w4 + gq, i1 = i0 + 8;
      const bool in0 = i0 < qp, in1 = i1 < qp;  // rows past the chunk read as 0
      // The carried state's part: (C S_{k-1}) for the M tile, times exp(cum_i).
      if (k > 0) {
        auto make = [&](int ks, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
          const int c0 = ks * 8 + tq;
          const float a[4] = {in0 ? cs[i0 * ldc + c0] : 0.f, in1 ? cs[i1 * ldc + c0] : 0.f,
                              in0 ? cs[i0 * ldc + c0 + 4] : 0.f, in1 ? cs[i1 * ldc + c0 + 4] : 0.f};
          split_a(a, hh, ll);
        };
        auto desc = [&](int ks, uint64_t& dh, uint64_t& dl) {
          dh = desc_k8(shi, kP, 0, ks);
          dl = desc_k8(slo, kP, 0, ks);
        };
        products<kMaxN / 8>(0, N / 8, acc, make, desc);
        const float e0 = in0 ? expf(cum[i0]) : 0.f, e1 = in1 ? expf(cum[i1]) : 0.f;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          acc[4 * nb] *= e0;
          acc[4 * nb + 1] *= e0;
          acc[4 * nb + 2] *= e1;
          acc[4 * nb + 3] *= e1;
        }
      }
      // The chunk's own steps: (C B^T . L) xdt over the M tile's k-steps.
      const int rb = 4 * m + w4, kend = min(8 * m + 8, qp / 8);
      const float ci0 = in0 ? cum[i0] : 0.f, ci1 = in1 ? cum[i1] : 0.f;
      auto make = [&](int kb, uint32_t (&hh)[4], uint32_t (&ll)[4]) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (rb < qb && kb <= 2 * rb + 1) {
          const int j0 = kb * 8 + 2 * tq;
          const float cj0 = cum[j0], cj1 = cum[j0 + 1];
          const float4 v = cb4[(rb * (rb + 1) + kb) * 32 + lane];
          // Selected, never multiplied: exp overflows above the diagonal.
          // __expf: ex2.approx of x log2(e), relative error ~1e-6 where the
          // decay is not negligible (|x| < 20).
          a[0] = j0 <= i0 ? v.x * __expf(ci0 - cj0) : 0.f;
          a[1] = j0 <= i1 ? v.z * __expf(ci1 - cj0) : 0.f;
          a[2] = j0 + 1 <= i0 ? v.y * __expf(ci0 - cj1) : 0.f;
          a[3] = j0 + 1 <= i1 ? v.w * __expf(ci1 - cj1) : 0.f;
        }
        split_a(a, hh, ll);
      };
      auto desc = [&](int kb, uint64_t& dh, uint64_t& dl) {
        dh = desc_k8(xhi, kP, 0, kb);
        dl = desc_k8(xlo, kP, 0, kb);
      };
      products<8>(0, kend, acc, make, desc);
      if (m == 1) products<8>(8, kend, acc, make, desc);
      float* yrow = p.y + b * p.yb + h * p.yh + t0 * p.ys;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int pc = nb * 8 + 2 * tq;
        if (i0 < valid)
          *reinterpret_cast<float2*>(yrow + i0 * p.ys + pc) = make_float2(acc[4 * nb], acc[4 * nb + 1]);
        if (i1 < valid)
          *reinterpret_cast<float2*>(yrow + i1 * p.ys + pc) = make_float2(acc[4 * nb + 2], acc[4 * nb + 3]);
      }
    }
    cp_wait<0>();
    __syncthreads();                // the tiles are free; head j + 1's rows landed
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) of launch 1's and launch 2's CTAs for chunk Q and
// state N (the head dim is kP).
int ssd_smem_bytes(int Q, int N) {
  const int a = smem_state_floats(Q, N), c = smem_out_floats(Q, N);
  return 4 * (a > c ? a : c);
}

// Ints of the `sync` scratch for nc chunks: the ticket counter and one
// count per (head group, chunk).
long long ssd_sync_ints(int B, int H, int G, int nc) {
  return 1 + (long long)B * G * ((H / G + kHeads - 1) / kHeads) * nc;
}

// Launch the two kernels on `stream`. dims: B, H, G, S, P (= 64), N (a
// multiple of 8, <= 64), Q (chunk length, <= S and <= 128). strides
// (elements): xdt b, h, s; loga b, h, s; b b, g, s; c b, g, s; y b, h, s;
// the last dims of xdt, b, c and y are contiguous, their rows 16-byte
// aligned. Scratch: cbt B G nc QB (QB + 1) 128 floats (QB = ceil(Q / 16)),
// states B H nc N P floats, with nc = ceil(S / Q), and sync
// ssd_sync_ints(B, H, G, nc) ints, which the launch zeroes. Returns the
// cudaError_t of the launches (0 = success); a shape the kernels cannot
// hold gives cudaErrorInvalidValue.
int ssd_chunked_launch(const void* xdt, const void* loga, const void* b, const void* c, void* y,
                       void* s_fin, void* cbt, void* states, void* sync,
                       const long long* dims, const long long* strides, void* stream) {
  Scan p;
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.G = (int)dims[2];
  p.S = (int)dims[3];
  p.N = (int)dims[5];
  p.Q = (int)dims[6];
  if (p.B <= 0 || p.H <= 0 || p.G <= 0 || p.H % p.G != 0 || p.S <= 0 || p.Q <= 0 ||
      p.Q > p.S || p.Q > kMaxQ || dims[4] != kP || p.N <= 0 || p.N % 8 != 0 || p.N > kMaxN)
    return (int)cudaErrorInvalidValue;
  p.nc = (p.S + p.Q - 1) / p.Q;
  p.hg = p.H / p.G;
  p.nhg = (p.hg + kHeads - 1) / kHeads;
  p.xdt = static_cast<const float*>(xdt);
  p.loga = static_cast<const float*>(loga);
  p.bm = static_cast<const float*>(b);
  p.cm = static_cast<const float*>(c);
  p.y = static_cast<float*>(y);
  p.s_fin = static_cast<float*>(s_fin);
  p.cbt = static_cast<float*>(cbt);
  p.states = static_cast<float*>(states);
  p.sync = static_cast<int*>(sync);
  p.xb = strides[0]; p.xh = strides[1]; p.xs = strides[2];
  p.lb = strides[3]; p.lh = strides[4]; p.ls = strides[5];
  p.bb = strides[6]; p.bg = strides[7]; p.bs = strides[8];
  p.cb = strides[9]; p.cg = strides[10]; p.cs = strides[11];
  p.yb = strides[12]; p.yh = strides[13]; p.ys = strides[14];

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem1 = 4 * smem_state_floats(p.Q, p.N);
  const int smem2 = 4 * smem_out_floats(p.Q, p.N);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_chunk_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(sync, 0, sizeof(int) * ssd_sync_ints(p.B, p.H, p.G, p.nc), st);
  if (err != cudaSuccess) return (int)err;

  const long long groups = (long long)p.B * p.G * p.nhg * p.nc;   // (b, group, head group, chunk)
  const long long n_cb = (long long)p.B * p.G * p.nc;
  ssd_chunk_state_kernel<<<(unsigned)(n_cb + groups), kThreads, smem1, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_out_kernel<<<(unsigned)groups, kThreads, smem2, st>>>(p);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
