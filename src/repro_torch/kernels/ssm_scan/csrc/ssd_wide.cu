// Chunked SSD scan, the wide route: head dims P and states N up to 1,024
// and chunks up to 512 steps (the xLSTM's mLSTM: P = 513, N = 512, Q =
// 512), for NVIDIA Hopper, sm_90a.
//
// Replaces, for the shapes that ssd_scan.cu's kernels refuse (P or N above
// 64, or a chunk above 128), the TPU kernel
// src/repro/kernels/ssm_scan/kernel.py (_ssd_kernel, launched by
// ssd_chunked_pallas) with its wrapper ops.py::ssd_chunked_scan. The
// function is the same as ssd_scan.cu's: per (batch b, head h) row, xdt
// (B, H, S, P) and loga (B, H, S) at any strides, B and C (B, G, S, N)
// shared by the H / G heads of a group (head h reads group h / (H / G)),
// in chunks of Q steps with an (N x P) state carried from chunk to chunk:
//     cum    = inclusive cumsum of loga over the chunk, cum_Q its total
//     y      = ((C B^T) . L) xdt + (C . exp(cum)) S_prev,
//              L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//     S_next = exp(cum_Q) S_prev + (B . exp(cum_Q - cum))^T xdt
// y (B, H, S, P) at any strides and the final state (B, H, N, P), all
// float32. The last chunk may be ragged: its steps past S read as loga = 0
// and xdt = b = c = 0, as the reference pads.
//
// What bounds it: at the xLSTM's scan shape (B 4, H = G = 4, S 2,048, P
// 513, N 512, Q 512) the function moves ~285 MB (0.085 ms at 3.35 TB/s)
// and needs ~47 GFLOP of products (upper triangles skipped, no inter-chunk
// product into the first chunk): 0.095 ms at the 495 TFLOP/s of the TF32
// tensor cores, the card's peak for float32 operands and the bound that
// bench.py and chip_smoke.py report, and 0.71 ms at the 67 TFLOP/s of
// float32 FMA that these kernels use. Operations bound it. A row's state
// is 512 x 513 x 4 B = 1.05 MB and a chunk's C B^T
// 1 MB, far above the 227 KB of shared memory a block may use, and there
// are only B H = 16 rows for 132 SMs: so nothing here keeps a row in one
// CTA. Every product is cut into 64 x 64 output tiles that are independent
// given the chunk's cum, C B^T and the state entering it: the columns of y
// and of the state depend only on their own xdt column.
//
// Four launches of 256-thread CTAs, in stream order:
//   1. wide_cum_kernel, per (row, chunk): cum, summed in step order.
//   2. wide_cb_kernel, per (b, group, chunk, 64 x 64 tile on or below the
//      diagonal): C B^T, written transposed ((C B^T)^T [j][i]) to scratch
//      once per group (1 MB a (group, chunk) at Q = 512), so that the
//      output tiles of the 9 P tiles read it instead of forming it again.
//   3. wide_state_kernel, per (row, 64 rows of N, 64 columns of P): walks
//      the chunks in order with its state tile in registers, S_k =
//      exp(cum_Q) S_{k-1} + (B . exp(cum_Q - cum))^T xdt, and writes S_k to
//      the chunk-state scratch (and the last to the final state). The
//      chain along the chunks is a loop inside one CTA; 1,152 CTAs at the
//      xLSTM's shape.
//   4. wide_out_kernel, per (row, chunk, 64 rows of y, 64 columns of P):
//      y = ((C B^T) . L) xdt over the key blocks up to the diagonal, then,
//      after the first chunk, + (C . exp(cum)) S_{k-1}; 4,608 CTAs.
// Each product runs on 64 x 64 tiles with k-steps of 32: both operands are
// staged in shared memory (the next k-step's loads in flight in registers
// while this one's FMAs run) and each thread keeps a 4 x 4 block of the
// output in registers (two 16-byte shared loads for 16 FMAs). ptxas holds
// the product kernels to 80 registers a thread, so that three CTAs share an
// SM (the output kernel spills 44 bytes): a scan at the xLSTM's prefill
// shape (S 1,819) took 2.45-2.57 ms this way on an H100 SXM at 700 W,
// against 2.82-2.90 ms at 122-127 registers and two CTAs an SM, timed in
// turns. P = 513 pads
// to 9 tiles of 64 (12% of the state and output products on zero columns);
// rows of xdt and y at the mixer's strides are not 16-byte aligned, so
// device memory is read and written one float at a time (coalesced).
//
// The decays: at the mLSTM's gates log f ~ -0.8 a step, so over a chunk of
// 512 cum falls to ~-400 and exp(cum) underflows to 0 for most steps. A
// factorised decay exp(cum_i) exp(-cum_j) would give 0 x inf = NaN; here
// every decay is exp of a difference that is <= 0 where it is used:
// exp(cum_i - cum_j) only for j <= i (selected, never multiplied by a
// mask), exp(cum_Q - cum_t), exp(cum_i) and exp(cum_Q). expf (not __expf)
// returns 0 for arguments below ~-104 and the exact denormal above, so the
// normaliser column max(|n|, 1) reads the same value as in the plain
// version. Values outside the chunk (past S, or past Q in a partial tile)
// are selected to 0 before any product, so no scratch is read there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, each a 4 x 4 block of a 64 x 64 tile
constexpr int kBlocksPerSm = 3; // the products' CTAs resident on one SM (80 registers a thread)
constexpr int kTile = 64;       // output tile edge
constexpr int kK = 32;          // depth of one k-step
constexpr int kLd = kTile + 4;  // shared row stride (floats): rows start on 16 bytes
constexpr int kMaxQ = 512;      // longest chunk
constexpr int kMaxDim = 1024;   // largest P and N

struct Wide {
  const float* xdt;  long long xb, xh, xs;    // (B, H, S, P), p contiguous
  const float* loga; long long lb, lh, ls;    // (B, H, S)
  const float* bm;   long long bb, bg, bs;    // (B, G, S, N), n contiguous
  const float* cm;   long long cb, cg, cs;    // (B, G, S, N), n contiguous
  float* y;          long long yb, yh, ys;    // (B, H, S, P), p contiguous
  float* s_fin;      // (B, H, N, P)
  float* cum;        // (B H, nc, Q)
  float* cbt;        // (B G, nc, Q, Q): (C B^T)^T, row j, column i
  float* states;     // (B H, nc, N, P): the state after each chunk
  int B, H, G, S, P, N, Q, nc;
  int hg;            // heads per group, H / G
};

struct Tiles {
  float a[kK][kLd];  // A^T: k-step by the tile's 64 rows
  float b[kK][kLd];  // B: k-step by the tile's 64 columns
};

// Element r of this thread's share of one k-step's 32 x 64 operand tile.
// "Along" tiles read device memory along the tile's 64 rows or columns (a
// warp reads 32 neighbouring floats of one k), "across" tiles along k (a
// warp reads 32 neighbouring k of one row); both land as [k][m].
template <bool kAcross>
__device__ __forceinline__ void slot(int r, int& kk, int& m) {
  const int e = threadIdx.x + kThreads * r;
  kk = kAcross ? (e & (kK - 1)) : (e / kTile);
  m = kAcross ? (e / kK) : (e & (kTile - 1));
}

template <bool kAcross, class F>
__device__ __forceinline__ void fetch(const F& f, int k0, float (&v)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int kk, m;
    slot<kAcross>(r, kk, m);
    v[r] = f(k0 + kk, m);
  }
}

template <bool kAcross>
__device__ __forceinline__ void put(float (*s)[kLd], const float (&v)[8]) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    int kk, m;
    slot<kAcross>(r, kk, m);
    s[kk][m] = v[r];
  }
}

// acc[r][c] += sum over k-steps [k_begin, k_end) of A(row 4 ty + r, k) B(k,
// column 4 tx + c), A and B given element by element by fa(k, row) and
// fb(k, column) (each returns 0 outside its operand). The next k-step's
// elements are loaded into registers while this one's FMAs run.
template <bool kAcrossA, bool kAcrossB, class FA, class FB>
__device__ __forceinline__ void gemm(Tiles& sm, float (&acc)[4][4], int k_begin, int k_end,
                                     const FA& fa, const FB& fb) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float va[8], vb[8];
  if (k_begin >= k_end) return;
  fetch<kAcrossA>(fa, k_begin, va);
  fetch<kAcrossB>(fb, k_begin, vb);
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
    __syncthreads();                 // the previous k-step's tiles are consumed
    put<kAcrossA>(sm.a, va);
    put<kAcrossB>(sm.b, vb);
    __syncthreads();
    if (k0 + kK < k_end) {
      fetch<kAcrossA>(fa, k0 + kK, va);
      fetch<kAcrossB>(fb, k0 + kK, vb);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&sm.a[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[k][4 * tx]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// 1. cum of one (row, chunk), summed in step order; steps past S add 0.
__global__ void __launch_bounds__(kThreads) wide_cum_kernel(Wide p) {
  __shared__ float s[kMaxQ];
  const int z = blockIdx.x / p.nc, k = blockIdx.x % p.nc;
  const int b = z / p.H, h = z % p.H;
  const int t0 = k * p.Q;
  const float* la = p.loga + b * p.lb + h * p.lh;
  for (int t = threadIdx.x; t < p.Q; t += kThreads)
    s[t] = t0 + t < p.S ? la[(long long)(t0 + t) * p.ls] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < p.Q; ++t) s[t] = run += s[t];
  }
  __syncthreads();
  float* out = p.cum + ((long long)z * p.nc + k) * p.Q;
  for (int t = threadIdx.x; t < p.Q; t += kThreads) out[t] = s[t];
}

// 2. (C B^T)^T of one (b, group, chunk) tile: rows j (B), columns i (C),
// for the tiles with j-tile <= i-tile.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) wide_cb_kernel(Wide p) {
  __shared__ Tiles sm;
  const int zg = blockIdx.x / p.nc, k = blockIdx.x % p.nc;
  const int b = zg / p.G, g = zg % p.G;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.y) ++it;
  const int jt = blockIdx.y - it * (it + 1) / 2;
  const int i0 = it * kTile, j0 = jt * kTile, t0 = k * p.Q;
  const int qv = min(p.Q, p.S - t0);
  const float* brow = p.bm + b * p.bb + g * p.bg + (long long)t0 * p.bs;
  const float* crow = p.cm + b * p.cb + g * p.cg + (long long)t0 * p.cs;
  const int N = p.N;
  const long long bs = p.bs, cs = p.cs;
  auto fa = [&](int n, int m) {           // A = B: row j = j0 + m, k = n
    const int j = j0 + m;
    return j < qv && n < N ? brow[j * bs + n] : 0.f;
  };
  auto fc = [&](int n, int m) {           // B operand = C^T: column i = i0 + m, k = n
    const int i = i0 + m;
    return i < qv && n < N ? crow[i * cs + n] : 0.f;
  };
  float acc[4][4];
  zero(acc);
  gemm<true, true>(sm, acc, 0, N, fa, fc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* out = p.cbt + ((long long)zg * p.nc + k) * p.Q * p.Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + 4 * ty + r;
    if (j >= p.Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * tx + c;
      if (i < p.Q) out[(long long)j * p.Q + i] = acc[r][c];
    }
  }
}

// 3. The chained state of one (row, N tile, P tile) along the chunks.
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) wide_state_kernel(Wide p) {
  __shared__ Tiles sm;
  __shared__ float w[kMaxQ];               // exp(cum_Q - cum_t) of this chunk
  const int z = blockIdx.x, b = z / p.H, h = z % p.H, g = h / p.hg;
  const int n0 = blockIdx.y * kTile, p0 = blockIdx.z * kTile;
  const int N = p.N, P = p.P;
  const long long bs = p.bs, xs = p.xs;
  float acc[4][4];
  zero(acc);
  for (int k = 0; k < p.nc; ++k) {
    const int t0 = k * p.Q, qv = min(p.Q, p.S - t0);
    const float* cum = p.cum + ((long long)z * p.nc + k) * p.Q;
    const float total = cum[p.Q - 1];
    __syncthreads();                       // the previous chunk's w is consumed
    for (int t = threadIdx.x; t < qv; t += kThreads) w[t] = expf(total - cum[t]);
    __syncthreads();
    const float decay = expf(total);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= decay;
    const float* brow = p.bm + b * p.bb + g * p.bg + (long long)t0 * bs;
    const float* xrow = p.xdt + b * p.xb + h * p.xh + (long long)t0 * xs;
    auto fa = [&](int t, int m) {          // A^T[t][n] = B[t, n] exp(cum_Q - cum_t)
      const int n = n0 + m;
      return t < qv && n < N ? brow[t * bs + n] * w[t] : 0.f;
    };
    auto fb = [&](int t, int m) {          // xdt[t, p]
      const int pc = p0 + m;
      return t < qv && pc < P ? xrow[t * xs + pc] : 0.f;
    };
    gemm<false, false>(sm, acc, 0, qv, fa, fb);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float* st = p.states + ((long long)z * p.nc + k) * N * P;
    float* fin = p.s_fin + (long long)z * N * P;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + 4 * ty + r;
      if (n >= N) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pc = p0 + 4 * tx + c;
        if (pc >= P) continue;
        st[(long long)n * P + pc] = acc[r][c];
        if (k == p.nc - 1) fin[(long long)n * P + pc] = acc[r][c];
      }
    }
  }
}

// 4. y of one (row, chunk, 64 rows, P tile).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) wide_out_kernel(Wide p) {
  __shared__ Tiles sm;
  __shared__ float ci[kTile], ei[kTile];   // cum_i and exp(cum_i) of the tile's rows
  const int z = blockIdx.x / p.nc, k = blockIdx.x % p.nc;
  const int b = z / p.H, h = z % p.H, g = h / p.hg;
  const int i0 = blockIdx.y * kTile, p0 = blockIdx.z * kTile;
  const int t0 = k * p.Q, qv = min(p.Q, p.S - t0);
  if (i0 >= qv) return;                    // rows past S: nothing to write
  const int N = p.N, P = p.P, Q = p.Q;
  const float* cum = p.cum + ((long long)z * p.nc + k) * Q;
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    const float cv = i < qv ? cum[i] : 0.f;
    ci[threadIdx.x] = cv;
    ei[threadIdx.x] = expf(cv);
  }
  __syncthreads();
  const long long xs = p.xs, cs = p.cs;
  const float* xrow = p.xdt + b * p.xb + h * p.xh + (long long)t0 * xs;
  const float* cbt = p.cbt + ((long long)(b * p.G + g) * p.nc + k) * Q * Q;
  float acc[4][4];
  zero(acc);
  // ((C B^T) . L) xdt: key steps j up to the tile's last row
  auto fm = [&](int j, int m) {            // A^T[j][i] = (C B^T)[i][j] exp(cum_i - cum_j), j <= i
    const int i = i0 + m;
    return j <= i && i < qv ? cbt[(long long)j * Q + i] * expf(ci[m] - cum[j]) : 0.f;
  };
  auto fx = [&](int j, int m) {            // xdt[j, p]
    const int pc = p0 + m;
    return j < qv && pc < P ? xrow[j * xs + pc] : 0.f;
  };
  gemm<false, false>(sm, acc, 0, min(i0 + kTile, qv), fm, fx);
  if (k > 0) {                             // + (C . exp(cum)) S_{k-1}
    const float* crow = p.cm + b * p.cb + g * p.cg + (long long)t0 * cs;
    const float* prev = p.states + ((long long)z * p.nc + k - 1) * N * P;
    auto fc = [&](int n, int m) {          // A^T[n][i] = C[i, n] exp(cum_i)
      const int i = i0 + m;
      return i < qv && n < N ? crow[i * cs + n] * ei[m] : 0.f;
    };
    auto fs = [&](int n, int m) {          // S_{k-1}[n, p]
      const int pc = p0 + m;
      return n < N && pc < P ? prev[(long long)n * P + pc] : 0.f;
    };
    gemm<true, false>(sm, acc, 0, N, fc, fs);
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* yrow = p.y + b * p.yb + h * p.yh + (long long)t0 * p.ys;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= qv) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pc = p0 + 4 * tx + c;
      if (pc < P) yrow[(long long)i * p.ys + pc] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Launch the four kernels on `stream`. dims: B, H, G, S, P, N, Q (Q <= S,
// Q <= 512, P and N <= 1,024). strides (elements): xdt b, h, s; loga b, h,
// s; b b, g, s; c b, g, s; y b, h, s; the last dims of xdt, b, c and y are
// contiguous (no alignment needed). Scratch, with nc = ceil(S / Q): cum
// B H nc Q floats, cbt B G nc Q Q floats, states B H nc N P floats (the
// state after each chunk, read back by the tests). Returns the
// cudaError_t of the launches (0 = success); a shape the kernels cannot
// hold gives cudaErrorInvalidValue.
int ssd_wide_launch(const void* xdt, const void* loga, const void* b, const void* c, void* y,
                    void* s_fin, void* cum, void* cbt, void* states,
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
  p.nc = (p.S + p.Q - 1) / p.Q;
  p.hg = p.H / p.G;
  p.xdt = static_cast<const float*>(xdt);
  p.loga = static_cast<const float*>(loga);
  p.bm = static_cast<const float*>(b);
  p.cm = static_cast<const float*>(c);
  p.y = static_cast<float*>(y);
  p.s_fin = static_cast<float*>(s_fin);
  p.cum = static_cast<float*>(cum);
  p.cbt = static_cast<float*>(cbt);
  p.states = static_cast<float*>(states);
  p.xb = strides[0]; p.xh = strides[1]; p.xs = strides[2];
  p.lb = strides[3]; p.lh = strides[4]; p.ls = strides[5];
  p.bb = strides[6]; p.bg = strides[7]; p.bs = strides[8];
  p.cb = strides[9]; p.cg = strides[10]; p.cs = strides[11];
  p.yb = strides[12]; p.yh = strides[13]; p.ys = strides[14];

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned qt = (p.Q + kTile - 1) / kTile;
  const unsigned nt = (p.N + kTile - 1) / kTile, pt = (p.P + kTile - 1) / kTile;
  const unsigned rows = (unsigned)(p.B * p.H), groups = (unsigned)(p.B * p.G);
  cudaError_t err;
  wide_cum_kernel<<<rows * p.nc, kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wide_cb_kernel<<<dim3(groups * p.nc, qt * (qt + 1) / 2), kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wide_state_kernel<<<dim3(rows, nt, pt), kThreads, 0, st>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wide_out_kernel<<<dim3(rows * p.nc, qt, pt), kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

const char* ssd_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
