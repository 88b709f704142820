// Order-pinned dot products of rows of phi, for the embedding server.
//
// A score is sum_j a[j] * b[j] taken as the NumPy oracle takes it: the
// products rounded one by one, then added left to right. Every thread owns
// whole (query, vertex) chains: acc starts at -0.0f (the identity of IEEE
// addition: -0 + x == x for every x, -0 and +0 included) and takes
// acc = __fadd_rn(acc, __fmul_rn(a[j], b[j])) for j = 0 .. d-1 in order.
// nvcc never contracts the _rn intrinsics into an FMA, so the scores equal
// the oracle's bit for bit. The build keeps subnormals (no -ftz, no fast
// math), as NumPy does.
//
// Two kernels, one per scoring form:
//   chain_dot_all_kernel  (B,) queries x every vertex -> (B, N): a block of
//       TILE vertices stages their rows in shared memory, DK columns at a
//       time, and loops over the wave's queries in groups of QG (staged
//       beside them), so phi is read once a wave. Across column chunks
//       (d > DK) a chain's partial sum waits in the output row.
//   chain_dot_pair_kernel (B,) queries x (B, C) candidates -> (B, C): a
//       block of TILE candidates of one query gathers their rows the same
//       way; each thread's chain stays in a register.
// Row strides in shared memory are DK + 4 floats: 16-byte aligned rows
// whose float4 reads fall on distinct banks within each quarter warp.
// Ids are int64 and normalised as a JAX gather normalises them (negative
// from the end, then clamped into [0, N)); every offset is int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;             // vertices (candidates) per block, one thread each
constexpr int DK = 128;               // columns per staged chunk
constexpr int STRIDE = DK + 4;        // floats per staged row
constexpr int MAX_QG = 32;            // queries per register group

__device__ __forceinline__ int64_t row_of(int64_t id, int64_t n) {
  if (id < 0) id += n;
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ float step(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// Chains of QG queries (staged at qs) against the row at `row`, over `len`
// columns, in column order.
template <int QG>
__device__ __forceinline__ void chain_group(float (&acc)[QG], const float* row,
                                            const float* qs, int len) {
  int j = 0;
  for (; j + 4 <= len; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + j);
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      const float4 y = *reinterpret_cast<const float4*>(qs + q * STRIDE + j);
      acc[q] = step(acc[q], y.x, x.x);
      acc[q] = step(acc[q], y.y, x.y);
      acc[q] = step(acc[q], y.z, x.z);
      acc[q] = step(acc[q], y.w, x.w);
    }
  }
  for (; j < len; ++j) {
    const float x = row[j];
#pragma unroll
    for (int q = 0; q < QG; ++q) acc[q] = step(acc[q], qs[q * STRIDE + j], x);
  }
}

template <int QG>
__global__ void __launch_bounds__(TILE)
chain_dot_all_kernel(const float* __restrict__ phi, const int64_t* __restrict__ u,
                     float* __restrict__ out, int64_t n, int64_t d, int64_t b) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                     // [TILE][STRIDE]
  float* qs = smem + TILE * STRIDE;       // [QG][STRIDE]
  const int t = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int rows = static_cast<int>(n - v0 < TILE ? n - v0 : TILE);
  const int64_t v = v0 + t;
  const float* row = tile + t * STRIDE;
  for (int64_t c0 = 0; c0 < d; c0 += DK) {
    const int len = static_cast<int>(d - c0 < DK ? d - c0 : DK);
    __syncthreads();                      // the last chunk's readers are done
    for (int e = t; e < rows * len; e += TILE) {
      const int r = e / len, j = e - r * len;
      tile[r * STRIDE + j] = phi[(v0 + r) * d + c0 + j];
    }
    for (int64_t g0 = 0; g0 < b; g0 += QG) {
      const int nq = static_cast<int>(b - g0 < QG ? b - g0 : QG);
      __syncthreads();
      for (int e = t; e < QG * len; e += TILE) {
        const int q = e / len, j = e - q * len;
        qs[q * STRIDE + j] = q < nq ? phi[row_of(u[g0 + q], n) * d + c0 + j] : 0.0f;
      }
      __syncthreads();
      float acc[QG];
#pragma unroll
      for (int q = 0; q < QG; ++q)
        acc[q] = (c0 == 0 || q >= nq || t >= rows) ? -0.0f : out[(g0 + q) * n + v];
      chain_group<QG>(acc, row, qs, len);
      if (t < rows) {
#pragma unroll
        for (int q = 0; q < QG; ++q)
          if (q < nq) out[(g0 + q) * n + v] = acc[q];
      }
    }
  }
}

__global__ void __launch_bounds__(TILE)
chain_dot_pair_kernel(const float* __restrict__ phi, const int64_t* __restrict__ u,
                      const int64_t* __restrict__ cand, float* __restrict__ out, int64_t n,
                      int64_t d, int64_t c, int64_t blocks_per_query) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                     // [TILE][STRIDE]
  float* qrow = smem + TILE * STRIDE;     // [STRIDE]
  __shared__ int64_t base[TILE];          // each candidate's row offset
  const int t = threadIdx.x;
  const int64_t q = blockIdx.x / blocks_per_query;
  const int64_t i0 = (blockIdx.x % blocks_per_query) * TILE;
  const int rows = static_cast<int>(c - i0 < TILE ? c - i0 : TILE);
  const int64_t qbase = row_of(u[q], n) * d;
  if (t < rows) base[t] = row_of(cand[q * c + i0 + t], n) * d;
  float acc[1] = {-0.0f};
  for (int64_t c0 = 0; c0 < d; c0 += DK) {
    const int len = static_cast<int>(d - c0 < DK ? d - c0 : DK);
    __syncthreads();                      // base[] written; the last chunk's readers done
    for (int e = t; e < rows * len; e += TILE) {
      const int r = e / len, j = e - r * len;
      tile[r * STRIDE + j] = phi[base[r] + c0 + j];
    }
    for (int j = t; j < len; j += TILE) qrow[j] = phi[qbase + c0 + j];
    __syncthreads();
    chain_group<1>(acc, tile + t * STRIDE, qrow, len);
  }
  if (t < rows) out[q * c + i0 + t] = acc[0];
}

template <int QG>
constexpr size_t all_smem() { return sizeof(float) * (TILE + QG) * STRIDE; }

constexpr size_t PAIR_SMEM = sizeof(float) * (TILE + 1) * STRIDE;

template <int QG>
cudaError_t launch_all(const float* phi, const int64_t* u, float* out, int64_t n, int64_t d,
                       int64_t b, cudaStream_t stream) {
  const int64_t blocks = (n + TILE - 1) / TILE;
  chain_dot_all_kernel<QG><<<static_cast<unsigned>(blocks), TILE, all_smem<QG>(), stream>>>(
      phi, u, out, n, d, b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lifts the dynamic shared memory limit of every kernel above 48 KB.
int chain_dot_init() {
  cudaError_t err = cudaFuncSetAttribute(chain_dot_pair_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(PAIR_SMEM));
#define CHAIN_DOT_ALLOW(QG)                                                              \
  if (err == cudaSuccess)                                                                \
    err = cudaFuncSetAttribute(chain_dot_all_kernel<QG>,                                 \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,              \
                               static_cast<int>(all_smem<QG>()));
  CHAIN_DOT_ALLOW(1)
  CHAIN_DOT_ALLOW(4)
  CHAIN_DOT_ALLOW(8)
  CHAIN_DOT_ALLOW(16)
  CHAIN_DOT_ALLOW(32)
#undef CHAIN_DOT_ALLOW
  return static_cast<int>(err);
}

// out (B, N) = the chain of every query row u[i] against every row of phi (N, d).
int chain_dot_all_launch(const float* phi, const int64_t* u, float* out, int64_t n, int64_t d,
                         int64_t b, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b <= 1) err = launch_all<1>(phi, u, out, n, d, b, s);
  else if (b <= 4) err = launch_all<4>(phi, u, out, n, d, b, s);
  else if (b <= 8) err = launch_all<8>(phi, u, out, n, d, b, s);
  else if (b <= 16) err = launch_all<16>(phi, u, out, n, d, b, s);
  else err = launch_all<MAX_QG>(phi, u, out, n, d, b, s);
  return static_cast<int>(err);
}

// out (B, C) = the chain of query row u[i] against the rows cand[i, :].
int chain_dot_pair_launch(const float* phi, const int64_t* u, const int64_t* cand, float* out,
                          int64_t n, int64_t d, int64_t b, int64_t c, void* stream) {
  const int64_t per_query = (c + TILE - 1) / TILE;
  chain_dot_pair_kernel<<<static_cast<unsigned>(b * per_query), TILE, PAIR_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(phi, u, cand, out, n, d, c,
                                                               per_query);
  return static_cast<int>(cudaGetLastError());
}

const char* chain_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
