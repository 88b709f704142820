// Fused SGNS lifetime update (paper §4.2-I/II) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/sgns/kernel.py
// (_sgns_kernel, launched by sgns_lifetime_pallas). It computes what
// src/repro_torch/kernels/sgns/ref.py computes: for each position p of a
// lifetime of W walks, with R = W*2w context rows and NC = W+K target
// columns,
//     logits = clip(C . T^T, +-6)           C: context rows (phi_in)
//     g      = (onehot - sigmoid) * masks   T: [W targets ; K negatives] (phi_out)
//     C += lr * g T ;  T += lr * g^T C_old  both from the old values
// plus the summed BCE loss.
//
// Design: one CTA per lifetime. The lifetime's W*T*d context rows live in
// dynamic shared memory for the whole loop over positions (100 KB at
// W=2, T=100, d=128) and go back to global memory once at the end. The
// target and negative rows are touched at one position only, so they are
// read from global memory at that position and written back there. Per
// position: one warp per context row computes its NC dot products (f32
// FMA, no TF32) and the gradient coefficients into shared memory; a
// barrier; T's update is formed from the old C; a barrier; C and T are
// updated. The loss is accumulated per thread and reduced once per CTA.
// Masked pairs contribute exactly zero, so masked rows are skipped, and a
// position where no walk has a valid target is the identity: the target
// and negative rows are copied through in one bulk pass at the start (16
// bytes per access), and the loop skips such positions. Walks end early
// (-1 padding), so the work follows the valid tokens.
//
// What bounds it: at the paper width a launch reads and writes ~59 MB and
// does ~1.4 GFLOP of f32 FMA; the positions are a serial chain with four
// barriers each, so a simple CTA like this one is latency-bound well
// above either limit. Later work: a ring of 2w+1 rows per walk instead of
// the whole lifetime, prefetch of the next position's rows.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCols = 16;     // W + K
constexpr float kMaxExp = 6.0f;
constexpr float kEps = 1e-7f;

__host__ __device__ inline size_t smem_bytes(int W, int T, int D, int K, int win) {
  const size_t nc = W + K, r = (size_t)W * 2 * win;
  const size_t floats = (size_t)W * T * D   // C: context rows, resident
                        + 2 * nc * D         // T rows and their update
                        + r * nc             // gradient coefficients
                        + r + nc + 32;       // row mask, column mask, loss
  const size_t ints = r + (size_t)W * T;     // row slot, valid flags
  return floats * sizeof(float) + ints * sizeof(int);
}

// n floats from src to dst by the whole block; 16 bytes per access where
// both ends are aligned, so each thread keeps several loads in flight.
__device__ inline void block_copy(float* __restrict__ dst, const float* __restrict__ src,
                                  int n) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const int n4 = n >> 2;
#pragma unroll 4
    for (int e = threadIdx.x; e < n4; e += blockDim.x) d4[e] = s4[e];
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

__global__ void __launch_bounds__(kThreads)
sgns_lifetime_kernel(const float* __restrict__ ctx, const float* __restrict__ out,
                     const float* __restrict__ neg, const int* __restrict__ valid,
                     float* __restrict__ ctx_o, float* __restrict__ out_o,
                     float* __restrict__ neg_o, float* __restrict__ loss,
                     int W, int T, int D, int K, int win, float lr) {
  extern __shared__ __align__(16) float smem[];
  const int NC = W + K;
  const int span = 2 * win;
  const int R = W * span;
  float* C = smem;                          // (W*T, D)
  float* Tr = C + (size_t)W * T * D;        // (NC, D)
  float* dT = Tr + NC * D;                  // (NC, D)
  float* Gm = dT + NC * D;                  // (R, NC)
  float* rowm = Gm + R * NC;                // (R,)
  float* colm = rowm + R;                   // (NC,)
  float* red = colm + NC;                   // (32,)
  int* rowpos = reinterpret_cast<int*>(red + 32);  // (R,) slot in C, -1 if outside
  int* vld = rowpos + R;                    // (W*T,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  const size_t g = blockIdx.x;
  const size_t wt_base = g * W * T * D;     // ctx / out offset of this lifetime
  const size_t neg_base = g * T * K * D;

  block_copy(C, ctx + wt_base, W * T * D);
  block_copy(out_o + wt_base, out + wt_base, W * T * D);   // rows the loop skips
  block_copy(neg_o + neg_base, neg + neg_base, T * K * D);
  for (int e = tid; e < W * T; e += nthr) vld[e] = valid[g * W * T + e];
  float my_loss = 0.f;
  __syncthreads();

  for (int p = 0; p < T; ++p) {
    // No walk has a valid target here: every pair is masked, the update is
    // the identity, and the rows were copied through already.
    bool any_target = false;
    for (int w = 0; w < W; ++w) any_target |= vld[w * T + p] != 0;
    if (!any_target) continue;                  // block-uniform

    // 1. Window bookkeeping and this position's target / negative rows.
    for (int r = tid; r < R; r += nthr) {
      const int w = r / span, j = r - w * span;
      const int idx = p + (j < win ? j - win : j - win + 1);
      const bool inb = idx >= 0 && idx < T;
      rowpos[r] = inb ? w * T + idx : -1;
      rowm[r] = (inb && vld[w * T + idx] && vld[w * T + p]) ? 1.f : 0.f;
    }
    for (int c = tid; c < NC; c += nthr) colm[c] = c < W ? (vld[c * T + p] ? 1.f : 0.f) : 1.f;
    for (int e = tid; e < NC * D; e += nthr) {
      const int c = e / D, k = e - c * D;
      Tr[e] = c < W ? out[wt_base + ((size_t)c * T + p) * D + k]
                    : neg[neg_base + ((size_t)p * K + (c - W)) * D + k];
    }
    __syncthreads();

    // 2. One warp per context row: its NC logits, gradient coefficients, loss.
    for (int r = warp; r < R; r += nwarps) {
      if (rowm[r] == 0.f) {                      // warp-uniform
        if (lane < NC) Gm[r * NC + lane] = 0.f;
        continue;
      }
      const float* crow = C + (size_t)rowpos[r] * D;
      float acc[kMaxCols];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[c] = 0.f;
      for (int k = lane; k < D; k += 32) {
        const float cv = crow[k];
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c)
          if (c < NC) acc[c] = fmaf(cv, Tr[c * D + k], acc[c]);
      }
      float mine = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c < NC) {
          float v = acc[c];
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
          if (lane == c) mine = v;
        }
      }
      if (lane < NC) {
        const float m = colm[lane];              // rowm[r] == 1 here
        const float logit = fminf(fmaxf(mine, -kMaxExp), kMaxExp);
        const float sig = 1.f / (1.f + expf(-logit));
        const float y = (lane == r / span) ? 1.f : 0.f;
        Gm[r * NC + lane] = (y - sig) * m;
        my_loss += -(y * logf(sig + kEps) + (1.f - y) * logf(1.f - sig + kEps)) * m;
      }
    }
    __syncthreads();

    // 3. dT = lr * g^T C_old, before C changes.
    for (int e = tid; e < NC * D; e += nthr) {
      const int c = e / D, k = e - c * D;
      float a = 0.f;
      for (int r = 0; r < R; ++r)       // masked rows have g == 0
        if (rowm[r] != 0.f) a = fmaf(Gm[r * NC + c], C[(size_t)rowpos[r] * D + k], a);
      dT[e] = a * lr;
    }
    __syncthreads();

    // 4. C += lr * g T_old (rows of one position are distinct), T += dT.
    for (int e = tid; e < R * D; e += nthr) {
      const int r = e / D, k = e - r * D;
      if (rowm[r] == 0.f) continue;       // g == 0: the row keeps its value
      float a = 0.f;
      for (int c = 0; c < NC; ++c) a = fmaf(Gm[r * NC + c], Tr[c * D + k], a);
      C[(size_t)rowpos[r] * D + k] += a * lr;
    }
    for (int e = tid; e < NC * D; e += nthr) {
      const int c = e / D, k = e - c * D;
      const float v = Tr[e] + dT[e];
      if (c < W) out_o[wt_base + ((size_t)c * T + p) * D + k] = v;
      else neg_o[neg_base + ((size_t)p * K + (c - W)) * D + k] = v;
    }
    __syncthreads();
  }

  block_copy(ctx_o + wt_base, C, W * T * D);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) my_loss += __shfl_xor_sync(0xffffffffu, my_loss, s);
  if (lane == 0) red[warp] = my_loss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < nwarps; ++i) s += red[i];
    loss[g] = s;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the caller refuses shapes above
// the card's per-block limit.
size_t sgns_lifetime_smem_bytes(int W, int T, int D, int K, int window) {
  return smem_bytes(W, T, D, K, window);
}

int sgns_lifetime_max_cols() { return kMaxCols; }

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int sgns_lifetime_launch(const float* ctx, const float* out, const float* neg,
                         const int* valid, float* ctx_o, float* out_o, float* neg_o,
                         float* loss, int G, int W, int T, int D, int K, int window,
                         float lr, void* stream) {
  const size_t smem = smem_bytes(W, T, D, K, window);
  cudaError_t err = cudaFuncSetAttribute(
      sgns_lifetime_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgns_lifetime_kernel<<<G, kThreads, smem, (cudaStream_t)stream>>>(
      ctx, out, neg, valid, ctx_o, out_o, neg_o, loss, W, T, D, K, window, lr);
  return (int)cudaGetLastError();
}

const char* sgns_lifetime_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
