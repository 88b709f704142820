// Chunked SSD scan (Mamba2's selective state-space prefill) for NVIDIA
// Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (_ssd_kernel, launched by ssd_chunked_pallas) together with its wrapper
// ops.py::ssd_chunked_scan. For xdt (BH, S, P), loga (BH, S) and b, c
// (BH, S, N), all float32 and contiguous, it walks each row in chunks of
// Q steps with the (N x P) state S carried from chunk to chunk:
//     cum    = inclusive cumsum of loga over the chunk
//     y      = ((C B^T) . L) xdt + (C . exp(cum)) S_prev,
//              L[i][j] = exp(cum_i - cum_j) for j <= i, else 0
//     S_next = exp(cum_Q) S_prev + (B . exp(cum_Q - cum))^T xdt
// and returns y (BH, S, P) and the final state (BH, N, P), both float32.
// The last chunk may be ragged: its steps past S are read as loga = 0 and
// xdt = b = c = 0, which is what the reference's padding gives (cum_Q is
// then the cumsum at the last valid step, and those steps add nothing).
//
// Design (a first, simple kernel): one CTA of 256 threads per BH row
// loops over the row's chunks, the carried state resident in shared
// memory: on the TPU the state was VMEM scratch carried along a
// sequential grid axis, but Hopper runs blocks in no order, so the loop
// lives inside the block. Per chunk: the chunk's xdt, and B and C
// transposed (rows padded by one float, so that the tiles' reads hit
// distinct banks), are staged in shared memory; warp 0 computes cum by
// an inclusive warp scan; then three register-tiled products on the f32
// FMA units, each thread holding a tile of outputs (rows ty + 16a,
// columns tx + 16b of a 16 x 16 thread grid): the scores C B^T (8 x 8 per
// thread) into a (Q x Q) tile, where the upper triangle is set to 0
// without evaluating exp(cum_i - cum_j), which overflows to inf there
// (cum falls by ~100 over a 128-step chunk at Mamba2's init, and inf * 0
// would be NaN); y (8 x 4 per thread), the carried state's part first;
// the next state (4 x 4 per thread) from B scaled by exp(cum_Q - cum).
// f32 FMA throughout, no TF32, and expf (not __expf) for the decays.
// Chunks up to 128; shared memory is dynamic,
// 4 (QP + 2N(Q+1) + Q(Q+1) + NP + 3Q) bytes, 183 KB at Q = 128 and
// N = P = 64; a chunk that does not fit is refused by the wrapper. The
// first version, one output per thread, took 8.0 ms at the shape below
// against this one's 4.1 ms (H100, PERF.md).
//
// What bounds it: at Mamba2's prefill shape (BH = 448, S = 1,819,
// N = P = 64, Q = 128) the function reads xdt, B, C and loga and writes y
// and the state once, ~845 MB (0.25 ms at 3.35 TB/s), against ~28 GFLOP of
// products in the lower triangle (0.06 ms at the 495 TFLOP/s TF32 rate),
// so bytes bound it. This kernel runs its products on the f32 FMA units
// out of shared memory, the full (Q x Q) tiles and not only their lower
// triangles, with one 183 KB CTA per SM, well above that bound; wgmma on
// the chunk products, TMA loads and several rows per CTA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 16;           // the block's threads as a 16 x 16 grid (ty, tx)
constexpr int kMaxQ = 128;       // longest chunk: scores tiles of 8 x 8 per thread

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xdt, const float* __restrict__ loga,
                const float* __restrict__ bmat, const float* __restrict__ cmat,
                float* __restrict__ y, float* __restrict__ s_fin, int S, int P, int N,
                int Q) {
  extern __shared__ __align__(16) float smem[];
  const int lq = Q + 1;              // padded row length of the (., Q) tiles
  float* xs = smem;                  // (Q, P) xdt of the chunk
  float* bt = xs + Q * P;            // (N, Q + 1) B transposed; scaled by wdec for the state
  float* ct = bt + N * lq;           // (N, Q + 1) C transposed
  float* sc = ct + N * lq;           // (Q, Q + 1) masked scores
  float* st = sc + Q * lq;           // (N, P) carried state
  float* cum = st + N * P;           // (Q,) inclusive cumsum of loga
  float* ecum = cum + Q;             // (Q,) exp(cum)
  float* wdec = ecum + Q;            // (Q,) exp(cum_Q - cum)

  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const size_t row = blockIdx.x;
  const float* xr = xdt + row * S * P;
  const float* lr = loga + row * S;
  const float* br = bmat + row * S * N;
  const float* cr = cmat + row * S * N;
  float* yr = y + row * S * P;

  for (int idx = tid; idx < N * P; idx += kThreads) st[idx] = 0.f;

  const int nc = (S + Q - 1) / Q;
  for (int ic = 0; ic < nc; ++ic) {
    const int t0 = ic * Q;
    const int valid = min(Q, S - t0);
    __syncthreads();                 // the previous chunk's state update is done
    for (int idx = tid; idx < Q * P; idx += kThreads) {
      const int t = idx / P;
      xs[idx] = t < valid ? xr[(size_t)(t0 + t) * P + idx % P] : 0.f;
    }
    for (int idx = tid; idx < Q * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      const bool ok = t < valid;
      bt[n * lq + t] = ok ? br[(size_t)(t0 + t) * N + n] : 0.f;
      ct[n * lq + t] = ok ? cr[(size_t)(t0 + t) * N + n] : 0.f;
    }
    if (tid < 32) {
      // Inclusive scan over Q steps: each lane sums a run of consecutive
      // steps, then the lanes' totals are scanned with shuffles.
      const int per = (Q + 31) / 32;
      const int lo = tid * per;
      float run = 0.f;
      for (int t = lo; t < min(lo + per, Q); ++t) {
        run += t < valid ? lr[t0 + t] : 0.f;
        cum[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int t = lo; t < min(lo + per, Q); ++t) cum[t] += excl;
    }
    __syncthreads();
    const float total = cum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      ecum[t] = expf(cum[t]);
      wdec[t] = expf(total - cum[t]);
    }
    {
      // Scores: each thread an 8 x 8 tile of rows ty + 16a, columns
      // tx + 16b. Above the diagonal the tile takes 0 by selection: the
      // decay exp(cum_i - cum_j) overflows there and is never evaluated.
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ty + kT * a;
          cv[a] = i < Q ? ct[n * lq + i] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < 8; ++b) bv[b] = (tx + kT * b) < Q ? bt[n * lq + tx + kT * b] : 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(cv[a], bv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + kT * a;
        if (i >= Q) continue;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const int j = tx + kT * b;
          if (j < Q) sc[i * lq + j] = j <= i ? acc[a][b] * expf(cum[i] - cum[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    // B scaled by exp(cum_Q - cum) for the state update (the scores are done with B).
    for (int idx = tid; idx < N * Q; idx += kThreads) {
      const int n = idx / Q, t = idx % Q;
      bt[n * lq + t] *= wdec[t];
    }
    // y: each thread an 8 x 4 tile of rows ty + 16a, columns p0 + tx + 16b;
    // first the carried state's part (C S_prev, times exp(cum_i)), then the
    // chunk's own steps ((C B^T . L) xdt).
    for (int p0 = 0; p0 < P; p0 += 4 * kT) {
      float acc[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ty + kT * a;
          cv[a] = i < Q ? ct[n * lq + i] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = p0 + tx + kT * b;
          sv[b] = p < P ? st[n * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cv[a], sv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + kT * a;
        const float e = i < Q ? ecum[i] : 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] *= e;
      }
      for (int j = 0; j < valid; ++j) {
        float sv[8], xv[4];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const int i = ty + kT * a;
          sv[a] = i < Q ? sc[i * lq + j] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = p0 + tx + kT * b;
          xv[b] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(sv[a], xv[b], acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ty + kT * a;
        if (i >= valid) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = p0 + tx + kT * b;
          if (p < P) yr[(size_t)(t0 + i) * P + p] = acc[a][b];
        }
      }
    }
    __syncthreads();                 // every y has read the previous state
    // Next state: each thread a 4 x 4 tile of (n0 + ty + 16a, p0 + tx + 16b).
    const float etot = expf(total);
    for (int n0 = 0; n0 < N; n0 += 4 * kT) {
      for (int p0 = 0; p0 < P; p0 += 4 * kT) {
        float acc[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
        for (int t = 0; t < valid; ++t) {
          float bv[4], xv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int n = n0 + ty + kT * a;
            bv[a] = n < N ? bt[n * lq + t] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = p0 + tx + kT * b;
            xv[b] = p < P ? xs[t * P + p] : 0.f;
          }
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(bv[a], xv[b], acc[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int n = n0 + ty + kT * a;
          if (n >= N) continue;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = p0 + tx + kT * b;
            if (p < P) st[n * P + p] = fmaf(etot, st[n * P + p], acc[a][b]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* sr = s_fin + row * N * P;
  for (int idx = tid; idx < N * P; idx += kThreads) sr[idx] = st[idx];
}

size_t smem_bytes(int Q, int N, int P) {
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)N * (Q + 1) + (size_t)Q * (Q + 1) +
                          (size_t)N * P + 3 * (size_t)Q);
}

}  // namespace

extern "C" {

// Launch on `stream`: one CTA per row of BH, chunk length Q (<= S and
// <= 128). Returns the cudaError_t of the launch (0 = success); a shape
// the kernel cannot hold gives cudaErrorInvalidValue.
int ssd_scan_launch(const void* xdt, const void* loga, const void* b, const void* c, void* y,
                    void* s_fin, int BH, int S, int P, int N, int Q, void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || Q <= 0 || Q > S || Q > kMaxQ)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<BH, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(loga),
      static_cast<const float*>(b), static_cast<const float*>(c), static_cast<float*>(y),
      static_cast<float*>(s_fin), S, P, N, Q);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
