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
// h / (Hq / Hkv) directly: no repeat is materialised.
//
// Design (a first, simple kernel): one CTA of 128 threads per
// (b * Hq + h, tile of BQ queries), looping over tiles of 32 keys. A tile
// of K and of V is staged in shared memory as float32 (32 KB at D = 128),
// shared by the CTA's queries. TPR threads (8, or 4 at D = 16 and 112)
// share one query row: each holds D/TPR of its dimensions (interleaved
// in 16-byte pieces, so the loads of one row hit distinct banks) for two
// query rows, scores
// 8 keys at a time with f32 FMA, sums the partial dots with warp shuffles,
// and applies one online-softmax update per 8 keys. P stays float32 for
// P.V, as in the TPU kernel. Key tiles strictly above the diagonal are
// never loaded; ragged Sq and Skv are read with bounds checks instead of
// padding. Query tiles are scheduled heaviest first under the causal mask.
//
// What bounds it: at the serving prefill shape (B = 4, Hq = 16, Hkv = 8,
// S = 2,048, D = 128, causal) the work is ~69 GFLOP of products against
// ~50 MB of q, k, v and o, so the tensor cores' rate bounds it (~0.07 ms
// at 989 TFLOP/s). This kernel runs on the f32 FMA units instead, well
// above that bound; wgmma tiles with TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;        // query rows per thread
constexpr int kBlockK = 32;     // keys per shared-memory tile
constexpr int kChunk = 8;       // keys scored before one softmax update
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
struct Layout {
  // Threads per query row: the largest power of two up to 8 that divides
  // the row's D/4 16-byte pieces (4 at D = 16 and D = 112, else 8), so the
  // partial dots of one row sum over aligned lanes by xor shuffles.
  static constexpr int TPR =
      (D / 4) % 8 == 0 ? 8 : (D / 4) % 4 == 0 ? 4 : (D / 4) % 2 == 0 ? 2 : 1;
  static constexpr int NV = D / (4 * TPR);              // 16-byte pieces per thread
  static constexpr int GROUPS = kThreads / TPR;         // row groups per CTA
  static constexpr int BQ = GROUPS * kRows;             // query rows per CTA
  static_assert(D % (4 * TPR) == 0, "D must be a multiple of 16");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int Hq, int Hkv, int Sq, int Skv, int causal,
             int q_offset, float sm_scale) {
  using L = Layout<D>;
  constexpr int TPR = L::TPR, NV = L::NV, GROUPS = L::GROUPS, BQ = L::BQ;
  constexpr int DV = D / 4;     // 16-byte pieces per row

  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

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

  for (int kt = 0; kt < kv_end; kt += kBlockK) {
    __syncthreads();                         // the previous tile is consumed
    for (int idx = tid; idx < kBlockK * DV; idx += kThreads) {
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
    const int n_keys = min(kBlockK, kv_end - kt);

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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; dtype 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 = success); an unsupported head dimension
// or type gives cudaErrorInvalidValue.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                           int q_offset, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dim<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset, sm_scale, s);
  if (dtype == 1)
    return (int)launch_dim<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, q_offset,
                                          sm_scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
