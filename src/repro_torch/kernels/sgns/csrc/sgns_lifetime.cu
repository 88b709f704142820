// Fused SGNS lifetime update (paper §4.2-I/II) for NVIDIA Hopper, sm_90a,
// and the duplicate-averaged write-back around it: the whole DSGL step.
//
// Replaces the TPU kernel src/repro/kernels/sgns/kernel.py (_sgns_kernel,
// launched by sgns_lifetime_pallas). For each lifetime of W walks x T
// positions it computes what src/repro_torch/kernels/sgns/ref.py computes:
// at each position p, with R = W*2w context rows C (the window of p in each
// walk, rows of phi_in) and NC = W+K columns T (the W targets at p and the
// K negatives of p, rows of phi_out),
//     logits = clip(C . T^T, +-6)           g = (onehot - sigmoid) * masks
//     C += lr * g T ;  T += lr * g^T C_old  both from the old values
// plus the summed BCE loss. Every (walk, position) slot and every
// (position, k) negative slot is its own copy of its row, taken when the
// step starts; the kernel writes each live slot's delta (final minus
// initial) into scratch. The write-back into phi (sgns_writeback_kernel,
// then sgns_clear_kernel) is a separate launch: every lifetime must read
// its rows before any row of phi changes.
//
// What bounds it. A yt-sim step (64 lifetimes, T = 100, d = 128, walks of
// 12 tokens on average) needs ~8 MB of live rows read and their deltas
// written and ~0.1 GFLOP of f32 FMA: a few microseconds at the card's
// limits. A lifetime is a serial chain over its positions, so a launch
// lasts as long as its longest lifetime, and the cost per position is
// latency: the rows' chains of shuffles and FMAs, the sum of the warps'
// g^T C partials, the barrier and the copies' issue. The shared-memory
// pipe carries the T rows into every warp that has a row (3.5 KB each),
// the partials out and back (2 x 57 KB) and the shuffles.
//
// Design: one CTA per lifetime.
// - Rows are gathered by id (walk_ids, neg_ids; validity is id >= 0) from
//   three row tables: phi_in / phi_out / phi_out in the fused step, the
//   gathered buffers with identity ids for sgns_lifetime_batch.
// - Only the lifetime's extent [lo, hi] (the positions where some walk has
//   a valid target) is visited; dead positions inside it only move the ring.
// - Context slots live in a ring of 2w + 1 + kPrefetch slots per walk. Slot q
//   is copied in when position q - w is reached and written out (its delta)
//   once position q + w is done. The ring keeps the initial value (phi does
//   not change during the launch); the current value lives in registers of
//   the warp that owns the ring slot: one float4 per lane (d <= 128).
// - Rows arrive by cp.async (16 bytes a lane, a row a warp; the rows of a
//   position spread over the warps) into shared memory, completing on one
//   mbarrier per position (cp.async.mbarrier.arrive). Position p +
//   kPrefetch is issued when p starts, so its rows land while p and p + 1
//   compute. Target and negative rows are used at one position only:
//   loaded ahead, used once, their delta written out. (One cp.async.bulk
//   per row, all issued by one warp, was slower: the issue serialises on
//   that warp.)
// - Per position and row, the warp that owns the row computes its NC
//   logits: 4 FMAs a lane, then a transposing reduction (NC values summed
//   over 32 lanes in 9 shuffles for NC <= 8, lane l ends with column
//   l >> 2), the sigmoid once per column, the gradient broadcast back
//   (NC shuffles), and the C update in registers. g^T C_old is a partial
//   per warp in shared memory, summed across warps after the position's
//   one block barrier; double-buffered, so one barrier per position.
// - No tensor cores: the products are 40x128 by 128x7 and 7x40 by 40x128,
//   below one wgmma tile, and their latency, not FLOPs, bounds them; TF32
//   would put the 5e-4 tolerance at risk. f32 FMA throughout.
// - The write-back (sgns_wb_keys_kernel, a stable sort of its keys, then
//   sgns_wb_segments_kernel) adds the deltas in a fixed order, so the same
//   step from the same state gives the same phi on every run. Each slot
//   gets a key: its row (phi_in rows first, then phi_out's), or a sentinel
//   for a dead walk slot. The keys sit in the reference's slot order
//   (context slots for phi_in; target slots, then negative slots for
//   phi_out), and a stable sort keeps that order within a row. For each
//   row segment (a run of one key) delta / count is added in that order
//   into the row, which is written once: eight lanes per segment of up to
//   32 slots, a CTA per longer one (a hub's row, hundreds or thousands of
//   slots, staged through shared memory). count is the segment's length,
//   which is the reference's duplicate count (phi_in: valid walk tokens;
//   phi_out: valid walk tokens plus every negative slot, also at dead
//   positions, whose deltas are not added). The sort is a library call;
//   every size is static, so a CUDA graph captures the step. The order
//   costs: the atomic adds it replaced took a tenth of the time (PERF.md).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kPrefetch = 2;               // positions in flight ahead of the one computed
constexpr int kStages = kPrefetch + 1;     // row buffers and mbarriers
constexpr int kMaxCols = 16;               // W + K
constexpr int kMaxRing = 64;               // W * (2w + 1 + kPrefetch) context slots
constexpr int kMaxDim = 128;               // one float4 per lane
constexpr int kSmemMax = 232448;
constexpr float kMaxExp = 6.0f;
constexpr float kEps = 1e-7f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDeadKey = 0x7fffffff;        // a write-back key that sorts after every row
constexpr int kGroup = 8;                   // lanes per short write-back segment
constexpr int kWbBatch = 2;                 // rows a write-back group loads ahead
constexpr int kWbShort = 32;                // longer segments go to the CTA kernel
constexpr int kLongRows = 128;              // slots a long-segment stage holds
constexpr int kLongThreads = 256;
constexpr int kLongCtas = 132;              // one per SM

// Warps per CTA and ring slots per warp for up to NCP columns; both cover
// kMaxRing slots. 8 columns keep the T rows and g^T C partials of a lane
// in 64 registers, so 16 warps fit; 16 columns need twice that.
template <int NCP> struct Shape;
template <> struct Shape<8> { static constexpr int kWarps = 16, kSlots = 4, kShift = 2; };
template <> struct Shape<16> { static constexpr int kWarps = 8, kSlots = 8, kShift = 1; };

struct Args {
  const float* ctx_src;   // context rows (phi_in, or the context buffer)
  const float* out_src;   // target rows (phi_out, or the target buffer)
  const float* neg_src;   // negative rows (phi_out, or the negative buffer)
  const int* walk_ids;    // (L, W, T) row of each walk slot in ctx_src and out_src, -1 = none
  const int* neg_ids;     // (L, T, K) row of each negative slot in neg_src
  long long rep_rows;     // rows per replica: lifetime l reads rows of replica l / per_rep
  int per_rep;
  float* d_ctx;           // (L, W, T, D) deltas, written for live slots only
  float* d_out;           // (L, W, T, D)
  float* d_neg;           // (L, T, K, D)
  float* loss;            // (L,)
  const float* lr;        // device scalar
  int W, T, D, K, win;
};

struct Layout {
  size_t ring, tbuf, part, wid, nid, live, red, total;
};

__host__ __device__ inline Layout layout(int W, int T, int D, int K, int win, int warps) {
  Layout s;
  const size_t nc = W + K, slots = (size_t)W * (2 * win + 1 + kPrefetch), row = (size_t)D * 4;
  size_t o = 64;                               // kStages mbarriers, then lo and hi
  s.ring = o;  o += slots * row;               // initial context rows
  s.tbuf = o;  o += kStages * nc * row;        // target and negative rows per stage
  s.part = o;  o += 2 * warps * nc * row;      // g^T C partials, double-buffered
  s.wid = o;   o += (size_t)W * T * 4;
  s.nid = o;   o += (size_t)T * K * 4;
  s.live = o;  o += (size_t)T * 4;             // bit w: walk w has a valid target at p
  s.red = o;   o += (size_t)warps * 4;
  s.total = o;
  return s;
}

// --- Hopper primitives (inline PTX) -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}


// Wait for the phase of parity `parity`; a phase that never completes (a
// lost copy) traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// 16 bytes from global to shared memory, through L2 only.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

// One arrival on `bar` once every cp.async this thread issued has landed
// (the barrier counts these arrivals: it is initialised with their number).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// --- float4 helpers ------------------------------------------------------------

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ float4 fma4(float s, float4 a, float4 b) {   // s * a + b
  return make_float4(fmaf(s, a.x, b.x), fmaf(s, a.y, b.y), fmaf(s, a.z, b.z), fmaf(s, a.w, b.w));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// Sum each of NCP values over the warp's 32 lanes. Halving steps (each lane
// keeps half of its values and trades the other half with the lane `off`
// apart) leave one value per lane, then a butterfly finishes: lane l holds
// the full sum of value l >> (5 - log2 NCP).
template <int NCP>
__device__ __forceinline__ float reduce_columns(float (&v)[NCP], int lane) {
  int off = 16;
#pragma unroll
  for (int n = NCP; n > 1; n >>= 1, off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[i + n / 2];
      const float keep = upper ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <int NCP>
__global__ void __launch_bounds__(Shape<NCP>::kWarps * 32, 1)
sgns_lifetime_kernel(const Args a) {
  constexpr int NW = Shape<NCP>::kWarps, J = Shape<NCP>::kSlots, SH = Shape<NCP>::kShift;
  extern __shared__ __align__(128) unsigned char smem[];   // all of it dynamic
  const int W = a.W, T = a.T, D = a.D, K = a.K, win = a.win;
  const int NC = W + K, ring = 2 * win + 1 + kPrefetch, nslots = W * ring;
  const Layout s = layout(W, T, D, K, win, NW);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int& s_lo = reinterpret_cast<int*>(smem)[2 * kStages];
  int& s_hi = reinterpret_cast<int*>(smem)[2 * kStages + 1];
  float* ringb = reinterpret_cast<float*>(smem + s.ring);
  float* tbuf = reinterpret_cast<float*>(smem + s.tbuf);
  float* part = reinterpret_cast<float*>(smem + s.part);
  int* wid = reinterpret_cast<int*>(smem + s.wid);
  int* nid = reinterpret_cast<int*>(smem + s.nid);
  int* live = reinterpret_cast<int*>(smem + s.live);
  float* red = reinterpret_cast<float*>(smem + s.red);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long l = blockIdx.x;
  const long long row0 = (l / a.per_rep) * a.rep_rows;   // first row of this replica
  const bool has4 = lane * 4 < D;                        // lane holds elements 4 lane .. 4 lane + 3

  for (int e = tid; e < W * T; e += NW * 32) wid[e] = a.walk_ids[l * W * T + e];
  for (int e = tid; e < T * K; e += NW * 32) nid[e] = a.neg_ids[l * T * K + e];
  if (tid == 0) { s_lo = T; s_hi = -1; }
  if (tid < kStages) mbar_init(smem_u32(bars + tid), NW * 32);
  fence_barrier_init();
  __syncthreads();
  for (int p = tid; p < T; p += NW * 32) {
    int m = 0;
    for (int w = 0; w < W; ++w) m |= (wid[w * T + p] >= 0 ? 1 : 0) << w;
    live[p] = m;
    if (m) { atomicMin(&s_lo, p); atomicMax(&s_hi, p); }
  }
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  const float lr = *a.lr;
  float my_loss = 0.f;

  // Item i of bundle b (position lo + b): a row's source and its place in
  // shared memory, or no copy (src null). Bundle 0 first carries the 2w
  // context slots before lo + w; then every bundle carries the context slot
  // p + w of each walk, then the position's W targets and K negatives.
  auto item = [&](int b, int i, const float*& src, float*& dst) {
    const int p = lo + b;
    src = nullptr;
    dst = nullptr;
    const int pro = b == 0 ? W * 2 * win : 0;
    int wi, q;
    if (i < pro) {
      wi = i / (2 * win);
      q = lo - win + i % (2 * win);
    } else if (i < pro + W) {
      wi = i - pro;
      q = p + win;
    } else {
      const int c = i - pro - W, m = live[p];
      if (m == 0 || (c < W && !((m >> c) & 1))) return;
      src = c < W ? a.out_src + (row0 + wid[c * T + p]) * D
                  : a.neg_src + (row0 + nid[p * K + c - W]) * D;
      dst = tbuf + ((size_t)(b % kStages) * NC + c) * D;
      return;
    }
    if (q < 0 || q >= T || wid[wi * T + q] < 0) return;
    src = a.ctx_src + (row0 + wid[wi * T + q]) * D;
    dst = ringb + ((size_t)wi * ring + q % ring) * D;
  };
  // Bundle b's copies, by every thread: item i by warp i % NW, 16 bytes a
  // lane; then each thread's arrival, when its copies have landed.
  auto issue = [&](int b) {
    const int n = (b == 0 ? W * 2 * win : 0) + W + NC;
    for (int i = warp; i < n; i += NW) {
      const float* src;
      float* dst;
      item(b, i, src, dst);
      if (src != nullptr && has4) cp_async16(smem_u32(dst + lane * 4), src + lane * 4);
    }
    cp_async_arrive(smem_u32(bars + b % kStages));
  };

  if (lo <= hi) {
    for (int b = 0; b < kPrefetch && lo + b <= hi; ++b) issue(b);
    // Ring slot r = warp + j NW holds walk wi[j]'s context slot q[j], the one
    // slot of [p - w, p - w + ring) with q = r mod ring; creg[j] is its
    // current value once it has entered the window.
    float4 creg[J];
    int wi[J], q[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = warp + j * NW, first = lo - win;
      wi[j] = r / ring;
      q[j] = first + ((r % ring - first) % ring + ring) % ring;
      creg[j] = zero4();
    }

    for (int p = lo; p <= hi; ++p) {
      const int b = p - lo, st = b % kStages, pb = b & 1, first = p - win;
      if (p + kPrefetch <= hi) issue(b + kPrefetch);
      mbar_wait(smem_u32(bars + st), (b / kStages) & 1);
      const int m = live[p];
      float4 t4[NCP], pt[NCP];
      bool loaded = false;
#pragma unroll
      for (int c = 0; c < NCP; ++c) pt[c] = zero4();
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = warp + j * NW;
        if (r >= nslots) break;
        if (q[j] < first) q[j] += ring;        // the slot that left after p - 1 is replaced
        const int qj = q[j], w = wi[j];
        if (qj < 0 || qj > p + win || qj >= T || wid[w * T + qj] < 0) continue;
        const float* init = ringb + (size_t)r * D;
        if (qj == p + win || p == lo) creg[j] = has4 ? ld4(init + lane * 4) : zero4();
        if (m != 0 && qj != p && ((m >> w) & 1)) {        // a context row of position p
          if (!loaded) {
#pragma unroll
            for (int c = 0; c < NCP; ++c)
              t4[c] = (c < NC && (c >= W || ((m >> c) & 1)) && has4)
                          ? ld4(tbuf + ((size_t)st * NC + c) * D + lane * 4) : zero4();
            loaded = true;
          }
          const float4 c4 = creg[j];
          float v[NCP];
#pragma unroll
          for (int c = 0; c < NCP; ++c) v[c] = dot4(c4, t4[c]);
          const float dotc = reduce_columns<NCP>(v, lane);
          const int col = lane >> SH;
          float gmine = 0.f;
          if (col < NC) {
            const float msk = (col >= W || ((m >> col) & 1)) ? 1.f : 0.f;
            const float logit = fminf(fmaxf(dotc, -kMaxExp), kMaxExp);
            const float sig = __fdividef(1.f, 1.f + __expf(-logit));
            const float y = col == w ? 1.f : 0.f;
            gmine = (y - sig) * msk;
            if ((lane & ((1 << SH) - 1)) == 0)   // y is 0 or 1: one of the two terms
              my_loss -= __logf((col == w ? sig : 1.f - sig) + kEps) * msk;
          }
          float4 dc = zero4();
#pragma unroll
          for (int c = 0; c < NCP; ++c) {
            if (c < NC) {
              const float g = __shfl_sync(kFull, gmine, c << SH);
              dc = fma4(g, t4[c], dc);
              pt[c] = fma4(g, c4, pt[c]);
            }
          }
          creg[j] = add4(c4, scale4(dc, lr));
        }
        if (qj == first && has4)               // leaves the window after p: its delta
          st4(a.d_ctx + ((l * W + w) * T + qj) * D + lane * 4,
              sub4(creg[j], ld4(init + lane * 4)));
      }
      if (m != 0 && has4) {
#pragma unroll
        for (int c = 0; c < NCP; ++c)
          if (c < NC) st4(part + (((size_t)pb * NW + warp) * NC + c) * D + lane * 4, pt[c]);
      }
      __syncthreads();
      if (m != 0) {            // T += lr g^T C_old: the column deltas, summed over warps
        const int d4 = D / 4;
        for (int e = tid; e < NC * d4; e += NW * 32) {
          const int c = e / d4, k4 = e - c * d4;
          if (c < W && !((m >> c) & 1)) continue;
          const float* src = part + ((size_t)pb * NW * NC + c) * D + k4 * 4;
          float4 acc = ld4(src);
#pragma unroll
          for (int w2 = 1; w2 < NW; ++w2) acc = add4(acc, ld4(src + (size_t)w2 * NC * D));
          float* dst = c < W ? a.d_out + ((l * W + c) * T + p) * D
                             : a.d_neg + ((l * T + p) * K + (c - W)) * D;
          st4(dst + k4 * 4, scale4(acc, lr));
        }
      }
    }
    // The slots still in the window after hi.
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = warp + j * NW;
      if (r < nslots && q[j] >= 0 && q[j] >= hi - win + 1 && q[j] <= hi && has4 &&
          wid[wi[j] * T + q[j]] >= 0)
        st4(a.d_ctx + ((l * W + wi[j]) * T + q[j]) * D + lane * 4,
            sub4(creg[j], ld4(ringb + (size_t)r * D + lane * 4)));
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) my_loss += __shfl_xor_sync(kFull, my_loss, off);
  if (lane == 0) red[warp] = my_loss;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < NW; ++w) t += red[w];
    a.loss[l] = t;
  }
}

// The write-back's keys, one per slot, in the reference's slot order: the
// n_walk context slots (phi_in), then the n_walk target slots and the n_neg
// negative slots (phi_out). A slot's key is its row of the stacked matrix,
// plus `rows` for phi_out, or kDeadKey for a walk slot without a token. A
// negative at a position where no walk has a token counts but adds nothing
// (its delta was not written): dead[f] marks it. Zeroes the long-segment
// count of this step.
__global__ void __launch_bounds__(256)
sgns_wb_keys_kernel(const int* walk_ids, const int* neg_ids, int* keys, unsigned char* dead,
                    long long* segs, long long n_walk, long long n_neg, int W, int T, int K,
                    int per_rep, long long rep_rows, long long rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e == 0) segs[0] = 0;
  if (e < 2 * n_walk) {
    const bool target = e >= n_walk;
    const long long f = target ? e - n_walk : e;
    const int id = walk_ids[f];
    keys[e] = id < 0 ? kDeadKey
                     : (int)((f / ((long long)W * T) / per_rep) * rep_rows + id + (target ? rows : 0));
  } else if (e < 2 * n_walk + n_neg) {
    const long long f = e - 2 * n_walk, lp = f / K, l = lp / T;
    const int p = (int)(lp - l * T);
    bool alive = false;
    for (int w = 0; w < W; ++w) alive |= walk_ids[(l * W + w) * T + p] >= 0;
    keys[e] = (int)(rows + (l / per_rep) * rep_rows + neg_ids[f]);
    dead[f] = alive ? 0 : 1;
  }
}

// Where slot `slot`'s delta is.
__device__ __forceinline__ const float* delta_of(long long slot, long long n_walk, int D,
                                                 const float* d_ctx, const float* d_out,
                                                 const float* d_neg) {
  return slot < n_walk ? d_ctx + slot * D
         : slot < 2 * n_walk ? d_out + (slot - n_walk) * D
                             : d_neg + (slot - 2 * n_walk) * D;
}

// A group of kGroup lanes per sorted key; the group whose key starts a
// segment (a run of one row) of at most kWbShort slots adds, in sorted
// order (the slots' own order, kept by the stable sort), each slot's delta
// times 1 / count into the row, count being the segment's length, and
// writes the row once (lane g holds float4 columns g, g + kGroup, ...). A
// longer segment goes to the list that sgns_wb_long_kernel reads. Multiply
// and add round separately, as the reference's scatter of delta * inv does.
__global__ void __launch_bounds__(256, 3)
sgns_wb_segments_kernel(float* phi_in, float* phi_out, const int* sorted, const long long* slot_of,
                        const unsigned char* dead, const float* d_ctx, const float* d_out,
                        const float* d_neg, long long* segs, long long n_walk, long long n_neg,
                        int D, long long rows) {
  constexpr int kCols = kMaxDim / (4 * kGroup);   // float4 columns a lane holds
  const int lane = threadIdx.x & 31, g = lane & (kGroup - 1), base = lane & ~(kGroup - 1);
  const unsigned gmask = ((1u << kGroup) - 1) << base;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  const long long n = 2 * n_walk + n_neg;
  if (i >= n) return;                        // i is the same in every lane of a group
  const int key = sorted[i];
  if (key == kDeadKey || (i > 0 && sorted[i - 1] == key)) return;
  long long end = i + 1;                     // the segment is [i, end)
  while (true) {
    const long long j = end + g;
    const unsigned other = (__ballot_sync(gmask, j >= n || sorted[j] != key) & gmask) >> base;
    if (other) { end += __ffs(other) - 1; break; }
    end += kGroup;
    if (end - i > kWbShort) break;
  }
  if (end - i > kWbShort) {                  // a long segment: the CTA kernel's
    // Its end by a kGroup-way search: each round probes kGroup points of
    // [lo, hi), where sorted[lo - 1] == key and the end lies in [lo, hi].
    long long lo = end, hi = n;
    while (lo < hi) {
      const long long span = hi - lo, p = lo + span * g / kGroup;
      const int c = __popc(__ballot_sync(gmask, sorted[p] == key) & gmask);   // a prefix
      if (c == 0) break;
      const long long nlo = lo + span * (c - 1) / kGroup + 1;
      hi = c < kGroup ? lo + span * c / kGroup : hi;
      lo = nlo;
    }
    if (g == 0) {
      const long long at = (long long)atomicAdd(reinterpret_cast<unsigned long long*>(segs), 1ull);
      segs[1 + 2 * at] = i;
      segs[2 + 2 * at] = lo;
    }
    return;
  }
  const float inv = 1.f / fmaxf((float)(end - i), 1.f);
  const bool out = key >= rows;
  float* dst = (out ? phi_out : phi_in) + ((long long)key - (out ? rows : 0)) * D;
  float4 acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = (q * kGroup + g) * 4;
    acc[q] = c < D ? ld4(dst + c) : zero4();
  }
  const int m = (int)(end - i);              // <= kWbShort
  for (int s0 = 0; s0 < m; s0 += kGroup) {
    const long long my = s0 + g < m ? slot_of[i + s0 + g] : 0;
    const bool my_live = s0 + g < m && (my < 2 * n_walk || !dead[my - 2 * n_walk]);
    const unsigned live = (__ballot_sync(gmask, my_live) & gmask) >> base;
    // kWbBatch slots' rows in flight, then their adds in order.
    for (int t0 = 0; t0 < kGroup && s0 + t0 < m; t0 += kWbBatch) {
      float4 d[kWbBatch][kCols];
#pragma unroll
      for (int u = 0; u < kWbBatch; ++u) {
        const long long slot = __shfl_sync(gmask, my, t0 + u, kGroup);
        const float* src = delta_of(slot, n_walk, D, d_ctx, d_out, d_neg);
        const bool use = (live >> (t0 + u)) & 1;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          const int c = (q * kGroup + g) * 4;
          d[u][q] = (use && c < D) ? ld4(src + c) : zero4();
        }
      }
#pragma unroll
      for (int u = 0; u < kWbBatch; ++u) {
        if ((live >> (t0 + u)) & 1) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            acc[q].x = __fadd_rn(acc[q].x, __fmul_rn(d[u][q].x, inv));
            acc[q].y = __fadd_rn(acc[q].y, __fmul_rn(d[u][q].y, inv));
            acc[q].z = __fadd_rn(acc[q].z, __fmul_rn(d[u][q].z, inv));
            acc[q].w = __fadd_rn(acc[q].w, __fmul_rn(d[u][q].w, inv));
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = (q * kGroup + g) * 4;
    if (c < D) st4(dst + c, acc[q]);
  }
}

// The long segments (a hub's row: hundreds or thousands of slots), one CTA
// each: stages of kLongRows slots, their delta rows copied into shared
// memory by every thread (cp.async, many rows in flight), then thread c
// adds column c of each row in slot order. The same order and rounding as
// the short segments'.
__global__ void __launch_bounds__(kLongThreads)
sgns_wb_long_kernel(float* phi_in, float* phi_out, const int* sorted, const long long* slot_of,
                    const unsigned char* dead, const float* d_ctx, const float* d_out,
                    const float* d_neg, const long long* segs, long long n_walk, int D,
                    long long rows) {
  extern __shared__ __align__(16) float tile[];          // kLongRows x D
  __shared__ long long s_slot[kLongRows];
  __shared__ int s_live[kLongRows];
  const int t = threadIdx.x, d4 = D / 4;
  const long long count = segs[0];
  for (long long g = blockIdx.x; g < count; g += gridDim.x) {
    const long long start = segs[1 + 2 * g], end = segs[2 + 2 * g];
    const int key = sorted[start];
    const bool out = key >= rows;
    float* dst = (out ? phi_out : phi_in) + ((long long)key - (out ? rows : 0)) * D;
    const float inv = 1.f / fmaxf((float)(end - start), 1.f);
    float acc = t < D ? dst[t] : 0.f;
    for (long long s0 = start; s0 < end; s0 += kLongRows) {
      const int m = (int)min((long long)kLongRows, end - s0);
      for (int r = t; r < m; r += kLongThreads) {
        const long long slot = slot_of[s0 + r];
        s_slot[r] = slot;
        s_live[r] = slot < 2 * n_walk || !dead[slot - 2 * n_walk];
      }
      __syncthreads();
      for (int e = t; e < m * d4; e += kLongThreads) {
        const int r = e / d4, c = e - r * d4;
        if (s_live[r])
          cp_async16(smem_u32(tile + (size_t)r * D + c * 4),
                     delta_of(s_slot[r], n_walk, D, d_ctx, d_out, d_neg) + c * 4);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (t < D) {
        for (int r = 0; r < m; ++r)
          if (s_live[r]) acc = __fadd_rn(acc, __fmul_rn(tile[(size_t)r * D + t], inv));
      }
      __syncthreads();
    }
    if (t < D) dst[t] = acc;
  }
}

inline int warps_for(int W, int K) {
  return W + K <= 8 ? Shape<8>::kWarps : Shape<16>::kWarps;
}

}  // namespace

extern "C" {

// Once per process: the lifetime kernels may use all of a block's shared
// memory, and every kernel of the library is loaded before a CUDA graph
// captures it.
int sgns_init() {
  cudaError_t err = cudaFuncSetAttribute(
      sgns_lifetime_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sgns_lifetime_kernel<16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sgns_wb_keys_kernel);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sgns_wb_segments_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sgns_wb_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kLongRows * kMaxDim * 4);
  return (int)err;
}

// Dynamic shared memory of one lifetime launch; the caller refuses shapes
// above the card's per-block limit.
size_t sgns_lifetime_smem_bytes(int W, int T, int D, int K, int window) {
  return layout(W, T, D, K, window, warps_for(W, K)).total;
}

int sgns_lifetime_max_cols() { return kMaxCols; }
int sgns_lifetime_max_ring() { return kMaxRing; }
int sgns_lifetime_max_dim() { return kMaxDim; }
int sgns_lifetime_prefetch() { return kPrefetch; }

// The lifetime kernel for L lifetimes on `stream`. Returns the launch's
// cudaError_t.
int sgns_lifetime_launch(const float* ctx_src, const float* out_src, const float* neg_src,
                         const int* walk_ids, const int* neg_ids, long long rep_rows,
                         int per_rep, float* d_ctx, float* d_out, float* d_neg, float* loss,
                         const float* lr, int L, int W, int T, int D, int K, int window,
                         void* stream) {
  const Args a{ctx_src, out_src, neg_src, walk_ids, neg_ids, rep_rows, per_rep, d_ctx,
               d_out,   d_neg,   loss,    lr,       W,        T,        D,       K,
               window};
  const size_t smem = sgns_lifetime_smem_bytes(W, T, D, K, window);
  cudaStream_t s = (cudaStream_t)stream;
  if (W + K <= 8)
    sgns_lifetime_kernel<8><<<L, Shape<8>::kWarps * 32, smem, s>>>(a);
  else
    sgns_lifetime_kernel<16><<<L, Shape<16>::kWarps * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The write-back's first launch: the 2 L W T + L T K keys of one step into
// `keys` and the dead negatives into `dead`, for a matrix of `rows` stacked
// rows (phi_out's keys are offset by rows, so 2 rows must stay below
// 2^31 - 1).
int sgns_wb_keys_launch(const int* walk_ids, const int* neg_ids, int* keys, unsigned char* dead,
                        long long* segs, int L, int W, int T, int K, int per_rep,
                        long long rep_rows, long long rows, void* stream) {
  const long long n_walk = (long long)L * W * T, n_neg = (long long)L * T * K;
  sgns_wb_keys_kernel<<<(unsigned)((2 * n_walk + n_neg + 255) / 256), 256, 0,
                        (cudaStream_t)stream>>>(walk_ids, neg_ids, keys, dead, segs, n_walk, n_neg,
                                                W, T, K, per_rep, rep_rows, rows);
  return (int)cudaGetLastError();
}

// The long-segment list's capacity for a step of L lifetimes: segs holds
// its count, then (start, end) pairs.
long long sgns_wb_segs_len(int L, int W, int T, int K) {
  return 1 + 2 * ((2LL * L * W * T + (long long)L * T * K) / (kWbShort + 1) + 1);
}

// The write-back's last launches, after the keys were sorted stably into
// `sorted` with each one's slot in `slot_of`: the live deltas into phi_in
// and phi_out, short segments a warp each, then long ones a CTA each.
int sgns_wb_segments_launch(float* phi_in, float* phi_out, const int* sorted,
                            const long long* slot_of, const unsigned char* dead,
                            const float* d_ctx, const float* d_out, const float* d_neg,
                            long long* segs, int L, int W, int T, int D, int K, long long rows,
                            void* stream) {
  const long long n_walk = (long long)L * W * T, n_neg = (long long)L * T * K;
  const long long n = 2 * n_walk + n_neg;
  cudaStream_t s = (cudaStream_t)stream;
  sgns_wb_segments_kernel<<<(unsigned)((n * kGroup + 255) / 256), 256, 0, s>>>(
      phi_in, phi_out, sorted, slot_of, dead, d_ctx, d_out, d_neg, segs, n_walk, n_neg, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sgns_wb_long_kernel<<<kLongCtas, kLongThreads, (size_t)kLongRows * D * 4, s>>>(
      phi_in, phi_out, sorted, slot_of, dead, d_ctx, d_out, d_neg, segs, n_walk, D, rows);
  return (int)cudaGetLastError();
}

const char* sgns_lifetime_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
