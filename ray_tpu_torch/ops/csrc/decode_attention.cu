// Decode attention for Hopper (sm_90a): one query token per sequence
// against its slot KV cache, at ragged per-sequence lengths.
//
// Replaces: ray_tpu/ops/decode_attention.py, _decode_kernel (launched by
// decode_attention_pallas). Same function: q [B, Hq, D] against caches
// [B, S, KV, D]; rows [0, lengths[b]) are valid; scale D^-0.5; softmax
// state in f32; GQA with rep = Hq / KV query heads per KV head; output in
// q's dtype; a sequence with length 0 gives zeros.
//
// Bound on the H100: memory bandwidth. Each step must read the K and V rows
// below each sequence's length once (2 * sum(len) * KV * D * elem bytes)
// over 3.35 TB/s; the arithmetic is 4 flops per cache element, far under
// the card's operations-per-byte ridge. At the serving width the whole
// cache of a step is a few MB, so the time is set by how many loads are in
// flight across the card, not by one block's walk.
//
// Design: split-K ("flash-decoding") with the merge in the same launch.
// - The grid is (B * KV * q-head groups, splits). The cache axis is cut
//   into chunks of `chunk` rows, chosen on the host (ops/decode_attention.py,
//   split_plan) as whole rounds of loads, at least two: at the serving shape
//   (B8, KV16, S1024) 128-row chunks and 8 splits, which give 544 active
//   blocks of 128 threads on the ragged lengths of the smoke run, about
//   four for each of the 132 SMs. A block whose chunk starts at or past its
//   sequence's length exits at once; the highest splits are issued first,
//   so those empty blocks retire before the full ones start.
// - A block serves up to `group` (1, 2, 4 or 8) query heads of one KV
//   head, so the chunk is read once for all of them. Its threads split into
//   workers of D / VEC lanes, each lane holding one 16-byte slice of a row;
//   workers stride over the chunk's rows below the length and load several
//   rows before they use any. Each worker keeps f32 (max, denominator,
//   accumulator) per query head; workers merge by shuffles, warps through
//   shared memory.
// - A sequence covered by one chunk writes its output directly. Otherwise
//   each block writes its f32 partials to a workspace, then takes a ticket
//   on an int counter of its (batch, KV head, group) with one acq_rel
//   atomic after a block barrier.
//   The block that draws the last ticket (ceil(len / chunk) active chunks)
//   merges the partials (one online pass over the splits, several loads
//   in flight per thread), writes the output and sets the counter back to 0,
//   so no memset launch is ever needed: one launch per layer per step.
//   Calls that share a counter buffer must be ordered on one stream.
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a), for groups of 1 / 2 / 4 / 8
// query heads: bf16 D=64 77 / 107 / 128 / 225 registers and 1,060 /
// 2,116 / 8,452 / 16,900 bytes of static shared memory; bf16 D=128 77 /
// 108 / 127 / 225 registers and 2,084 / 4,164 / 16,644 / 33,284 bytes;
// f32 64 to 149 registers; no instance spills. D = 32 and 16 (a row is
// 4 or 2 bf16 lanes, 8 or 4 f32 lanes; the shuffles of the score sum and
// of the workers' merge run over those lane counts) are new instances of
// the same source; their resources are in PERF.md.
// Other head dims (any multiple of 8 from 8 to 256) run on runtime-width
// instances, decode_attention_rt_kernel<T, DP, REP>: the same body at a
// tile width DP (8, 32, 64, 128 or 256, the power of two at or above D),
// with the real D as an argument. A row is DP / VEC lanes (at most 32;
// at DP = 256 in f32 each lane holds two 16-byte slices); lanes whose
// slice starts at or past D load zeros and store nothing, so D = 80 and 96
// in bf16 (10 and 12 lanes of data) run as workers of 16 lanes. The rows,
// the workspace and the output are D wide, so nothing is padded in memory.
// At DP = 256 a block serves at most 4 query heads (8 would need a 64 KB
// merge buffer, over the 48 KB of static shared memory, and 2048 outputs
// to merge in one block: split_plan gives Gemma's 8 query heads of one KV
// head two blocks), and may use 255 registers.
// The TPU kernel's sequential grid over cache blocks, its 8-row q padding
// and its (rep, 128) scratch have no counterpart here.

#include <math.h>

#include "common.cuh"

namespace {

// Threads of a block: 128, or 256 for groups of 4 or 8 query heads, whose
// merge has more outputs. ops/decode_attention.py (rows_per_round) sizes
// the chunks from these and from kUnroll below.
template <int REP>
__host__ __device__ constexpr int threads() {
  return REP >= 4 ? 256 : 128;
}

// Blocks per SM the register budget must allow, so that no variant
// spills: one query head at D=64 fits in 80 registers a thread (6 blocks
// of 128), two heads or D=128 in 128; groups of 4 (256 threads) in 128 and
// groups of 8 in up to 255. A lane's state is one 16-byte slice per query
// head at every D, so at D = 32 and 16 one head gets D=64's budget and two
// heads D=64's two-head budget.
template <int D, int REP>
__host__ __device__ constexpr int min_blocks() {
  return D == 256 ? 1
                  : REP >= 4 ? (REP == 4 ? 2 : 1)
                             : ((D < 64 ? REP == 1 : REP * D <= 64) ? 6 : 4);
}

using rt::load_raw;
using rt::store;
using rt::unpack;
using rt::Vec;

// exp(m - m_new) with exp(-inf - x) = 0, also for x = -inf.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

// The kernel at tile width D and head dim d: d == D (a compile-time
// constant) for the exact instances, any multiple of 8 up to D for the
// runtime-width ones (kRt), whose lanes past d load zeros and store
// nothing.
template <typename T, int D, int REP, bool kRt>
__device__ __forceinline__ void decode_attention_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ counters, int S, int Hq, int KV, int rep, int n_groups, int chunk,
    int n_splits, float scale, const int d) {
  constexpr int kThreads = threads<REP>();
  constexpr int kWarps = kThreads / 32;
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC < 32 ? D / VEC : 32;  // lanes that hold one cache row
  constexpr int NV = D / VEC / TPR;   // 16-byte slices a lane holds (2 only at f32 D=256)
  constexpr int RPW = 32 / TPR;       // rows one warp reads at once
  constexpr int kWorkers = kWarps * RPW;
  constexpr int kUnroll = REP >= 4 ? 2 : 4;  // rows in flight per worker

  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][D];
  __shared__ int sm_last;

  const int item = blockIdx.x;  // (batch, KV head, group of query heads)
  // Highest split first: those are empty for all but the longest
  // sequences, so they retire at once and the rest follow in one wave.
  const int split = n_splits - 1 - blockIdx.y;
  const int b = item / (KV * n_groups);
  const int kvh = (item / n_groups) % KV;
  const int r0 = (item % n_groups) * REP;
  const int nrep = min(REP, rep - r0);
  const size_t q_row0 = (size_t)b * Hq + (size_t)kvh * rep + r0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / TPR;
  const int part = lane % TPR;
  // The first column of this lane's slice sl, and whether it holds data.
  auto col = [&](int sl) { return (sl * TPR + part) * VEC; };
  auto live = [&](int sl) { return !kRt || col(sl) < d; };

  const int len = max(0, min(__ldg(lengths + b), S));
  const int row_begin = split * chunk;
  if (row_begin >= len) {
    if (split == 0)  // length 0: zeros
      for (int idx = threadIdx.x; idx < nrep * d; idx += kThreads)
        store(out + (q_row0 + idx / d) * d + idx % d, 0.f);
    return;
  }
  // q as loaded; it is unpacked after the first rows' loads are issued,
  // so its load and theirs are in flight together.
  uint4 q_raw[REP][NV];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int sl = 0; sl < NV; ++sl)
      q_raw[r][sl] = r < nrep && live(sl) ? load_raw(q + (q_row0 + r) * d + col(sl))
                                          : make_uint4(0, 0, 0, 0);
  const int row_end = min(row_begin + chunk, len);
  const int n_active = (len + chunk - 1) / chunk;

  float m[REP], l[REP], acc[REP][NV][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int sl = 0; sl < NV; ++sl)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][sl][i] = 0.f;
  }

  const size_t row_stride = (size_t)KV * d;
  const size_t base_off = ((size_t)b * S * KV + kvh) * d + part * VEC;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // `base` is uniform across the warp, so every lane reaches the shuffles.
  for (int base = row_begin + warp * RPW; base < row_end;
       base += kWorkers * kUnroll) {
    // Rows stay as loaded (16 bytes) until used: half the registers of
    // f32 for bf16.
    uint4 kr[kUnroll][NV], vr[kUnroll][NV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * kWorkers;
#pragma unroll
      for (int sl = 0; sl < NV; ++sl) {
        if (t < row_end && live(sl)) {
          kr[u][sl] = load_raw(kb + (size_t)t * row_stride + sl * TPR * VEC);
          vr[u][sl] = load_raw(vb + (size_t)t * row_stride + sl * TPR * VEC);
        } else {
          kr[u][sl] = vr[u][sl] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    float qv[REP][NV][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int sl = 0; sl < NV; ++sl) {
        unpack(q_raw[r][sl], q, qv[r][sl]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) qv[r][sl][i] *= scale;
      }
    // Scores of the rows in flight, then one rescale of the state for all
    // of them.
    float sc[kUnroll][REP];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + sub + u * kWorkers < row_end;
      float kf[NV][VEC];
#pragma unroll
      for (int sl = 0; sl < NV; ++sl) unpack(kr[u][sl], kb, kf[sl]);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int sl = 0; sl < NV; ++sl)
#pragma unroll
          for (int i = 0; i < VEC; ++i) s += qv[r][sl][i] * kf[sl][i];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        sc[u][r] = valid ? s : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, sc[u][r]);
      const float alpha = rescale(m[r], m_new);
      l[r] *= alpha;
#pragma unroll
      for (int sl = 0; sl < NV; ++sl)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][sl][i] *= alpha;
      m[r] = m_new;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float vf[NV][VEC];
#pragma unroll
      for (int sl = 0; sl < NV; ++sl) unpack(vr[u][sl], vb, vf[sl]);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = rescale(sc[u][r], m[r]);  // 0 for rows past the chunk
        l[r] += p;
#pragma unroll
        for (int sl = 0; sl < NV; ++sl)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][sl][i] += p * vf[sl][i];
      }
    }
  }

  // Merge the workers of one warp: lanes at distance TPR, 2*TPR, ... hold
  // the same slice of D for other rows.
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_new = fmaxf(m[r], mo);
      const float a = rescale(m[r], m_new);
      const float c = rescale(mo, m_new);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int sl = 0; sl < NV; ++sl)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][sl][i], off);
          acc[r][sl][i] = acc[r][sl][i] * a + ao * c;
        }
      m[r] = m_new;
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (part == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int sl = 0; sl < NV; ++sl)
#pragma unroll
        for (int i = 0; i < VEC; ++i) sm_acc[warp][r][col(sl) + i] = acc[r][sl][i];
    }
  }
  __syncthreads();

  // Merge the warps into this chunk's (max, denominator, accumulator); the
  // chunk holds at least one row, so the max is finite. Partials are laid
  // out [item][split][REP] with d accumulator floats, then (max, denom).
  const size_t slot0 = ((size_t)item * n_splits + split) * REP;
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)gridDim.x * n_splits * REP * d;
  for (int idx = threadIdx.x; idx < nrep * d; idx += kThreads) {
    const int r = idx / d;
    const int dd = idx % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = rescale(sm_m[w][r], mx);
      den += sm_l[w][r] * c;
      num += sm_acc[w][r][dd] * c;
    }
    if (n_active == 1) {
      store(out + (q_row0 + r) * d + dd, num / den);
    } else {
      ws_acc[(slot0 + r) * d + dd] = num;
      if (dd == 0) {
        ws_ml[2 * (slot0 + r)] = mx;
        ws_ml[2 * (slot0 + r) + 1] = den;
      }
    }
  }
  if (n_active == 1) return;

  // Ticket: the last of the n_active blocks of this item merges. The
  // barrier orders the block's partial writes before thread 0's ticket,
  // whose release publishes them at GPU scope and whose acquire makes the
  // other blocks' partials visible to this one (one fenced atomic instead
  // of a fence in every thread).
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counters + item)
                 : "memory");
    sm_last = ticket == n_active - 1;
  }
  __syncthreads();
  if (!sm_last) return;
  // One pass over the splits' partials, online as in the loop above; each
  // thread keeps the (max, denominator, numerator) of its outputs and loads
  // several splits before it uses any.
  const size_t item0 = (size_t)item * n_splits * REP;
  constexpr int kOut = (REP * D + kThreads - 1) / kThreads;  // outputs a thread
  float mo[kOut], lo[kOut], no[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    mo[o] = -INFINITY;
    lo[o] = no[o] = 0.f;
  }
#pragma unroll 8
  for (int sp = 0; sp < n_active; ++sp) {
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      const int idx = threadIdx.x + o * kThreads;
      const int r = idx / d;
      if (r < nrep) {
        const size_t slot = item0 + sp * REP + r;
        const float m_s = __ldcg(ws_ml + 2 * slot);
        const float l_s = __ldcg(ws_ml + 2 * slot + 1);
        const float a_s = __ldcg(ws_acc + slot * d + idx % d);
        const float m_new = fmaxf(mo[o], m_s);
        const float c_old = rescale(mo[o], m_new);
        const float c_s = expf(m_s - m_new);
        lo[o] = lo[o] * c_old + l_s * c_s;
        no[o] = no[o] * c_old + a_s * c_s;
        mo[o] = m_new;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    const int idx = threadIdx.x + o * kThreads;
    if (idx / d < nrep) store(out + q_row0 * d + idx, no[o] / lo[o]);
  }
  if (threadIdx.x == 0) counters[item] = 0;  // ready for the next launch
}

// The instances of head dims 16, 32, 64 and 128.
template <typename T, int D, int REP>
__global__ void __launch_bounds__(threads<REP>(), (min_blocks<D, REP>()))
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ ws, int* __restrict__ counters,
                        int S, int Hq, int KV, int rep, int n_groups,
                        int chunk, int n_splits, float scale) {
  decode_attention_body<T, D, REP, false>(q, k, v, lengths, out, ws, counters, S, Hq, KV,
                                          rep, n_groups, chunk, n_splits, scale, D);
}

// Runtime-width instances: head dim d (a multiple of 8, at most DP).
template <typename T, int DP, int REP>
__global__ void __launch_bounds__(threads<REP>(), (min_blocks<DP, REP>()))
decode_attention_rt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ ws,
                           int* __restrict__ counters, int S, int Hq, int KV, int rep,
                           int n_groups, int chunk, int n_splits, float scale, int d) {
  decode_attention_body<T, DP, REP, true>(q, k, v, lengths, out, ws, counters, S, Hq, KV,
                                          rep, n_groups, chunk, n_splits, scale, d);
}

// The exact instance of head dim D (d == D), or with kRt the runtime-width
// instance of tile D at head dim d.
template <typename T, int D, int REP, bool kRt>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* ws, void* counters,
                   int B, int Hq, int KV, int S, int chunk, int n_splits, int d,
                   cudaStream_t stream) {
  const int rep = Hq / KV;
  const int n_groups = (rep + REP - 1) / REP;
  const dim3 grid(B * KV * n_groups, n_splits);
  const float scale = 1.0f / sqrtf((float)d);
  if constexpr (!kRt)
    decode_attention_kernel<T, D, REP><<<grid, threads<REP>(), 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        static_cast<T*>(out), static_cast<float*>(ws),
        static_cast<int*>(counters), S, Hq, KV, rep, n_groups, chunk, n_splits,
        scale);
  else
    decode_attention_rt_kernel<T, D, REP><<<grid, threads<REP>(), 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(lengths),
        static_cast<T*>(out), static_cast<float*>(ws),
        static_cast<int*>(counters), S, Hq, KV, rep, n_groups, chunk, n_splits,
        scale, d);
  return cudaGetLastError();
}

template <typename T, int D, bool kRt>
cudaError_t by_group(const void* q, const void* k, const void* v,
                     const void* lengths, void* out, void* ws, void* counters,
                     int B, int Hq, int KV, int S, int group, int chunk,
                     int n_splits, int d, cudaStream_t stream) {
  switch (group) {
    case 1: return launch<T, D, 1, kRt>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, chunk, n_splits, d, stream);
    case 2: return launch<T, D, 2, kRt>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, chunk, n_splits, d, stream);
    case 4: return launch<T, D, 4, kRt>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, chunk, n_splits, d, stream);
    case 8:
      if constexpr (D == 256) return cudaErrorInvalidValue;  // at most 4 heads there
      else return launch<T, D, 8, kRt>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, chunk, n_splits, d, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The tile width of a runtime-width head dim D (ops/decode_attention.py,
// decode_tile): the power of two at or above it, at least 8.
inline int rt_tile(int D) { return D <= 8 ? 8 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

template <typename T>
cudaError_t by_width(const void* q, const void* k, const void* v, const void* lengths,
                     void* out, void* ws, void* counters, int B, int Hq, int KV, int S,
                     int D, int group, int chunk, int n_splits, cudaStream_t s) {
  switch (D) {  // the exact instances
    case 16: return by_group<T, 16, false>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, 16, s);
    case 32: return by_group<T, 32, false>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, 32, s);
    case 64: return by_group<T, 64, false>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, 64, s);
    case 128: return by_group<T, 128, false>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, 128, s);
    default: break;
  }
  if (D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  switch (rt_tile(D)) {
    case 8: return by_group<T, 8, true>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, D, s);
    case 32: return by_group<T, 32, true>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, D, s);
    case 64: return by_group<T, 64, true>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, D, s);
    case 128: return by_group<T, 128, true>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, D, s);
    default: return by_group<T, 256, true>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, group, chunk, n_splits, D, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: a multiple of 8 from 8 to 256.
// `group` query heads per block (1, 2, 4 or 8), cache chunks of `chunk` rows, n_splits * chunk >= S; `ws`
// holds B * KV * ceil(rep / group) * n_splits * group * (D + 2) floats and
// `counters` B * KV * ceil(rep / group) zeroed ints. Returns the
// cudaError_t of the launch.
extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* ws, void* counters, int B,
                                   int Hq, int KV, int S, int D, int dtype,
                                   int group, int chunk, int n_splits,
                                   void* stream) {
  if (B <= 0 || KV <= 0 || Hq % KV != 0 || chunk <= 0 || n_splits <= 0 ||
      (long long)chunk * n_splits < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)by_width<float>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, D, group, chunk, n_splits, s);
  if (dtype == 1)
    return (int)by_width<__nv_bfloat16>(q, k, v, lengths, out, ws, counters, B, Hq, KV, S, D, group, chunk, n_splits, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
