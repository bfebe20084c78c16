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
// the card's operations-per-byte ridge.
//
// Design: one block per (b, kv_head, group of up to 8 query heads), so a
// KV head's cache is read once for all the query heads that share it. The
// block's threads split into workers of D / VEC lanes, each lane holding
// one 16-byte slice of a row; workers stride over rows [0, len) and never
// touch rows at or past len. A worker keeps its own f32 (max, denom, acc)
// for each query head and loads several rows before it uses any, so many
// 16-byte loads are in flight per SM. Workers in a warp merge by shuffles,
// warps merge through shared memory. The TPU kernel's sequential grid over
// cache blocks, its 8-row q padding and its (rep, 128) scratch have no
// counterpart here.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;

using rt::load_vec;
using rt::store;
using rt::Vec;

// exp(m - m_new) with exp(-inf - x) = 0, also for x = -inf.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : expf(m - m_new);
}

template <typename T, int D, int REP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int Hq, int KV, int rep, float scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int TPR = D / VEC;        // lanes that hold one cache row
  constexpr int RPW = 32 / TPR;       // rows one warp reads at once
  constexpr int kWorkers = kWarps * RPW;
  constexpr int kUnroll = REP >= 4 ? 2 : 4;  // rows in flight per worker

  __shared__ float sm_m[kWarps][REP];
  __shared__ float sm_l[kWarps][REP];
  __shared__ float sm_acc[kWarps][REP][D];

  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int r0 = blockIdx.y * REP;
  const int nrep = min(REP, rep - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / TPR;
  const int part = lane % TPR;
  const int len = max(0, min(lengths[b], S));

  const size_t q_row0 = (size_t)b * Hq + (size_t)kvh * rep + r0;
  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < nrep) {
      load_vec(q + (q_row0 + r) * D + part * VEC, qv[r]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[r][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) qv[r][i] = 0.f;
    }
  }

  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  const size_t row_stride = (size_t)KV * D;
  const size_t base_off = ((size_t)b * S * KV + kvh) * D + part * VEC;
  const T* kb = k + base_off;
  const T* vb = v + base_off;

  // `base` is uniform across the warp, so every lane reaches the shuffles.
  for (int base = warp * RPW; base < len; base += kWorkers * kUnroll) {
    float kr[kUnroll][VEC], vr[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * kWorkers;
      if (t < len) {
        load_vec(kb + (size_t)t * row_stride, kr[u]);
        load_vec(vb + (size_t)t * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * kWorkers;
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += qv[r][i] * kr[u][i];
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (t < len) {
          const float m_new = fmaxf(m[r], s);
          const float alpha = rescale(m[r], m_new);
          const float p = expf(s - m_new);
          l[r] = l[r] * alpha + p;
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][i] = acc[r][i] * alpha + p * vr[u][i];
          m[r] = m_new;
        }
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
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a + ao * c;
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
      for (int i = 0; i < VEC; ++i) sm_acc[warp][r][part * VEC + i] = acc[r][i];
    }
  }
  __syncthreads();

  // Merge the warps; a row that saw no key (len == 0) comes out as zeros.
  for (int idx = threadIdx.x; idx < nrep * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float o = 0.f;
    if (mx != -INFINITY) {
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = rescale(sm_m[w][r], mx);
        den += sm_l[w][r] * c;
        num += sm_acc[w][r][d] * c;
      }
      o = num / den;
    }
    store(out + (q_row0 + r) * D + d, o);
  }
}

template <typename T, int D, int REP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int Hq, int KV,
                   int S, cudaStream_t stream) {
  const int rep = Hq / KV;
  const dim3 grid(B * KV, (rep + REP - 1) / REP);
  const float scale = 1.0f / sqrtf((float)D);
  decode_attention_kernel<T, D, REP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(out), S, Hq, KV, rep, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_rep(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int Hq, int KV,
                   int S, cudaStream_t stream) {
  const int rep = Hq / KV;
  if (rep <= 1) return launch<T, D, 1>(q, k, v, lengths, out, B, Hq, KV, S, stream);
  if (rep <= 2) return launch<T, D, 2>(q, k, v, lengths, out, B, Hq, KV, S, stream);
  if (rep <= 4) return launch<T, D, 4>(q, k, v, lengths, out, B, Hq, KV, S, stream);
  return launch<T, D, kMaxRep>(q, k, v, lengths, out, B, Hq, KV, S, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, int B, int Hq, int KV, int S,
                                   int D, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || Hq % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)by_rep<float, 64>(q, k, v, lengths, out, B, Hq, KV, S, s);
  if (dtype == 0 && D == 128) return (int)by_rep<float, 128>(q, k, v, lengths, out, B, Hq, KV, S, s);
  if (dtype == 1 && D == 64) return (int)by_rep<__nv_bfloat16, 64>(q, k, v, lengths, out, B, Hq, KV, S, s);
  if (dtype == 1 && D == 128) return (int)by_rep<__nv_bfloat16, 128>(q, k, v, lengths, out, B, Hq, KV, S, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
