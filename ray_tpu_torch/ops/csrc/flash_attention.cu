// Flash attention forward for Hopper (sm_90a).
//
// Replaces: ray_tpu/ops/flash_attention.py, _flash_kernel (launched by
// flash_attention). Same function: q [B, Sq, Hq, D] against k/v
// [B, Sk, Hkv, D] (GQA when Hq > Hkv), scale D^-0.5, optional causal mask
// with diagonal offset Sk - Sq (query row i sees keys j <= i + Sk - Sq),
// online softmax with f32 state, output in q's dtype, forward only.
// Rule for a query row that sees no key (only when causal and Sq > Sk):
// its output is zeros.
//
// Bound on the H100: operations. The products need 4 * B * Hq * Sq * Sk * D
// flops (about half of that when causal) against reading q, k, v and
// writing the output once; at the main path's shapes that is hundreds of
// flops per byte, above the card's ridge, so the bound is the bf16
// tensor-core peak (989 TFLOP/s).
//
// Design: one block per (q tile of 64 rows, head, batch). The block loops
// over 64-key tiles up to the causal diagonal (tiles wholly above it are
// never loaded) and masks the ragged edge of Sq and Sk itself, so any Sq/Sk
// is taken; the online softmax state stays in f32. Two paths:
// - bfloat16 runs on the tensor cores: mma.sync m16n8k16 (bf16 in, f32
//   accumulate). Each of 4 warps owns 16 query rows and keeps their Q
//   fragments, softmax state and output accumulator in registers; K (row
//   major) and V (transposed) tiles are staged in shared memory with rows
//   padded so fragment loads hit 32 banks. P is rounded to bf16 for the PV
//   product, as FlashAttention-2 does. No TMA/wgmma pipeline yet.
// - float32 runs on the CUDA cores in f32 (16 x 16 threads, scores in
//   shared memory), so f32 results keep full precision.
// The TPU kernel's (8, 128) tile rule and its (block_q, 128) scratch have
// no counterpart here.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // f32 path: 16 x 16 threads over output tiles
constexpr int kBQ = 64;
constexpr int kBK = 64;

using rt::load_vec;
using rt::store;
using rt::Vec;

template <int D>
constexpr size_t smem_floats() {
  // Qs [BQ][D], Ks [BK][D+1], Vs [BK][D], Ss [BQ][BK+1], m/l/alpha [BQ]
  return (size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, float scale, int causal) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;  // 16-byte vectors per row
  constexpr int NJ = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * D;
  float* Vs = Ks + kBK * (D + 1);
  float* Ss = Vs + kBK * D;
  float* row_m = Ss + kBQ * (kBK + 1);
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  for (int idx = threadIdx.x; idx < kBQ * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const int i = q0 + r;
    float tmp[VEC];
    if (i < Sq) {
      load_vec(q + (((size_t)b * Sq + i) * Hq + h) * D + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) Qs[r * D + c + e] = tmp[e] * scale;
  }
  if (threadIdx.x < kBQ) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }

  // Keys this tile can see: all of them, or up to the diagonal of its last
  // real row.
  int k_end = Sk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_row + off + 1));
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBK * VPR; idx += kThreads) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * VEC;
      const int j = k0 + r;
      float kt[VEC], vt[VEC];
      if (j < Sk) {
        const size_t o = (((size_t)b * Sk + j) * Hkv + hk) * D + c;
        load_vec(k + o, kt);
        load_vec(v + o, vt);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kt[e] = vt[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * (D + 1) + c + e] = kt[e];
        Vs[r * D + c + e] = vt[e];
      }
    }
    __syncthreads();

    // Scores for rows ty + 16 i, columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kb[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int kj = k0 + col;
        const bool visible = kj < Sk && (!causal || kj <= q0 + row + off);
        Ss[row * (kBK + 1) + col] = visible ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: four lanes per row.
    {
      const int row = threadIdx.x / 4;
      const int part = threadIdx.x % 4;
      float* srow = Ss + row * (kBK + 1);
      float mx = -INFINITY;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = m_new == -INFINITY ? 0.f : expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_new);
        row_a[row] = alpha;
        row_l[row] = row_l[row] * alpha + sum;
        row_m[row] = m_new;
      }
    }
    __syncthreads();

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[i] = row_a[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs and Ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty + 16 * i;
    const int qi = q0 + row;
    if (qi >= Sq) continue;
    const float den = row_l[row];
    const float inv = den > 0.f ? 1.f / den : 0.f;
    T* orow = out + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(orow + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                   cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const float scale = 1.0f / sqrtf((float)D);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, scale,
      causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 path

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kPad = 8;  // bf16 pad per shared-memory row (16 bytes)

template <int D>
constexpr size_t mma_smem_bytes() {
  // Qs [BQ][D+pad], Ks [BK][D+pad], Vt [D][BK+pad], all bf16
  return sizeof(__nv_bfloat16) * ((size_t)kBQ * (D + kPad) +
                                  (size_t)kBK * (D + kPad) +
                                  (size_t)D * (kBK + kPad));
}

// c += a @ b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1 (+ 8) of column g;
// C holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                           int Hq, int Hkv, float scale_log2, int causal) {
  constexpr int QS = D + kPad;    // row stride of Qs and Ks
  constexpr int VS = kBK + kPad;  // row stride of Vt
  constexpr int VPR = D / 8;      // 16-byte vectors per row
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int NT = kBK / 8;     // 8-key score tiles per k tile
  constexpr int ND = D / 8;       // 8-column output tiles
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* Ks = Qs + kBQ * QS;
  __nv_bfloat16* Vt = Ks + kBK * QS;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's two query rows
  const int row1 = row0 + 8;

  for (int idx = threadIdx.x; idx < kBQ * VPR; idx += kMmaThreads) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < Sq)
      val = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + q0 + r) * Hq + h) * D + c);
    *reinterpret_cast<uint4*>(Qs + r * QS + c) = val;
  }
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * QS + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * QS);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * QS + 8);
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain)
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the denominator

  int k_end = Sk;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_row + off + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    for (int idx = threadIdx.x; idx < kBK * VPR; idx += kMmaThreads) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk)
        val = *reinterpret_cast<const uint4*>(
            k + (((size_t)b * Sk + k0 + r) * Hkv + hk) * D + c);
      *reinterpret_cast<uint4*>(Ks + r * QS + c) = val;
    }
    // V transposed; neighbouring lanes take neighbouring keys so that the
    // 2-byte stores into a Vt row do not collide on a bank.
    for (int idx = threadIdx.x; idx < kBK * VPR; idx += kMmaThreads) {
      const int r = idx % kBK;
      const int c = (idx / kBK) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk)
        val = *reinterpret_cast<const uint4*>(
            v + (((size_t)b * Sk + k0 + r) * Hkv + hk) * D + c);
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c + e) * VS + r] = e8[e];
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* p = Ks + (j * 8 + g) * QS + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_bf16(s[j], qf[kk], bf);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t + e;
        const bool in = col < Sk;
        s[j][e] = in && (!causal || col <= row0 + off)
                      ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = in && (!causal || col <= row1 + off)
                          ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // exp2(-inf - x) = 0, also when both are -inf (a row with no key yet)
    const float a0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
    const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    uint32_t pf[kBK / 16][4];  // P as A fragments of the PV product
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p00 = mn0 == -INFINITY ? 0.f : exp2f(s[j][0] - mn0);
      const float p01 = mn0 == -INFINITY ? 0.f : exp2f(s[j][1] - mn0);
      const float p10 = mn1 == -INFINITY ? 0.f : exp2f(s[j][2] - mn1);
      const float p11 = mn1 == -INFINITY ? 0.f : exp2f(s[j][3] - mn1);
      ls0 += p00 + p01;
      ls1 += p10 + p11;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* p = Vt + (n * 8 + g) * VS + kk * 16 + 2 * t;
        const uint32_t bf[2] = {ld32(p), ld32(p + 8)};
        mma_bf16(o[n], pf[kk], bf);
      }
    }
    __syncthreads();  // the next tile overwrites Ks and Vt
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // no visible key: zeros
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * Sq + row0) * Hq + h) * D + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(
          out + (((size_t)b * Sq + row1) * Hq + h) * D + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                       int causal, cudaStream_t stream) {
  const size_t bytes = mma_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_mma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_attention_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Sk, Hq, Hkv, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Sk, int Hq,
                                  int Hkv, int D, int causal, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_mma<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_mma<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
