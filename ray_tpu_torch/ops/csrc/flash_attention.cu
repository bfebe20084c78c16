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
// Logsumexp for the backward (flash_attention_bwd.cu): given a non-null
// `lse`, both instances also write f32 [B, Hq, Sq] in natural log,
// lse[b, h, i] = log sum_j exp(D^-0.5 q_i . k_j) over the keys row i sees,
// and -inf for a row that sees none. Inference passes nullptr and writes
// nothing more.
//
// Bound on the H100: operations. The products need 4 * B * Hq * Sq * Sk * D
// flops (about half of that when causal) against reading q, k, v and
// writing the output once; at the main path's shapes that is hundreds of
// flops per byte, above the card's ridge, so the bound is the bf16
// tensor-core peak (989 TFLOP/s). The exponentials (one per score, 16 per
// clock per SM) cost about as much as the D=64 products, so the design
// keeps the tensor cores busy while the softmax runs.
//
// bfloat16 design (FlashAttention-3's schedule): one block per (128-row
// q tile, head, batch), issued heaviest causal tile first, with three
// warpgroups.
// - A producer warpgroup gives its registers away (setmaxnreg 40); one of
//   its threads issues TMA loads: Q once, then K and V tiles of 128 keys
//   into a two-stage ring, each stage with a full and an empty mbarrier.
//   The tensor maps are 4-D over [B, S, H, D] as they lie in memory (no
//   transpose, no copy), 64 columns per box with the 128-byte swizzle;
//   rows past Sq or Sk come back as zeros.
// - Two consumer warpgroups (setmaxnreg 232) own 64 query rows each.
//   S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//   (both K-major). The online softmax runs in registers in the exp2
//   domain with f32 state; P is rounded to bf16 in registers and is the
//   A operand of O += P V, a register-sourced wgmma that reads V from
//   shared memory as an MN-major operand (transpose bit), so V is never
//   transposed. The next tile's Q K^T is issued right behind this tile's
//   P V, and the two warpgroups' softmaxes overlap each other's products.
// - Masks run only on tiles that cross the causal diagonal or the Sk edge.
// - The epilogue normalises O in registers, stages it as bf16 in the
//   warpgroup's own rows of the Q tile and writes 16-byte stores, masking
//   rows past Sq.
// float32 stays on the CUDA cores (16 x 16 threads, scores in shared
// memory) so the golden check keeps full f32 precision.
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a): the bf16 kernel 168 registers
// at entry (setmaxnreg then gives the consumers 232 and the producer 40),
// 80 bytes of static shared memory (the mbarriers) and 82,944 (D=64) or
// 164,864 (D=128) bytes of dynamic shared memory (Q, two K and two V tiles
// and 1 KB of alignment slack), no spills; the f32 kernel 64 (D=64) or
// 102 (D=128) registers, no spills. The logsumexp store leaves all of
// these unchanged and adds no serialised wgmma.
// The TPU kernel's (8, 128) tile rule and its (block_q, 128) scratch have
// no counterpart here.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
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
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int Sq, int Sk, int Hq, int Hkv,
                       float scale, int causal) {
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
  if (lse != nullptr && threadIdx.x < kBQ && q0 + threadIdx.x < Sq) {
    const float den = row_l[threadIdx.x];
    lse[((size_t)b * Hq + h) * Sq + q0 + threadIdx.x] =
        den > 0.f ? row_m[threadIdx.x] + logf(den) : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
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
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 path

constexpr int kTile = 128;                  // q rows per block, keys per K/V tile
constexpr int kStages = 2;                  // depth of the K/V ring
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWsThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kPanelBytes = kTile * 128;    // 128 rows of one 64-column panel
constexpr int kConsumerWarps = 8;

// Shared memory of one block: Q, then kStages K tiles, then kStages V
// tiles, each [D / 64 panels][128 rows][64 columns] bf16 in TMA's 128-byte
// swizzle, from a 1024-byte aligned base.
template <int D>
struct Smem {
  static constexpr int kTileBytes = (D / 64) * kPanelBytes;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes + 1024;  // + alignment
};

// mbarriers: Q full; K full, V full, K empty, V empty for each stage.
enum { kQFull = 0, kKFull = 1, kVFull = 3, kKEmpty = 5, kVEmpty = 7, kNumBars = 9 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Arrives when `pred` holds. Predicated inside the asm rather than
// branched around it: a branch is a divergent path, and the wgmma that
// follow it would be serialised.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// Returns once the phase of parity `parity` has completed. The poll loop
// lives inside one asm block: a loop the compiler can see is a divergent
// path, and a wgmma after it would be serialised. A wait that outlasts any
// real load (2^26 polls) traps, so a fault in the pipeline is a launch
// error and not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 polls;\nmov.u32 polls, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 polls, polls, 1;\n"
      "setp.eq.u32 p, polls, 67108864;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// K-major operand (rows of 64 columns, 8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand: the N axis runs along the 128-byte rows (panels of 64
// columns kPanelBytes apart), the K axis down the rows (8 rows per 1024).
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr) {
  return sw128_desc(addr, kPanelBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x 128, f32) = A(64 x 16, smem) * B(16 x 128, smem), both K-major: the
// first k-step, which writes D without reading it.
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D(64 x 128, f32) += A(64 x 16, smem) * B(16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D(64 x 64, f32) (+)= A(64 x 16, registers) * B(16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) (+)= A(64 x 16, registers) * B(16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// S(64 q rows x 128 keys) = Q K^T over D: q_a is this warpgroup's 64 rows
// of the Q tile, k_b a K tile; a k-step of 16 columns is 32 bytes along a
// swizzled row, and every 4 steps the next 64-column panel.
template <int D>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_a, uint32_t k_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    if (kk == 0)
      wgmma_ss_n128_first(s, k_major_desc(q_a + off), k_major_desc(k_b + off));
    else
      wgmma_ss_n128(s, k_major_desc(q_a + off), k_major_desc(k_b + off));
  }
}

// O(64 x D) += P(64 x 128 keys, registers) V(128 keys x D); a k-step of
// 16 keys is 16 rows (2048 bytes) of every panel.
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p, uint32_t v_b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if constexpr (D == 64)
      wgmma_rs_n64(o, p + 4 * kk, mn_major_desc(v_b + kk * 2048), 1);
    else
      wgmma_rs_n128(o, p + 4 * kk, mn_major_desc(v_b + kk * 2048), 1);
  }
}

// Accumulator layout of wgmma m64nN (f32), per warpgroup thread (warp w,
// lane = 4 g + t): d[4j], d[4j+1] are row 16w + g, columns 8j + 2t and
// 8j + 2t + 1; d[4j+2], d[4j+3] the same columns of row 16w + g + 8. The
// A fragment of a register-sourced wgmma k-step kk is that of mma.sync
// m16n8k16: rows g / g + 8, keys 16kk + 2t (+1) and 16kk + 8 + 2t (+1), so
// two neighbouring 8-key column blocks of S become one k-step of P.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Sk, int Hq,
                             int Hkv, float scale_log2, int causal) {
  using L = Smem<D>;
  extern __shared__ unsigned char ws_smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];

  const uint32_t raw = smem_u32(ws_smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* smem = ws_smem_raw + pad;  // 1024-byte aligned, for the swizzle
  const uint32_t q_s = raw + pad;
  const uint32_t k_s = q_s + L::kK;
  const uint32_t v_s = q_s + L::kV;
  const uint32_t bar0 = smem_u32(bars);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;  // longest causal rows first
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  int k_end = Sk;  // keys this tile's last real row can see
  if (causal) k_end = max(0, min(Sk, min(q0 + kTile, Sq) + off));
  const int n_tiles = (k_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(bar0 + 8 * kQFull, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar0 + 8 * (kKFull + st), 1);
      mbar_init(bar0 + 8 * (kVFull + st), 1);
      mbar_init(bar0 + 8 * (kKEmpty + st), kConsumerWarps);
      mbar_init(bar0 + 8 * (kVEmpty + st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so the compiler sees it
  // uniform across the warp (else it serialises the wgmma of the branch).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {
    // ---- producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      constexpr uint32_t kTx = L::kTileBytes;
      mbar_expect_tx(bar0 + 8 * kQFull, kTx);
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(q_s + p * kPanelBytes, &q_map, bar0 + 8 * kQFull, p * 64, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n & 1;
        const uint32_t ph = (n >> 1) & 1;
        const uint32_t k_full = bar0 + 8 * (kKFull + st);
        const uint32_t v_full = bar0 + 8 * (kVFull + st);
        mbar_wait(bar0 + 8 * (kKEmpty + st), ph ^ 1);
        mbar_expect_tx(k_full, kTx);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(k_s + st * L::kTileBytes + p * kPanelBytes, &k_map, k_full, p * 64,
                      hk, n * kTile, b);
        mbar_wait(bar0 + 8 * (kVEmpty + st), ph ^ 1);
        mbar_expect_tx(v_full, kTx);
#pragma unroll
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(v_s + st * L::kTileBytes + p * kPanelBytes, &v_map, v_full, p * 64,
                      hk, n * kTile, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wg_row0 = q0 + c * 64;            // this warpgroup's first row
    const int row0 = wg_row0 + warp * 16 + g;  // this thread's rows row0, row0 + 8
    const int row1 = row0 + 8;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, scaled log2 domain
    float l0 = 0.f, l1 = 0.f;              // this thread's part of the denominators

    if (n_tiles > 0) {
      float s[64];
      uint32_t p[32];
      const uint32_t q_a = q_s + c * 64 * 128;
      mbar_wait(bar0 + 8 * kQFull, 0);
      mbar_wait(bar0 + 8 * kKFull, 0);
      wgmma_fence();
      issue_qk<D>(s, q_a, k_s);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<64>(s);
      mbar_arrive_if(bar0 + 8 * kKEmpty, lane == 0);  // one arrival a warp

      for (int n = 0; n < n_tiles; ++n) {
        const int st = n & 1;
        const uint32_t ph = (n >> 1) & 1;
        const int k0 = n * kTile;
        if (k0 + kTile > Sk || (causal && k0 + kTile - 1 > wg_row0 + off)) {
#pragma unroll
          for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + j * 8 + 2 * t + e;
              const bool in = col < Sk;
              if (!in || (causal && col > row0 + off)) s[4 * j + e] = -INFINITY;
              if (!in || (causal && col > row1 + off)) s[4 * j + 2 + e] = -INFINITY;
            }
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0 * scale_log2);
        const float mn1 = fmaxf(m1, mx1 * scale_log2);
        // A row with no visible key yet keeps max -inf; subtracting 0 then
        // gives exp2(-inf) = 0 for its scores and its old state alike.
        const float base0 = mn0 == -INFINITY ? 0.f : mn0;
        const float base1 = mn1 == -INFINITY ? 0.f : mn1;
        const float a0 = ex2(m0 - base0);
        const float a1 = ex2(m1 - base1);
        m0 = mn0;
        m1 = mn1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j) {
          const float p00 = ex2(fmaf(s[4 * j], scale_log2, -base0));
          const float p01 = ex2(fmaf(s[4 * j + 1], scale_log2, -base0));
          const float p10 = ex2(fmaf(s[4 * j + 2], scale_log2, -base1));
          const float p11 = ex2(fmaf(s[4 * j + 3], scale_log2, -base1));
          ls0 += p00 + p01;
          ls1 += p10 + p11;
          p[4 * (j / 2) + 2 * (j % 2)] = pack_bf16(p00, p01);
          p[4 * (j / 2) + 2 * (j % 2) + 1] = pack_bf16(p10, p11);
        }
        l0 = l0 * a0 + ls0;
        l1 = l1 * a1 + ls1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }

        mbar_wait(bar0 + 8 * (kVFull + st), ph);
        fence_regs<D / 2>(o);
        fence_regs<32>(p);
        wgmma_fence();
        issue_pv<D>(o, p, v_s + st * L::kTileBytes);
        wgmma_commit();
        const bool more = n + 1 < n_tiles;
        if (more) {  // the next tile's scores, behind this tile's P V
          const int st1 = st ^ 1;
          mbar_wait(bar0 + 8 * (kKFull + st1), ((n + 1) >> 1) & 1);
          issue_qk<D>(s, q_a, k_s + st1 * L::kTileBytes);
          wgmma_commit();
        }
        wgmma_wait_all();
        fence_regs<D / 2>(o);
        fence_regs<64>(s);
        mbar_arrive_if(bar0 + 8 * (kVEmpty + st), lane == 0);
        mbar_arrive_if(bar0 + 8 * (kKEmpty + (st ^ 1)), lane == 0 && more);
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // no visible key: zeros
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    // m is the running max in the scaled log2 domain, so the natural-log
    // logsumexp of a row is (m + log2 l) ln 2. After every wgmma of the
    // block, so the branch costs the products nothing.
    if (lse != nullptr && t == 0) {
      float* lrow = lse + ((size_t)b * Hq + h) * Sq;
      if (row0 < Sq) lrow[row0] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f : -INFINITY;
      if (row1 < Sq) lrow[row1] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f : -INFINITY;
    }

    // Stage O as bf16 in this warpgroup's own rows of the Q tile (same
    // swizzle, so the 4-byte stores of a warp hit 32 banks), then write
    // whole 16-byte pieces of rows below Sq.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int lr = c * 64 + warp * 16 + g;  // tile rows lr and lr + 8
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int piece = (j / 8) * kPanelBytes + (((j % 8) ^ (lr & 7)) * 16) + t * 4;
      *reinterpret_cast<uint32_t*>(smem + piece + lr * 128) =
          pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<uint32_t*>(smem + piece + (lr + 8) * 128) =
          pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    named_bar_sync(1 + c, kWgThreads);
    constexpr int kPieces = D / 8;  // 16-byte pieces per row
    for (int idx = tid; idx < 64 * kPieces; idx += kWgThreads) {
      const int r = c * 64 + idx / kPieces;
      const int pc = idx % kPieces;
      const int qi = q0 + r;
      if (qi < Sq) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            smem + (pc / 8) * kPanelBytes + r * 128 + (((pc % 8) ^ (r & 7)) * 16));
        *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * Hq + h) * D + pc * 8) =
            val;
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [B, S, H, D] tensor, boxes of 64
// columns x 1 head x 128 rows x 1 batch in the 128-byte swizzle; boxes
// reaching past S (or any edge) are filled with zeros.
bool encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTile, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                         int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bshd(&q_map, q, B, Sq, Hq, D) || !encode_bshd(&k_map, k, B, Sk, Hkv, D) ||
      !encode_bshd(&v_map, v, B, Sk, Hkv, D))
    return cudaErrorInvalidValue;
  constexpr int bytes = Smem<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(Hq, B, (Sq + kTile - 1) / kTile);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_attention_wgmma_kernel<D><<<grid, kWsThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq,
      Hkv, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `lse` is nullptr or f32 [B, Hq, Sq].
// Returns the cudaError_t of the launch.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 1 && D == 64) return (int)launch_wgmma<64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 1 && D == 128) return (int)launch_wgmma<128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
