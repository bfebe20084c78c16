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

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

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
      wgmma_rs_n64(o, p + 4 * kk, mn_major_desc(v_b + kk * 2048, kPanelBytes), 1);
    else
      wgmma_rs_n128(o, p + 4 * kk, mn_major_desc(v_b + kk * 2048, kPanelBytes), 1);
  }
}

// Accumulator and A-fragment layouts of wgmma: hopper.cuh.
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
      wgmma_wait<0>();
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
        wgmma_wait<0>();
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
    fence_proxy_async();
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

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                         int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bshd(&q_map, q, B, Sq, Hq, D, kTile) ||
      !encode_bshd(&k_map, k, B, Sk, Hkv, D, kTile) ||
      !encode_bshd(&v_map, v, B, Sk, Hkv, D, kTile))
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
