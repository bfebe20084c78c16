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
// At D = 32 and 16 the products shrink with D and the exponentials do not:
// one exponential per visible score at 16 per clock per SM on 132 SMs takes
// longer than the products (at B4 S1024 H16 D32 causal and 1,980 MHz about
// 7.9 us against 4.3 us) and than the bytes (5.0 us), so the exponentials
// bound these instances. They keep the same schedule, which already
// overlaps one warpgroup's softmax with the other's products; a score tile
// is 128 keys wide at every D, so the exponentials per wgmma issued grow
// as D shrinks and the products hide behind them.
//
// bfloat16 design (FlashAttention-3's schedule): one block per (128-row
// q tile, head, batch), issued heaviest causal tile first, with three
// warpgroups.
// - A producer warpgroup gives its registers away (setmaxnreg 40); one of
//   its threads issues TMA loads: Q once, then K and V tiles of 128 keys
//   into a two-stage ring, each stage with a full and an empty mbarrier.
//   The tensor maps are 4-D over [B, S, H, D] as they lie in memory (no
//   transpose, no copy), 64 columns per box with the 128-byte swizzle
//   (at D = 32 and 16 the whole row per box, with the 64- or 32-byte
//   swizzle); rows past Sq or Sk come back as zeros.
// - Two consumer warpgroups (setmaxnreg 232) own 64 query rows each.
//   S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//   (both K-major). The online softmax runs in registers in the exp2
//   domain with f32 state; P is rounded to bf16 in registers and is the
//   A operand of O += P V, a register-sourced wgmma that reads V from
//   shared memory as an MN-major operand (transpose bit), so V is never
//   transposed. At D = 32 and 16 that is m64n32k16 / m64n16k16 on V's
//   64- or 32-byte-swizzled rows, one swizzle atom wide along N (each
//   descriptor is checked alone against a plain product through
//   wgmma_probe.cu). The next tile's Q K^T is issued right behind this
//   tile's P V, and the two warpgroups' softmaxes overlap each other's
//   products.
// - Masks run only on tiles that cross the causal diagonal or the Sk edge.
// - The epilogue normalises O in registers, stages it as bf16 in the
//   warpgroup's own rows of the Q tile and writes 16-byte stores, masking
//   rows past Sq.
// float32 stays on the CUDA cores in full f32 FMAs, so the golden checks
// keep f32 precision: 32-row query tiles, groups of 64 threads that take a
// tile's key tiles in turn, scores and softmax in register tiles, the
// groups' partials merged in a fixed order (the f32 path below says how).
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a): the bf16 kernel 168 registers
// at entry (setmaxnreg then gives the consumers 232 and the producer 40),
// 80 bytes of static shared memory (the mbarriers) and 82,944 (D=64) or
// 164,864 (D=128) bytes of dynamic shared memory (Q, two K and two V tiles
// and 1 KB of alignment slack), no spills. The logsumexp store leaves
// these unchanged and adds no serialised wgmma. The D = 32 and 16
// instances are written so that the D = 64 and 128 ones compile from the
// same source as before (every difference is an `if constexpr` on D or a
// constant equal to the old one there); their resources, and the f32
// kernel's, are in PERF.md.
//
// Head dims. The TPU kernel takes any D; here every multiple of 8 from 8 to
// 256 runs on a kernel. D = 16, 32, 64 and 128 have their instances (above),
// and so have D = 80 and 96 (Phi-2's and Phi-3-mini's heads): their rows
// are two 64-column panels, the 4-D tensor maps have the real D as their
// inner extent so TMA fills the second panel past D with zeros, Q K^T
// issues D / 16 k-steps (5 and 6), and P V is an m64n64k16 on the first
// panel plus an m64n16k16 or m64n32k16 on the first 16 or 32 columns of the
// second (part of a swizzle atom; wgmma_probe.cu checks both against a
// plain product). They are faster than the tile of 128 that any other D
// from 72 to 128 runs (chip_width_probe.py times both). Any other D runs on a runtime-width instance,
// flash_attention_wgmma_rt_kernel<DT>: the tile DT is the power of two at
// or above D (16 to 256), the zeros TMA puts past D go through the
// products, and only D columns are stored (in f32 every D runs so, on
// flash_fwd_f32_kernel<DT> of its tile). The tile of 256 (Gemma's D =
// 256) takes 64-key K/V tiles: Q is 64 KB, and two stages of 128-key K and
// V tiles would need 256 KB; with 64-key tiles the block holds 193 KB, the
// scores are m64n64k16 products and P V two m64n128k16 per k-step. The new
// instances' resources are in PERF.md (168 registers at entry, no spills).
// The TPU kernel's (8, 128) tile rule and its (block_q, 128) scratch have
// no counterpart here.

#include <math.h>

#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------ f32 path
//
// Full f32 FMAs on the CUDA cores (no TF32, no bf16), so the golden checks
// keep f32 precision. At the f32 shapes the port runs the products do not
// bound the call (B1 S256 H4 D64 causal: 0.034 GFLOP, about 0.5 us of the
// card's 67 TFLOP/s f32 peak); each block's chain of key tiles, its loads
// and its barriers do. So, as the f32 backward's Q blocks
// (flash_attention_bwd.cu, f32 path):
// - one block per 32-row query tile (kF32Rows) of one query head, the tile
//   with the longest causal rows first; the block is fwd_f32_groups<DT>
//   groups of 64 threads (4 up to the tile of 128, 2 at 256, where shared
//   memory bounds them), and group g takes the key tiles g, g + G, ... of
//   the keys the tile sees, so a block's chain is 1/G of its tiles;
// - each group has its own two-stage cp.async ring of K and V tiles
//   (fwd_f32_keys<DT> keys: 32, or 16 at the tiles of 128 and 256, where
//   4 groups of 32-key stages would not fit), so the next tile's load
//   overlaps this tile's work;
// - S (32 rows x the tile's keys) lives in registers, 4 x 4 a thread (4 x
//   2 at the tiles of 128 and 256): thread t of a group holds rows
//   t / 8 + 8x and keys t % 8 + 8y, read as float4 along D from
//   [rows][DT + 4] tiles. Q is
//   scaled by D^-0.5 log2(e) once, after its load, so the softmax runs in
//   the exp2 domain; a row's max and sum are shuffles among the 8 threads
//   that hold it. P goes to P.V through a per-group [32][keys + 8] buffer;
//   each thread owns O's rows t / 8 + 8x (those of its scores, so the
//   rescale needs no exchange) and DT / 8 columns;
// - at the end each group's partial (its running max m, sum l and O)
//   passes through its own stages, and the block adds them in group order:
//   no atomics, so the output and the lse are bitwise repeatable.
// The tile DT is the power of two at or above D (16 to 256); columns past D
// are zeros in shared memory and are not stored.

using namespace f32tile;

template <int DT>
__host__ __device__ constexpr int fwd_f32_keys() {
  return DT >= 128 ? 16 : 32;
}

template <int DT>
__host__ __device__ constexpr int fwd_f32_groups() {
  return DT <= 128 ? 4 : 2;
}

// Floats of a P row.
template <int DT>
__host__ __device__ constexpr int fwd_f32_pld() {
  return fwd_f32_keys<DT>() + 8;
}

// Shared memory (floats): the block's Q tile, then for each group two
// stages of K, two of V, and its P. At the end a group's stages hold its
// partial: O [32][DT], then m [32] and l [32].
template <int DT>
struct FwdF32Smem {
  static constexpr int kQ = kF32Rows * f32_ld<DT>();
  static constexpr int kKV = fwd_f32_keys<DT>() * f32_ld<DT>();  // one K or V tile
  static constexpr int kP = kF32Rows * fwd_f32_pld<DT>();
  static constexpr int kGroup = 4 * kKV + kP;
  static constexpr int kFloats = kQ + fwd_f32_groups<DT>() * kGroup;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(4 * kKV >= kF32Rows * (DT + 2), "a group's stages hold its partial");
};

// A thread's O columns: chunks of W floats (float4, or float2 at the tile
// of 16), W * 8 apart, the first at (t % 8) * W.
template <int DT>
__host__ __device__ constexpr int fwd_f32_chunk() {
  return DT / 8 < 4 ? DT / 8 : 4;
}

template <int W>
__device__ __forceinline__ void load_chunk(float* a, const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void store_chunk(float* p, const float* a) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}

// Key tile n of KV head hk into a group's stage at st (K there, V two
// tiles on), by the group's thread t.
template <int DT>
__device__ __forceinline__ void load_kv(float* st, const float* __restrict__ k,
                                        const float* __restrict__ v, int b, int n, int Sk,
                                        int Hkv, int hk, int d, int t) {
  constexpr int KK = fwd_f32_keys<DT>();
  f32_load_tile<DT>(st, k, b, n * KK, KK, Sk, Hkv, hk, d, t, kF32GroupThreads);
  f32_load_tile<DT>(st + 2 * FwdF32Smem<DT>::kKV, v, b, n * KK, KK, Sk, Hkv, hk, d, t,
                    kF32GroupThreads);
}

// The f32 kernel at tile width DT and head dim d (a multiple of 8, at most
// DT). Block y: query tile nq - 1 - y / (B Hq), head y % Hq, batch
// y / Hq % B.
template <int DT>
__global__ void __launch_bounds__(kF32GroupThreads * fwd_f32_groups<DT>(), 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int B, int Sq, int Sk, int Hq, int Hkv,
                     float scale_log2, int causal, int d) {
  using L = FwdF32Smem<DT>;
  constexpr int G = fwd_f32_groups<DT>();
  constexpr int KK = fwd_f32_keys<DT>();
  constexpr int LD = f32_ld<DT>();
  constexpr int PLD = fwd_f32_pld<DT>();
  constexpr int NY = KK / 8;  // keys of a thread's score tile
  constexpr int W = fwd_f32_chunk<DT>();
  constexpr int TC = DT / 8;  // O columns of a thread
  extern __shared__ __align__(16) float fwd_smem[];
  const int g = threadIdx.x / kF32GroupThreads;
  const int t = threadIdx.x % kF32GroupThreads;
  const int tr = t / 8, tc = t % 8;
  float* Qs = fwd_smem;
  float* group = fwd_smem + L::kQ + g * L::kGroup;
  float* Ps = group + 4 * L::kKV;
  const int nq = (Sq + kF32Rows - 1) / kF32Rows;
  const int y = blockIdx.x;
  const int h = y % Hq;
  const int b = y / Hq % B;
  const int hk = h / (Hq / Hkv);
  const int q0 = (nq - 1 - y / (B * Hq)) * kF32Rows;
  const int off = Sk - Sq;
  const int k_end = causal ? max(0, min(Sk, min(q0 + kF32Rows, Sq) + off)) : Sk;
  const int items = (k_end + KK - 1) / KK;

  f32_load_tile<DT>(Qs, q, b, q0, kF32Rows, Sq, Hq, h, d, threadIdx.x, blockDim.x);
  if (g < items) load_kv<DT>(group, k, v, b, g, Sk, Hkv, hk, d, t);
  cp_async_commit();
  cp_async_wait_all();
  // Scale the Q chunks this thread copied (its own copies are complete).
  for (int idx = threadIdx.x; idx < kF32Rows * (DT / 4); idx += blockDim.x) {
    float4* p = reinterpret_cast<float4*>(Qs + (idx / (DT / 4)) * LD + (idx % (DT / 4)) * 4);
    float4 x = *p;
    x.x *= scale_log2; x.y *= scale_log2; x.z *= scale_log2; x.w *= scale_log2;
    *p = x;
  }
  __syncthreads();

  float o[4][TC];
  float m[4], l[4];  // per row: running max (scaled log2 domain), this thread's sum
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    m[x] = -INFINITY;
    l[x] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c) o[x][c] = 0.f;
  }
  int it = 0;
  for (int n = g; n < items; n += G, ++it) {
    const float* Ks = group + (it & 1) * L::kKV;
    const float* Vs = Ks + 2 * L::kKV;
    cp_async_wait_all();
    named_bar_sync(1 + g, kF32GroupThreads);  // this tile in; the last one's P.V done
    if (n + G < items)
      load_kv<DT>(group + ((it + 1) & 1) * L::kKV, k, v, b, n + G, Sk, Hkv, hk, d, t);
    cp_async_commit();

    float s[4][NY];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int j = 0; j < NY; ++j) s[x][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DT; c += 4) {
      float4 kb[NY];
#pragma unroll
      for (int j = 0; j < NY; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tc + 8 * j) * LD + c);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 qa = *reinterpret_cast<const float4*>(Qs + (tr + 8 * x) * LD + c);
#pragma unroll
        for (int j = 0; j < NY; ++j) {
          s[x][j] = fmaf(qa.x, kb[j].x, s[x][j]);
          s[x][j] = fmaf(qa.y, kb[j].y, s[x][j]);
          s[x][j] = fmaf(qa.z, kb[j].z, s[x][j]);
          s[x][j] = fmaf(qa.w, kb[j].w, s[x][j]);
        }
      }
    }

    // Mask (only on a tile that crosses the Sk edge or the diagonal of the
    // block's first row), then the online softmax of each row.
    const int k0 = n * KK;
    const bool edge = k0 + KK > Sk || (causal && k0 + KK - 1 > q0 + off);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = q0 + tr + 8 * x;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const int kj = k0 + tc + 8 * j;
        if (edge && (kj >= Sk || (causal && kj > i + off))) s[x][j] = -INFINITY;
        mx = fmaxf(mx, s[x][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[x], mx);
      // A row with no visible key yet keeps max -inf; subtracting 0 then
      // gives exp2(-inf) = 0 for its scores and its old state alike.
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[x] - base);
      m[x] = mn;
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        const float p = exp2f(s[x][j] - base);
        ls += p;
        Ps[(tr + 8 * x) * PLD + tc + 8 * j] = p;
      }
      l[x] = l[x] * alpha + ls;
#pragma unroll
      for (int c = 0; c < TC; ++c) o[x][c] *= alpha;
    }
    named_bar_sync(1 + g, kF32GroupThreads);  // P in

    // O += P V: four keys at a time, a float4 of P per row.
#pragma unroll 2
    for (int kk = 0; kk < KK; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int x = 0; x < 4; ++x) load_chunk<4>(pa[x], Ps + (tr + 8 * x) * PLD + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cq = 0; cq < TC / W; ++cq) {
          float vb[W];
          load_chunk<W>(vb, Vs + (kk + e) * LD + tc * W + cq * 8 * W);
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int w = 0; w < W; ++w) o[x][cq * W + w] = fmaf(pa[x][e], vb[w], o[x][cq * W + w]);
        }
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {  // the row's sum over its 8 threads
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 4);
  }

  // Merge: each group's partial into its stages, then summed in group order.
  cp_async_wait_all();
  __syncthreads();  // every group's last P.V done: its stages are free
  float* pm = group + kF32Rows * DT;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = tr + 8 * x;
#pragma unroll
    for (int cq = 0; cq < TC / W; ++cq)
      store_chunk<W>(group + r * DT + tc * W + cq * 8 * W, &o[x][cq * W]);
    if (tc == 0) {
      pm[r] = m[x];
      pm[kF32Rows + r] = l[x];
    }
  }
  __syncthreads();
  const float* parts = fwd_smem + L::kQ;
  for (int idx = threadIdx.x; idx < kF32Rows * (DT / 4); idx += blockDim.x) {
    const int r = idx / (DT / 4);
    const int c = (idx % (DT / 4)) * 4;
    if (q0 + r >= Sq || c >= d) continue;
    float mx = -INFINITY;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) mx = fmaxf(mx, parts[gg * L::kGroup + kF32Rows * DT + r]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float den = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const float* part = parts + gg * L::kGroup;
      const float w = exp2f(part[kF32Rows * DT + r] - base);
      den = fmaf(part[kF32Rows * DT + kF32Rows + r], w, den);
      const float4 pv = *reinterpret_cast<const float4*>(part + r * DT + c);
      acc.x = fmaf(pv.x, w, acc.x);
      acc.y = fmaf(pv.y, w, acc.y);
      acc.z = fmaf(pv.z, w, acc.z);
      acc.w = fmaf(pv.w, w, acc.w);
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;  // no visible key: zeros
    *reinterpret_cast<float4*>(out + (((size_t)b * Sq + q0 + r) * Hq + h) * d + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    // m is in the scaled log2 domain: the natural-log lse is (m + log2 l) ln 2.
    if (lse != nullptr && c == 0)
      lse[((size_t)b * Hq + h) * Sq + q0 + r] =
          den > 0.f ? (mx + log2f(den)) * 0.6931471805599453f : -INFINITY;
  }
}

// Every f32 head dim runs on the instance of its tile DT.
template <int DT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal, int d,
                       cudaStream_t stream) {
  constexpr size_t bytes = FwdF32Smem<DT>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const unsigned blocks = (unsigned)((Sq + kF32Rows - 1) / kF32Rows) * Hq * B;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  flash_fwd_f32_kernel<DT><<<blocks, kF32GroupThreads * fwd_f32_groups<DT>(), bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, B, Sq, Sk, Hq, Hkv, scale_log2, causal, d);
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16 path

constexpr int kTile = 128;                  // q rows per block
constexpr int kStages = 2;                  // depth of the K/V ring
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWsThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kPanelBytes = kTile * 128;    // 128 rows of one 64-column panel
constexpr int kConsumerWarps = 8;

// An instance is named by its head dim D (0 for a runtime-width instance,
// which takes D as an argument) and its tile width DT, the columns of a
// tile row in shared memory: D itself at 16, 32, 64 and 128; 128 at D = 80
// and 96 (two panels, TMA fills the second past D with zeros); the power of
// two at or above D for a runtime width.
template <int D>
__host__ __device__ constexpr int wgmma_tile() {
  return D <= 32 ? D : (D + 63) / 64 * 64;
}

// Keys per K/V tile: 128, or 64 at a tile of 256 columns, where Q (64 KB)
// and two stages of 128-key K and V tiles (256 KB) would not fit.
template <int DT>
__host__ __device__ constexpr int keys() {
  return DT == 256 ? 64 : 128;
}

// Columns of the P V product and of O: D, or the whole tile for a runtime
// width (its columns past D are products with zeros).
template <int D, int DT>
__host__ __device__ constexpr int pv_width() {
  return D == 0 ? DT : D;
}

// Shared memory of one block: Q, then kStages K tiles, then kStages V
// tiles, each [panels][rows][64 columns] bf16 in TMA's 128-byte swizzle (at
// a tile of 32 and 16 columns [rows][DT columns] in the 64- or 32-byte
// swizzle), from a 1024-byte aligned base.
template <int DT>
struct Smem {
  static constexpr int kRowBytes = row_bytes<DT>() * panels<DT>();
  static constexpr int kTileBytes = kTile * kRowBytes;       // Q
  static constexpr int kKVBytes = keys<DT>() * kRowBytes;    // one K or V tile
  static constexpr int kKVPanel = keys<DT>() * 128;          // a K or V panel
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBytes = kV + kStages * kKVBytes + 1024;  // + alignment
};

// mbarriers: Q full; K full, V full, K empty, V empty for each stage.
enum { kQFull = 0, kKFull = 1, kVFull = 3, kKEmpty = 5, kVEmpty = 7, kNumBars = 9 };

// S(64 q rows x the tile's keys) = Q K^T over D: q_a is this warpgroup's
// 64 rows of the Q tile, k_b a K tile; a k-step of 16 columns is 32 bytes
// along a swizzled row, and every 4 steps the next 64-column panel (tiles
// of 32 and 16 columns have one panel, in rows of 2DT bytes). D = 80 and
// 96 take 5 and 6 steps, the last in the second panel.
template <int D, int DT>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_a, uint32_t k_b) {
  using L = Smem<DT>;
#pragma unroll
  for (int kk = 0; kk < pv_width<D, DT>() / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    const uint32_t k_off = (kk / 4) * L::kKVPanel + (kk % 4) * 32;
    if constexpr (DT < 64) {
      if (kk == 0)
        wgmma_ss_n128_first(s, k_major_desc_narrow<DT>(q_a + off),
                            k_major_desc_narrow<DT>(k_b + off));
      else
        wgmma_ss_n128(s, k_major_desc_narrow<DT>(q_a + off),
                      k_major_desc_narrow<DT>(k_b + off));
    } else if constexpr (keys<DT>() == 64) {
      if (kk == 0)
        wgmma_ss_n64_first<0, 0>(s, k_major_desc(q_a + off), k_major_desc(k_b + k_off));
      else
        wgmma_ss_n64<0, 0>(s, k_major_desc(q_a + off), k_major_desc(k_b + k_off));
    } else if (kk == 0)
      wgmma_ss_n128_first(s, k_major_desc(q_a + off), k_major_desc(k_b + k_off));
    else
      wgmma_ss_n128(s, k_major_desc(q_a + off), k_major_desc(k_b + k_off));
  }
}

// O(64 x pv_width) += P(64 x the tile's keys, registers) V(keys x D); a
// k-step of 16 keys is 16 rows (2048 bytes) of every panel (16 rows of 2DT
// bytes at a tile of 32 or 16 columns). At D = 80 and 96 the first panel
// is an m64n64k16 product and the second an m64n16k16 or m64n32k16 on its
// first 16 or 32 columns; at a tile of 256 two m64n128k16, one for each
// pair of panels.
template <int D, int DT>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p, uint32_t v_b) {
  constexpr int kN = pv_width<D, DT>();
  constexpr uint32_t kP = Smem<DT>::kKVPanel;
#pragma unroll
  for (int kk = 0; kk < keys<DT>() / 16; ++kk) {
    const uint32_t v0 = v_b + kk * 2048;
    if constexpr (DT < 64)
      wgmma_rs_narrow<DT>(o, p + 4 * kk, mn_major_desc_narrow<DT>(v_b + kk * 16 * 2 * DT), 1);
    else if constexpr (kN == 64)
      wgmma_rs_n64(o, p + 4 * kk, mn_major_desc(v0, kP), 1);
    else if constexpr (kN == 128)
      wgmma_rs_n128(o, p + 4 * kk, mn_major_desc(v0, kP), 1);
    else if constexpr (kN == 256) {
      wgmma_rs_n128(o, p + 4 * kk, mn_major_desc(v0, kP), 1);
      wgmma_rs_n128(o + 64, p + 4 * kk, mn_major_desc(v0 + 2 * kP, kP), 1);
    } else {
      static_assert(kN == 80 || kN == 96, "P V widths: 16, 32, 64, 80, 96, 128, 256");
      wgmma_rs_n64(o, p + 4 * kk, mn_major_desc(v0, kP), 1);
      if constexpr (kN == 80)
        wgmma_rs_n16(o + 32, p + 4 * kk, mn_major_desc(v0 + kP, kP), 1);
      else
        wgmma_rs_n32(o + 32, p + 4 * kk, mn_major_desc(v0 + kP, kP), 1);
    }
  }
}

// The block's work at head dim D (0: runtime width d) and tile width DT.
// Accumulator and A-fragment layouts of wgmma: hopper.cuh.
template <int D, int DT>
__device__ __forceinline__ void flash_wgmma_body(const CUtensorMap& q_map,
                                                 const CUtensorMap& k_map,
                                                 const CUtensorMap& v_map,
                                                 __nv_bfloat16* __restrict__ out,
                                                 float* __restrict__ lse, int Sq, int Sk,
                                                 int Hq, int Hkv, float scale_log2, int causal,
                                                 const int d) {
  using L = Smem<DT>;
  constexpr int kKeys = keys<DT>();
  constexpr int kN = pv_width<D, DT>();
  constexpr bool kRt = D == 0;
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
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

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
      mbar_expect_tx(bar0 + 8 * kQFull, L::kTileBytes);
#pragma unroll
      for (int p = 0; p < panels<DT>(); ++p)
        tma_load_4d(q_s + p * kPanelBytes, &q_map, bar0 + 8 * kQFull, p * 64, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n & 1;
        const uint32_t ph = (n >> 1) & 1;
        const uint32_t k_full = bar0 + 8 * (kKFull + st);
        const uint32_t v_full = bar0 + 8 * (kVFull + st);
        mbar_wait(bar0 + 8 * (kKEmpty + st), ph ^ 1);
        mbar_expect_tx(k_full, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < panels<DT>(); ++p)
          tma_load_4d(k_s + st * L::kKVBytes + p * L::kKVPanel, &k_map, k_full, p * 64, hk,
                      n * kKeys, b);
        mbar_wait(bar0 + 8 * (kVEmpty + st), ph ^ 1);
        mbar_expect_tx(v_full, L::kKVBytes);
#pragma unroll
        for (int p = 0; p < panels<DT>(); ++p)
          tma_load_4d(v_s + st * L::kKVBytes + p * L::kKVPanel, &v_map, v_full, p * 64, hk,
                      n * kKeys, b);
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

    float o[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, scaled log2 domain
    float l0 = 0.f, l1 = 0.f;              // this thread's part of the denominators

    if (n_tiles > 0) {
      float s[kKeys / 2];
      uint32_t p[kKeys / 4];
      const uint32_t q_a = q_s + c * 64 * row_bytes<DT>();
      mbar_wait(bar0 + 8 * kQFull, 0);
      mbar_wait(bar0 + 8 * kKFull, 0);
      wgmma_fence();
      issue_qk<D, DT>(s, q_a, k_s);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kKeys / 2>(s);
      mbar_arrive_if(bar0 + 8 * kKEmpty, lane == 0);  // one arrival a warp

      for (int n = 0; n < n_tiles; ++n) {
        const int st = n & 1;
        const uint32_t ph = (n >> 1) & 1;
        const int k0 = n * kKeys;
        if (k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > wg_row0 + off)) {
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
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
        for (int j = 0; j < kKeys / 8; ++j) {
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
        for (int j = 0; j < kKeys / 8; ++j) {
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
        for (int j = 0; j < kN / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }

        mbar_wait(bar0 + 8 * (kVFull + st), ph);
        fence_regs<kN / 2>(o);
        fence_regs<kKeys / 4>(p);
        wgmma_fence();
        issue_pv<D, DT>(o, p, v_s + st * L::kKVBytes);
        wgmma_commit();
        const bool more = n + 1 < n_tiles;
        if (more) {  // the next tile's scores, behind this tile's P V
          const int st1 = st ^ 1;
          mbar_wait(bar0 + 8 * (kKFull + st1), ((n + 1) >> 1) & 1);
          issue_qk<D, DT>(s, q_a, k_s + st1 * L::kKVBytes);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs<kN / 2>(o);
        fence_regs<kKeys / 2>(s);
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
    // whole 16-byte pieces of rows below Sq (and, at a runtime width, of
    // columns below d).
    fence_proxy_async();
    const int lr = c * 64 + warp * 16 + g;  // tile rows lr and lr + 8
    constexpr int kPieces = kN / 8;         // 16-byte pieces per row
    if constexpr (DT < 64) {
      // Rows of 2DT bytes, 16-byte chunks where the swizzle of such rows
      // puts them.
      constexpr int RB = 2 * DT;
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        *reinterpret_cast<uint32_t*>(smem + lr * RB + swizzled_chunk<RB>(lr, j) * 16 + t * 4) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(smem + (lr + 8) * RB + swizzled_chunk<RB>(lr + 8, j) * 16 +
                                     t * 4) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      named_bar_sync(1 + c, kWgThreads);
      for (int idx = tid; idx < 64 * kPieces; idx += kWgThreads) {
        const int r = c * 64 + idx / kPieces;
        const int pc = idx % kPieces;
        const int qi = q0 + r;
        if (qi < Sq && (!kRt || pc * 8 < d)) {
          const uint4 val =
              *reinterpret_cast<const uint4*>(smem + r * RB + swizzled_chunk<RB>(r, pc) * 16);
          *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * Hq + h) * d + pc * 8) =
              val;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPieces; ++j) {
        const int piece = (j / 8) * kPanelBytes + (((j % 8) ^ (lr & 7)) * 16) + t * 4;
        *reinterpret_cast<uint32_t*>(smem + piece + lr * 128) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        *reinterpret_cast<uint32_t*>(smem + piece + (lr + 8) * 128) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
      named_bar_sync(1 + c, kWgThreads);
      for (int idx = tid; idx < 64 * kPieces; idx += kWgThreads) {
        const int r = c * 64 + idx / kPieces;
        const int pc = idx % kPieces;
        const int qi = q0 + r;
        if (qi < Sq && (!kRt || pc * 8 < d)) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              smem + (pc / 8) * kPanelBytes + r * 128 + (((pc % 8) ^ (r & 7)) * 16));
          *reinterpret_cast<uint4*>(out + (((size_t)b * Sq + qi) * Hq + h) * d + pc * 8) =
              val;
        }
      }
    }
  }
}

// The instances of head dims 16, 32, 64, 80, 96 and 128.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Sk, int Hq,
                             int Hkv, float scale_log2, int causal) {
  flash_wgmma_body<D, wgmma_tile<D>()>(q_map, k_map, v_map, out, lse, Sq, Sk, Hq, Hkv,
                                       scale_log2, causal, D);
}

// Runtime-width instances: head dim d (a multiple of 8, at most DT).
template <int DT>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_attention_wgmma_rt_kernel(const __grid_constant__ CUtensorMap q_map,
                                const __grid_constant__ CUtensorMap k_map,
                                const __grid_constant__ CUtensorMap v_map,
                                __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                int Sq, int Sk, int Hq, int Hkv, float scale_log2, int causal,
                                int d) {
  flash_wgmma_body<0, DT>(q_map, k_map, v_map, out, lse, Sq, Sk, Hq, Hkv, scale_log2, causal,
                          d);
}

// The exact instance of head dim D (D > 0), or the runtime-width instance
// of tile DT at head dim d (D == 0).
template <int D, int DT>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                         int causal, int d, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bshd(&q_map, q, B, Sq, Hq, d, kTile, DT) ||
      !encode_bshd(&k_map, k, B, Sk, Hkv, d, keys<DT>(), DT) ||
      !encode_bshd(&v_map, v, B, Sk, Hkv, d, keys<DT>(), DT))
    return cudaErrorInvalidValue;
  constexpr int bytes = Smem<DT>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e;
    if constexpr (D == 0)
      e = cudaFuncSetAttribute(flash_attention_wgmma_rt_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    else
      e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid(Hq, B, (Sq + kTile - 1) / kTile);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)d);
  if constexpr (D == 0)
    flash_attention_wgmma_rt_kernel<DT><<<grid, kWsThreads, bytes, stream>>>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv,
        scale_log2, causal, d);
  else
    flash_attention_wgmma_kernel<D><<<grid, kWsThreads, bytes, stream>>>(
        q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, Hq, Hkv,
        scale_log2, causal);
  return cudaGetLastError();
}

// The tile of a runtime head dim: the power of two at or above it, at
// least 16 (ops/flash_attention.py, runtime_tile).
inline int rt_tile(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: a multiple of 8 from 8 to 256.
// `lse` is nullptr or f32 [B, Hq, Sq]. Returns the cudaError_t of the
// launch.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int B, int Sq, int Sk,
                                  int Hq, int Hkv, int D, int causal, int dtype,
                                  void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 256 ||
      D % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    switch (rt_tile(D)) {
      case 16: return (int)launch_f32<16>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 32: return (int)launch_f32<32>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 64: return (int)launch_f32<64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 128: return (int)launch_f32<128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
      default: return (int)launch_f32<256>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    }
  }
  switch (D) {  // the exact instances
    case 16: return (int)launch_wgmma<16, 16>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 32: return (int)launch_wgmma<32, 32>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 64: return (int)launch_wgmma<64, 64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 80: return (int)launch_wgmma<80, 128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 96: return (int)launch_wgmma<96, 128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 128: return (int)launch_wgmma<128, 128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    default: break;
  }
  switch (rt_tile(D)) {
    case 16: return (int)launch_wgmma<0, 16>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 32: return (int)launch_wgmma<0, 32>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 64: return (int)launch_wgmma<0, 64>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    case 128: return (int)launch_wgmma<0, 128>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
    default: return (int)launch_wgmma<0, 256>(q, k, v, out, l, B, Sq, Sk, Hq, Hkv, causal, D, s);
  }
}

extern "C" const char* rt_flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
