// Flash attention backward for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. It is the gradient of the function of
// ray_tpu/ops/flash_attention.py, _flash_kernel, which has no gradient rule
// there (the JAX package differentiates the XLA path, _xla_attention).
// Given q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D], the forward's output o and
// its logsumexp lse (f32 [B, Hq, Sq], natural log, -inf for a row that sees
// no key; flash_attention.cu writes it) and dO [B, Sq, Hq, D], it writes dq,
// dk and dv in the inputs' dtype: scale D^-0.5, GQA (dk and dv of a KV head
// sum over its query heads), causal with diagonal offset Sk - Sq, any Sq and
// Sk. A row that sees no key contributes nothing and gets dq = 0.
//
// With P = exp(scale S - lse) (S = Q K^T), dP = dO V^T and
// Delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dS = P o (dP - Delta),  dK = scale dS^T Q,  dQ = scale dS K.
//
// Bound on the H100: the 5 products need 10 B Hq Sq Sk D flops (about half
// when causal) against reading q, k, v, o, dO, lse once and writing dq, dk,
// dv once. At the training shape (B4 S1024 H16 D64 causal) that is 21.5
// GFLOP against 67 MB, so the bf16 tensor-core peak allows 0.0217 ms and the
// bytes 0.0201 ms: operations bound it, by a little, so the design keeps
// the five products on wgmma and computes each of them once.
//
// bfloat16 (FlashAttention-3's backward), three launches per call:
// 1. prep: Delta (from the returned O, already rounded to its dtype) and
//    the logsumexp in the scaled log2 domain, both f32 [B, Hq, Sq_pad] with
//    Sq_pad = Sq rounded up to the query tile; a row past Sq or without a
//    visible key gets lse +inf, so its P is exp2(-inf) = 0 and never NaN. It
//    also zeroes the f32 dQ accumulator [B, Hq, Sq_pad, D].
// 2. main: one block per (128-key tile, KV head, batch), key tile 0 (the
//    one every causal query row sees) issued first, three warpgroups.
//    - A producer warpgroup gives its registers away (setmaxnreg 40); one
//      thread loads K and V once by TMA, then streams the Q and dO tiles of
//      the KV head's query heads, from the first query tile that sees the
//      key tile, into a two-stage ring (full and empty mbarriers), with
//      their lse and Delta by bulk copy. The tensor maps are 4-D over
//      [B, S, H, D] as they lie in memory, 64 columns per box in the
//      128-byte swizzle; rows past Sq or Sk come back as zeros.
//    - Two consumer warpgroups (setmaxnreg 232) own 64 keys each. Per
//      query tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma with Q and dO
//      read K-major; P^T = exp2(S^T scale log2 e - lse) and
//      dS^T = P^T (dP^T - Delta) in registers, rounded to bf16 (masks only
//      on tiles that cross the causal diagonal or the Sk edge); dV += P^T dO
//      and dK += dS^T Q as register-sourced wgmma that read dO and Q
//      MN-major through the transpose bit, so nothing is transposed; dS^T
//      goes to shared memory (double-buffered, one named barrier per tile
//      between the two warpgroups) and dQ = dS K is an SS wgmma reading dS
//      and K MN-major, each warpgroup one 64 x 64 block of it, added into
//      the f32 accumulator with vector atomics. Five products per visible
//      tile pair, each once. dK and dV stay in registers across the KV
//      head's query heads (the GQA sum inside the block) and are written
//      once.
// 3. convert: dq = bf16(scale * accumulator).
// dq is a sum of f32 atomics whose order changes from run to run, so its
// last bf16 bit may differ between two calls on the same inputs; dk and dv
// are deterministic. float32 runs on the CUDA cores (scores in shared
// memory, dK/dV and dQ in two kernels, no atomics) so the golden gradient
// check keeps full f32 precision.
//
// Resources (nvcc -Xptxas -v, sm_90a): see PERF.md (the ptxas lines that
// chip_smoke.py prints for every instance).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::load_vec;
using rt::Vec;
using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ prep

// One row (b, h, i) of [B, Hq, Sq_pad] per D / VEC neighbouring lanes:
// delta = sum_d dO[b, i, h, d] O[b, i, h, d] in f32 (0 past Sq). Where
// given, lse_log2 = lse log2(e) (+inf past Sq and for a row without a
// visible key) and the row of dq_accum is zeroed.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse_log2, float* __restrict__ dq_accum, long rows,
                      int Sq, int Sq_pad, int Hq) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;  // lanes per row, at most 32
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long r = gid / VPR;
  const int c = (int)(gid % VPR) * VEC;
  const long bh = r / Sq_pad;
  const int i = (int)(r % Sq_pad);
  float acc = 0.f;
  if (r < rows && i < Sq) {
    const size_t src = (((size_t)(bh / Hq) * Sq + i) * Hq + bh % Hq) * D + c;
    float a[VEC], g[VEC];
    load_vec(o + src, a);
    load_vec(dout + src, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc += a[e] * g[e];
  }
#pragma unroll
  for (int w = VPR / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (r >= rows) return;
  if (c == 0) {
    delta[r] = acc;
    if (lse_log2 != nullptr) {
      const float l = i < Sq ? lse[bh * Sq + i] : -INFINITY;
      lse_log2[r] = l == -INFINITY ? INFINITY : l * kLog2e;
    }
  }
  if (dq_accum != nullptr) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dq_accum + r * D + c + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ------------------------------------------------------------ bf16 path

constexpr int kKeys = 128;                  // keys per block: 64 per consumer warpgroup
constexpr int kStages = 2;                  // depth of the Q / dO ring
constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWsThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kKPanel = kKeys * 128;        // 128 rows of one 64-column panel

// Query rows per tile: 128 at D = 64; 64 at D = 128, where dK and dV alone
// take 128 registers a thread.
template <int D>
__host__ __device__ constexpr int q_rows() {
  return D == 64 ? 128 : 64;
}

// Shared memory of one block, from a 1024-byte aligned base: K and V,
// kStages Q and dO tiles (each [D / 64 panels][rows][64 columns] bf16 in
// the 128-byte swizzle), two dS^T buffers ([rows / 64 panels][128 keys][64
// query rows], same swizzle), then kStages rows of lse and of Delta (f32).
template <int D>
struct BwdSmem {
  static constexpr int kRows = q_rows<D>();
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kKVBytes = (D / 64) * kKPanel;
  static constexpr int kQBytes = (D / 64) * kQPanel;
  static constexpr int kDSBytes = (kRows / 64) * kKPanel;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDS = kDO + kStages * kQBytes;
  static constexpr int kLse = kDS + 2 * kDSBytes;
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kBytes = kDelta + kStages * kRows * 4 + 1024;  // + alignment
};

// mbarriers: K and V full; Q/dO/lse/Delta full and empty for each stage.
enum { kKVFull = 0, kFull = 1, kEmpty = 1 + kStages, kNumBars = 1 + 2 * kStages };

// S^T (64 keys x 64 query rows) = K_wg Q^T over D, or dP^T = V_wg dO^T:
// a is this warpgroup's 64 rows of the K (V) tile, b 64 rows of a Q (dO)
// tile, both K-major; a k-step of 16 columns is 32 bytes along a swizzled
// row, every 4 steps the next panel.
template <int D>
__device__ __forceinline__ void issue_scores(float* acc, uint32_t a, uint32_t b) {
  using L = BwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = k_major_desc(a + (kk / 4) * kKPanel + (kk % 4) * 32);
    const uint64_t db = k_major_desc(b + (kk / 4) * L::kQPanel + (kk % 4) * 32);
    if (kk == 0)
      wgmma_ss_n64_first<0, 0>(acc, da, db);
    else
      wgmma_ss_n64<0, 0>(acc, da, db);
  }
}

// dV (64 keys x D) += P^T (64 keys x 64 query rows, registers) dO (64 rows
// x D), or dK += dS^T Q: b 64 rows of a dO (Q) tile, read MN-major; a
// k-step of 16 query rows is 16 rows (2048 bytes) of every panel.
template <int D>
__device__ __forceinline__ void issue_grad(float* acc, const uint32_t* frag, uint32_t b) {
  using L = BwdSmem<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mn_major_desc(b + kk * 2048, L::kQPanel);
    if constexpr (D == 64)
      wgmma_rs_n64(acc, frag + 4 * kk, db, 1);
    else
      wgmma_rs_n128(acc, frag + 4 * kk, db, 1);
  }
}

// One 64 x 64 block of dQ = dS K over the 128 keys: a the block's 64 query
// rows of a dS^T buffer, b the block's 64 columns of the K tile, both read
// MN-major; a k-step of 16 keys is 2048 bytes.
__device__ __forceinline__ void issue_dq(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t da = mn_major_desc(a + kk * 2048, kKPanel);
    const uint64_t db = mn_major_desc(b + kk * 2048, kKPanel);
    if (kk == 0)
      wgmma_ss_n64_first<1, 1>(acc, da, db);
    else
      wgmma_ss_n64<1, 1>(acc, da, db);
  }
}

// Accumulator and A-fragment layouts of wgmma: hopper.cuh. Here the rows
// of S^T, dP^T, dK and dV are keys and the columns of S^T and dP^T query
// rows, so lse and Delta are read per column.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse_log2, const float* __restrict__ delta,
                       float* __restrict__ dq_accum, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int Sq_pad,
                       float scale, float scale_log2, int causal) {
  using L = BwdSmem<D>;
  constexpr int R = L::kRows;
  extern __shared__ unsigned char bwd_smem_raw[];
  __shared__ __align__(8) uint64_t bars[kNumBars];

  const uint32_t raw = smem_u32(bwd_smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  unsigned char* smem = bwd_smem_raw + pad;  // 1024-byte aligned, for the swizzle
  const uint32_t k_s = raw + pad;
  const uint32_t v_s = k_s + L::kV;
  const uint32_t q_s = k_s + L::kQ;
  const uint32_t do_s = k_s + L::kDO;
  const uint32_t ds_s = k_s + L::kDS;
  const float* lse_sm = reinterpret_cast<const float*>(smem + L::kLse);
  const float* delta_sm = reinterpret_cast<const float*>(smem + L::kDelta);
  const uint32_t bar0 = smem_u32(bars);

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // key tile 0, the heaviest when causal, first
  const int rep = Hq / Hkv;
  const int off = Sk - Sq;
  // query tiles of each head: from the first with a row that sees key k0
  // (row i sees key j when j <= i + off)
  const int m_begin = causal ? max(0, k0 - off) / R : 0;
  const int per_head = max(0, (Sq + R - 1) / R - m_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar0 + 8 * kKVFull, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar0 + 8 * (kFull + st), 1);
      mbar_init(bar0 + 8 * (kEmpty + st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, read through a shuffle so the compiler sees it
  // uniform across the warp (else it serialises the wgmma of the branch).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  if (wg == 0) {
    // ---- producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && per_head > 0) {
      mbar_expect_tx(bar0 + 8 * kKVFull, 2 * L::kKVBytes);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        tma_load_4d(k_s + p * kKPanel, &k_map, bar0 + 8 * kKVFull, p * 64, hk, k0, b);
        tma_load_4d(v_s + p * kKPanel, &v_map, bar0 + 8 * kKVFull, p * 64, hk, k0, b);
      }
      int n = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int h = hk * rep + hh;
        for (int m = m_begin; m < m_begin + per_head; ++m, ++n) {
          const int st = n % kStages;
          const uint32_t full = bar0 + 8 * (kFull + st);
          mbar_wait(bar0 + 8 * (kEmpty + st), ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * L::kQBytes + 2 * R * 4);
#pragma unroll
          for (int p = 0; p < D / 64; ++p) {
            tma_load_4d(q_s + st * L::kQBytes + p * L::kQPanel, &q_map, full, p * 64, h,
                        m * R, b);
            tma_load_4d(do_s + st * L::kQBytes + p * L::kQPanel, &do_map, full, p * 64, h,
                        m * R, b);
          }
          const size_t row = ((size_t)b * Hq + h) * Sq_pad + (size_t)m * R;
          bulk_load(k_s + L::kLse + st * R * 4, lse_log2 + row, R * 4, full);
          bulk_load(k_s + L::kDelta + st * R * 4, delta + row, R * 4, full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wg_key0 = k0 + c * 64;            // this warpgroup's first key
    const int key0 = wg_key0 + warp * 16 + g;  // this thread's keys key0, key0 + 8
    const int key1 = key0 + 8;
    const int lr = c * 64 + warp * 16 + g;     // key0's row in the tile

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (per_head > 0) {
      const uint32_t k_a = k_s + c * 64 * 128;  // this warpgroup's rows of K and V
      const uint32_t v_a = v_s + c * 64 * 128;
      // this warpgroup's 64 x 64 block of each dQ tile: query rows
      // [dq_r0, dq_r0 + 64) of the tile and columns [dq_c0, dq_c0 + 64)
      const int dq_r0 = R == 128 ? c * 64 : 0;
      const int dq_c0 = D == 128 ? c * 64 : 0;
      mbar_wait(bar0 + 8 * kKVFull, 0);
      int n = 0;
      for (int hh = 0; hh < rep; ++hh) {
        const int h = hk * rep + hh;
        float* dq_h = dq_accum + ((size_t)b * Hq + h) * Sq_pad * D;
        for (int m = m_begin; m < m_begin + per_head; ++m, ++n) {
          const int q0 = m * R;
          const int st = n % kStages;
          const uint32_t q_b = q_s + st * L::kQBytes;
          const uint32_t do_b = do_s + st * L::kQBytes;
          const float* lse_st = lse_sm + st * R;
          const float* delta_st = delta_sm + st * R;
          const uint32_t ds_b = ds_s + (n & 1) * L::kDSBytes;
          mbar_wait(bar0 + 8 * (kFull + st), (n / kStages) & 1);

          // The tile's query rows in halves of 64: a half's S^T and dP^T
          // (32 registers each) are live only until its dV and dK products
          // are issued, which the next half's scores queue behind.
          float s[32], dp[32];
          wgmma_fence();
          issue_scores<D>(s, k_a, q_b);
          wgmma_commit();
          issue_scores<D>(dp, v_a, do_b);
          wgmma_commit();
#pragma unroll
          for (int hf = 0; hf < R / 64; ++hf) {
            const int r0 = q0 + hf * 64;  // the half's first query row
            wgmma_wait<1>();
            fence_regs<32>(s);
            if (wg_key0 + 64 > Sk || (causal && wg_key0 + 63 > r0 + off)) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int row = r0 + j * 8 + 2 * t + e;
                  if (key0 >= Sk || (causal && key0 > row + off)) s[4 * j + e] = -INFINITY;
                  if (key1 >= Sk || (causal && key1 > row + off)) s[4 * j + 2 + e] = -INFINITY;
                }
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 l =
                  *reinterpret_cast<const float2*>(lse_st + hf * 64 + j * 8 + 2 * t);
              s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -l.x));
              s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -l.y));
              s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -l.x));
              s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -l.y));
            }
            wgmma_wait<0>();
            fence_regs<32>(dp);
            uint32_t pf[16], df[16];  // P^T, dS^T of the half as A fragments
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 dl =
                  *reinterpret_cast<const float2*>(delta_st + hf * 64 + j * 8 + 2 * t);
              const int r = 4 * (j / 2) + 2 * (j % 2);
              pf[r] = pack_bf16(s[4 * j], s[4 * j + 1]);
              pf[r + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
              df[r] = pack_bf16(s[4 * j] * (dp[4 * j] - dl.x),
                                s[4 * j + 1] * (dp[4 * j + 1] - dl.y));
              df[r + 1] = pack_bf16(s[4 * j + 2] * (dp[4 * j + 2] - dl.x),
                                    s[4 * j + 3] * (dp[4 * j + 3] - dl.y));
            }
            fence_regs<D / 2>(dv_acc);
            fence_regs<D / 2>(dk_acc);
            fence_regs<16>(pf);
            fence_regs<16>(df);
            wgmma_fence();
            issue_grad<D>(dv_acc, pf, do_b + hf * 64 * 128);
            issue_grad<D>(dk_acc, df, q_b + hf * 64 * 128);
            wgmma_commit();
            if (hf + 1 < R / 64) {  // the next half's scores, behind them
              issue_scores<D>(s, k_a, q_b + (hf + 1) * 64 * 128);
              wgmma_commit();
              issue_scores<D>(dp, v_a, do_b + (hf + 1) * 64 * 128);
              wgmma_commit();
            }
            // dS^T into this tile's buffer (panel hf), in the swizzle the
            // wgmma reads (the 4-byte stores of a warp hit 32 banks). The
            // buffer was last read two tiles ago, before both warpgroups
            // passed the barrier of the previous tile.
            unsigned char* ds_half = smem + L::kDS + (n & 1) * L::kDSBytes + hf * kKPanel;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int r = 4 * (j / 2) + 2 * (j % 2);
              const int piece = ((j ^ (lr & 7)) * 16) + t * 4;
              *reinterpret_cast<uint32_t*>(ds_half + piece + lr * 128) = df[r];
              *reinterpret_cast<uint32_t*>(ds_half + piece + (lr + 8) * 128) = df[r + 1];
            }
          }
          fence_proxy_async();
          named_bar_sync(1, 2 * kWgThreads);  // both halves of dS^T are in place
          float dq[32];
          issue_dq(dq, ds_b + (dq_r0 / 64) * kKPanel, k_s + (dq_c0 / 64) * kKPanel);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32>(dq);
          fence_regs<D / 2>(dv_acc);
          fence_regs<D / 2>(dk_acc);
          mbar_arrive_if(bar0 + 8 * (kEmpty + st), lane == 0);  // one arrival a warp

          // The block into the f32 accumulator (padded to Sq_pad rows, so
          // no row needs a bound check).
          float* dst = dq_h + (size_t)(q0 + dq_r0 + warp * 16 + g) * D + dq_c0 + 2 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            atomicAdd(reinterpret_cast<float2*>(dst + j * 8),
                      make_float2(dq[4 * j], dq[4 * j + 1]));
            atomicAdd(reinterpret_cast<float2*>(dst + 8 * D + j * 8),
                      make_float2(dq[4 * j + 2], dq[4 * j + 3]));
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (key0 < Sk) {
        const size_t o = (((size_t)b * Sk + key0) * Hkv + hk) * D + col;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key1 < Sk) {
        const size_t o = (((size_t)b * Sk + key1) * Hkv + hk) * D + col;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

// dq [B, Sq, Hq, D] = bf16(scale * dq_accum [B, Hq, Sq_pad, D]), 8 columns
// a thread.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_convert_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq, long n8,
                         int Sq, int Sq_pad, int Hq, float scale) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const long e = idx * 8;
  const int d = (int)(e % D);
  const long row = e / D;  // (b, i, h) of dq
  const int h = (int)(row % Hq);
  const long bi = row / Hq;
  const int i = (int)(bi % Sq);
  const long b = bi / Sq;
  const float* src = dq_accum + ((b * Hq + h) * Sq_pad + i) * D + d;
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  uint4 out;
  out.x = pack_bf16(lo.x * scale, lo.y * scale);
  out.y = pack_bf16(lo.z * scale, lo.w * scale);
  out.z = pack_bf16(hi.x * scale, hi.y * scale);
  out.w = pack_bf16(hi.z * scale, hi.w * scale);
  *reinterpret_cast<uint4*>(dq + e) = out;
}

// ------------------------------------------------------------ f32 path

constexpr int kF32Threads = 256;
constexpr int kF32Keys = 64;  // keys of a dK/dV block, rows of a dQ block
constexpr int kF32Step = 32;  // query rows (dK/dV) or keys (dQ) per step

template <int D>
constexpr size_t f32_smem_bytes() {
  // two [64][D+1] and two [32][D+1] tiles, two [64][33] score tiles, 2 x 32
  return sizeof(float) * (2 * (size_t)kF32Keys * (D + 1) + 2 * (size_t)kF32Step * (D + 1) +
                          2 * (size_t)kF32Keys * (kF32Step + 1) + 2 * kF32Step);
}

// Rows [s0, s0 + rows) of head h of batch b of a [B, S, H, D] f32 tensor
// into a [rows][D + 1] tile; rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_f32_tile(const float* __restrict__ src, int b, int s0,
                                              int S, int H, int h, int rows, float* dst) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kF32Threads) {
    const int r = idx / D;
    const int c = idx % D;
    dst[r * (D + 1) + c] =
        s0 + r < S ? src[(((size_t)b * S + s0 + r) * H + h) * D + c] : 0.f;
  }
}

// dK/dV of a 64-key tile on the CUDA cores: thread (j = tid / 4, tid % 4)
// owns key j's columns tid % 4 + 4m of dK and dV, and the score entries
// (j, tid % 4 + 4m) of each 32-row query step.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                          int Hq, int Hkv, float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int SP = kF32Step + 1;
  constexpr int NC = D / 4;  // output columns per thread
  extern __shared__ float f32_smem[];
  float* Ks = f32_smem;
  float* Vs = Ks + kF32Keys * DP;
  float* Qs = Vs + kF32Keys * DP;
  float* dOs = Qs + kF32Step * DP;
  float* Ps = dOs + kF32Step * DP;
  float* dSs = Ps + kF32Keys * SP;
  float* lse_s = dSs + kF32Keys * SP;
  float* delta_s = lse_s + kF32Step;

  const int k0 = blockIdx.x * kF32Keys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int off = Sk - Sq;
  const int jr = threadIdx.x / 4;  // key row within the tile
  const int part = threadIdx.x % 4;
  const int j = k0 + jr;

  load_f32_tile<D>(k, b, k0, Sk, Hkv, hk, kF32Keys, Ks);
  load_f32_tile<D>(v, b, k0, Sk, Hkv, hk, kF32Keys, Vs);
  float dka[NC], dva[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) dka[m] = dva[m] = 0.f;

  const int q_begin = causal ? max(0, k0 - off) / kF32Step * kF32Step : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    for (int q0 = q_begin; q0 < Sq; q0 += kF32Step) {
      __syncthreads();
      load_f32_tile<D>(q, b, q0, Sq, Hq, h, kF32Step, Qs);
      load_f32_tile<D>(dout, b, q0, Sq, Hq, h, kF32Step, dOs);
      if (threadIdx.x < kF32Step) {
        const int i = q0 + threadIdx.x;
        const size_t o = ((size_t)b * Hq + h) * Sq + i;
        lse_s[threadIdx.x] = i < Sq ? lse[o] : -INFINITY;
        delta_s[threadIdx.x] = i < Sq ? delta[o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kF32Step / 4; ++m) {
        const int ir = part + 4 * m;
        const int i = q0 + ir;
        float s = 0.f, dpv = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s += Ks[jr * DP + d] * Qs[ir * DP + d];
          dpv += Vs[jr * DP + d] * dOs[ir * DP + d];
        }
        const float l = lse_s[ir];
        const bool vis = i < Sq && j < Sk && l != -INFINITY && (!causal || j <= i + off);
        const float p = vis ? expf(s * scale - l) : 0.f;
        Ps[jr * SP + ir] = p;
        dSs[jr * SP + ir] = p * (dpv - delta_s[ir]);
      }
      __syncthreads();
      for (int ir = 0; ir < kF32Step; ++ir) {
        const float p = Ps[jr * SP + ir];
        const float ds = dSs[jr * SP + ir];
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          dva[m] += p * dOs[ir * DP + part + 4 * m];
          dka[m] += ds * Qs[ir * DP + part + 4 * m];
        }
      }
    }
  }
  if (j < Sk) {
    const size_t o = (((size_t)b * Sk + j) * Hkv + hk) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) {
      dk[o + part + 4 * m] = dka[m] * scale;
      dv[o + part + 4 * m] = dva[m];
    }
  }
}

// dQ of a 64-row query tile on the CUDA cores: thread (i = tid / 4,
// tid % 4) owns row i's columns tid % 4 + 4m of dQ and the score entries
// (i, tid % 4 + 4m) of each 32-key step.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, float scale,
                        int causal) {
  constexpr int DP = D + 1;
  constexpr int SP = kF32Step + 1;
  constexpr int NC = D / 4;
  extern __shared__ float f32_smem[];
  float* Qs = f32_smem;
  float* dOs = Qs + kF32Keys * DP;
  float* Ks = dOs + kF32Keys * DP;
  float* Vs = Ks + kF32Step * DP;
  float* dSs = Vs + kF32Step * DP;

  const int q0 = blockIdx.x * kF32Keys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  const int ir = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int i = q0 + ir;

  load_f32_tile<D>(q, b, q0, Sq, Hq, h, kF32Keys, Qs);
  load_f32_tile<D>(dout, b, q0, Sq, Hq, h, kF32Keys, dOs);
  const size_t ro = ((size_t)b * Hq + h) * Sq + i;
  const float l = i < Sq ? lse[ro] : -INFINITY;
  const float dl = i < Sq ? delta[ro] : 0.f;
  int k_end = Sk;
  if (causal) k_end = max(0, min(Sk, min(q0 + kF32Keys, Sq) + off));

  float dqa[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) dqa[m] = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += kF32Step) {
    __syncthreads();
    load_f32_tile<D>(k, b, k0, Sk, Hkv, hk, kF32Step, Ks);
    load_f32_tile<D>(v, b, k0, Sk, Hkv, hk, kF32Step, Vs);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kF32Step / 4; ++m) {
      const int jr = part + 4 * m;
      const int j = k0 + jr;
      float s = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s += Qs[ir * DP + d] * Ks[jr * DP + d];
        dpv += dOs[ir * DP + d] * Vs[jr * DP + d];
      }
      const bool vis = i < Sq && j < Sk && l != -INFINITY && (!causal || j <= i + off);
      const float p = vis ? expf(s * scale - l) : 0.f;
      dSs[ir * SP + jr] = p * (dpv - dl);
    }
    __syncthreads();
    for (int jr = 0; jr < kF32Step; ++jr) {
      const float ds = dSs[ir * SP + jr];
#pragma unroll
      for (int m = 0; m < NC; ++m) dqa[m] += ds * Ks[jr * DP + part + 4 * m];
    }
  }
  if (i < Sq) {
    const size_t o = (((size_t)b * Sq + i) * Hq + h) * D;
#pragma unroll
    for (int m = 0; m < NC; ++m) dq[o + part + 4 * m] = dqa[m] * scale;
  }
}

// ------------------------------------------------------------ launches

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = true;
  return e;
}

template <typename T, int D>
cudaError_t launch_prep(const void* o, const void* dout, const float* lse, float* delta,
                        float* lse_log2, float* dq_accum, int B, int Sq, int Sq_pad, int Hq,
                        cudaStream_t stream) {
  const long rows = (long)B * Hq * Sq_pad;
  const long threads = rows * (D / Vec<T>::N);
  flash_bwd_prep_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, lse_log2, dq_accum,
      rows, Sq, Sq_pad, Hq);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, float* lse_log2,
                        float* dq_accum, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                        int Hq, int Hkv, int causal, cudaStream_t stream) {
  constexpr int R = q_rows<D>();
  const int Sq_pad = (Sq + R - 1) / R * R;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_bshd(&q_map, q, B, Sq, Hq, D, R) || !encode_bshd(&do_map, dout, B, Sq, Hq, D, R) ||
      !encode_bshd(&k_map, k, B, Sk, Hkv, D, kKeys) ||
      !encode_bshd(&v_map, v, B, Sk, Hkv, D, kKeys))
    return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_wgmma_kernel<D>, BwdSmem<D>::kBytes, &configured);
  if (e != cudaSuccess) return e;
  e = launch_prep<bf16, D>(o, dout, lse, delta, lse_log2, dq_accum, B, Sq, Sq_pad, Hq, stream);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)D);
  flash_bwd_wgmma_kernel<D>
      <<<dim3(Hkv, B, (Sk + kKeys - 1) / kKeys), kWsThreads, BwdSmem<D>::kBytes, stream>>>(
          q_map, k_map, v_map, do_map, lse_log2, delta, dq_accum, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, Sq_pad, scale, scale * kLog2e, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n8 = (long)B * Sq * Hq * D / 8;
  flash_bwd_convert_kernel<D><<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
      dq_accum, static_cast<bf16*>(dq), n8, Sq, Sq_pad, Hq, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_bwd_dkdv_f32_kernel<D>, f32_smem_bytes<D>(), &dkdv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dq_f32_kernel<D>, f32_smem_bytes<D>(), &dq_ok);
  if (e != cudaSuccess) return e;
  e = launch_prep<float, D>(o, dout, lse, delta, nullptr, nullptr, B, Sq, Sq, Hq, stream);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)D);
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dout);
  flash_bwd_dkdv_f32_kernel<D><<<dim3((Sk + kF32Keys - 1) / kF32Keys, Hkv, B), kF32Threads,
                                 f32_smem_bytes<D>(), stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk,
      Hq, Hkv, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_f32_kernel<D><<<dim3((Sq + kF32Keys - 1) / kF32Keys, Hq, B), kF32Threads,
                               f32_smem_bytes<D>(), stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dq), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dout/dq [B, Sq, Hq, D], k/v/dk/dv
// [B, Sk, Hkv, D] of that dtype; lse f32 [B, Hq, Sq] from the forward.
// block_k and block_q are the bf16 kernel's tiles (keys, query rows) as the
// caller sized its scratch; a pair this library was not compiled with is
// refused. Scratch, all f32: bf16 takes delta and lse_log2 [B, Hq, Sq_pad]
// and dq_accum [B, Hq, Sq_pad, D] with Sq_pad = Sq rounded up to block_q;
// float32 takes delta [B, Hq, Sq] and null for the other two. Returns the
// cudaError_t of the first launch that failed, else of the last.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* lse_log2, void* dq_accum, void* dq,
                                      void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                                      int Hkv, int D, int causal, int dtype, int block_k,
                                      int block_q, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1) || block_k != kKeys ||
      block_q != (D == 64 ? q_rows<64>() : q_rows<128>()))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (lse_log2 == nullptr || dq_accum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* l2 = static_cast<float*>(lse_log2);
  float* acc = static_cast<float*>(dq_accum);
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  if (D == 64) return (int)launch_bf16<64>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  return (int)launch_bf16<128>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
}

extern "C" const char* rt_flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
