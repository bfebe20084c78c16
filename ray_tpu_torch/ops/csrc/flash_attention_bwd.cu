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
// the five products on wgmma and computes each of them once. The small f32
// shapes the port runs are bound by operations too, but at a microsecond or
// so (B1 S256 H4 D64: 0.08 GFLOP of f32 FMAs, 0.0013 ms at the 67 TFLOP/s
// peak; 2.1 MB, 0.0006 ms), far below a launch's latency, so there the
// design is about latency: enough blocks, a short chain per block.
//
// bfloat16 (FlashAttention-3's backward), three launches per call (four
// when blocks share a KV head):
// 1. prep: Delta (from the returned O, already rounded to its dtype) and
//    the logsumexp in the scaled log2 domain, both f32 [B, Hq, Sq_pad] with
//    Sq_pad = Sq rounded up to the query tile; a row past Sq or without a
//    visible key gets lse +inf, so its P is exp2(-inf) = 0 and never NaN. It
//    also zeroes the f32 dQ accumulator.
// 2. main: one block per (128-key tile, KV head [x hsplit], batch), key
//    tile 0 (the one every causal query row sees) issued first, three
//    warpgroups.
//    - A producer warpgroup gives its registers away (setmaxnreg 40); one
//      thread loads K and V once by TMA, then streams the Q and dO tiles of
//      its query heads, from the first query tile that sees the key tile,
//      into a ring of stages<DT>() stages (three; two at the tile of 256),
//      with full and empty mbarriers, their lse and Delta by bulk copy. The
//      tensor maps are 4-D over [B, S, H, D] as they lie in memory, 64
//      columns per box in the 128-byte swizzle (at D = 32 and 16 the whole
//      row per box, in the 64- or 32-byte swizzle); rows past Sq or Sk come
//      back as zeros.
//    - Two consumer warpgroups (setmaxnreg 232) own 64 keys each. Per
//      query tile: S^T = K Q^T and dP^T = V dO^T as SS wgmma with Q and dO
//      read K-major; P^T = exp2(S^T scale log2 e - lse) and
//      dS^T = P^T (dP^T - Delta) in registers, rounded to bf16 (masks only
//      on tiles that cross the causal diagonal or the Sk edge); dV += P^T dO
//      and dK += dS^T Q as register-sourced wgmma that read dO and Q
//      MN-major through the transpose bit, so nothing is transposed; dS^T
//      goes to shared memory (double-buffered) and, after a named barrier
//      between the two warpgroups (dQ = dS K needs both halves of dS^T),
//      which each reaches with its dV and dK products done, dQ = dS K is
//      an SS wgmma reading dS and K MN-major, each warpgroup one 64 x 64
//      block of it (64 x D at D = 32 and 16, m64n32k16 / m64n16k16 reading
//      K's narrow rows MN-major). Five products per visible tile pair,
//      each once.
//    - dQ leaves the registers through shared memory: past that barrier
//      neither warpgroup reads the stage's Q or dO tile again, so
//      warpgroup 0 stores its f32 dQ block into the Q tile and warpgroup 1
//      into the dO tile (each tile's bytes are exactly one warpgroup's dQ
//      blocks), in the order the accumulator holds it, with conflict-free
//      8-byte stores; one thread of each adds the block to the f32
//      accumulator with one bulk reduce-add (cp.reduce.async.bulk .add.f32,
//      the adds done in the L2); the stage is released once the copy
//      engine has read it, which with three stages is checked a tile
//      later, so no thread waits. The
//      accumulator is tile-major (dq_block_offset): each 64-row block is
//      one contiguous span, so a reduce-add is one copy. This replaces 16
//      float2 atomics per thread per tile, which held both warpgroups while
//      the tensor cores waited, and frees the shared memory of a third
//      stage. No thread waits on a reduce-add: the next tile's S^T and
//      dP^T are issued once the dQ registers are stored. (Issuing them
//      right behind the dQ product instead, with dQ's registers live, made
//      ptxas serialise the wgmma (C7515) and the training shape 10%
//      slower: PERF.md.)
//    - dK and dV stay in registers across the block's query heads (the GQA
//      sum inside the block) and are written once. Where a grid of one
//      block per key tile leaves SMs idle (GQA, MQA), hsplit blocks share a
//      KV head's query heads (ops/flash_attention.py, bwd_head_split, at
//      every width): each writes its f32 dK and dV partial to a slot of its
//      own, [hsplit][2][B, Sk, Hkv, d], and flash_bwd_convert_dkv_kernel
//      adds the slots in slot order and rounds to bf16. With hsplit = 1
//      nothing is written to slots and there is no fourth launch.
// 3. convert: dq = bf16(scale * accumulator), undoing the tile-major layout.
// dq is a sum of reduce-adds whose order changes from run to run, so its
// last bf16 bit may differ between two calls on the same inputs; dk and dv
// are bitwise repeatable at every width and split.
//
// At D = 32 and 16 the products shrink with D but the exponentials (one per
// visible score) do not, so they, not the products, bound those instances;
// the schedule is the same, with 128-row query tiles (dK and dV are 16 or
// 32 registers a thread there).
//
// Other head dims (every multiple of 8 from 8 to 256) run on a
// runtime-width instance, flash_bwd_wgmma_rt_kernel<DT>, at the tile DT
// that is the power of two at or above it (16 to 256; TMA fills the
// columns past D with zeros), with the prep and convert kernels taking D at
// run time; the reduce-adds of their dQ blocks stop at D.
// Phi-2's and Phi-3-mini's D = 80 and 96 run the tile of 128: instances of
// their own (S^T and dP^T in D / 16 k-steps) were no faster on an H100
// (PERF.md, chip_smoke.py phase 2's rows). At the tile of 256 (Gemma's
// D = 256) a block owns 64 keys, which both consumer warpgroups share:
// each computes their S^T and dP^T over all 256 columns (those two products
// run twice) and owns half of the columns of dK and dV (64 registers each),
// the first writes dS^T, and each computes dQ's two 64-column blocks of its
// half one after the other; shared memory holds K, V, two stages of 64-row
// Q and dO tiles and dS^T in 215 KB.
//
// float32: the f32 path below (its own header), two launches: the prep
// (Delta), then flash_bwd_f32_kernel<DT> at the tile DT of D.
//
// Resources (nvcc -Xptxas -v, sm_90a): see PERF.md (the ptxas lines that
// chip_smoke.py prints for every instance).

#include <math.h>

#include "common.cuh"
#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::load_vec;
using rt::Vec;
using namespace hopper;
using namespace f32tile;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ prep

// One row (b, h, i) of [B, Hq, Sq_pad] per L = min(32, D / VEC)
// neighbouring lanes (a lane holds D / VEC / L 16-byte slices; D is the
// tile width, d the head dim, the slices at or past d read as zeros):
// delta = sum_d dO[b, i, h, d] O[b, i, h, d] in f32 (0 past Sq). Where
// given, lse_log2 = lse log2(e) (+inf past Sq and for a row without a
// visible key), and dq_accum (rows x d floats, tile-major: see
// dq_block_offset) is zeroed, 8 floats a thread.
template <typename T, int D, bool kRt>
__device__ __forceinline__ void flash_bwd_prep_body(const T* __restrict__ o,
                                                    const T* __restrict__ dout,
                                                    const float* __restrict__ lse,
                                                    float* __restrict__ delta,
                                                    float* __restrict__ lse_log2,
                                                    float* __restrict__ dq_accum, long rows,
                                                    int Sq, int Sq_pad, int Hq, const int d) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC < 32 ? D / VEC : 32;  // lanes per row
  constexpr int NV = D / VEC / VPR;                  // slices a lane holds
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long r = gid / VPR;
  const int c = (int)(gid % VPR) * VEC;
  const long bh = r / Sq_pad;
  const int i = (int)(r % Sq_pad);
  float acc = 0.f;
  if (r < rows && i < Sq) {
    const size_t src = (((size_t)(bh / Hq) * Sq + i) * Hq + bh % Hq) * d + c;
#pragma unroll
    for (int sl = 0; sl < NV; ++sl) {
      if (kRt && c + sl * VPR * VEC >= d) continue;
      float a[VEC], g[VEC];
      load_vec(o + src + sl * VPR * VEC, a);
      load_vec(dout + src + sl * VPR * VEC, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc += a[e] * g[e];
    }
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
  if (dq_accum != nullptr && gid * 8 < rows * d) {  // bf16: D / 8 threads a row
    float4* z = reinterpret_cast<float4*>(dq_accum + gid * 8);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ delta,
                      float* __restrict__ lse_log2, float* __restrict__ dq_accum, long rows,
                      int Sq, int Sq_pad, int Hq) {
  flash_bwd_prep_body<T, D, false>(o, dout, lse, delta, lse_log2, dq_accum, rows, Sq, Sq_pad,
                                   Hq, D);
}

// Runtime widths: head dim d, a multiple of 8, at most D.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_rt_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ delta,
                         float* __restrict__ lse_log2, float* __restrict__ dq_accum, long rows,
                         int Sq, int Sq_pad, int Hq, int d) {
  flash_bwd_prep_body<T, D, true>(o, dout, lse, delta, lse_log2, dq_accum, rows, Sq, Sq_pad,
                                  Hq, d);
}

// ------------------------------------------------------------ bf16 path

constexpr int kWgThreads = 128;             // one warpgroup
constexpr int kWsThreads = 3 * kWgThreads;  // producer + two consumers

// An instance is named by its head dim D (0 for a runtime-width instance,
// which takes D as an argument) and its tile width DT, the columns of a
// tile row in shared memory: D itself at 16, 32, 64 and 128; the power of
// two at or above D for a runtime width (TMA fills the columns past D with
// zeros).

// Keys per block: 128, 64 for each consumer warpgroup; at a tile of 256
// columns 64, which both warpgroups share, each owning half of the
// columns of dK and dV (64 keys x 256 columns of f32 are 128 registers a
// thread for each; the halves keep them at D = 128's).
template <int DT>
__host__ __device__ constexpr int keys() {
  return DT == 256 ? 64 : 128;
}

// Query rows per tile: 128 at tiles up to 64 columns; 64 at 128 and 256,
// where shared memory holds no more.
template <int DT>
__host__ __device__ constexpr int q_rows() {
  return DT >= 128 ? 64 : 128;
}

// Columns of a warpgroup's dV and dK products and accumulators: the tile
// (at a runtime width the ones past D are products with the zeros TMA
// filled), or half of the tile of 256.
template <int DT>
__host__ __device__ constexpr int grad_width() {
  return DT == 256 ? DT / 2 : DT;
}

// Depth of the Q / dO ring: three stages where shared memory holds them,
// since a stage is released only once its dQ staging has been read.
template <int DT>
__host__ __device__ constexpr int stages() {
  return DT == 256 ? 2 : 3;
}

// Shared memory of one block, from a 1024-byte aligned base: K and V,
// stages<DT>() Q and dO tiles (each [panels][rows][64 columns] bf16 in the
// 128-byte swizzle; at a tile of 32 and 16 columns [rows][DT columns] in
// the 64- or 32-byte swizzle), two dS^T buffers ([rows / 64 panels][keys]
// [64 query rows], 128-byte swizzle), then a stage's rows of lse and of
// Delta (f32) for each stage.
template <int DT>
struct BwdSmem {
  static constexpr int kStages = stages<DT>();
  static constexpr int kRows = q_rows<DT>();
  static constexpr int kKeys = keys<DT>();
  static constexpr int kRowBytes = row_bytes<DT>() * panels<DT>();
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kKPanel = kKeys * 128;  // a K or V panel, a dS^T panel
  static constexpr int kKVBytes = kKeys * kRowBytes;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kDSBytes = (kRows / 64) * kKPanel;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kDS = kDO + kStages * kQBytes;
  static constexpr int kLse = kDS + 2 * kDSBytes;
  static_assert(kQBytes >= 64 * (DT < 64 ? DT : 64) * 4 * (DT == 256 ? 2 : 1),
                "a Q or dO tile holds its warpgroup's dQ blocks in f32");
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kBytes = kDelta + kStages * kRows * 4 + 1024;  // + alignment
};

// mbarriers: K and V full; Q/dO/lse/Delta full and empty for each stage.
enum { kKVFull = 0, kFull = 1 };
template <int DT>
__host__ __device__ constexpr int empty_bar() {
  return 1 + stages<DT>();
}
template <int DT>
__host__ __device__ constexpr int num_bars() {
  return 1 + 2 * stages<DT>();
}

// dQ's f32 accumulator is tile-major: for each (b, h) and 64 query rows,
// 64 d floats, in blocks of 64 rows x 64 columns (the last min(64, d -
// 64 cb) wide), each block one contiguous span in the order a warpgroup's
// wgmma accumulator holds it (float pair p of thread tid at p * 256 +
// 2 tid), so that a consumer warpgroup stores its block to shared memory
// with conflict-free 8-byte stores and adds it with one bulk reduce-add.
// Its first w columns are its first 64 w floats, so a block narrower than
// 64 (D = 16, 32, or the columns up to a runtime width) is a prefix. The
// float offset of row r, column c of a block (hopper.cuh: row r is
// 16 w + g + 8 hh, column c is 8 j + 2 t + e):
__host__ __device__ constexpr int dq_block_offset(int r, int c) {
  return (2 * (c / 8) + (r / 8) % 2) * 256 + (32 * (r / 16) + 4 * (r % 8) + (c % 8) / 2) * 2 +
         c % 2;
}

// S^T (64 keys x 64 query rows) = K_wg Q^T over D, or dP^T = V_wg dO^T:
// a is this warpgroup's 64 rows of the K (V) tile, b 64 rows of a Q (dO)
// tile, both K-major; a k-step of 16 columns is 32 bytes along a swizzled
// row, every 4 steps the next panel (one panel at tiles of 32 and 16).
template <int D, int DT>
__device__ __forceinline__ void issue_scores(float* acc, uint32_t a, uint32_t b) {
  using L = BwdSmem<DT>;
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    if constexpr (DT < 64) {
      const uint64_t da = k_major_desc_narrow<DT>(a + kk * 32);
      const uint64_t db = k_major_desc_narrow<DT>(b + kk * 32);
      if (kk == 0)
        wgmma_ss_n64_first<0, 0>(acc, da, db);
      else
        wgmma_ss_n64<0, 0>(acc, da, db);
    } else {
      const uint64_t da = k_major_desc(a + (kk / 4) * L::kKPanel + (kk % 4) * 32);
      const uint64_t db = k_major_desc(b + (kk / 4) * L::kQPanel + (kk % 4) * 32);
      if (kk == 0)
        wgmma_ss_n64_first<0, 0>(acc, da, db);
      else
        wgmma_ss_n64<0, 0>(acc, da, db);
    }
  }
}

// dV (64 keys x grad_width) += P^T (64 keys x 64 query rows, registers)
// dO (64 rows x D), or dK += dS^T Q: b 64 rows of a dO (Q) tile from the
// warpgroup's first column, read MN-major; a k-step of 16 query rows is 16
// rows (2048 bytes) of every panel (16 rows of 2DT bytes at tiles of 32
// and 16).
template <int DT>
__device__ __forceinline__ void issue_grad(float* acc, const uint32_t* frag, uint32_t b) {
  constexpr int kN = grad_width<DT>();
  constexpr uint32_t kP = BwdSmem<DT>::kQPanel;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DT < 64)
      wgmma_rs_narrow<DT>(acc, frag + 4 * kk, mn_major_desc_narrow<DT>(b + kk * 16 * 2 * DT), 1);
    else if constexpr (kN == 64)
      wgmma_rs_n64(acc, frag + 4 * kk, mn_major_desc(b + kk * 2048, kP), 1);
    else
      wgmma_rs_n128(acc, frag + 4 * kk, mn_major_desc(b + kk * 2048, kP), 1);
  }
}

// One 64 x 64 block of dQ = dS K over the block's keys: a the block's 64
// query rows of a dS^T buffer, b the block's 64 columns of the K tile,
// both read MN-major; a k-step of 16 keys is 2048 bytes.
template <int DT>
__device__ __forceinline__ void issue_dq(float* acc, uint32_t a, uint32_t b) {
  using L = BwdSmem<DT>;
#pragma unroll
  for (int kk = 0; kk < L::kKeys / 16; ++kk) {
    const uint64_t da = mn_major_desc(a + kk * 2048, L::kKPanel);
    const uint64_t db = mn_major_desc(b + kk * 2048, L::kKPanel);
    if (kk == 0)
      wgmma_ss_n64_first<1, 1>(acc, da, db);
    else
      wgmma_ss_n64<1, 1>(acc, da, db);
  }
}

// dQ (64 query rows x D) = dS K over the 128 keys at tiles of 32 and 16: a
// as in issue_dq, b the K tile's narrow rows, read MN-major; a k-step of 16
// keys is 2048 bytes of dS^T and 16 rows of K.
template <int D>
__device__ __forceinline__ void issue_dq_narrow(float* acc, uint32_t a, uint32_t b) {
  constexpr int kKPanel = BwdSmem<D>::kKPanel;
#pragma unroll
  for (int kk = 0; kk < keys<D>() / 16; ++kk)
    wgmma_ss_narrow<D, 1, 1>(acc, mn_major_desc(a + kk * 2048, kKPanel),
                             mn_major_desc_narrow<D>(b + kk * 16 * 2 * D), kk > 0);
}

// The block's work at head dim D (0: runtime width d) and tile width DT.
// Accumulator and A-fragment layouts of wgmma: hopper.cuh. Here the rows
// of S^T, dP^T, dK and dV are keys and the columns of S^T and dP^T query
// rows, so lse and Delta are read per column.
template <int D, int DT>
__device__ __forceinline__ void flash_bwd_wgmma_body(
    const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map,
    const CUtensorMap& do_map, const float* __restrict__ lse_log2,
    const float* __restrict__ delta, float* __restrict__ dq_accum, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int Sq_pad, float scale,
    float scale_log2, int causal, const int d, float* __restrict__ dkv_accum,
    const int hsplit) {
  using L = BwdSmem<DT>;
  constexpr int R = L::kRows;
  constexpr int kKeys = L::kKeys;
  // At the tile of 256 both consumer warpgroups own the block's 64 keys
  // (each computes their S^T and dP^T) and half of dK's and dV's columns.
  constexpr bool kSplitD = DT == 256;
  constexpr int kGradN = grad_width<DT>();
  constexpr bool kMaskCols = D != DT;  // columns past d exist in the tile
  constexpr int kStages = L::kStages;
  constexpr int kEmpty = empty_bar<DT>();
  extern __shared__ unsigned char bwd_smem_raw[];
  __shared__ __align__(8) uint64_t bars[num_bars<DT>()];

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

  // A block owns a key tile of one KV head and walks rep_blk of its query
  // heads: all of them, or with hsplit > 1 (few blocks) one hsplit-th, its
  // dK and dV then written to its slot of dkv_accum.
  const int hk = blockIdx.x / hsplit;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;  // key tile 0, the heaviest when causal, first
  const int rep = Hq / Hkv;
  const int rep_blk = rep / hsplit;
  const int h_first = hk * rep + (blockIdx.x % hsplit) * rep_blk;
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
      mbar_init(bar0 + 8 * (kEmpty + st), 2);  // one thread of each consumer warpgroup
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
      for (int p = 0; p < panels<DT>(); ++p) {
        tma_load_4d(k_s + p * L::kKPanel, &k_map, bar0 + 8 * kKVFull, p * 64, hk, k0, b);
        tma_load_4d(v_s + p * L::kKPanel, &v_map, bar0 + 8 * kKVFull, p * 64, hk, k0, b);
      }
      int n = 0;
      for (int hh = 0; hh < rep_blk; ++hh) {
        const int h = h_first + hh;
        for (int m = m_begin; m < m_begin + per_head; ++m, ++n) {
          const int st = n % kStages;
          const uint32_t full = bar0 + 8 * (kFull + st);
          mbar_wait(bar0 + 8 * (kEmpty + st), ((n / kStages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * L::kQBytes + 2 * R * 4);
#pragma unroll
          for (int p = 0; p < panels<DT>(); ++p) {
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
    // ---- consumer warpgroups: 64 keys each (or, at the tile of 256, the
    // same 64 keys and half of the columns each)
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int tid = threadIdx.x % kWgThreads;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int wg_keys = kSplitD ? 0 : c * 64;  // this warpgroup's first key in the block
    const int wg_key0 = k0 + wg_keys;
    const int key0 = wg_key0 + warp * 16 + g;  // this thread's keys key0, key0 + 8
    const int key1 = key0 + 8;
    const int lr = wg_keys + warp * 16 + g;    // key0's row in the tile
    const int col0 = kSplitD ? c * kGradN : 0;  // this warpgroup's first dK / dV column

    float dk_acc[kGradN / 2], dv_acc[kGradN / 2];
#pragma unroll
    for (int i = 0; i < kGradN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (per_head > 0) {
      constexpr int RB = row_bytes<DT>();
      const uint32_t k_a = k_s + wg_keys * RB;  // this warpgroup's rows of K and V
      const uint32_t v_a = v_s + wg_keys * RB;
      const uint32_t grad_b = (col0 / 64) * L::kQPanel;  // its first column's panel
      // this warpgroup's block of each dQ tile: query rows [dq_r0, dq_r0 +
      // 64) of the tile and columns [dq_c0, dq_c0 + 64 kDqBlocks), one
      // 64-column block at a time (two at the tile of 256, where both at
      // once serialised the products, C7512); a block of the tile-major
      // accumulator takes kDqFloats floats in shared memory and its
      // columns below d in global memory
      constexpr int kDqRegs = DT < 64 ? DT / 2 : 32;
      constexpr int kDqBlocks = DT == 256 ? 2 : 1;
      constexpr int kDqFloats = 64 * (DT < 64 ? DT : 64);
      const int dq_r0 = R == 128 ? c * 64 : 0;
      const int dq_c0 = R == 128 ? 0 : c * 64 * kDqBlocks;
      mbar_wait(bar0 + 8 * kKVFull, 0);
      // With three stages a stage is released one tile later, after the
      // next tile's products, when its reduce-adds have long read it: so no
      // thread waits on the copy engine. With two, at once.
      int pending = -1;  // the stage to release at the next tile
      int n = 0;
      for (int hh = 0; hh < rep_blk; ++hh) {
        const int h = h_first + hh;
        float* dq_h = dq_accum + ((size_t)b * Hq + h) * Sq_pad * d;
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
          issue_scores<D, DT>(s, k_a, q_b);
          wgmma_commit();
          issue_scores<D, DT>(dp, v_a, do_b);
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
            fence_regs<kGradN / 2>(dv_acc);
            fence_regs<kGradN / 2>(dk_acc);
            fence_regs<16>(pf);
            fence_regs<16>(df);
            wgmma_fence();
            issue_grad<DT>(dv_acc, pf, do_b + hf * 64 * RB + grad_b);
            issue_grad<DT>(dk_acc, df, q_b + hf * 64 * RB + grad_b);
            wgmma_commit();
            if (hf + 1 < R / 64) {  // the next half's scores, behind them
              issue_scores<D, DT>(s, k_a, q_b + (hf + 1) * 64 * RB);
              wgmma_commit();
              issue_scores<D, DT>(dp, v_a, do_b + (hf + 1) * 64 * RB);
              wgmma_commit();
            }
            // dS^T into this tile's buffer (panel hf), in the swizzle the
            // wgmma reads (the 4-byte stores of a warp hit 32 banks). The
            // buffer was last read two tiles ago, before both warpgroups
            // passed the barrier of the previous tile. At the tile of 256
            // both warpgroups hold the same dS^T; the first writes it.
            if (!kSplitD || c == 0) {
              unsigned char* ds_half = smem + L::kDS + (n & 1) * L::kDSBytes + hf * L::kKPanel;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int r = 4 * (j / 2) + 2 * (j % 2);
                const int piece = ((j ^ (lr & 7)) * 16) + t * 4;
                *reinterpret_cast<uint32_t*>(ds_half + piece + lr * 128) = df[r];
                *reinterpret_cast<uint32_t*>(ds_half + piece + (lr + 8) * 128) = df[r + 1];
              }
            }
          }
          // This warpgroup's products of the tile done, then one barrier:
          // after it both halves of dS^T are in place for dQ = dS K, and
          // neither warpgroup reads the stage's Q or dO tile again, so each
          // stages its dQ blocks in one of them (warpgroup 0 in Q, 1 in
          // dO; each tile holds exactly its warpgroup's f32 blocks).
          wgmma_wait<0>();
          fence_regs<kGradN / 2>(dv_acc);
          fence_regs<kGradN / 2>(dk_acc);
          fence_proxy_async();
          named_bar_sync(1, 2 * kWgThreads);
          if constexpr (kStages > 2) {  // the previous tile's stage, long read
            bulk_wait_read<0>();
            mbar_arrive_if(bar0 + 8 * (kEmpty + pending), tid == 0 && pending >= 0);
          }
          const uint32_t stage_off = (c == 0 ? L::kQ : L::kDO) + st * L::kQBytes;
#pragma unroll 1  // two blocks at the tile of 256: unrolled, their wgmma serialised (C7512)
          for (int blk = 0; blk < kDqBlocks; ++blk) {
            const int col = dq_c0 + blk * 64;
            float dq[kDqRegs];
            if constexpr (DT < 64) {
#pragma unroll
              for (int i = 0; i < kDqRegs; ++i) dq[i] = 0.f;
              issue_dq_narrow<DT>(dq, ds_b + (dq_r0 / 64) * L::kKPanel, k_s);
            } else {
              issue_dq<DT>(dq, ds_b + (dq_r0 / 64) * L::kKPanel, k_s + (col / 64) * L::kKPanel);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs<kDqRegs>(dq);
            // the block in float pairs in the accumulator's order, then one
            // thread adds it to the tile-major accumulator with a bulk
            // reduce-add; dQ's registers are free once stored
            float2* stage = reinterpret_cast<float2*>(smem + stage_off) + blk * kDqFloats / 2;
#pragma unroll
            for (int p = 0; p < kDqRegs / 2; ++p)
              stage[p * kWgThreads + tid] = make_float2(dq[2 * p], dq[2 * p + 1]);
            fence_proxy_async();
            named_bar_sync(3 + c, kWgThreads);
            const int cols = min(d - col, DT < 64 ? DT : 64);  // of this block below d
            float* dst = dq_h + (size_t)(q0 + dq_r0) * d + (size_t)col * 64;
            bulk_reduce_add_f32_if(dst, k_s + stage_off + blk * kDqFloats * 4, 256 * cols,
                                   tid == 0 && cols > 0);
            bulk_commit();
          }
          // the stage is free once the reduce-adds have read it
          if constexpr (kStages > 2) {
            pending = st;
          } else {
            bulk_wait_read<0>();
            mbar_arrive_if(bar0 + 8 * (kEmpty + st), tid == 0);
          }
        }
      }
    }

    if (dkv_accum != nullptr) {  // a share of the KV head's query heads: its slot
      const size_t n_kv = (size_t)gridDim.y * Sk * Hkv * d;
      float* dk_slot = dkv_accum + (blockIdx.x % hsplit) * 2 * n_kv;
      float* dv_slot = dk_slot + n_kv;
#pragma unroll
      for (int j = 0; j < kGradN / 8; ++j) {
        const int col = col0 + j * 8 + 2 * t;
        if (kMaskCols && col >= d) continue;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int key = hr ? key1 : key0;
          if (key >= Sk) continue;
          const size_t o = (((size_t)b * Sk + key) * Hkv + hk) * d + col;
          *reinterpret_cast<float2*>(dk_slot + o) =
              make_float2(dk_acc[4 * j + 2 * hr] * scale, dk_acc[4 * j + 2 * hr + 1] * scale);
          *reinterpret_cast<float2*>(dv_slot + o) =
              make_float2(dv_acc[4 * j + 2 * hr], dv_acc[4 * j + 2 * hr + 1]);
        }
      }
      bulk_wait_read<0>();  // the last reduce-add has read shared memory: exit
      return;
    }
#pragma unroll
    for (int j = 0; j < kGradN / 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (kMaskCols && col >= d) continue;
      if (key0 < Sk) {
        const size_t o = (((size_t)b * Sk + key0) * Hkv + hk) * d + col;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key1 < Sk) {
        const size_t o = (((size_t)b * Sk + key1) * Hkv + hk) * d + col;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
    bulk_wait_read<0>();  // the last reduce-add has read shared memory: exit
  }
}

// The instances of head dims 16, 32, 64 and 128, and the runtime-width
// instances (head dim d, a multiple of 8, at most DT). With hsplit > 1 a KV
// head's query heads are shared among hsplit blocks, each writing its dK
// and dV to its slot of dkv_accum (f32 [hsplit][2][B, Sk, Hkv, d]).
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const float* __restrict__ lse_log2, const float* __restrict__ delta,
                       float* __restrict__ dq_accum, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int Sq_pad,
                       float scale, float scale_log2, int causal,
                       float* __restrict__ dkv_accum, int hsplit) {
  flash_bwd_wgmma_body<D, D>(q_map, k_map, v_map, do_map, lse_log2, delta, dq_accum, dk, dv,
                             Sq, Sk, Hq, Hkv, Sq_pad, scale, scale_log2, causal, D,
                             hsplit > 1 ? dkv_accum : nullptr, hsplit);
}

template <int DT>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_bwd_wgmma_rt_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse_log2, const float* __restrict__ delta,
                          float* __restrict__ dq_accum, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int Sq_pad,
                          float scale, float scale_log2, int causal, int d,
                          float* __restrict__ dkv_accum, int hsplit) {
  flash_bwd_wgmma_body<0, DT>(q_map, k_map, v_map, do_map, lse_log2, delta, dq_accum, dk, dv,
                              Sq, Sk, Hq, Hkv, Sq_pad, scale, scale_log2, causal, d,
                              hsplit > 1 ? dkv_accum : nullptr, hsplit);
}

// dk, dv [B, Sk, Hkv, d] = bf16 of the sums of the hsplit slots of
// dkv_accum [hsplit][2][B, Sk, Hkv, d] (dk already scaled), taken in slot
// order, 8 values a thread.
__global__ void __launch_bounds__(256)
flash_bwd_convert_dkv_kernel(const float* __restrict__ dkv_accum, bf16* __restrict__ dk,
                             bf16* __restrict__ dv, long n8, int hsplit) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * n8) return;
  const long e = (idx % n8) * 8;
  const float* src = dkv_accum + (idx >= n8 ? n8 * 8 : 0) + e;
  float4 lo = *reinterpret_cast<const float4*>(src);
  float4 hi = *reinterpret_cast<const float4*>(src + 4);
  for (int sl = 1; sl < hsplit; ++sl) {
    const float4 a = *reinterpret_cast<const float4*>(src + sl * 2 * n8 * 8);
    const float4 c = *reinterpret_cast<const float4*>(src + sl * 2 * n8 * 8 + 4);
    lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
    hi.x += c.x; hi.y += c.y; hi.z += c.z; hi.w += c.w;
  }
  uint4 out;
  out.x = pack_bf16(lo.x, lo.y);
  out.y = pack_bf16(lo.z, lo.w);
  out.z = pack_bf16(hi.x, hi.y);
  out.w = pack_bf16(hi.z, hi.w);
  *reinterpret_cast<uint4*>((idx >= n8 ? dv : dk) + e) = out;
}

// dq [B, Sq, Hq, d] = bf16(scale * dq_accum), the accumulator tile-major
// (dq_block_offset); 8 columns a thread, which lie in 8 consecutive floats
// of a block.
__device__ __forceinline__ void flash_bwd_convert_body(const float* __restrict__ dq_accum,
                                                       bf16* __restrict__ dq, long n8, int Sq,
                                                       int Sq_pad, int Hq, float scale,
                                                       const int d) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n8) return;
  const long e = idx * 8;
  const int c = (int)(e % d);
  const long row = e / d;  // (b, i, h) of dq
  const int h = (int)(row % Hq);
  const long bi = row / Hq;
  const int i = (int)(bi % Sq);
  const long b = bi / Sq;
  const float* src = dq_accum + ((b * Hq + h) * Sq_pad + (i - i % 64)) * d + (c / 64) * 4096 +
                     dq_block_offset(i % 64, c % 64);
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  uint4 out;
  out.x = pack_bf16(lo.x * scale, lo.y * scale);
  out.y = pack_bf16(lo.z * scale, lo.w * scale);
  out.z = pack_bf16(hi.x * scale, hi.y * scale);
  out.w = pack_bf16(hi.z * scale, hi.w * scale);
  *reinterpret_cast<uint4*>(dq + e) = out;
}

template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_convert_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq, long n8,
                         int Sq, int Sq_pad, int Hq, float scale) {
  flash_bwd_convert_body(dq_accum, dq, n8, Sq, Sq_pad, Hq, scale, D);
}

// Any head dim d that is a multiple of 8 (the runtime widths).
__global__ void __launch_bounds__(256)
flash_bwd_convert_rt_kernel(const float* __restrict__ dq_accum, bf16* __restrict__ dq,
                            long n8, int Sq, int Sq_pad, int Hq, float scale, int d) {
  flash_bwd_convert_body(dq_accum, dq, n8, Sq, Sq_pad, Hq, scale, d);
}

// ------------------------------------------------------------ f32 path
//
// Full f32 FMAs on the CUDA cores, one launch after the prep (which writes
// Delta). Its grid has two kinds of block:
// - a KV block owns a key tile (f32_keys<DT> keys) of one KV head and sums its
//   dK and dV over every query tile of the head's query heads that sees it;
// - a Q block owns a 32-row query tile of one query head and sums its dQ
//   over every key tile it sees.
// Each recomputes S = Q K^T and dP = dO V^T for its tile pairs, so a pair
// takes seven products, not five: the dQ of one query tile then needs no sum
// across blocks (no scratch partials, no second pass, no atomics), and at
// the f32 shapes the port runs the products are not what bounds the call
// (B1 S256 H4 D64: 0.08 GFLOP, about 1.3 us of the f32 peak) while each
// block's chain of tiles and its loads are. A block is kF32Groups<DT> groups
// of 64 threads that take its tiles in turn (group g the tiles g, g + G, ...)
// with their own two-stage cp.async ring, so a block's chain is 1/G of its
// tiles; the groups' sums are added in group order at the end. Every sum is
// in a fixed order, so dq, dk and dv are bitwise repeatable.
//
// Register tiles: in a group, S and dP (32 rows x f32_keys<DT> keys) are 4 x 4
// (4 x 2 at the tile of 256) a thread, read as float4 along D from rows of
// [rows][DT + 4] tiles (the 4 floats of padding put 8 rows on 32 banks);
// dK and dV (keys x DT) and dQ (32 x DT) are TR x TC a thread (f32_out),
// each float4 of P, dS, dO, Q or K read from shared memory feeding 4 to 32
// FMAs. P and dS go through shared memory between the two products.

template <int DT>
__host__ __device__ constexpr int f32_keys() {
  return DT == 256 ? 16 : 32;  // keys of a tile (dK and dV: 64 registers each)
}

template <int DT>
__host__ __device__ constexpr int f32_groups() {
  return DT <= 64 ? 4 : DT == 128 ? 2 : 1;  // shared memory bounds the groups
}

// Floats of a P / dS row.
template <int DT>
__host__ __device__ constexpr int f32_sld() {
  return f32_keys<DT>() + 8;
}

// Shared memory (floats): the block's fixed tiles (K and V of a KV block;
// Q, dO, lse and Delta of a Q block), then for each group two stages of
// streamed tiles (Q, dO, lse, Delta; or K and V) and its P and dS.
template <int DT>
struct F32Smem {
  static constexpr int kTile = kF32Rows * f32_ld<DT>();
  static constexpr int kPair = 2 * kTile + 2 * kF32Rows;  // two tiles and two rows
  static constexpr int kScratch = 2 * kF32Rows * f32_sld<DT>();
  static constexpr int kGroup = 2 * kPair + kScratch;
  static constexpr int kFloats = kPair + f32_groups<DT>() * kGroup;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

// S = Q K^T and dP = dO V^T of one tile pair (32 rows x KK keys) by a group
// thread t: rows t / 8 + 8x, keys t % 8 + 8y; then P = exp(scale S - lse)
// (0 where the key is not visible) and dS = P (dP - Delta), stored as
// P[row][key] and dS[row][key] (KV blocks) or dS^T[key][row] (Q blocks,
// kTransposed). q0 and k0 are the tile pair's first row and key.
template <int DT, bool kTransposed>
__device__ __forceinline__ void f32_scores(const float* Qs, const float* dOs, const float* Ks,
                                           const float* Vs, const float* lse_s,
                                           const float* delta_s, float* Ps, float* dSs, int q0,
                                           int k0, int Sq, int Sk, int off, int causal,
                                           float scale, int t) {
  constexpr int LD = f32_ld<DT>();
  constexpr int KK = f32_keys<DT>();
  constexpr int NY = KK / 8;
  const int tr = t / 8, tc = t % 8;
  float s[4][NY], dp[4][NY];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < NY; ++y) s[x][y] = dp[x][y] = 0.f;
#pragma unroll 4
  for (int k = 0; k < DT; k += 4) {
    float4 kb[NY], vb[NY];
#pragma unroll
    for (int y = 0; y < NY; ++y) {
      kb[y] = *reinterpret_cast<const float4*>(Ks + (tc + 8 * y) * LD + k);
      vb[y] = *reinterpret_cast<const float4*>(Vs + (tc + 8 * y) * LD + k);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 qa = *reinterpret_cast<const float4*>(Qs + (tr + 8 * x) * LD + k);
      const float4 da = *reinterpret_cast<const float4*>(dOs + (tr + 8 * x) * LD + k);
#pragma unroll
      for (int y = 0; y < NY; ++y) {
        s[x][y] = fmaf(qa.x, kb[y].x, s[x][y]);
        s[x][y] = fmaf(qa.y, kb[y].y, s[x][y]);
        s[x][y] = fmaf(qa.z, kb[y].z, s[x][y]);
        s[x][y] = fmaf(qa.w, kb[y].w, s[x][y]);
        dp[x][y] = fmaf(da.x, vb[y].x, dp[x][y]);
        dp[x][y] = fmaf(da.y, vb[y].y, dp[x][y]);
        dp[x][y] = fmaf(da.z, vb[y].z, dp[x][y]);
        dp[x][y] = fmaf(da.w, vb[y].w, dp[x][y]);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int r = tr + 8 * x;
    const int i = q0 + r;
    const float l = lse_s[r];
    const float dl = delta_s[r];
#pragma unroll
    for (int y = 0; y < NY; ++y) {
      const int c = tc + 8 * y;
      const int j = k0 + c;
      const bool vis = i < Sq && j < Sk && l != -INFINITY && (!causal || j <= i + off);
      const float p = vis ? expf(s[x][y] * scale - l) : 0.f;
      const float ds = p * (dp[x][y] - dl);
      if constexpr (kTransposed) {
        dSs[c * (kF32Rows + 4) + r] = ds;
      } else {
        Ps[r * f32_sld<DT>() + c] = p;
        dSs[r * f32_sld<DT>() + c] = ds;
      }
    }
  }
}

// A group thread's tile of an R x DT output (dK, dV: R = keys; dQ: R = 32):
// CT threads across the columns, TC columns each (float4 chunks CT * 4
// apart), 64 / CT threads down the rows, TR consecutive rows each.
template <int DT, int R>
struct f32_out {
  static constexpr int CT = DT / 4 < 8 ? DT / 4 : 8;
  static constexpr int TC = DT / CT;
  static constexpr int TR = R / (kF32GroupThreads / CT);
};

// TR consecutive floats from shared memory (TR = 1, 2 or 4).
template <int TR>
__device__ __forceinline__ void f32_load_col(float* a, const float* p) {
  if constexpr (TR == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else if constexpr (TR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = *p;
  }
}

// acc[x][4q + e] += sum over k < K of A[k][row0 + x] B[k][col(q) + e]: A
// rows of `lda` floats (P, dS or dS^T), B tile rows of DT + 4 (dO, Q or K).
template <int DT, int R, int K>
__device__ __forceinline__ void f32_outer(float (*acc)[f32_out<DT, R>::TC], const float* A,
                                          int lda, const float* B, int t) {
  using O = f32_out<DT, R>;
  const int row0 = (t / O::CT) * O::TR;
  const int col0 = (t % O::CT) * 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[O::TR];
    f32_load_col<O::TR>(a, A + k * lda + row0);
#pragma unroll
    for (int q = 0; q < O::TC / 4; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(B + k * f32_ld<DT>() + col0 + q * 4 * O::CT);
#pragma unroll
      for (int x = 0; x < O::TR; ++x) {
        acc[x][4 * q] = fmaf(a[x], bv.x, acc[x][4 * q]);
        acc[x][4 * q + 1] = fmaf(a[x], bv.y, acc[x][4 * q + 1]);
        acc[x][4 * q + 2] = fmaf(a[x], bv.z, acc[x][4 * q + 2]);
        acc[x][4 * q + 3] = fmaf(a[x], bv.w, acc[x][4 * q + 3]);
      }
    }
  }
}

// A thread's output tile into a dense [R][DT] block of shared memory.
template <int DT, int R>
__device__ __forceinline__ void f32_store_out(float* dst, float (*acc)[f32_out<DT, R>::TC],
                                              int t) {
  using O = f32_out<DT, R>;
  const int row0 = (t / O::CT) * O::TR;
  const int col0 = (t % O::CT) * 4;
#pragma unroll
  for (int x = 0; x < O::TR; ++x)
#pragma unroll
    for (int q = 0; q < O::TC / 4; ++q)
      *reinterpret_cast<float4*>(dst + (row0 + x) * DT + col0 + q * 4 * O::CT) =
          make_float4(acc[x][4 * q], acc[x][4 * q + 1], acc[x][4 * q + 2], acc[x][4 * q + 3]);
}

// rows x DT of f32 output [B, S, H, d] from the groups' dense [rows][DT]
// blocks (`n` of them, `stride` floats apart), summed in group order,
// times `mul`; rows past S and columns past d are not written.
template <int DT>
__device__ __forceinline__ void f32_write_sum(float* __restrict__ out, const float* parts,
                                              int n, int stride, int rows, float mul, int b,
                                              int s0, int S, int H, int h, int d) {
  constexpr int kChunks = DT / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    if (s0 + r >= S || c >= d) continue;
    float4 sum = *reinterpret_cast<const float4*>(parts + r * DT + c);
    for (int g = 1; g < n; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(parts + g * stride + r * DT + c);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (((size_t)b * S + s0 + r) * H + h) * d + c) =
        make_float4(sum.x * mul, sum.y * mul, sum.z * mul, sum.w * mul);
  }
}

// The f32 kernel at tile width DT (the power of two at or above the head
// dim d, at least 16; columns past d are zeros in shared memory). Blocks
// [0, n_kv) are KV blocks, key tile major (key tile 0, which every causal
// query row sees, first); the rest Q blocks, last query tile first.
template <int DT>
__global__ void __launch_bounds__(kF32GroupThreads * f32_groups<DT>())
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int B, int Sq, int Sk, int Hq, int Hkv, float scale, int causal, int d,
                     int n_kv) {
  using L = F32Smem<DT>;
  constexpr int G = f32_groups<DT>();
  constexpr int KK = f32_keys<DT>();
  extern __shared__ __align__(16) float f32_smem[];
  const int g = threadIdx.x / kF32GroupThreads;
  const int t = threadIdx.x % kF32GroupThreads;
  const int nt = blockDim.x;
  float* fixed = f32_smem;
  float* group = f32_smem + L::kPair + g * L::kGroup;
  float* scratch = group + 2 * L::kPair;
  const int rep = Hq / Hkv;
  const int off = Sk - Sq;
  const int nq = (Sq + kF32Rows - 1) / kF32Rows;

  if ((int)blockIdx.x < n_kv) {
    // ---- KV block: fixed K, V; streamed Q, dO, lse, Delta
    const int kt = blockIdx.x / (B * Hkv);
    const int hk = blockIdx.x % Hkv;
    const int b = blockIdx.x / Hkv % B;
    const int k0 = kt * KK;
    const float* Ks = fixed;
    const float* Vs = fixed + L::kTile;
    const int m_first = causal ? max(0, k0 - off) / kF32Rows : 0;
    const int per_head = nq - m_first;
    const int items = rep * per_head;
    // item n: query head hk * rep + n / per_head, query tile m_first + n % per_head
    auto load = [&](int n, float* st) {
      const int h = hk * rep + n / per_head;
      const int q0 = (m_first + n % per_head) * kF32Rows;
      f32_load_tile<DT>(st, q, b, q0, kF32Rows, Sq, Hq, h, d, t, kF32GroupThreads);
      f32_load_tile<DT>(st + L::kTile, dout, b, q0, kF32Rows, Sq, Hq, h, d, t,
                        kF32GroupThreads);
      const size_t row = ((size_t)b * Hq + h) * Sq;
      f32_load_row(st + 2 * L::kTile, lse, row, q0, Sq, t);
      f32_load_row(st + 2 * L::kTile + kF32Rows, delta, row, q0, Sq, t - kF32Rows);
    };
    f32_load_tile<DT>(fixed, k, b, k0, KK, Sk, Hkv, hk, d, threadIdx.x, nt);
    f32_load_tile<DT>(fixed + L::kTile, v, b, k0, KK, Sk, Hkv, hk, d, threadIdx.x, nt);
    if (g < items) load(g, group);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    using O = f32_out<DT, KK>;
    float dk_acc[O::TR][O::TC], dv_acc[O::TR][O::TC];
#pragma unroll
    for (int x = 0; x < O::TR; ++x)
#pragma unroll
      for (int c = 0; c < O::TC; ++c) dk_acc[x][c] = dv_acc[x][c] = 0.f;
    int it = 0;
    for (int n = g; n < items; n += G, ++it) {
      float* st = group + (it & 1) * L::kPair;
      cp_async_wait_all();
      named_bar_sync(1 + g, kF32GroupThreads);  // this tile in; the last one's products done
      if (n + G < items) load(n + G, group + ((it + 1) & 1) * L::kPair);
      cp_async_commit();
      const int q0 = (m_first + n % per_head) * kF32Rows;
      f32_scores<DT, false>(st, st + L::kTile, Ks, Vs, st + 2 * L::kTile,
                            st + 2 * L::kTile + kF32Rows, scratch,
                            scratch + kF32Rows * f32_sld<DT>(), q0, k0, Sq, Sk, off, causal,
                            scale, t);
      named_bar_sync(1 + g, kF32GroupThreads);
      f32_outer<DT, KK, kF32Rows>(dv_acc, scratch, f32_sld<DT>(), st + L::kTile, t);
      f32_outer<DT, KK, kF32Rows>(dk_acc, scratch + kF32Rows * f32_sld<DT>(), f32_sld<DT>(), st,
                                  t);
    }
    __syncthreads();  // every group's last products done: its stages hold its sums
    f32_store_out<DT, KK>(group, dk_acc, t);
    f32_store_out<DT, KK>(group + KK * DT, dv_acc, t);
    __syncthreads();
    float* parts = f32_smem + L::kPair;
    f32_write_sum<DT>(dk, parts, G, L::kGroup, KK, scale, b, k0, Sk, Hkv, hk, d);
    f32_write_sum<DT>(dv, parts + KK * DT, G, L::kGroup, KK, 1.f, b, k0, Sk, Hkv, hk, d);
  } else {
    // ---- Q block: fixed Q, dO, lse, Delta; streamed K, V
    const int y = blockIdx.x - n_kv;
    const int qt = nq - 1 - y / (B * Hq);
    const int h = y % Hq;
    const int b = y / Hq % B;
    const int hk = h / rep;
    const int q0 = qt * kF32Rows;
    const int k_end = causal ? max(0, min(Sk, min(q0 + kF32Rows, Sq) + off)) : Sk;
    const int items = (k_end + KK - 1) / KK;
    const float* Qs = fixed;
    const float* dOs = fixed + L::kTile;
    auto load = [&](int n, float* st) {
      f32_load_tile<DT>(st, k, b, n * KK, KK, Sk, Hkv, hk, d, t, kF32GroupThreads);
      f32_load_tile<DT>(st + L::kTile, v, b, n * KK, KK, Sk, Hkv, hk, d, t, kF32GroupThreads);
    };
    f32_load_tile<DT>(fixed, q, b, q0, kF32Rows, Sq, Hq, h, d, threadIdx.x, nt);
    f32_load_tile<DT>(fixed + L::kTile, dout, b, q0, kF32Rows, Sq, Hq, h, d, threadIdx.x, nt);
    const size_t row = ((size_t)b * Hq + h) * Sq;
    f32_load_row(fixed + 2 * L::kTile, lse, row, q0, Sq, threadIdx.x);
    f32_load_row(fixed + 2 * L::kTile + kF32Rows, delta, row, q0, Sq,
                 (int)threadIdx.x - kF32Rows);
    if (g < items) load(g, group);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    using O = f32_out<DT, kF32Rows>;
    float dq_acc[O::TR][O::TC];
#pragma unroll
    for (int x = 0; x < O::TR; ++x)
#pragma unroll
      for (int c = 0; c < O::TC; ++c) dq_acc[x][c] = 0.f;
    int it = 0;
    for (int n = g; n < items; n += G, ++it) {
      float* st = group + (it & 1) * L::kPair;
      cp_async_wait_all();
      named_bar_sync(1 + g, kF32GroupThreads);
      if (n + G < items) load(n + G, group + ((it + 1) & 1) * L::kPair);
      cp_async_commit();
      f32_scores<DT, true>(Qs, dOs, st, st + L::kTile, fixed + 2 * L::kTile,
                           fixed + 2 * L::kTile + kF32Rows, nullptr, scratch, q0, n * KK, Sq, Sk,
                           off, causal, scale, t);
      named_bar_sync(1 + g, kF32GroupThreads);
      f32_outer<DT, kF32Rows, KK>(dq_acc, scratch, kF32Rows + 4, st, t);
    }
    __syncthreads();
    f32_store_out<DT, kF32Rows>(group, dq_acc, t);
    __syncthreads();
    f32_write_sum<DT>(dq, f32_smem + L::kPair, G, L::kGroup, kF32Rows, scale, b, q0, Sq, Hq, h,
                      d);
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

// The prep of the exact instance of head dim D (kRt false, d == D), or of
// the tile D at head dim d.
template <typename T, int D, bool kRt>
cudaError_t launch_prep(const void* o, const void* dout, const float* lse, float* delta,
                        float* lse_log2, float* dq_accum, int B, int Sq, int Sq_pad, int Hq,
                        int d, cudaStream_t stream) {
  const long rows = (long)B * Hq * Sq_pad;
  constexpr int lanes = D / Vec<T>::N < 32 ? D / Vec<T>::N : 32;
  const long threads = rows * lanes;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  if constexpr (kRt)
    flash_bwd_prep_rt_kernel<T, D><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, lse_log2, dq_accum,
        rows, Sq, Sq_pad, Hq, d);
  else
    flash_bwd_prep_kernel<T, D><<<blocks, 256, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, lse_log2, dq_accum,
        rows, Sq, Sq_pad, Hq);
  return cudaGetLastError();
}

// The exact instance of head dim D (D > 0), or the runtime-width instance
// of tile DT at head dim d (D == 0).
template <int D, int DT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* delta, float* lse_log2,
                        float* dq_accum, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                        int Hq, int Hkv, int causal, int d, float* dkv_accum, int hsplit,
                        cudaStream_t stream) {
  constexpr int R = q_rows<DT>();
  constexpr int kK = keys<DT>();
  constexpr bool kExact = D == DT;  // D 16, 32, 64 or 128: the prep and convert of its own
  const int Sq_pad = (Sq + R - 1) / R * R;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_bshd(&q_map, q, B, Sq, Hq, d, R, DT) ||
      !encode_bshd(&do_map, dout, B, Sq, Hq, d, R, DT) ||
      !encode_bshd(&k_map, k, B, Sk, Hkv, d, kK, DT) ||
      !encode_bshd(&v_map, v, B, Sk, Hkv, d, kK, DT))
    return cudaErrorInvalidValue;
  static bool configured = false;
  cudaError_t e;
  if constexpr (D == 0)
    e = allow_smem(flash_bwd_wgmma_rt_kernel<DT>, BwdSmem<DT>::kBytes, &configured);
  else
    e = allow_smem(flash_bwd_wgmma_kernel<D>, BwdSmem<DT>::kBytes, &configured);
  if (e != cudaSuccess) return e;
  e = launch_prep<bf16, DT, !kExact>(o, dout, lse, delta, lse_log2, dq_accum, B, Sq, Sq_pad,
                                     Hq, d, stream);
  if (e != cudaSuccess) return e;
  const long dkv_n8 = (long)B * Sk * Hkv * d / 8;
  const float scale = 1.0f / sqrtf((float)d);
  const dim3 grid(Hkv * hsplit, B, (Sk + kK - 1) / kK);
  if constexpr (D == 0)
    flash_bwd_wgmma_rt_kernel<DT><<<grid, kWsThreads, BwdSmem<DT>::kBytes, stream>>>(
        q_map, k_map, v_map, do_map, lse_log2, delta, dq_accum, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, Sq_pad, scale, scale * kLog2e, causal, d,
        dkv_accum, hsplit);
  else
    flash_bwd_wgmma_kernel<D><<<grid, kWsThreads, BwdSmem<DT>::kBytes, stream>>>(
        q_map, k_map, v_map, do_map, lse_log2, delta, dq_accum, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Sk, Hq, Hkv, Sq_pad, scale, scale * kLog2e, causal,
        dkv_accum, hsplit);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (hsplit > 1) {
    flash_bwd_convert_dkv_kernel<<<(unsigned)((2 * dkv_n8 + 255) / 256), 256, 0, stream>>>(
        dkv_accum, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dkv_n8, hsplit);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const long n8 = (long)B * Sq * Hq * d / 8;
  const unsigned blocks = (unsigned)((n8 + 255) / 256);
  if constexpr (kExact)
    flash_bwd_convert_kernel<D><<<blocks, 256, 0, stream>>>(
        dq_accum, static_cast<bf16*>(dq), n8, Sq, Sq_pad, Hq, scale);
  else
    flash_bwd_convert_rt_kernel<<<blocks, 256, 0, stream>>>(
        dq_accum, static_cast<bf16*>(dq), n8, Sq, Sq_pad, Hq, scale, d);
  return cudaGetLastError();
}

// The f32 kernel of tile DT at head dim d: the prep (Delta), then one
// launch of its KV and Q blocks.
template <int DT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int causal, int d,
                       cudaStream_t stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_f32_kernel<DT>, F32Smem<DT>::kBytes, &configured);
  if (e != cudaSuccess) return e;
  e = launch_prep<float, DT, true>(o, dout, lse, delta, nullptr, nullptr, B, Sq, Sq, Hq, d,
                                   stream);
  if (e != cudaSuccess) return e;
  const int n_kv = B * Hkv * ((Sk + f32_keys<DT>() - 1) / f32_keys<DT>());
  const int n_q = B * Hq * ((Sq + kF32Rows - 1) / kF32Rows);
  flash_bwd_f32_kernel<DT><<<n_kv + n_q, kF32GroupThreads * f32_groups<DT>(),
                             F32Smem<DT>::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, Hq, Hkv,
      1.0f / sqrtf((float)d), causal, d, n_kv);
  return cudaGetLastError();
}

// The tile of a head dim: the power of two at or above it, at least 16
// (ops/flash_attention.py, kernel_tile).
inline int tile_of(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }

inline int keys_of(int DT) { return DT == 256 ? keys<256>() : keys<128>(); }
inline int q_rows_of(int DT) { return DT >= 128 ? q_rows<128>() : q_rows<64>(); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D a multiple of 8 from 8 to 256.
// q/o/dout/dq [B, Sq, Hq, D], k/v/dk/dv [B, Sk, Hkv, D] of that dtype; lse
// f32 [B, Hq, Sq] from the forward. block_k and block_q are the bf16
// kernel's tiles (keys, query rows) as the caller sized its scratch; a pair
// this library does not use at D is refused. Scratch, all f32: bf16 takes
// delta and lse_log2 [B, Hq, Sq_pad] and dq_accum of B Hq Sq_pad D floats
// (tile-major, dq_block_offset) with Sq_pad = Sq rounded up to block_q; float32 takes delta [B, Hq, Sq] and null for the other
// two. hsplit: blocks that share a KV head's query heads, a divisor of
// Hq / Hkv; above 1 only in bf16, with dkv_accum f32 [hsplit, 2, B, Sk,
// Hkv, D] (else null). Returns the cudaError_t of the first launch that
// failed, else of the last.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* lse_log2, void* dq_accum, void* dq,
                                      void* dk, void* dv, int B, int Sq, int Sk, int Hq,
                                      int Hkv, int D, int causal, int dtype, int block_k,
                                      int block_q, void* dkv_accum, int hsplit,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 256 ||
      D % 8 != 0 || (dtype != 0 && dtype != 1) || block_k != keys_of(tile_of(D)) ||
      block_q != q_rows_of(tile_of(D)) || hsplit < 1 || (Hq / Hkv) % hsplit != 0 ||
      (hsplit > 1 && (dtype != 1 || dkv_accum == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* dkv = static_cast<float*>(dkv_accum);
  if (dtype == 1 && (lse_log2 == nullptr || dq_accum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* l2 = static_cast<float*>(lse_log2);
  float* acc = static_cast<float*>(dq_accum);
  if (dtype == 0) {
    switch (tile_of(D)) {
      case 16: return (int)launch_f32<16>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 32: return (int)launch_f32<32>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 64: return (int)launch_f32<64>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, s);
      case 128: return (int)launch_f32<128>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, s);
      default: return (int)launch_f32<256>(q, k, v, o, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, s);
    }
  }
  switch (D) {  // the exact instances
    case 16: return (int)launch_bf16<16, 16>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 32: return (int)launch_bf16<32, 32>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 64: return (int)launch_bf16<64, 64>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 128: return (int)launch_bf16<128, 128>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    default: break;
  }
  switch (tile_of(D)) {
    case 16: return (int)launch_bf16<0, 16>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 32: return (int)launch_bf16<0, 32>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 64: return (int)launch_bf16<0, 64>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    case 128: return (int)launch_bf16<0, 128>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
    default: return (int)launch_bf16<0, 256>(q, k, v, o, dout, l, dl, l2, acc, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, D, dkv, hsplit, s);
  }
}

extern "C" const char* rt_flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
