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
// One call runs three launches (FlashAttention-2's backward):
// 1. delta: Delta from the returned O (already rounded to its dtype), f32.
// 2. dK/dV: one block per (64-key tile, KV head, batch). It loops over the
//    KV head's query heads and the query tiles that see the key tile,
//    recomputes S and dP, and keeps dK and dV of its keys in registers, so
//    the GQA sum happens inside the block and dk/dv are written once.
// 3. dQ: one block per (64-row query tile, head, batch), looping over the
//    key tiles its rows see; it recomputes S and dP again (7 products in all
//    against the 5 the gradient needs) so that dq needs no atomics and is
//    deterministic.
//
// Bound on the H100: the 5 products need 10 B Hq Sq Sk D flops (about half
// when causal) against reading q, k, v, o, dO, lse once and writing dq, dk,
// dv once. At the training shape (B4 S1024 H16 D64 causal) that is 21.5
// GFLOP against 67 MB, so the bf16 tensor-core peak allows 0.0217 ms and the
// bytes 0.0201 ms: operations bound the ideal kernel, by a little. This
// first version reaches neither: it loads each tile synchronously and
// multiplies on mma.sync (wgmma, TMA and one fused pass are later work).
//
// bfloat16: mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16
// rows. Tiles are staged in shared memory with rows padded by 16 bytes so
// fragment loads hit 32 banks; an operand read along its other axis has a
// transposed copy (Q and dO in the dK/dV kernel, K in the dQ kernel). P and
// dS are rounded to bf16 as the A operands of the products, as the forward
// rounds P. float32 runs on the CUDA cores (scores in shared memory) so the
// golden gradient check keeps full f32 precision.
//
// Resources (nvcc -Xptxas -v, sm_90a), no instance spills: bf16 dK/dV
// 168 registers (D=64) and 242 (D=128), dQ 128 and 166; f32 dK/dV 80 and
// 128, dQ 64 and 96; delta 24. Dynamic shared memory: bf16 dK/dV 55,808
// (D=64) and 72,960 (D=128) bytes, dQ 46,080 and 88,064; f32 67,072 and
// 116,224.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::load_vec;
using rt::Vec;

constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ delta

// Delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d] in f32. The rows of
// [B, Sq, Hq, D] are contiguous, so D / VEC neighbouring lanes take one row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int Hq) {
  constexpr int VEC = Vec<T>::N;
  constexpr int VPR = D / VEC;  // lanes per row, at most 32
  const long gid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long r = gid / VPR;
  const int c = (int)(gid % VPR) * VEC;
  float acc = 0.f;
  if (r < rows) {
    float a[VEC], g[VEC];
    load_vec(o + r * D + c, a);
    load_vec(dout + r * D + c, g);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc += a[e] * g[e];
  }
#pragma unroll
  for (int w = VPR / 2; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (r < rows && c == 0) {
    const long b = r / ((long)Sq * Hq);
    const int i = (int)(r / Hq % Sq);
    const int h = (int)(r % Hq);
    delta[(b * Hq + h) * Sq + i] = acc;
  }
}

// ------------------------------------------------------------ bf16 path

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;   // bf16 pad per shared-memory row (16 bytes)
constexpr int kKeys = 64; // keys of a dK/dV block; keys per step of dQ
constexpr int kRows = 64; // query rows of a dQ block

// Query rows per step of the dK/dV kernel: 64 at D = 64; 32 at D = 128,
// where dK and dV alone take 128 registers a thread.
template <int D>
__host__ __device__ constexpr int kv_step_rows() { return D == 64 ? 64 : 32; }

template <int D>
constexpr size_t dkdv_smem_bytes() {
  constexpr int BQ = kv_step_rows<D>();
  // Ks, Vs [64][D+pad]; Qs, dOs [BQ][D+pad]; Qt, dOt [D][BQ+pad]; lse, delta [BQ]
  return sizeof(bf16) * (2 * (size_t)kKeys * (D + kPad) + 2 * (size_t)BQ * (D + kPad) +
                         2 * (size_t)D * (BQ + kPad)) +
         2 * sizeof(float) * BQ;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs [64][D+pad]; Ks, Vs [64][D+pad]; Kt [D][64+pad]
  return sizeof(bf16) * (4 * (size_t)kRows * (D + kPad) + (size_t)D * (kKeys + kPad));
}

// c += a @ b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats as one register of two bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout of m16n8k16 (lane = 4 g + t): A holds rows g and g + 8,
// columns 2t, 2t + 1 (+ 8); B holds k rows 2t, 2t + 1 (+ 8) of column g;
// C holds rows g (c0, c1) and g + 8 (c2, c3), columns 2t and 2t + 1. So the
// C tiles 2kk and 2kk + 1 of a 16-row strip are the A fragment of k-step kk.

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int stride, int r0,
                                       int c0, int g, int t) {
  const bf16* p = tile + (r0 + g) * stride + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// B fragment (k rows [c0, c0 + 16), column n0 + g) of a tile stored with
// the n axis as rows and k contiguous.
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile, int stride, int n0,
                                       int c0, int g, int t) {
  const bf16* p = tile + (n0 + g) * stride + c0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// Rows [s0, s0 + ROWS) of head h of batch b of a [B, S, H, D] bf16 tensor
// into shared memory, row-major (stride D + kPad) and, where `trans` is
// given, transposed (trans[d][row], stride ROWS + kPad); rows past S are
// zeros. Neighbouring threads take neighbouring rows, so the 2-byte stores
// into a transposed row do not collide on a bank.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, int b, int s0, int S,
                                          int H, int h, bf16* rowmaj, bf16* trans) {
  constexpr int VPR = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += kThreads) {
    const int r = idx % ROWS;
    const int c = (idx / ROWS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (((size_t)b * S + s0 + r) * H + h) * D + c);
    *reinterpret_cast<uint4*>(rowmaj + r * (D + kPad) + c) = val;
    if (trans != nullptr) {
      const bf16* e8 = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) trans[(c + e) * (ROWS + kPad) + r] = e8[e];
    }
  }
}

// dK and dV of one 64-key tile: warp w owns keys k0 + 16w .. + 15. For each
// query tile, S^T = K Q^T and dP^T = V dO^T (16 keys x BQ rows per warp),
// P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
                          int Hq, int Hkv, float scale, float scale_log2, int causal) {
  constexpr int BQ = kv_step_rows<D>();
  constexpr int DS = D + kPad;   // row stride of the row-major tiles
  constexpr int TS = BQ + kPad;  // row stride of the transposed tiles
  constexpr int KD = D / 16;     // k-steps over the head dim
  constexpr int NQ = BQ / 8;     // 8-row column tiles of S^T
  constexpr int KQ = BQ / 16;    // k-steps over the query tile
  constexpr int ND = D / 8;      // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Vs = Ks + kKeys * DS;
  bf16* Qs = Vs + kKeys * DS;
  bf16* dOs = Qs + BQ * DS;
  bf16* Qt = dOs + BQ * DS;
  bf16* dOt = Qt + D * TS;
  float* lse_s = reinterpret_cast<float*>(dOt + D * TS);  // log2 domain
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = Hq / Hkv;
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int key0 = k0 + warp * 16 + g;  // this lane's two keys
  const int key1 = key0 + 8;

  load_tile<kKeys, D>(k, b, k0, Sk, Hkv, hk, Ks, nullptr);
  load_tile<kKeys, D>(v, b, k0, Sk, Hkv, hk, Vs, nullptr);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // The first query tile with a row that sees key k0 (row i sees j when
  // j <= i + off).
  const int q_begin = causal ? max(0, k0 - off) / BQ * BQ : 0;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const float* lse_h = lse + ((size_t)b * Hq + h) * Sq;
    const float* delta_h = delta + ((size_t)b * Hq + h) * Sq;
    for (int q0 = q_begin; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile is read; K and V are in place
      load_tile<BQ, D>(q, b, q0, Sq, Hq, h, Qs, Qt);
      load_tile<BQ, D>(dout, b, q0, Sq, Hq, h, dOs, dOt);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse_h[q0 + r] * kLog2e : -INFINITY;
        delta_s[r] = in ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks, DS, warp * 16, kk * 16, g, t);
        load_a(va, Vs, DS, warp * 16, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bq[2], bo[2];
          load_b(bq, Qs, DS, n * 8, kk * 16, g, t);
          load_b(bo, dOs, DS, n * 8, kk * 16, g, t);
          mma_bf16(s[n], ka, bq);
          mma_bf16(dp[n], va, bo);
        }
      }

      uint32_t pf[KQ][4], df[KQ][4];  // P^T, dS^T as A fragments
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t + e;
          const int i = q0 + col;
          const float l2 = lse_s[col];
          const float dl = delta_s[col];
          // rows of no visible key have lse -inf: their P is 0, not NaN
          const bool row_ok = i < Sq && l2 != -INFINITY;
          const bool v0 = row_ok && key0 < Sk && (!causal || key0 <= i + off);
          const bool v1 = row_ok && key1 < Sk && (!causal || key1 <= i + off);
          p[e] = v0 ? exp2f(fmaf(s[n][e], scale_log2, -l2)) : 0.f;
          p[2 + e] = v1 ? exp2f(fmaf(s[n][2 + e], scale_log2, -l2)) : 0.f;
          ds[e] = p[e] * (dp[n][e] - dl);
          ds[2 + e] = p[2 + e] * (dp[n][2 + e] - dl);
        }
        pf[n / 2][(n % 2) * 2] = pack_bf16(p[0], p[1]);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        df[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
        df[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bo[2], bq[2];
          load_b(bo, dOt, TS, n * 8, kk * 16, g, t);
          load_b(bq, Qt, TS, n * 8, kk * 16, g, t);
          mma_bf16(dva[n], pf[kk], bo);
          mma_bf16(dka[n], df[kk], bq);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (key0 < Sk) {
      const size_t o = (((size_t)b * Sk + key0) * Hkv + hk) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][0], dva[n][1]);
    }
    if (key1 < Sk) {
      const size_t o = (((size_t)b * Sk + key1) * Hkv + hk) * D + col;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// dQ of one 64-row query tile: warp w owns rows q0 + 16w .. + 15. For each
// 64-key tile its rows see, S = Q K^T and dP = dO V^T, dS in registers,
// then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, float scale,
                        float scale_log2, int causal) {
  constexpr int DS = D + kPad;
  constexpr int TS = kKeys + kPad;
  constexpr int KD = D / 16;
  constexpr int NK = kKeys / 8;   // 8-key column tiles of S
  constexpr int KK = kKeys / 16;  // k-steps over the key tile
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* dOs = Qs + kRows * DS;
  bf16* Ks = dOs + kRows * DS;
  bf16* Vs = Ks + kKeys * DS;
  bf16* Kt = Vs + kKeys * DS;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int row0 = q0 + warp * 16 + g;  // this lane's two query rows
  const int row1 = row0 + 8;

  load_tile<kRows, D>(q, b, q0, Sq, Hq, h, Qs, nullptr);
  load_tile<kRows, D>(dout, b, q0, Sq, Hq, h, dOs, nullptr);
  const float* lse_h = lse + ((size_t)b * Hq + h) * Sq;
  const float* delta_h = delta + ((size_t)b * Hq + h) * Sq;
  const float l2_0 = row0 < Sq ? lse_h[row0] * kLog2e : -INFINITY;
  const float l2_1 = row1 < Sq ? lse_h[row1] * kLog2e : -INFINITY;
  const float d0 = row0 < Sq ? delta_h[row0] : 0.f;
  const float d1 = row1 < Sq ? delta_h[row1] : 0.f;

  int k_end = Sk;  // keys this tile's last real row can see
  if (causal) k_end = max(0, min(Sk, min(q0 + kRows, Sq) + off));

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous key tile is read
    load_tile<kKeys, D>(k, b, k0, Sk, Hkv, hk, Ks, Kt);
    load_tile<kKeys, D>(v, b, k0, Sk, Hkv, hk, Vs, nullptr);
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, DS, warp * 16, kk * 16, g, t);
      load_a(oa, dOs, DS, warp * 16, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        uint32_t bk[2], bv[2];
        load_b(bk, Ks, DS, n * 8, kk * 16, g, t);
        load_b(bv, Vs, DS, n * 8, kk * 16, g, t);
        mma_bf16(s[n], qa, bk);
        mma_bf16(dp[n], oa, bv);
      }
    }

    uint32_t df[KK][4];  // dS as A fragments
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + 2 * t + e;
        const bool in = j < Sk;
        const bool v0 = in && row0 < Sq && l2_0 != -INFINITY && (!causal || j <= row0 + off);
        const bool v1 = in && row1 < Sq && l2_1 != -INFINITY && (!causal || j <= row1 + off);
        const float p0 = v0 ? exp2f(fmaf(s[n][e], scale_log2, -l2_0)) : 0.f;
        const float p1 = v1 ? exp2f(fmaf(s[n][2 + e], scale_log2, -l2_1)) : 0.f;
        ds[e] = p0 * (dp[n][e] - d0);
        ds[2 + e] = p1 * (dp[n][2 + e] - d1);
      }
      df[n / 2][(n % 2) * 2] = pack_bf16(ds[0], ds[1]);
      df[n / 2][(n % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t bk[2];
        load_b(bk, Kt, TS, n * 8, kk * 16, g, t);
        mma_bf16(dqa[n], df[kk], bk);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(dq + (((size_t)b * Sq + row0) * Hq + h) * D + col) =
          pack_bf16(dqa[n][0] * scale, dqa[n][1] * scale);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(dq + (((size_t)b * Sq + row1) * Hq + h) * D + col) =
          pack_bf16(dqa[n][2] * scale, dqa[n][3] * scale);
  }
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
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int Sq, int Hq,
                         cudaStream_t stream) {
  const long rows = (long)B * Sq * Hq;
  const long threads = rows * (D / Vec<T>::N);
  flash_bwd_delta_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, (int)rows, Sq, Hq);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, void* dk, void* dv,
                        int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                        cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_bwd_dkdv_mma_kernel<D>, dkdv_smem_bytes<D>(), &dkdv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dq_mma_kernel<D>, dq_smem_bytes<D>(), &dq_ok);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)D);
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  flash_bwd_dkdv_mma_kernel<D>
      <<<dim3((Sk + kKeys - 1) / kKeys, Hkv, B), kThreads, dkdv_smem_bytes<D>(), stream>>>(
          q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq,
          Sk, Hq, Hkv, scale, scale * kLog2e, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_mma_kernel<D>
      <<<dim3((Sq + kRows - 1) / kRows, Hq, B), kThreads, dq_smem_bytes<D>(), stream>>>(
          q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dq), Sq, Sk, Hq, Hkv, scale,
          scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv,
                       int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                       cudaStream_t stream) {
  static bool dkdv_ok = false, dq_ok = false;
  cudaError_t e = allow_smem(flash_bwd_dkdv_f32_kernel<D>, f32_smem_bytes<D>(), &dkdv_ok);
  if (e != cudaSuccess) return e;
  e = allow_smem(flash_bwd_dq_f32_kernel<D>, f32_smem_bytes<D>(), &dq_ok);
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
// [B, Sk, Hkv, D] of that dtype; lse f32 [B, Hq, Sq] from the forward;
// delta f32 [B, Hq, Sq] is scratch. Returns the cudaError_t of the first
// launch that failed, else of the last.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* delta, void* dq, void* dk, void* dv, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                                      int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (D != 64 && D != 128) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t e;
  if (dtype == 0)
    e = D == 64 ? launch_delta<float, 64>(o, dout, dl, B, Sq, Hq, s)
                : launch_delta<float, 128>(o, dout, dl, B, Sq, Hq, s);
  else
    e = D == 64 ? launch_delta<bf16, 64>(o, dout, dl, B, Sq, Hq, s)
                : launch_delta<bf16, 128>(o, dout, dl, B, Sq, Hq, s);
  if (e != cudaSuccess) return (int)e;
  if (dtype == 0 && D == 64) return (int)launch_f32<64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 0 && D == 128) return (int)launch_f32<128>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  if (D == 64) return (int)launch_bf16<64>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
  return (int)launch_bf16<128>(q, k, v, dout, l, dl, dq, dk, dv, B, Sq, Sk, Hq, Hkv, causal, s);
}

extern "C" const char* rt_flash_attention_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
