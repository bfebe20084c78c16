// One wgmma product through each narrow-row descriptor of hopper.cuh, for a
// test: the tiles come in by TMA (encode_bshd, as the flash kernels load
// them), one warpgroup runs the product exactly as a flash kernel issues it,
// and the f32 result goes to global memory for the caller to hold against a
// plain product. Not a kernel of any model path; tests/test_torch_cuda.py
// builds and runs it on the card.
//
// Cases (`which`), at D = 16 or 32 (and 64, through the same code), and at
// D = 80 and 96, whose rows are two 64-column panels of the 128-byte
// swizzle, the second filled with zeros past D by TMA:
//   0  out[64][128] = A[64][D] B[128][D]^T, both K-major, m64n128k16: the
//      forward's S = Q K^T.
//   1  out[64][64] = A[64][D] B[64][D]^T, both K-major, m64n64k16: the
//      backward's S^T = K Q^T and dP^T = V dO^T.
//   2  out[64][D] = P[64][128] B[128][D], P from registers, B MN-major,
//      m64nDk16 register-sourced: the forward's O += P V and the
//      backward's dV += P^T dO, dK += dS^T Q. At D = 80 and 96 an
//      m64n64k16 on the first panel and an m64n16k16 or m64n32k16 on the
//      first 16 or 32 columns of the second (part of a swizzle atom).
//   3  out[64][D] = A^T B with A[128][64] (dS^T, 128-byte swizzle) and
//      B[128][D], both MN-major, m64nDk16: the backward's dQ = dS K (at
//      D = 80 and 96 an m64n64k16 on each panel).

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kA = 0;        // A tile at the aligned base: at most 16 KB
constexpr int kB = 16384;    // B tile: 128 rows of at most two 128-byte panels
constexpr int kSmem = 16384 + 32768 + 1024;

// The columns of a tile row in shared memory: D, or two panels at 80, 96.
template <int D>
__host__ __device__ constexpr int probe_tile() {
  return D <= 64 ? D : 128;
}

// Writes this thread's part of a 64 x N f32 accumulator to out [64][N].
template <int N>
__device__ __forceinline__ void store_acc(const float* d, float* out) {
  const int tid = threadIdx.x;
  const int row = (tid / 32) * 16 + (tid % 32) / 4;
  const int col = 2 * (tid % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    out[row * N + 8 * j + col] = d[4 * j];
    out[row * N + 8 * j + col + 1] = d[4 * j + 1];
    out[(row + 8) * N + 8 * j + col] = d[4 * j + 2];
    out[(row + 8) * N + 8 * j + col + 1] = d[4 * j + 3];
  }
}

template <int D>
__device__ __forceinline__ uint64_t k_desc(uint32_t addr) {
  if constexpr (D < 64)
    return k_major_desc_narrow<D>(addr);
  else
    return k_major_desc(addr);
}

template <int D, int kWhich>
__global__ void __launch_bounds__(128)
wgmma_probe_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap b_map, const bf16* __restrict__ p,
                   float* __restrict__ out, uint32_t tx_bytes) {
  static_assert(D == 16 || D == 32 || D == 64 || D == 80 || D == 96, "probe widths");
  // bytes between 64-column panels of A and of B (as the case loads them)
  constexpr uint32_t a_panel = (kWhich == 0 || kWhich == 1 ? 64 : 128) * 128;
  constexpr uint32_t b_panel = (kWhich == 1 ? 64 : 128) * 128;
  extern __shared__ unsigned char probe_smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t raw = smem_u32(probe_smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t b_bar = smem_u32(&bar);
  if (threadIdx.x == 0) {
    mbar_init(b_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b_bar, tx_bytes);
    if constexpr (kWhich != 2) {
#pragma unroll
      for (int pn = 0; pn < (kWhich == 3 ? 1 : panels<D>()); ++pn)
        tma_load_4d(base + kA + pn * a_panel, &a_map, b_bar, pn * 64, 0, 0, 0);
    }
#pragma unroll
    for (int pn = 0; pn < panels<D>(); ++pn)
      tma_load_4d(base + kB + pn * b_panel, &b_map, b_bar, pn * 64, 0, 0, 0);
  }
  mbar_wait(b_bar, 0);

  if constexpr (kWhich == 0) {
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(d, k_desc<D>(base + kA + (kk / 4) * a_panel + (kk % 4) * 32),
                    k_desc<D>(base + kB + (kk / 4) * b_panel + (kk % 4) * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(d);
    store_acc<128>(d, out);
  } else if constexpr (kWhich == 1) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(d, k_desc<D>(base + kA + (kk / 4) * a_panel + (kk % 4) * 32),
                         k_desc<D>(base + kB + (kk / 4) * b_panel + (kk % 4) * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(d);
    store_acc<64>(d, out);
  } else if constexpr (kWhich == 2) {
    // P's A fragments (hopper.cuh): rows g and g + 8 of the warp's 16,
    // columns 16 kk + 2t (+1) and 16 kk + 8 + 2t (+1).
    const int tid = threadIdx.x;
    const int r0 = (tid / 32) * 16 + (tid % 32) / 4;
    const int t = tid % 4;
    uint32_t a[32];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int c0 = 16 * kk + 2 * t;
      a[4 * kk] = *reinterpret_cast<const uint32_t*>(p + r0 * 128 + c0);
      a[4 * kk + 1] = *reinterpret_cast<const uint32_t*>(p + (r0 + 8) * 128 + c0);
      a[4 * kk + 2] = *reinterpret_cast<const uint32_t*>(p + r0 * 128 + c0 + 8);
      a[4 * kk + 3] = *reinterpret_cast<const uint32_t*>(p + (r0 + 8) * 128 + c0 + 8);
    }
    float d[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) d[i] = 0.f;
    fence_regs<32>(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t b0 = base + kB + kk * 2048;
      if constexpr (D < 64)
        wgmma_rs_narrow<D>(d, a + 4 * kk, mn_major_desc_narrow<D>(base + kB + kk * 16 * 2 * D),
                           1);
      else
        wgmma_rs_n64(d, a + 4 * kk, mn_major_desc(b0, b_panel), 1);
      if constexpr (D == 80)
        wgmma_rs_n16(d + 32, a + 4 * kk, mn_major_desc(b0 + b_panel, b_panel), 1);
      else if constexpr (D == 96)
        wgmma_rs_n32(d + 32, a + 4 * kk, mn_major_desc(b0 + b_panel, b_panel), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(d);
    store_acc<D>(d, out);
  } else {
    constexpr int kRegs = probe_tile<D>() / 2;
    float d[kRegs];
#pragma unroll
    for (int i = 0; i < kRegs; ++i) d[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t da = mn_major_desc(base + kA + kk * 2048, 128 * 128);
      const uint32_t b0 = base + kB + kk * 2048;
      if constexpr (D < 64)
        wgmma_ss_narrow<D, 1, 1>(d, da, mn_major_desc_narrow<D>(base + kB + kk * 16 * 2 * D), 1);
      else
        wgmma_ss_n64<1, 1>(d, da, mn_major_desc(b0, b_panel));
      if constexpr (D > 64) wgmma_ss_n64<1, 1>(d + 32, da, mn_major_desc(b0 + b_panel, b_panel));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kRegs>(d);
    store_acc<D>(d, out);
  }
}

template <int D, int kWhich>
cudaError_t launch(const void* a, const void* b, const void* p, void* out, cudaStream_t s) {
  // rows of A and B as the case reads them
  constexpr int a_rows = kWhich == 3 ? 128 : 64;
  constexpr int a_cols = kWhich == 3 ? 64 : D;
  constexpr int b_rows = kWhich == 1 ? 64 : 128;
  constexpr int tile = probe_tile<D>();
  constexpr int a_tile = kWhich == 3 ? 64 : tile;
  CUtensorMap a_map, b_map;
  if (!encode_bshd(&b_map, b, 1, b_rows, 1, D, b_rows, tile)) return cudaErrorInvalidValue;
  uint32_t tx = b_rows * tile * 2;  // TMA counts the zeros it fills
  if (kWhich != 2) {
    if (!encode_bshd(&a_map, a, 1, a_rows, 1, a_cols, a_rows, a_tile))
      return cudaErrorInvalidValue;
    tx += a_rows * a_tile * 2;
  } else {
    a_map = b_map;  // unused
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        wgmma_probe_kernel<D, kWhich>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  wgmma_probe_kernel<D, kWhich><<<1, 128, kSmem, s>>>(
      a_map, b_map, static_cast<const bf16*>(p), static_cast<float*>(out), tx);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_case(const void* a, const void* b, const void* p, void* out, int which,
                    cudaStream_t s) {
  switch (which) {
    case 0: return launch<D, 0>(a, b, p, out, s);
    case 1: return launch<D, 1>(a, b, p, out, s);
    case 2: return launch<D, 2>(a, b, p, out, s);
    case 3: return launch<D, 3>(a, b, p, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a, b, p: contiguous bf16 as the case above reads them (a or p may be
// null where the case takes none); out: f32 of the case's shape. Returns
// the cudaError_t of the launch.
extern "C" int rt_wgmma_probe(const void* a, const void* b, const void* p, void* out, int D,
                              int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return (int)by_case<16>(a, b, p, out, which, s);
  if (D == 32) return (int)by_case<32>(a, b, p, out, which, s);
  if (D == 64) return (int)by_case<64>(a, b, p, out, which, s);
  if (D == 80) return (int)by_case<80>(a, b, p, out, which, s);
  if (D == 96) return (int)by_case<96>(a, b, p, out, which, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_wgmma_probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
