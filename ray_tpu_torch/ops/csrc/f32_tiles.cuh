// Float32 tiles on the CUDA cores, shared by the f32 paths of the flash
// kernels (flash_attention.cu, flash_attention_bwd.cu): cp.async copies
// from device memory into shared memory, and the loads of a head's rows
// into [rows][DT + 4] tiles (the 4 floats of padding put 8 rows of float4
// reads on 32 banks) and of a [B, Hq, Sq] row.

#pragma once

#include <stddef.h>

#include "hopper.cuh"

namespace f32tile {

using hopper::smem_u32;

constexpr int kF32Rows = 32;  // query rows of a tile
constexpr int kF32GroupThreads = 64;

// Floats of a tile row in shared memory.
template <int DT>
__host__ __device__ constexpr int f32_ld() {
  return DT + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [s0, s0 + rows) of head h of batch b of a [B, S, H, d] f32 tensor
// into a [rows][DT + 4] tile by `nt` threads (this one `t`), 16 bytes at a
// time; rows past S and columns past d are zeros.
template <int DT>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* __restrict__ src, int b,
                                              int s0, int rows, int S, int H, int h, int d,
                                              int t, int nt) {
  constexpr int kChunks = DT / 4;
  for (int idx = t; idx < rows * kChunks; idx += nt) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 4;
    const bool valid = s0 + r < S && c < d;
    cp_async16(dst + r * f32_ld<DT>() + c,
               valid ? src + (((size_t)b * S + s0 + r) * H + h) * d + c : src, valid);
  }
}

// 32 values of a [B, Hq, Sq] row (lse or Delta) from row i0 (zeros past Sq).
__device__ __forceinline__ void f32_load_row(float* dst, const float* __restrict__ src,
                                             size_t base, int i0, int Sq, int t) {
  if (t >= 0 && t < kF32Rows) {
    const bool valid = i0 + t < Sq;
    cp_async4(dst + t, valid ? src + base + i0 + t : src, valid);
  }
}

}  // namespace f32tile
