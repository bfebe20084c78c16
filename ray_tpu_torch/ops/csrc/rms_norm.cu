// RMSNorm for Hopper (sm_90a): forward and backward, f32 arithmetic over
// float32 or bfloat16 rows.
//
// Replaces: no Pallas kernel. The JAX package writes the norm as plain jnp
// (ray_tpu/models/transformer.py, RMSNorm) and XLA fuses that formula into
// one pass on the TPU. Eager PyTorch runs it as one kernel and one full-size
// f32 tensor per operation (the cast, the square, the mean, the rsqrt, two
// products, the cast back; about twice that in the backward), so the port
// adds this kernel.
//
// Function, over rows of width d: r = rsqrt(mean(x^2) + eps) per row and
// y = (x r) scale, rounded once to x's dtype. Gradient, with g = dy scale:
// dx = r (g - x r^2 mean(g x)), rounded once; dscale = sum over rows of
// dy x r (f32). Every sum and product is in f32, as the plain version's.
// In a residual block x also reaches the block's output unchanged; the
// gradient that arrives that way (dres) is added into dx in the same pass,
// where autograd would add the two with a kernel of its own.
//
// Bound on the H100: memory bandwidth (a few flops per byte). At the
// training shape (16,384 rows of 5,120 bf16) the forward reads x and writes
// y, 0.336 GB (0.10 ms at 3.35 TB/s); the backward reads x and dy and writes
// dx, 0.50 GB (0.15 ms), and 0.67 GB (0.20 ms) where it also reads dres (the
// separate add it replaces would move 0.50 GB). The scale, r and dscale are
// a few hundred KB.
//
// Design: each byte of x, dy, y and dx crosses device memory once.
// - A group of `threads_per_row` threads (a multiple of 32, at most 512)
//   holds a row in registers, K 16-byte vectors a thread (K = 1, 2 or 4,
//   the fewest that fit), vector v of the row at thread v % threads_per_row.
//   ops/rms_norm.py (launch_plan) picks K, the group's width and the rows a
//   block holds (narrow rows share a block of up to 256 threads) from d
//   alone; at the training width a thread holds exactly 2 vectors. Rows
//   whose width is not a multiple of the vector, or pointers not 16-byte
//   aligned, take the same layout with element loads (VEC = false), the
//   tail masked.
// - The row's sum is a butterfly over each warp, then the group's warps in
//   order through shared memory: every thread of the row gets the same
//   value, and the order is fixed.
// - Forward: one row per group and no loop, so every row's loads are issued
//   at once; it writes y and, when autograd needs it, r (one f32 a row).
//   Nothing else is saved: the backward reads x (which the step holds) and
//   r.
// - Backward: a block walks a contiguous range of rows, each step's loads
//   issued one step ahead (x and dy held as loaded, 16 raw bytes a vector;
//   dres issued before the row's sum; the scale read from L1); a thread
//   adds dy x r into registers of its own, so dscale needs no atomics. The
//   grid is as many blocks as fit on the card at once (the occupancy of
//   the instance times the SMs), and each
//   block writes its partial dscale to a row of an f32 scratch [G, d]. A
//   second kernel adds the G rows column by column in a fixed order, so dx
//   and dscale are bitwise repeatable.

#include <algorithm>

#include "common.cuh"

namespace {

using rt::Vec;

constexpr int kMaxThreads = 512;  // a block; also the widest row group
constexpr int kDscaleLanes = 8;   // partial rows summed side by side

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N = Vec<T>::N elements of row p from column c (masked past d) as floats.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* p, int c, int d,
                                           bool live, float* out) {
  constexpr int N = Vec<T>::N;
  if (VEC && live && c < d) {
    rt::load_vec(p + c, out);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    out[i] = (!VEC && live && c + i < d) ? to_f32(p[c + i]) : 0.f;
}

// The same columns of the f32 scale (N floats: one or two 16-byte loads).
template <int N, bool VEC>
__device__ __forceinline__ void load_scale(const float* s, int c, int d,
                                           float* out) {
  if (VEC && c < d) {
#pragma unroll
    for (int j = 0; j < N; j += 4) rt::load_vec(s + c + j, out + j);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = (!VEC && c + i < d) ? s[c + i] : 0.f;
}

__device__ __forceinline__ uint4 pack(const float* v, const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float* v, const __nv_bfloat16*) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

// N values to row p at column c, each rounded once to T (masked past d).
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_chunk(T* p, int c, int d,
                                            const float* v) {
  if (VEC) {
    if (c < d) {
#pragma unroll
      for (int j = 0; j < N; j += Vec<T>::N)
        *reinterpret_cast<uint4*>(p + c + j) = pack(v + j, p);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (c + i < d) rt::store(p + c + i, v[i]);
}

// The sum of v over the threads of this row group (threadIdx.y), the same
// in each of them: a butterfly over each warp (every lane ends with the
// same value), then the group's warps in order. `red` holds a float per
// warp of the block.
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x / 32;
  float* mine = red + threadIdx.y * warps;
  if ((threadIdx.x & 31) == 0) mine[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += mine[w];
  __syncthreads();  // red is written again for the next row
  return s;
}

struct FwdArgs {
  const void* x;
  const float* scale;
  void* y;
  float* rinv;  // null: r is not written
  int rows, d;
  float eps;
};

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_fwd_kernel(FwdArgs a) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[kMaxThreads / 32];
  const int tpr = blockDim.x, tx = threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < a.rows;
  const long long at = (live ? row : 0) * (long long)a.d;
  const T* xr = static_cast<const T*>(a.x) + at;
  float v[K][N];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_chunk<T, VEC>(xr, (k * tpr + tx) * N, a.d, live, v[k]);
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(v[k][i], v[k][i], ss);
  }
  const float r = rsqrtf(row_sum(ss, red) / (float)a.d + a.eps);
  if (!live) return;
  T* yr = static_cast<T*>(a.y) + at;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * tpr + tx) * N;
    if (c >= a.d) break;
    float s[N], out[N];
    load_scale<N, VEC>(a.scale, c, a.d, s);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = (v[k][i] * r) * s[i];
    store_chunk<T, N, VEC>(yr, c, a.d, out);
  }
  if (a.rinv != nullptr && tx == 0) a.rinv[row] = r;
}

struct BwdArgs {
  const void* x;
  const void* dy;
  const void* dres;  // null, or the gradient reaching x by another path
  const float* scale;
  const float* rinv;
  void* dx;
  float* partial;  // [gridDim.x, d]
  int rows, d;
  int chunk;       // rows a block walks, a multiple of blockDim.y
};

// Partials of the row groups of a block meet here when a block holds more
// than one row (then K = 1 and the block has at most 256 threads of 8
// floats).
constexpr int kCombineFloats = 256 * 8;

// A chunk of a row as loaded: its 16 raw bytes where the row loads
// vectors (half the registers of floats in bf16), else N floats.
template <typename T, bool VEC>
struct Held {
  uint4 raw;
  __device__ __forceinline__ void load(const T* p, int c, int d, bool live) {
    raw = live && c < d ? rt::load_raw(p + c) : make_uint4(0, 0, 0, 0);
  }
  __device__ __forceinline__ void get(float* out) const {
    rt::unpack(raw, static_cast<const T*>(nullptr), out);
  }
};

template <typename T>
struct Held<T, false> {
  float v[Vec<T>::N];
  __device__ __forceinline__ void load(const T* p, int c, int d, bool live) {
    load_chunk<T, false>(p, c, d, live, v);
  }
  __device__ __forceinline__ void get(float* out) const {
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) out[i] = v[i];
  }
};

template <typename T, int K, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_bwd_kernel(BwdArgs a) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[kMaxThreads / 32];
  __shared__ float combine[K == 1 ? kCombineFloats : 1];
  const int tpr = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  const int rpb = blockDim.y;
  const long long first = (long long)blockIdx.x * a.chunk;
  const long long end = min(first + a.chunk, (long long)a.rows);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* dres = static_cast<const T*>(a.dres);
  float acc[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[k][i] = 0.f;
  }
  // this row group's row of each step, and the next step's, loaded one
  // step ahead so two rows' loads are in flight
  Held<T, VEC> xh[K], dh[K];
  float r = 0.f;
  auto fetch = [&](long long row, Held<T, VEC>* xs, Held<T, VEC>* ds,
                   float* rr) {
    const bool live = row < end;
    const long long at = (live ? row : 0) * (long long)a.d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * tpr + tx) * N;
      xs[k].load(x + at, c, a.d, live);
      ds[k].load(dy + at, c, a.d, live);
    }
    *rr = live ? a.rinv[row] : 0.f;
  };
  fetch(first + ty, xh, dh, &r);
  for (long long base = first; base < end; base += rpb) {
    const long long row = base + ty;
    const bool live = row < end;
    Held<T, VEC> xn[K], dn[K], res[K];
    float rn;
    fetch(row + rpb, xn, dn, &rn);
    const long long at = (live ? row : 0) * (long long)a.d;
    if (dres != nullptr) {  // in flight while the row's sum is taken
#pragma unroll
      for (int k = 0; k < K; ++k)
        res[k].load(dres + at, (k * tpr + tx) * N, a.d, live);
    }
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float xv[N], gv[N], sv[N];
      xh[k].get(xv);
      dh[k].get(gv);
      load_scale<N, VEC>(a.scale, (k * tpr + tx) * N, a.d, sv);
#pragma unroll
      for (int i = 0; i < N; ++i) dot = fmaf(gv[i] * sv[i], xv[i], dot);
    }
    const float c2 = r * r * (row_sum(dot, red) / (float)a.d);
    if (live) {
      T* dxr = static_cast<T*>(a.dx) + at;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = (k * tpr + tx) * N;
        if (c >= a.d) break;
        float xv[N], gv[N], sv[N], out[N];
        xh[k].get(xv);
        dh[k].get(gv);
        load_scale<N, VEC>(a.scale, c, a.d, sv);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          out[i] = r * (gv[i] * sv[i] - xv[i] * c2);
          acc[k][i] = fmaf(gv[i], xv[i] * r, acc[k][i]);
        }
        if (dres != nullptr) {
          float rv[N];
          res[k].get(rv);
#pragma unroll
          for (int i = 0; i < N; ++i) out[i] += rv[i];
        }
        store_chunk<T, N, VEC>(dxr, c, a.d, out);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      xh[k] = xn[k];
      dh[k] = dn[k];
    }
    r = rn;
  }
  float* prow = a.partial + (long long)blockIdx.x * a.d;
  if constexpr (K == 1) {
    if (rpb > 1) {  // the row groups' partials, added in order
#pragma unroll
      for (int i = 0; i < N; ++i) combine[(ty * tpr + tx) * N + i] = acc[0][i];
      __syncthreads();
      if (ty != 0) return;
      for (int y = 1; y < rpb; ++y) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[0][i] += combine[(y * tpr + tx) * N + i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    store_chunk<float, N, VEC>(prow, (k * tpr + tx) * N, a.d, acc[k]);
}

// dscale[j] = sum over the G partial rows of column j: 32 columns a block,
// kDscaleLanes lanes each summing every kDscaleLanes-th row in order, the
// lanes then added in order.
__global__ void __launch_bounds__(32 * kDscaleLanes)
rms_norm_dscale_kernel(const float* partial, int blocks, int d,
                       float* dscale) {
  __shared__ float lanes[kDscaleLanes][32];
  const int col = threadIdx.x & 31, lane = threadIdx.x / 32;
  const int j = blockIdx.x * 32 + col;
  float s = 0.f;
  if (j < d) {
#pragma unroll 4
    for (int g = lane; g < blocks; g += kDscaleLanes)
      s += partial[(long long)g * d + j];
  }
  lanes[lane][col] = s;
  __syncthreads();
  if (lane == 0 && j < d) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kDscaleLanes; ++l) t += lanes[l][col];
    dscale[j] = t;
  }
}

template <typename T_, int K_, bool VEC_>
struct Inst {
  using T = T_;
  static constexpr int K = K_;
  static constexpr bool VEC = VEC_;
};

template <typename T, typename Fn>
cudaError_t by_k(int k, bool vec, Fn&& fn) {
  switch (k) {
    case 1: return vec ? fn(Inst<T, 1, true>{}) : fn(Inst<T, 1, false>{});
    case 2: return vec ? fn(Inst<T, 2, true>{}) : fn(Inst<T, 2, false>{});
    case 4: return vec ? fn(Inst<T, 4, true>{}) : fn(Inst<T, 4, false>{});
    default: return cudaErrorInvalidValue;
  }
}

// Calls fn with the instance of (dtype, K, VEC): dtype 0 float32, 1
// bfloat16.
template <typename Fn>
cudaError_t by_instance(int dtype, int k, bool vec, Fn&& fn) {
  if (dtype == 0) return by_k<float>(k, vec, fn);
  if (dtype == 1) return by_k<__nv_bfloat16>(k, vec, fn);
  return cudaErrorInvalidValue;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The launch plan's rules (ops/rms_norm.py, launch_plan): the row fits the
// group, a group is whole warps, a block at most kMaxThreads threads, and a
// block of several rows holds one vector a thread within kCombineFloats.
bool plan_ok(int d, int dtype, int k, int tpr, int rpb) {
  const int n = dtype == 0 ? 4 : 8;
  return d > 0 && (k == 1 || k == 2 || k == 4) && tpr >= 32 && tpr % 32 == 0 &&
         rpb >= 1 && tpr * rpb <= kMaxThreads && (long long)k * tpr * n >= d &&
         (rpb == 1 || (k == 1 && tpr * rpb * n <= kCombineFloats));
}

}  // namespace

// y = (x r) scale and, when rinv is not null, r per row; x and y [rows, d]
// of `dtype`, scale f32 [d]. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rt_rms_norm(const void* x, const void* scale, void* y,
                           void* rinv, int rows, int d, float eps, int dtype,
                           int vec_per_thread, int threads_per_row,
                           int rows_per_block, void* stream) {
  if (rows <= 0 || !plan_ok(d, dtype, vec_per_thread, threads_per_row,
                            rows_per_block))
    return (int)cudaErrorInvalidValue;
  const int n = dtype == 0 ? 4 : 8;
  const bool vec = d % n == 0 && aligned(x) && aligned(y) && aligned(scale);
  FwdArgs a{x, static_cast<const float*>(scale), y,
            static_cast<float*>(rinv), rows, d, eps};
  const dim3 block(threads_per_row, rows_per_block);
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  return (int)by_instance(dtype, vec_per_thread, vec, [&](auto inst) {
    using I = decltype(inst);
    rms_norm_fwd_kernel<typename I::T, I::K, I::VEC>
        <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return cudaGetLastError();
  });
}

// dx [rows, d] of `dtype` and dscale f32 [d] from x, dy and the forward's r
// (f32 [rows]), plus dres (like dx) where it is not null; `partial` is f32
// scratch of max_blocks rows of d. Two launches on `stream`; returns
// cudaGetLastError().
extern "C" int rt_rms_norm_bwd(const void* x, const void* dy,
                               const void* dres, const void* scale,
                               const void* rinv, void* dx,
                               void* partial, void* dscale, int rows, int d,
                               int dtype, int vec_per_thread,
                               int threads_per_row, int rows_per_block,
                               int max_blocks, void* stream) {
  if (rows <= 0 || max_blocks <= 0 ||
      !plan_ok(d, dtype, vec_per_thread, threads_per_row, rows_per_block))
    return (int)cudaErrorInvalidValue;
  const int n = dtype == 0 ? 4 : 8;
  const bool vec = d % n == 0 && aligned(x) && aligned(dy) && aligned(dx) &&
                   aligned(dres) && aligned(scale) && aligned(partial);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(threads_per_row, rows_per_block);
  return (int)by_instance(dtype, vec_per_thread, vec, [&](auto inst) {
    using I = decltype(inst);
    auto kernel = rms_norm_bwd_kernel<typename I::T, I::K, I::VEC>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads_per_row * rows_per_block, 0);
    if (e != cudaSuccess) return e;
    // as many blocks as run at once, each walking a whole number of its
    // row groups; none left without rows
    const long long groups = (rows + rows_per_block - 1) / rows_per_block;
    long long blocks = (long long)std::max(per_sm, 1) * sms;
    blocks = std::min(blocks, std::min(groups, (long long)max_blocks));
    const long long per_block = (groups + blocks - 1) / blocks;
    const int chunk = (int)(per_block * rows_per_block);
    blocks = (rows + chunk - 1) / chunk;
    BwdArgs a{x, dy, dres, static_cast<const float*>(scale),
              static_cast<const float*>(rinv), dx,
              static_cast<float*>(partial), rows, d, chunk};
    kernel<<<(unsigned)blocks, block, 0, s>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rms_norm_dscale_kernel<<<(d + 31) / 32, 32 * kDscaleLanes, 0, s>>>(
        static_cast<const float*>(partial), (int)blocks, d,
        static_cast<float*>(dscale));
    return cudaGetLastError();
  });
}

extern "C" const char* rt_rms_norm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* rt_rms_norm_bwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
