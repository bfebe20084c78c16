// Decode attention for Hopper (sm_90a): one query token per sequence
// against its slot KV cache, at ragged per-sequence lengths.
//
// Replaces: ray_tpu/ops/decode_attention.py, _decode_kernel (launched by
// decode_attention_pallas, pallas_call at :114). Same function: q [B, Hq, D]
// against caches [B, S, KV, D]; rows [0, lengths[b]) are valid; scale
// D^-0.5; softmax state in f32; GQA with rep = Hq / KV query heads per KV
// head; output in q's dtype; a sequence with length 0 gives zeros.
//
// Bound on the H100: memory bandwidth. Each step must read the K and V rows
// below each sequence's length once (2 * sum(len) * KV * D * elem bytes)
// over 3.35 TB/s; the arithmetic is 4 flops per cache element, far under
// the card's operations-per-byte ridge. At the serving width the whole
// cache of a step is a few MB, so the time is set by how many bytes are in
// flight across the card and by the fixed costs of a block (its first
// copy's latency, the merge), not by one block's walk.
//
// Design: split-K ("flash-decoding") with the merge in the same launch.
// - The grid is (B * KV * q-head groups, splits). A block serves `group`
//   (1 to 8) query heads of one KV head, so the cache is read once for all
//   of them, over a chunk of `chunk` rows; ops/decode_attention.py
//   (split_plan) sizes the chunks from the card's SM count and the shapes
//   alone, never the lengths. A block whose chunk starts at or past its
//   sequence's length exits at once.
// - Rows reach shared memory by bulk copies, never through registers. Warp
//   0 is the producer: it walks the chunk in stages of kTile rows and
//   issues each stage's copies into a ring of dynamic shared memory (as
//   many slots as the chunk has stages, up to 8), each completing on its
//   slot's `full` mbarrier with expect_tx equal to the bytes it copies. A
//   full stage is one tensor copy (cp.async.bulk.tensor, maps cached per
//   cache pointer and shape) each of K and V, or one per 64-column panel
//   on tensor cores; one KV head's rows are contiguous, so otherwise they
//   take plain bulk copies (cp.async.bulk) of whole spans; the rows of a
//   partial stage among several KV heads take one bulk copy each. Only
//   rows below the length are copied, at their real width (160 or 192
//   bytes at D = 80 and 96).
// - Four consumer warps take the stages in turn (stage i to warp i % 4),
//   each keeping its own f32 softmax state in base 2 (one ex2 per
//   exponential), and free a slot through its `empty` mbarrier. Rows past
//   the length in a partial stage are never read: their scores are -inf
//   and, on tensor cores, their ldmatrix rows point at a zero row.
//   * One query head (every served configuration) and all f32 inputs: CUDA
//     cores (decode_attention_kernel<T, DT, REP>). A lane holds NV 16-byte
//     slices of a row, TPR lanes a row: at D = 80 and 96 in bf16 2 and 4
//     lanes of 5 and 3 slices, so no lane carries zeros; at widths that are
//     neither a power of two nor 80 / 96 the row runs on the tile DT above
//     it, whose lanes past D read nothing.
//   * Groups of 2 to 8 query heads in bf16: tensor cores
//     (decode_attention_mma_kernel<DT>), mma.sync m16n8k16 with the group's
//     heads as M (rows past the group are zeros) and 8 keys as N for the
//     scores, then O^T += V^T P^T with 16 head-dim columns as M and the
//     heads as N: the scores' accumulator is P^T's operand as it stands.
//     Scores and the P V state stay in f32, P is rounded to bf16 for its
//     product. ldmatrix's 8 rows of a matrix fall on 8 bank groups: a full
//     stage lies in TMA's swizzle, a partial one in 8 sub-spans of kTile /
//     8 rows, 16 bytes apart, an 8-key block taking one row of each.
//     f32 never runs on tensor cores (not even TF32).
// - The consumers' states meet in shared memory (the ring's bytes, once
//   the stream is done) and give the chunk's (max, denominator,
//   accumulator). A sequence covered by one chunk writes its output
//   directly. Otherwise the merge is a tree of two levels through the
//   workspace: the last of each group of kMergeFanIn chunks (a ticket on
//   an int counter, one acq_rel atomic after a block barrier) merges its
//   group's partials; with more than one group, the last group merger (a
//   second ticket) merges the groups. No block merges more than
//   kMergeFanIn partials at the first level, so a long sequence can take
//   as many chunks as fill the card, and each merger's loads are
//   independent (batches of partials, no chain of online rescales). Each
//   merger sets its counter back to 0, so no memset launch is ever
//   needed: one launch per layer per step, and a CUDA graph can capture
//   it. Calls that share a counter buffer must be ordered on one stream.
// - Registers bound how many blocks an SM holds: the merge reads at most
//   4 (CUDA cores) or 8 (tensor cores) partials' 16 bytes at once per
//   thread (with 8 and 16 every instance took 160-250 registers and the
//   serving width ran 1.9x slower on an H100, chip_decode_probe.py), and
//   the tensor-core instances ask for 3 blocks an SM (2 at DT = 256).
//
// Resources (nvcc -Xptxas -v, sm_90a) of each instance: PERF.md, and
// chip_smoke.py phase 1 prints them.
// The TPU kernel's sequential grid over cache blocks, its 8-row q padding
// and its (rep, 128) scratch have no counterpart here.

#include <math.h>

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive_if;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_bar_sync;
using hopper::pack_bf16;
using hopper::smem_u32;
using rt::store;
using rt::unpack;
using rt::Vec;

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (1 + kConsumerWarps);
// Chunks whose partials one block merges at the first level
// (ops/decode_attention.py, MERGE_FANIN).
constexpr int kMergeFanIn = 16;
// Bytes between the sub-spans of a stage in the tensor-core layout.
constexpr int kGap = 16;
// Shared memory before the ring: a full and an empty mbarrier per slot, the
// zero row, the ticket flag.
constexpr int kHeader = 256;
constexpr int kZeroRow = 128;
constexpr int kFlag = 144;

// K bytes of one stage at tile width DT: on CUDA cores 2 KB up to DT = 64
// (more, smaller stages spread a chunk over more consumer warps; on an
// H100 they beat 8 KB ones at the serving width, chip_decode_probe.py) and
// 8 KB above it (the other way round at D = 80); on tensor cores (GAP > 0)
// 16 KB below DT = 256 and 8 KB at it.
template <int DT, int GAP>
__host__ __device__ constexpr int stage_budget() {
  return GAP ? (DT < 256 ? 16384 : 8192) : (DT <= 64 ? 2048 : 8192);
}

// Rows of one stage at tile width DT, 16 to 64 (ops/decode_attention.py,
// stage_rows).
template <int DT, int ELEM, int GAP>
__host__ __device__ constexpr int stage_rows() {
  return stage_budget<DT, GAP>() / (DT * ELEM) >= 64   ? 64
         : stage_budget<DT, GAP>() / (DT * ELEM) >= 32 ? 32
                                                       : 16;
}

// The tensor-core layout of a full stage: the rows in panels of up to 64
// columns (128-byte rows, or the whole row at DT = 16 and 32), in TMA's
// swizzle of that row width, one tensor copy per panel.
template <int DT>
__host__ __device__ constexpr int panel_cols() {
  return DT >= 64 ? 64 : DT;
}

template <int DT>
__host__ __device__ constexpr int panels() {
  return DT >= 64 ? (DT + 63) / 64 : 1;
}

// Bytes of a ring slot's K (or V) part at head dim d: on CUDA cores (GAP
// 0) the stage's rows at their real width; on tensor cores the larger of
// the swizzled panels of a full stage and the 8 sub-spans of kTile / 8
// rows, GAP bytes after each, that a partial stage fills, in whole KB (the
// swizzle's atom).
template <int DT, int ELEM, int GAP>
__host__ __device__ constexpr int part_bytes(int d) {
  constexpr int kTile = stage_rows<DT, ELEM, GAP>();
  constexpr int kSwizzled = panels<DT>() * kTile * 2 * panel_cols<DT>();
  constexpr int kSpans = 8 * (kTile / 8 * DT * ELEM + GAP);
  return GAP == 0 ? kTile * d * ELEM
                  : ((kSwizzled > kSpans ? kSwizzled : kSpans) + 1023) / 1024 * 1024;
}

// Slots of the ring at most: 8 when a stage (K and V) holds at most about
// 8 KB, else 4. A launch takes as many as its chunk has stages, up to this
// (ring_slots): a slot is then either used once or always by the same
// consumer warp, which waits on its phases in order.
template <int DT, int ELEM, int GAP>
__host__ __device__ constexpr int max_stages() {
  return 2 * part_bytes<DT, ELEM, GAP>(DT) <= 8704 ? 8 : 4;
}

template <int DT, int ELEM, int GAP>
__host__ __device__ constexpr int ring_slots(int chunk) {
  return (chunk + stage_rows<DT, ELEM, GAP>() - 1) / stage_rows<DT, ELEM, GAP>() <
                 max_stages<DT, ELEM, GAP>()
             ? (chunk + stage_rows<DT, ELEM, GAP>() - 1) / stage_rows<DT, ELEM, GAP>()
             : max_stages<DT, ELEM, GAP>();
}

// Dynamic shared memory of an instance at head dim d with `slots` ring
// slots: the header, room to start the ring on a 1 KB boundary, then the
// larger of the ring and the consumers' merge buffers (kSlot heads each).
template <int DT, int ELEM, int GAP, int kSlot>
__host__ __device__ constexpr int smem_bytes(int d, int slots) {
  const int ring = slots * 2 * part_bytes<DT, ELEM, GAP>(d);
  const int merge = kConsumerWarps * kSlot * (d + 2) * 4;
  return kHeader + 1024 + (ring > merge ? ring : merge);
}

// Where the ring starts: the first 1 KB boundary past the header.
__device__ __forceinline__ unsigned char* ring_of(unsigned char* smem) {
  const uint32_t base = smem_u32(smem);
  return smem + (((base + kHeader + 1023) & ~1023u) - base);
}

// Scores, maxima and the partials' maxima are kept in base 2 (the scale
// carries log2(e)), so each exponential is one ex2.approx.
// 2^(m - m_new) with 2^(-inf - x) = 0, also for x = -inf.
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m == -INFINITY ? 0.f : hopper::ex2(m - m_new);
}

// What a block works on: its (batch, KV head, group of query heads) and
// split, and the rows of its chunk below the length.
struct Work {
  int item, split, b, kvh, nrep, len, row_begin, row_end;
  size_t q_row0;
};

// Which split a block takes: on tensor cores the highest first (those are
// empty for all but the longest sequences, so they retire at once and the
// rest follow in one wave), on CUDA cores the lowest first (a grid larger
// than the card holds at once then starts the blocks with rows before the
// empty ones; on an H100 this was 6% faster at Phi-3-mini's D = 96 and
// slower at the multi-query D = 256, chip_decode_probe.py).
template <bool kLowestFirst>
__device__ __forceinline__ Work work_of(const int* lengths, int S, int Hq, int KV,
                                        int rep, int group, int n_groups, int chunk,
                                        int n_splits) {
  Work w;
  w.item = blockIdx.x;
  w.split = kLowestFirst ? blockIdx.y : n_splits - 1 - blockIdx.y;
  w.b = w.item / (KV * n_groups);
  w.kvh = (w.item / n_groups) % KV;
  const int r0 = (w.item % n_groups) * group;
  w.nrep = min(group, rep - r0);
  w.q_row0 = (size_t)w.b * Hq + (size_t)w.kvh * rep + r0;
  w.len = max(0, min(__ldg(lengths + w.b), S));
  w.row_begin = w.split * chunk;
  w.row_end = min(w.row_begin + chunk, w.len);
  return w;
}

// True when the block has rows to read; a block of split 0 with none
// (length 0) writes zeros.
template <typename T>
__device__ __forceinline__ bool has_rows(const Work& w, T* out, int d) {
  if (w.row_begin < w.len) return true;
  if (w.split == 0)
    for (int idx = threadIdx.x; idx < w.nrep * d; idx += blockDim.x)
      store(out + (w.q_row0 + idx / d) * d + idx % d, 0.f);
  return false;
}

__device__ __forceinline__ void init_barriers(unsigned char* smem, int stages) {
  if (threadIdx.x == 0) {
    const uint32_t bars = smem_u32(smem);
    for (int s = 0; s < 2 * stages; ++s) mbar_init(bars + 8 * s, 1);
    *reinterpret_cast<uint4*>(smem + kZeroRow) = make_uint4(0, 0, 0, 0);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: stage i of the chunk (rows [t0, t0 + n)) into slot
// i % stages once its consumer has freed it; each slot's K and V parts are
// `part` bytes. Row t of a stage lies at (t / R) * span + (t % R) * rb in
// the stage's K part (and V part), R = kTile / 8, span = R * rb + GAP: on
// CUDA cores (GAP 0) the rows are dense. A full stage is one tensor copy
// each of K and V on CUDA cores with more than one KV head (kmap, vmap:
// boxes of kTile rows of one head), and one per panel on tensor cores (the
// swizzled layout); one KV head's rows are contiguous, so otherwise they
// take one copy (dense) or eight (sub-spans), and rows of a partial stage
// among several KV heads one copy each.
template <typename T, int DT, int kTile, int GAP>
__device__ __forceinline__ void produce(const T* k, const T* v, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const Work& w, int S,
                                        int KV, int d, int stages, int part, uint32_t bars,
                                        uint32_t ring) {
  constexpr int kR = kTile / 8;
  constexpr int kPanelBytes = kTile * 2 * panel_cols<DT>();
  const int lane = threadIdx.x & 31;
  const int rb = d * (int)sizeof(T);
  const int span = kR * rb + GAP;
  const int n_panels = (d + panel_cols<DT>() - 1) / panel_cols<DT>();
  const size_t row_stride = (size_t)KV * d;
  const size_t base = ((size_t)w.b * S * KV + w.kvh) * d;
  const T* kb = k + base;
  const T* vb = v + base;
  const int n_tiles = (w.row_end - w.row_begin + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int slot = i % stages;
    const uint32_t full = bars + 8 * slot;
    if (i >= stages) mbar_wait(bars + 8 * (stages + slot), (i / stages - 1) & 1);
    const int t0 = w.row_begin + i * kTile;
    const int n = min(kTile, w.row_end - t0);
    const bool swizzled = GAP > 0 && n == kTile;
    if (lane == 0)
      mbar_expect_tx(full, swizzled ? 2 * n_panels * kPanelBytes : 2 * n * rb);
    __syncwarp();
    const uint32_t kd = ring + slot * 2 * part;
    const uint32_t vd = kd + part;
    if (swizzled) {  // one tensor copy per panel each
      if (lane < n_panels) {
        hopper::tma_load_4d(kd + lane * kPanelBytes, kmap, full, lane * 64, w.kvh, t0, w.b);
        hopper::tma_load_4d(vd + lane * kPanelBytes, vmap, full, lane * 64, w.kvh, t0, w.b);
      }
    } else if (GAP == 0 && KV > 1 && n == kTile) {  // one tensor copy each
      if (lane == 0) {
        hopper::tma_load_4d(kd, kmap, full, 0, w.kvh, t0, w.b);
        hopper::tma_load_4d(vd, vmap, full, 0, w.kvh, t0, w.b);
      }
    } else if (KV == 1 && GAP == 0) {  // one contiguous span each
      if (lane < 2)
        bulk_load(lane ? vd : kd, (lane ? vb : kb) + (size_t)t0 * d, n * rb, full);
    } else if (KV == 1) {  // eight sub-spans each
      const int j = lane & 7;
      const int c = min(kR, n - j * kR);
      if (lane < 16 && c > 0)
        bulk_load((lane < 8 ? kd : vd) + j * span,
                  (lane < 8 ? kb : vb) + (size_t)(t0 + j * kR) * d, c * rb, full);
    } else {  // one copy per row of this KV head
      for (int t = lane; t < n; t += 32) {
        const uint32_t off = (t / kR) * span + (t % kR) * rb;
        const size_t src = (size_t)(t0 + t) * row_stride;
        bulk_load(kd + off, kb + src, rb, full);
        bulk_load(vd + off, vb + src, rb, full);
      }
    }
  }
}

// ------------------------------------------------------------ CUDA cores

// Slices of 16 bytes one lane holds and lanes one row takes at tile DT:
// TPR is the largest power of two (at most 32) dividing the row's slices,
// so D = 80 and 96 in bf16 (10 and 12 slices) take 2 and 4 lanes of 5 and
// 3 slices.
template <typename T, int DT>
struct Lanes {
  static constexpr int VEC = Vec<T>::N;
  static constexpr int NSL = DT / VEC;
  static constexpr int TPR = (NSL & -NSL) < 32 ? (NSL & -NSL) : 32;
  static constexpr int NV = NSL / TPR;
  static constexpr int RPW = 32 / TPR;  // rows one warp reads at once
};

// A consumer warp on CUDA cores: its stages' rows into (max, denominator,
// accumulator) per query head, kept per worker (TPR lanes), then merged
// across the warp's workers into the merge buffer `mw` ([REP] max, [REP]
// denominator, [REP][d] accumulator).
template <typename T, int DT, int REP, int kTile>
__device__ __forceinline__ void consume_core(const T* __restrict__ q, const Work& w, int d,
                                             float scale, int stages, uint32_t bars,
                                             const unsigned char* ring, float* mbuf) {
  using L = Lanes<T, DT>;
  constexpr int VEC = L::VEC, TPR = L::TPR, NV = L::NV, RPW = L::RPW;
  // Rows in flight per worker: 4 where a row is one slice of one head, 2 up
  // to 32 floats, 1 where a row's slices for every head already fill the
  // registers (D = 80 in bf16, the f32 groups).
  constexpr int kUnroll = NV * VEC * REP <= 8 ? 4 : NV * VEC * REP <= 32 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int cw = (threadIdx.x >> 5) - 1;
  const int sub = lane / TPR;
  const int part_lane = lane % TPR;
  auto col = [&](int sl) { return (sl * TPR + part_lane) * VEC; };
  const int rb = d * (int)sizeof(T);
  const int part = part_bytes<DT, (int)sizeof(T), 0>(d);

  float qv[REP][NV][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int sl = 0; sl < NV; ++sl) {
      if (r < w.nrep && col(sl) < d) {
        rt::load_vec(q + (w.q_row0 + r) * d + col(sl), qv[r][sl]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) qv[r][sl][i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) qv[r][sl][i] = 0.f;
      }
    }
  float m[REP], l[REP], acc[REP][NV][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int sl = 0; sl < NV; ++sl)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][sl][i] = 0.f;
  }

  const int n_tiles = (w.row_end - w.row_begin + kTile - 1) / kTile;
  for (int it = cw; it < n_tiles; it += kConsumerWarps) {
    const int slot = it % stages;
    mbar_wait(bars + 8 * slot, (it / stages) & 1);
    const int n = min(kTile, w.row_end - (w.row_begin + it * kTile));
    const unsigned char* ks = ring + slot * 2 * part;
    const unsigned char* vs = ks + part;
    // `base` is uniform across the warp, so every lane reaches the shuffles.
    for (int base = 0; base < n; base += RPW * kUnroll) {
      float sc[kUnroll][REP];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + sub + u * RPW;
        const bool valid = t < n;
        float s[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) s[r] = 0.f;
        // one slice at a time: its 16 bytes are unpacked only where used
#pragma unroll
        for (int sl = 0; sl < NV; ++sl) {
          if (valid && col(sl) < d) {
            float kf[VEC];
            unpack(*reinterpret_cast<const uint4*>(ks + t * rb + col(sl) * sizeof(T)), q, kf);
#pragma unroll
            for (int r = 0; r < REP; ++r)
#pragma unroll
              for (int i = 0; i < VEC; ++i) s[r] += qv[r][sl][i] * kf[i];
          }
        }
#pragma unroll
        for (int r = 0; r < REP; ++r) {
#pragma unroll
          for (int off = TPR / 2; off > 0; off >>= 1)
            s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
          sc[u][r] = valid ? s[r] : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float m_new = m[r];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, sc[u][r]);
        const float alpha = rescale(m[r], m_new);
        l[r] *= alpha;
#pragma unroll
        for (int sl = 0; sl < NV; ++sl)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[r][sl][i] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + sub + u * RPW;
        if (t >= n) continue;  // its p is 0; its row is not read
        float p[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          p[r] = rescale(sc[u][r], m[r]);
          l[r] += p[r];
        }
#pragma unroll
        for (int sl = 0; sl < NV; ++sl) {
          if (col(sl) < d) {
            float vf[VEC];
            unpack(*reinterpret_cast<const uint4*>(vs + t * rb + col(sl) * sizeof(T)), q, vf);
#pragma unroll
            for (int r = 0; r < REP; ++r)
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[r][sl][i] += p[r] * vf[i];
          }
        }
      }
    }
    __syncwarp();
    mbar_arrive_if(bars + 8 * (stages + slot), lane == 0);
  }

  // Merge the workers of the warp: lanes at distance TPR, 2*TPR, ... hold
  // the same slices of D for other rows.
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float m_new = fmaxf(m[r], mo);
      const float a = rescale(m[r], m_new);
      const float c = rescale(mo, m_new);
      l[r] = l[r] * a + lo * c;
#pragma unroll
      for (int sl = 0; sl < NV; ++sl)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[r][sl][i], off);
          acc[r][sl][i] = acc[r][sl][i] * a + ao * c;
        }
      m[r] = m_new;
    }
  }
  named_bar_sync(1, 32 * kConsumerWarps);  // every consumer is done with the ring
  float* mw = mbuf + cw * REP * (d + 2);
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (part_lane == 0) {
        mw[r] = m[r];
        mw[REP + r] = l[r];
      }
#pragma unroll
      for (int sl = 0; sl < NV; ++sl)
        if (col(sl) < d)
#pragma unroll
          for (int i = 0; i < VEC; ++i) mw[2 * REP + r * d + col(sl) + i] = acc[r][sl][i];
    }
  }
}

// ----------------------------------------------------------- tensor cores

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c (16 x 8, f32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16,
// column-major). Thread (g, t) = (lane / 4, lane % 4) holds a0 / a2 of row
// g, a1 / a3 of row g + 8, columns 2t (+1) and 2t + 8 (+1); b0 / b1 rows
// 2t (+1) and 2t + 8 (+1) of column g; c0 / c1 row g, columns 2t (+1), c2
// / c3 row g + 8.
__device__ __forceinline__ void mma_16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A consumer warp on tensor cores (bf16, up to 8 query heads). Per stage of
// kTile keys: for each 8-key block x the scores S (heads x keys) = Q K^T in
// DT / 16 k-steps (Q's A fragments kept in registers, K's B fragments by
// ldmatrix), the online softmax per head (the 4 lanes of a head share it),
// then per pair of blocks O^T (d x heads) += V^T P^T, V^T's A fragments by
// ldmatrix.trans, P^T's B fragments the scores' accumulators packed to
// bf16. An 8-key block is keys 8x to 8x + 7 of a full stage (swizzled
// panels) and key j * R + x (j = 0..7, one row of each sub-span) of a
// partial one: either way ldmatrix's 8 rows fall on 8 bank groups. Head
// dims that are not a multiple of 16 end with a half k-step whose second 8
// columns read the zero row.
template <int DT, int kTile>
__device__ __forceinline__ void consume_mma(const __nv_bfloat16* __restrict__ q, const Work& w,
                                            int d, float scale, int stages, int part,
                                            uint32_t bars, uint32_t ring, uint32_t zero,
                                            float* mbuf) {
  constexpr int kKS = DT / 16;
  constexpr int kR = kTile / 8;
  constexpr int kCols = panel_cols<DT>();
  constexpr int kRowBytes = 2 * kCols;
  constexpr int kPanelBytes = kTile * kRowBytes;
  const int lane = threadIdx.x & 31;
  const int cw = (threadIdx.x >> 5) - 1;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int j = lane & 7;   // the key row of this lane's ldmatrix address in a block
  const int mi = lane >> 3;  // the 8x8 matrix this lane addresses
  const int rb = 2 * d;
  const int span = kR * rb + kGap;

  uint32_t qa[kKS][2];
  const __nv_bfloat16* qrow = q + (w.q_row0 + g) * d;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const int c = 16 * kk + 2 * t4;
    qa[kk][0] = g < w.nrep && c < d ? *reinterpret_cast<const uint32_t*>(qrow + c) : 0u;
    qa[kk][1] = g < w.nrep && c + 8 < d ? *reinterpret_cast<const uint32_t*>(qrow + c + 8) : 0u;
  }
  float o[kKS][4];
#pragma unroll
  for (int mb = 0; mb < kKS; ++mb) o[mb][0] = o[mb][1] = o[mb][2] = o[mb][3] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int n_tiles = (w.row_end - w.row_begin + kTile - 1) / kTile;
  for (int it = cw; it < n_tiles; it += kConsumerWarps) {
    const int slot = it % stages;
    mbar_wait(bars + 8 * slot, (it / stages) & 1);
    const int n = min(kTile, w.row_end - (w.row_begin + it * kTile));
    const uint32_t ks = ring + slot * 2 * part;
    const uint32_t vs = ks + part;
    const bool swizzled = n == kTile;
    // The key in row j of 8-key block x, and the address of its 8 columns
    // from colb in the stage's part at `base`.
    auto key = [&](int jj, int x) { return swizzled ? 8 * x + jj : jj * kR + x; };
    auto at = [&](uint32_t base, int t, int colb) -> uint32_t {
      if (swizzled)
        return base + (colb / 64) * kPanelBytes + t * kRowBytes +
               16 * hopper::swizzled_chunk<kRowBytes>(t, colb % kCols / 8);
      return base + (t / kR) * span + (t % kR) * rb + 2 * colb;
    };
    float s[kR][2];
#pragma unroll
    for (int x = 0; x < kR; ++x) {
      const int t = key(j, x);
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        if (16 * kk < d) {
          const int colb = 16 * kk + 8 * (mi & 1);
          uint32_t b0, b1;
          ldsm_x2(b0, b1, t < n && colb < d ? at(ks, t, colb) : zero);
          mma_16816(c, qa[kk][0], 0u, qa[kk][1], 0u, b0, b1);
        }
      }
      s[x][0] = key(2 * t4, x) < n ? c[0] * scale : -INFINITY;
      s[x][1] = key(2 * t4 + 1, x) < n ? c[1] * scale : -INFINITY;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int x = 0; x < kR; ++x) mx = fmaxf(mx, fmaxf(s[x][0], s[x][1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = rescale(m, m_new);
    uint32_t pb[kR];
    float ps = 0.f;
#pragma unroll
    for (int x = 0; x < kR; ++x) {
      const float p0 = rescale(s[x][0], m_new);
      const float p1 = rescale(s[x][1], m_new);
      ps += p0 + p1;
      pb[x] = pack_bf16(p0, p1);
    }
    l = l * alpha + ps;
    m = m_new;
    // O^T's columns are heads 2t and 2t + 1: their lanes' alpha
    const float a_lo = __shfl_sync(0xffffffffu, alpha, 8 * t4);
    const float a_hi = __shfl_sync(0xffffffffu, alpha, 8 * t4 + 4);
#pragma unroll
    for (int mb = 0; mb < kKS; ++mb) {
      o[mb][0] *= a_lo;
      o[mb][1] *= a_hi;
      o[mb][2] *= a_lo;
      o[mb][3] *= a_hi;
    }
#pragma unroll
    for (int x = 0; x < kR; x += 2) {
      const int t = key(j, x + (mi >> 1));
#pragma unroll
      for (int mb = 0; mb < kKS; ++mb) {
        if (16 * mb < d) {
          const int colb = 16 * mb + 8 * (mi & 1);
          uint32_t a0, a1, a2, a3;
          ldsm_x4_trans(a0, a1, a2, a3, t < n && colb < d ? at(vs, t, colb) : zero);
          mma_16816(o[mb], a0, a1, a2, a3, pb[x], pb[x + 1]);
        }
      }
    }
    __syncwarp();
    mbar_arrive_if(bars + 8 * (stages + slot), lane == 0);
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  named_bar_sync(1, 32 * kConsumerWarps);  // every consumer is done with the ring
  float* mw = mbuf + cw * 8 * (d + 2);
  if (t4 == 0 && g < w.nrep) {
    mw[g] = m;
    mw[8 + g] = l;
  }
  float* mw_acc = mw + 16;
#pragma unroll
  for (int mb = 0; mb < kKS; ++mb) {
    const int d0 = 16 * mb + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int head = 2 * t4 + h;
      if (head < w.nrep) {
        if (d0 < d) mw_acc[head * d + d0] = o[mb][h];
        if (d0 + 8 < d) mw_acc[head * d + d0 + 8] = o[mb][2 + h];
      }
    }
  }
}

// ------------------------------------------------------------- the merge

// Thread 0 takes a ticket on `counter` after a block barrier (so the
// block's partial writes are released with it); true in the block that
// draws the last of `n`, whose acquire makes the others' partials visible.
__device__ __forceinline__ bool last_ticket(int* counter, int n, volatile int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    *flag = ticket == n - 1;
  }
  __syncthreads();
  return *flag;
}

// Merges n partials (slots first, first + stride, ...; each nrep heads of
// d accumulator floats in `acc` and (max, denominator) in `ml`) into the
// output rows `out`, or into the partial slot (dacc, dml) when out is null.
// A thread takes 4 outputs at a time and reads kBatch partials at once:
// their (max, denominator) and accumulators are independent loads, issued
// together, then one rescale of the running sums per batch (no chain of
// online rescales through the partials). kBatch is 8 on tensor cores and
// 4 on CUDA cores, whose served instances have 80 registers a thread.
template <typename T, int kBatch>
__device__ void merge_partials(const float* acc, const float* ml, size_t first, int n,
                               int stride, int nrep, int d, T* out, float* dacc,
                               float* dml) {
#pragma unroll 1
  for (int i4 = threadIdx.x; i4 < nrep * d / 4; i4 += kThreads) {
    const int r = 4 * i4 / d;
    const int dd = 4 * i4 % d;
    float mo = -INFINITY, lo = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int base = 0; base < n; base += kBatch) {
      const int nb = min(kBatch, n - base);
      float m[kBatch], l[kBatch];
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j < nb) {
          const size_t s = first + (size_t)(base + j) * stride + r;
          m[j] = __ldcg(ml + 2 * s);
          l[j] = __ldcg(ml + 2 * s + 1);
          x[j] = __ldcg(reinterpret_cast<const float4*>(acc + s * d + dd));
        }
      }
      float mx = mo;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (j < nb) mx = fmaxf(mx, m[j]);
      const float c = rescale(mo, mx);
      lo *= c;
      num.x *= c;
      num.y *= c;
      num.z *= c;
      num.w *= c;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j < nb) {
          const float wt = hopper::ex2(m[j] - mx);
          lo += l[j] * wt;
          num.x += x[j].x * wt;
          num.y += x[j].y * wt;
          num.z += x[j].z * wt;
          num.w += x[j].w * wt;
        }
      }
      mo = mx;
    }
    if (out != nullptr) {
      const float inv = 1.f / lo;
      T* dst = out + (size_t)r * d + dd;
      store(dst, num.x * inv);
      store(dst + 1, num.y * inv);
      store(dst + 2, num.z * inv);
      store(dst + 3, num.w * inv);
    } else {
      *reinterpret_cast<float4*>(dacc + (size_t)r * d + dd) = num;
      if (dd == 0) {
        dml[2 * r] = mo;
        dml[2 * r + 1] = lo;
      }
    }
  }
}

// The consumers' states (kSlot heads a warp in `mbuf`) into the chunk's
// partial, then the merge tree. Workspace: the first level's accumulators
// [item][split][group] of d floats, the second level's [item][chunk
// group][group], then the first level's (max, denominator) and the
// second's in the same order. Counters: [item][chunk group] for the first
// level, then [item] for the second.
template <typename T, int kSlot, int kBatch>
__device__ void finish(const Work& w, T* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ counters, const float* mbuf, int d, int group,
                       int chunk, int n_splits, volatile int* flag) {
  const int n_active = (w.len + chunk - 1) / chunk;
  const int n_grp_all = (n_splits + kMergeFanIn - 1) / kMergeFanIn;
  const size_t items = gridDim.x;
  float* l1_acc = ws;
  float* l2_acc = l1_acc + items * n_splits * group * d;
  float* l1_ml = l2_acc + items * n_grp_all * group * d;
  float* l2_ml = l1_ml + items * n_splits * group * 2;
  const size_t slot = ((size_t)w.item * n_splits + w.split) * group;
  for (int idx = threadIdx.x; idx < w.nrep * d; idx += kThreads) {
    const int r = idx / d;
    const int dd = idx % d;
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kConsumerWarps; ++c) mx = fmaxf(mx, mbuf[c * kSlot * (d + 2) + r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int c = 0; c < kConsumerWarps; ++c) {
      const float* mw = mbuf + c * kSlot * (d + 2);
      const float a = rescale(mw[r], mx);  // 0 for a warp that had no stage
      den += mw[kSlot + r] * a;
      num += mw[2 * kSlot + r * d + dd] * a;
    }
    if (n_active == 1) {
      store(out + (w.q_row0 + r) * d + dd, num / den);
    } else {
      l1_acc[(slot + r) * d + dd] = num;
      if (dd == 0) {
        l1_ml[2 * (slot + r)] = mx;
        l1_ml[2 * (slot + r) + 1] = den;
      }
    }
  }
  if (n_active == 1) return;

  const int grp = w.split / kMergeFanIn;
  const int n_grp = (n_active + kMergeFanIn - 1) / kMergeFanIn;
  const int members = min(kMergeFanIn, n_active - grp * kMergeFanIn);
  int* c1 = counters + (size_t)w.item * n_grp_all + grp;
  if (!last_ticket(c1, members, flag)) return;
  const size_t first = ((size_t)w.item * n_splits + (size_t)grp * kMergeFanIn) * group;
  T* dst = out + w.q_row0 * d;
  if (n_grp == 1) {
    merge_partials<T, kBatch>(l1_acc, l1_ml, first, members, group, w.nrep, d, dst, nullptr,
                              nullptr);
    if (threadIdx.x == 0) *c1 = 0;  // ready for the next launch
    return;
  }
  const size_t slot2 = ((size_t)w.item * n_grp_all + grp) * group;
  merge_partials<T, kBatch>(l1_acc, l1_ml, first, members, group, w.nrep, d, nullptr,
                            l2_acc + slot2 * d, l2_ml + 2 * slot2);
  if (threadIdx.x == 0) *c1 = 0;
  int* c2 = counters + items * n_grp_all + w.item;
  if (!last_ticket(c2, n_grp, flag)) return;
  merge_partials<T, kBatch>(l2_acc, l2_ml, (size_t)w.item * n_grp_all * group, n_grp,
                            group, w.nrep, d, dst, nullptr, nullptr);
  if (threadIdx.x == 0) *c2 = 0;
}

// -------------------------------------------------------------- kernels

// CUDA cores: tile DT (head dim d <= DT), REP query heads a block at most.
template <typename T, int DT, int REP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ ws,
                        int* __restrict__ counters, int S, int Hq, int KV, int rep,
                        int group, int n_groups, int chunk, int n_splits, float scale,
                        int d, int stages) {
  constexpr int kTile = stage_rows<DT, (int)sizeof(T), 0>();
  // the length's load is in flight while thread 0 sets up the barriers
  const Work w =
      work_of<true>(lengths, S, Hq, KV, rep, group, n_groups, chunk, n_splits);
  extern __shared__ __align__(128) unsigned char smem[];
  init_barriers(smem, stages);
  if (!has_rows(w, out, d)) return;
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = ring_of(smem);
  float* mbuf = reinterpret_cast<float*>(ring);
  if (threadIdx.x < 32)
    produce<T, DT, kTile, 0>(k, v, &kmap, &vmap, w, S, KV, d, stages,
                             part_bytes<DT, (int)sizeof(T), 0>(d), bars, smem_u32(ring));
  else
    consume_core<T, DT, REP, kTile>(q, w, d, scale, stages, bars, ring, mbuf);
  __syncthreads();
  finish<T, REP, 4>(w, out, ws, counters, mbuf, d, group, chunk, n_splits,
                 reinterpret_cast<int*>(smem + kFlag));
}

// Tensor cores: bf16, tile DT (head dim d <= DT), up to 8 query heads a
// block; three blocks an SM at least (at most 136 registers a thread), two
// at DT = 256, whose q fragments and accumulators alone take 96.
template <int DT>
__global__ void __launch_bounds__(kThreads, (DT == 256 ? 2 : 3))
decode_attention_mma_kernel(const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ ws, int* __restrict__ counters, int S, int Hq,
                            int KV, int rep, int group, int n_groups, int chunk,
                            int n_splits, float scale, int d, int stages) {
  constexpr int kTile = stage_rows<DT, 2, kGap>();
  // the length's load is in flight while thread 0 sets up the barriers
  const Work w =
      work_of<false>(lengths, S, Hq, KV, rep, group, n_groups, chunk, n_splits);
  extern __shared__ __align__(128) unsigned char smem[];
  init_barriers(smem, stages);
  if (!has_rows(w, out, d)) return;
  const uint32_t bars = smem_u32(smem);
  unsigned char* ring = ring_of(smem);
  float* mbuf = reinterpret_cast<float*>(ring);
  constexpr int kPart = part_bytes<DT, 2, kGap>(DT);
  if (threadIdx.x < 32)
    produce<__nv_bfloat16, DT, kTile, kGap>(k, v, &kmap, &vmap, w, S, KV, d, stages, kPart,
                                            bars, smem_u32(ring));
  else
    consume_mma<DT, kTile>(q, w, d, scale, stages, kPart, bars, smem_u32(ring),
                           bars + kZeroRow, mbuf);
  __syncthreads();
  finish<__nv_bfloat16, 8, 8>(w, out, ws, counters, mbuf, d, group, chunk, n_splits,
                           reinterpret_cast<int*>(smem + kFlag));
}

// A 4-D tensor map over a contiguous [B, S, KV, D] cache of T, boxes of
// `rows` rows of one head: at the real width D with no swizzle when
// `swizzle_tile` is 0, else (bf16) hopper::encode_bshd's panels of a tile
// of that width in their swizzle. Encoded once per (pointer, shape, rows,
// tile): the engine's caches never move, and the serving step is bound by
// the host's time per launch.
template <typename T>
cudaError_t cache_map(CUtensorMap* map, const void* ptr, int B, int S, int KV, int D,
                      int rows, int swizzle_tile) {
  struct Entry {
    const void* ptr;
    int B, S, KV, D, rows, swizzle_tile;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static Entry entries[kEntries];
  static int used = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = entries[i];
    if (e.ptr == ptr && e.B == B && e.S == S && e.KV == KV && e.D == D && e.rows == rows &&
        e.swizzle_tile == swizzle_tile) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if (swizzle_tile > 0) {
    if (!hopper::encode_bshd(map, ptr, B, S, KV, D, rows, swizzle_tile))
      return cudaErrorInvalidValue;
  } else {
    const hopper::EncodeTiledFn fn = hopper::encode_tiled();
    if (fn == nullptr) return cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KV, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * sizeof(T), (cuuint64_t)KV * D * sizeof(T),
                                   (cuuint64_t)S * KV * D * sizeof(T)};
    const cuuint32_t box[4] = {(cuuint32_t)D, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
    if (fn(map,
           sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
           4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  entries[next] = Entry{ptr, B, S, KV, D, rows, swizzle_tile, *map};
  next = (next + 1) % kEntries;
  used = used < kEntries ? used + 1 : kEntries;
  return cudaSuccess;
}

// One call's arguments. With `smem` set, launch() writes the launch's
// dynamic shared memory there instead of launching (chip_smoke.py prints
// it beside each instance's registers).
struct Args {
  const void *q, *k, *v, *lengths;
  void *out, *ws, *counters;
  int B, Hq, KV, S, d, group, chunk, n_splits;
  cudaStream_t stream;
  int* smem;
};

template <typename T, int DT, int REP, bool kMma>
cudaError_t launch(const Args& a) {
  constexpr int kElem = sizeof(T);
  constexpr int kGapB = kMma ? kGap : 0;
  constexpr int kSlot = kMma ? 8 : REP;
  const int stages = ring_slots<DT, kElem, kGapB>(a.chunk);
  const int bytes = smem_bytes<DT, kElem, kGapB, kSlot>(a.d, stages);
  if (a.smem != nullptr) {
    *a.smem = bytes;
    return cudaSuccess;
  }
  const int rep = a.Hq / a.KV;
  const int n_groups = (rep + a.group - 1) / a.group;
  const dim3 grid(a.B * a.KV * n_groups, a.n_splits);
  const float scale = 1.4426950408889634f / sqrtf((float)a.d);  // log2(e) / sqrt(d)
  static bool configured = false;  // the most any d and chunk of this instance need
  if (!configured) {
    cudaError_t e;
    if constexpr (kMma)
      e = cudaFuncSetAttribute(decode_attention_mma_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<DT, kElem, kGapB, kSlot>(
                                   DT, max_stages<DT, kElem, kGapB>()));
    else
      e = cudaFuncSetAttribute(decode_attention_kernel<T, DT, REP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<DT, kElem, kGapB, kSlot>(
                                   DT, max_stages<DT, kElem, kGapB>()));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // Full stages' tensor copies: on tensor cores always (swizzled panels of
  // the tile), on CUDA cores with more than one KV head (one KV head's rows
  // are contiguous and go by plain bulk copies).
  constexpr int kTile = stage_rows<DT, kElem, kGapB>();
  CUtensorMap kmap = {}, vmap = {};
  if (kMma || a.KV > 1) {
    const int swizzle_tile = !kMma ? 0 : DT >= 64 ? (DT + 63) / 64 * 64 : DT;
    cudaError_t e = cache_map<T>(&kmap, a.k, a.B, a.S, a.KV, a.d, kTile, swizzle_tile);
    if (e == cudaSuccess) e = cache_map<T>(&vmap, a.v, a.B, a.S, a.KV, a.d, kTile, swizzle_tile);
    if (e != cudaSuccess) return e;
  }
  if constexpr (kMma)
    decode_attention_mma_kernel<DT><<<grid, kThreads, bytes, a.stream>>>(
        kmap, vmap, static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k), static_cast<const __nv_bfloat16*>(a.v),
        static_cast<const int*>(a.lengths), static_cast<__nv_bfloat16*>(a.out),
        static_cast<float*>(a.ws), static_cast<int*>(a.counters), a.S, a.Hq, a.KV, rep,
        a.group, n_groups, a.chunk, a.n_splits, scale, a.d, stages);
  else
    decode_attention_kernel<T, DT, REP><<<grid, kThreads, bytes, a.stream>>>(
        kmap, vmap, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const int*>(a.lengths),
        static_cast<T*>(a.out), static_cast<float*>(a.ws), static_cast<int*>(a.counters),
        a.S, a.Hq, a.KV, rep, a.group, n_groups, a.chunk, a.n_splits, scale, a.d, stages);
  return cudaGetLastError();
}

// bf16: one head a block on CUDA cores, 2 to 8 on tensor cores (tile 16 at
// D = 8); f32: CUDA cores, REP the power of two at or above the group.
template <typename T, int DT>
cudaError_t by_group(const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.group == 1) return launch<T, DT, 1, false>(a);
    return launch<T, (DT < 16 ? 16 : DT), 8, true>(a);
  } else {
    if (a.group == 1) return launch<T, DT, 1, false>(a);
    if (a.group == 2) return launch<T, DT, 2, false>(a);
    if (a.group <= 4) return launch<T, DT, 4, false>(a);
    return launch<T, DT, 8, false>(a);
  }
}

// The tile of head dim D (ops/decode_attention.py, decode_tile): D itself at
// 8, 16, 32, 64, 80, 96, 128 and 256, else the power of two above it.
template <typename T>
cudaError_t by_width(const Args& a) {
  const int D = a.d;
  if (D < 8 || D > 256 || D % 8 != 0) return cudaErrorInvalidValue;
  if (D <= 8) return by_group<T, 8>(a);
  if (D <= 16) return by_group<T, 16>(a);
  if (D <= 32) return by_group<T, 32>(a);
  if (D <= 64) return by_group<T, 64>(a);
  if (D == 80) return by_group<T, 80>(a);
  if (D == 96) return by_group<T, 96>(a);
  if (D <= 128) return by_group<T, 128>(a);
  return by_group<T, 256>(a);
}

cudaError_t by_dtype(int dtype, const Args& a) {
  if (a.group < 1 || a.group > 8 || a.chunk <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) return by_width<float>(a);
  if (dtype == 1) return by_width<__nv_bfloat16>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. D: a multiple of 8 from 8 to 256.
// `group` query heads per block (1 to 8; ceil(Hq / KV / group) blocks per
// KV head), cache chunks of `chunk` rows, n_splits * chunk >= S,
// n_splits <= 65535. With G = ceil(n_splits / 16) chunk groups and items =
// B * KV * ceil(Hq / KV / group), `ws` holds items * (n_splits + G) *
// group * (D + 2) floats and `counters` items * (G + 1) zeroed ints.
// Returns the cudaError_t of the launch.
extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* ws, void* counters, int B,
                                   int Hq, int KV, int S, int D, int dtype,
                                   int group, int chunk, int n_splits,
                                   void* stream) {
  if (B <= 0 || KV <= 0 || Hq % KV != 0 || n_splits <= 0 || n_splits > 65535 ||
      (long long)chunk * n_splits < S)
    return (int)cudaErrorInvalidValue;
  return (int)by_dtype(dtype, Args{q, k, v, lengths, out, ws, counters, B, Hq, KV, S, D,
                                   group, chunk, n_splits,
                                   static_cast<cudaStream_t>(stream), nullptr});
}

// The dynamic shared memory in bytes that rt_decode_attention launches with
// at head dim D, dtype, `group` and `chunk`, or -1 where it launches
// nothing.
extern "C" int rt_decode_attention_smem(int D, int dtype, int group, int chunk) {
  int bytes = -1;
  Args a{};
  a.d = D;
  a.group = group;
  a.chunk = chunk;
  a.smem = &bytes;
  return by_dtype(dtype, a) == cudaSuccess ? bytes : -1;
}

extern "C" const char* rt_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
