// One-token decode attention over one KV head, split across blocks
// (split-KV), shared by the paged (K2, paged_decode.cu) and contiguous (K5,
// flash_decode.cu) decode kernels.
//
// A row's positions are cut into tiles of bk positions from position 0 (K2:
// bk = pages_per_program * page, the plain version's page group; K5: bk =
// block_k), and the tiles into splits of tiles_per_split(bk) tiles.  The grid
// is (splits, Hk, B): block (s, h, b) holds the G query heads that read KV
// head h of row b and walks split s of the row.  The split depends only on
// bk, not on B or on the longest row, so a row's bits depend on its own
// length and the blocking only.
//
// A block stages its tiles' K and V in a ring of two stages in shared memory
// (one where a split holds one tile, bk > 96) with 16-byte cp.async copies,
// the next tile's copies in flight while the current one is computed
// (positions at or past len zero-filled and never
// multiplied into the sums; tiles past len never read).  Rows are stored
// without padding, their 16-byte chunks swizzled (chunk c of row j at
// c ^ (j % 8) within its group of 8, when d is a multiple of 64), so that
// reads of one chunk from 8 neighbouring rows, and of one row by a warp, hit
// distinct banks.  Per tile, all float32: the G x bk scores q . k * scale,
// four lanes a key (tile_scores); the online softmax with one warp per query
// head (shuffle reductions over the tile); the accumulator's update, four
// lanes a d pair (tile_pv).  A row that fits
// in one split (len <= tiles_per_split * bk; len 0 included) writes its
// output acc / max(l, 1e-30) rounded to bf16 directly, so a row of length 0
// gives zeros.  A longer row's blocks write their partial (m, l, acc) in
// float32 to scratch, and combine_splits merges the partials in split order:
// M = max m_s, out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M),
// 1e-30).  The two kernels differ only in where a position's K/V row lies,
// which the Rows functor gives: rows(pos) is the element offset of position
// pos's row in k and v.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_tile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;  // the ring of staged tiles, at most
constexpr float kNegInf = -1e30f;
// The split: a whole number of tiles, as many as fit in 192 positions (at
// least one).  At qwen3-14b's long-run decode (B 8, Hk 8, 1088 positions,
// pages_per_program 4 of 16 positions: bk 64) that is 3 tiles a split and 6
// splits a row, 384 blocks: 2.9 waves of the H100's 132 SMs, which hold three
// such blocks each (71 KB of shared memory a block), against 64 blocks with
// one block per (row, KV head).  At bk 128 (pages_per_program 8) a split is
// one tile and the ring one stage: 73 KB, three blocks an SM as well.
constexpr int kSplitPositions = 192;

__host__ __device__ inline int tiles_per_split(int bk) {
  return bk >= kSplitPositions ? 1 : kSplitPositions / bk;
}

// Splits of a row of `capacity` positions (the grid's first dimension).
__host__ __device__ inline int n_splits(int capacity, int bk) {
  const int tiles = (capacity + bk - 1) / bk;
  const int per = tiles_per_split(bk);
  return (tiles + per - 1) / per;
}

// Stages of the ring: a split of one tile has no next tile to stage.
__host__ __device__ inline int ring_stages(int bk) {
  return tiles_per_split(bk) < kStages ? tiles_per_split(bk) : kStages;
}

// Shared memory one block needs for G query heads, head dim d and tiles of
// bk positions.
__host__ __device__ inline size_t smem_bytes(int g, int d, int bk) {
  return static_cast<size_t>(g) * d * 4                     // q (float32)
         + ring_stages(bk) * 2 * static_cast<size_t>(bk) * d * 2  // K and V ring (bf16)
         + static_cast<size_t>(g) * bk * 4                  // scores / p
         + static_cast<size_t>(g) * d * 4                   // accumulator
         + 3 * static_cast<size_t>(g) * 4;                  // m, l, alpha
}

// Where 16-byte chunk c of staged row j lies in the row.
template <int D>
__device__ __forceinline__ int chunk_at(int j, int c) {
  return D % 64 == 0 ? c ^ (j & 7) : c;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// Stages the K and V rows of positions start .. start + bk - 1 (those at or
// past len zero-filled, nothing read there) and commits them as one group.
// A thread finds the rows of four of its chunks before it starts their
// copies, so the page-table reads of a paged cache overlap instead of
// delaying each copy in turn.
template <int D, class Rows>
__device__ __forceinline__ void stage(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                      const __nv_bfloat16* k, const __nv_bfloat16* v,
                                      const Rows& rows, int start, int len, int bk) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  constexpr int kBatch = 4;
  for (int idx0 = threadIdx.x; idx0 < bk * kVec; idx0 += kBatch * kThreads) {
    size_t off[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = idx0 + u * kThreads, j = idx / kVec;
      off[u] = idx < bk * kVec && start + j < len ? rows(start + j) + (idx % kVec) * 8 : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = idx0 + u * kThreads;
      if (idx >= bk * kVec) break;
      const int j = idx / kVec;
      const bool valid = start + j < len;
      const int at = j * D + chunk_at<D>(j, idx % kVec) * 8;
      cp_async_16(ks + at, k + off[u], valid);
      cp_async_16(vs + at, v + off[u], valid);
    }
  }
  asm volatile("cp.async.commit_group;\n");
}

// The tile's scores ps[r * bk + j] = q_r . k_j * scale for the G heads and
// the tile's keys (kNegInf at j >= n_valid).  Four neighbouring lanes take
// one key, each a quarter of its 16-byte chunks (chunks quarter, quarter + 4,
// ...), held in registers for all G heads, and sum their parts with two
// shuffles.  A warp's 8 keys are ordered so that the two keys of a
// quarter-warp lie 4 rows apart: their swizzled chunks then fall on distinct
// banks.
template <int D>
__device__ __forceinline__ void tile_scores(const float* __restrict__ qs,
                                            const __nv_bfloat16* __restrict__ kt,
                                            float* __restrict__ ps, int g, int bk, int n_valid,
                                            float scale) {
  constexpr int kVec = D / 8, kChunks = (kVec + 3) / 4;  // chunks per quarter
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int quarter = lane & 3, kk = lane >> 2;
  for (int j0 = 0; j0 < bk; j0 += kThreads / 4) {
    const int j = j0 + 8 * warp + (kk >> 1) + 4 * (kk & 1);
    const bool valid = j < n_valid;
    float kf[kChunks * 8];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int chunk = 4 * c + quarter;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (valid && chunk < kVec)
        raw = *reinterpret_cast<const uint4*>(kt + j * D + chunk_at<D>(j, chunk) * 8);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        kf[8 * c + 2 * e] = f.x;
        kf[8 * c + 2 * e + 1] = f.y;
      }
    }
    for (int r = 0; r < g; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(qs + r * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int chunk = 4 * c + quarter;
        if (chunk >= kVec) break;
        const float4 qa = qr[2 * chunk], qb = qr[2 * chunk + 1];
        dot = fmaf(qa.x, kf[8 * c], dot);
        dot = fmaf(qa.y, kf[8 * c + 1], dot);
        dot = fmaf(qa.z, kf[8 * c + 2], dot);
        dot = fmaf(qa.w, kf[8 * c + 3], dot);
        dot = fmaf(qb.x, kf[8 * c + 4], dot);
        dot = fmaf(qb.y, kf[8 * c + 5], dot);
        dot = fmaf(qb.z, kf[8 * c + 6], dot);
        dot = fmaf(qb.w, kf[8 * c + 7], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (quarter == 0 && j < bk) ps[r * bk + j] = valid ? dot * scale : kNegInf;
    }
  }
}

// acc[r][d] = acc[r][d] * as[r] + sum_j ps[r * bk + j] v_j[d] over the tile's
// n_valid keys.  A warp takes 8 d pairs, four lanes a pair, each lane a
// quarter of a 64-key batch (keys 8 (i / 2) + 2 lane/8 + i % 2, whose
// swizzled chunks fall on distinct banks), its values of v held in registers
// for all G heads; the quarters are summed with two shuffles and added to
// acc, the first batch after the rescale.
template <int D>
__device__ __forceinline__ void tile_pv(const __nv_bfloat16* __restrict__ vt,
                                        const float* __restrict__ ps,
                                        const float* __restrict__ as, float* __restrict__ acc,
                                        int g, int bk, int n_valid) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slot = lane >> 3;
  for (int dp0 = 0; dp0 < D / 2; dp0 += 8 * kWarps) {
    const int dp = dp0 + 8 * warp + (lane & 7);  // this lane's d pair
    const bool dvalid = dp < D / 2;
    for (int base = 0; base < n_valid; base += 64) {
      float2 vv[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = base + 8 * (i >> 1) + 2 * slot + (i & 1);
        vv[i] = make_float2(0.f, 0.f);
        if (dvalid && j < n_valid)
          vv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              vt + j * D + chunk_at<D>(j, dp / 4) * 8 + 2 * (dp % 4)));
      }
      for (int r = 0; r < g; ++r) {
        const float* pr = ps + r * bk;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int j = base + 8 * (i >> 1) + 2 * slot + (i & 1);
          const float p = j < n_valid ? pr[j] : 0.f;
          a0 = fmaf(p, vv[i].x, a0);
          a1 = fmaf(p, vv[i].y, a1);
        }
        a0 += __shfl_xor_sync(0xffffffffu, a0, 8);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 8);
        a0 += __shfl_xor_sync(0xffffffffu, a0, 16);
        a1 += __shfl_xor_sync(0xffffffffu, a1, 16);
        if (slot == 0 && dvalid) {
          float* ac = acc + r * D + 2 * dp;
          const float alpha = base == 0 ? as[r] : 1.f;
          ac[0] = ac[0] * alpha + a0;
          ac[1] = ac[1] * alpha + a1;
        }
      }
    }
  }
}

// Split blockIdx.x of one (row, KV head): q and out hold the block's G rows
// of D at q_base; len is already clamped to the positions the cache holds;
// part points at this (row, KV head)'s partials: (m, l) per (split, query
// head), then acc per (split, query head, d).
template <int D, class Rows>
__device__ __forceinline__ void decode_split(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const Rows& rows, int len,
                                             __nv_bfloat16* __restrict__ out, size_t q_base,
                                             float* __restrict__ part, int g, int bk,
                                             float scale) {
  static_assert(D % 16 == 0, "16-byte rows, d pairs");
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x;
  const int per = tiles_per_split(bk), stages = ring_stages(bk);
  const int n_tiles = (len + bk - 1) / bk;
  const int t0 = split * per, t1 = min(t0 + per, n_tiles);
  const bool single = n_tiles <= per;  // the whole row is split 0
  if (t0 >= t1 && !(single && split == 0)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + g * D);  // stage s: ks + 2 s bk D
  float* ps = reinterpret_cast<float*>(ks + stages * 2 * bk * D);
  float* acc = ps + g * bk;
  float* ms = acc + g * D;
  float* ls = ms + g;
  float* as = ls + g;

  if (t0 < t1) stage<D>(ks, ks + bk * D, k, v, rows, t0 * bk, len, bk);
  for (int idx = tid; idx < g * D; idx += kThreads) {
    qs[idx] = __bfloat162float(q[q_base + idx]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int start = tile * bk;
    const int n_valid = min(bk, len - start);
    __nv_bfloat16* kt = ks + ((tile - t0) % stages) * 2 * bk * D;
    const __nv_bfloat16* vt = kt + bk * D;
    if (tile + 1 < t1) {  // the next tile's copies, in flight during this one
      __nv_bfloat16* kn = ks + ((tile + 1 - t0) % stages) * 2 * bk * D;
      stage<D>(kn, kn + bk * D, k, v, rows, start + bk, len, bk);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile has landed for every thread; q, m, l, acc are set
    tile_scores<D>(qs, kt, ps, g, bk, n_valid, scale);
    __syncthreads();
    for (int r = warp; r < g; r += kWarps) {  // one warp per query head
      float* pr = ps + r * bk;
      const float m_prev = ms[r];
      float mx = m_prev;
      for (int j = lane; j < n_valid; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float e = j < n_valid ? expf(pr[j] - mx) : 0.f;
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        ls[r] = ls[r] * alpha + sum;
        ms[r] = mx;
        as[r] = alpha;
      }
    }
    __syncthreads();
    tile_pv<D>(vt, ps, as, acc, g, bk, n_valid);
    __syncthreads();  // every thread is done with this stage, ps and acc
  }
  __syncthreads();
  if (single) {
    for (int idx = tid; idx < g * D; idx += kThreads) {
      const int r = idx / D;
      out[q_base + idx] = __float2bfloat16(acc[idx] / fmaxf(ls[r], 1e-30f));
    }
    return;
  }
  const int splits = gridDim.x;
  for (int r = tid; r < g; r += kThreads) {
    part[(split * g + r) * 2] = ms[r];
    part[(split * g + r) * 2 + 1] = ls[r];
  }
  float* pacc = part + static_cast<size_t>(splits) * g * 2 + static_cast<size_t>(split) * g * D;
  for (int idx = tid; idx < g * D; idx += kThreads) pacc[idx] = acc[idx];
}

// Merges the partials of the rows that took more than one split, in split
// order: the body of each kernel's second launch, grid (Hk, B), one block
// per (row, KV head), g * (splits + 1) floats of dynamic shared memory.  part
// holds each (row, KV head)'s partials at ((b * hk + h) * splits * g *
// (D + 2)).  Each head's weights w_s = e^(m_s - M) and L = sum_s l_s w_s are
// found once; then out = sum_s acc_s w_s / max(L, 1e-30) per (head, d), the
// splits in order.
template <int D>
__device__ __forceinline__ void combine_splits(const float* __restrict__ part,
                                               const int* __restrict__ lengths,
                                               __nv_bfloat16* __restrict__ out, int hk, int g,
                                               int capacity, int bk, int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > capacity ? capacity : len);
  const int n = ((len + bk - 1) / bk + tiles_per_split(bk) - 1) / tiles_per_split(bk);
  if (n <= 1) return;  // written by its only split
  extern __shared__ float wts[];  // (g, splits) weights, then g sums L
  float* sums = wts + g * splits;
  const size_t row = static_cast<size_t>(b) * hk + h;
  const float* ml = part + row * splits * g * (D + 2);
  const float* pacc = ml + static_cast<size_t>(splits) * g * 2;
  for (int r = threadIdx.x; r < g; r += kThreads) {
    float mx = kNegInf;
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[(s * g + r) * 2]);
    float l = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = expf(ml[(s * g + r) * 2] - mx);
      wts[r * splits + s] = w;
      l = fmaf(ml[(s * g + r) * 2 + 1], w, l);
    }
    sums[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * D; idx += kThreads) {
    const int r = idx / D;
    float o = 0.f;
    for (int s = 0; s < n; ++s)
      o = fmaf(pacc[static_cast<size_t>(s) * g * D + idx], wts[r * splits + s], o);
    out[row * g * D + idx] = __float2bfloat16(o / sums[r]);
  }
}

}  // namespace decode_tile
