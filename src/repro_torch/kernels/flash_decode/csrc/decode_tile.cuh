// One-token decode attention over one KV head, shared by the paged (K2,
// paged_decode.cu) and contiguous (K5, flash_decode.cu) decode kernels.
//
// A block holds the G query heads that read one KV head of one batch row.
// It walks the row's first len positions in tiles of bk: it stages each
// tile's K and V in shared memory (positions at or past len zero-filled and
// never multiplied into the sums), computes the G x bk scores q . k * scale
// by (head, key) pairs, runs the online softmax with one warp per query head
// (shuffle reductions over the tile), and accumulates p v by (head, d)
// pairs.  Scores, softmax and accumulator are float32; the output is
// acc / max(l, 1e-30) rounded to bf16, so a row of length 0 gives zeros.
// Tiles past len are never read.  The two kernels differ only in where a
// position's K/V row lies, which the Rows functor gives: rows(pos) is the
// element offset of position pos's row in k and v.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode_tile {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // bf16 padding per K/V row in shared memory
constexpr float kNegInf = -1e30f;

// Shared memory one block needs for G query heads, head dim d and tiles of
// bk positions.
__host__ __device__ inline size_t smem_bytes(int g, int d, int bk) {
  return static_cast<size_t>(g) * d * 4                  // q (float32)
         + 2 * static_cast<size_t>(bk) * (d + kPad) * 2  // K and V tiles (bf16)
         + static_cast<size_t>(g) * bk * 4               // scores / p
         + static_cast<size_t>(g) * d * 4                // accumulator
         + 3 * static_cast<size_t>(g) * 4;               // m, l, alpha
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

// q and out hold the block's G rows of D at q_base; len is already clamped
// to the positions the cache holds.
template <int D, class Rows>
__device__ __forceinline__ void decode_block(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const Rows& rows, int len,
                                             __nv_bfloat16* __restrict__ out, size_t q_base,
                                             int g, int bk, float scale) {
  constexpr int kRow = D + kPad;
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + g * D);
  __nv_bfloat16* vs = ks + bk * kRow;
  float* ps = reinterpret_cast<float*>(vs + bk * kRow);
  float* acc = ps + g * bk;
  float* ms = acc + g * D;
  float* ls = ms + g;
  float* as = ls + g;

  for (int idx = tid; idx < g * D; idx += kThreads) {
    qs[idx] = __bfloat162float(q[q_base + idx]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  const int n_tiles = (len + bk - 1) / bk;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int start = tile * bk;
    const int n_valid = min(bk, len - start);
    __syncthreads();  // the previous tile's readers are done with ks / vs / ps
    for (int idx = tid; idx < bk * kVec; idx += kThreads) {
      const int j = idx / kVec, c = idx % kVec;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j < n_valid) {
        const size_t off = rows(start + j) + c * 8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(ks + j * kRow + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + j * kRow + c * 8) = vv;
    }
    __syncthreads();
    for (int pair = tid; pair < g * bk; pair += kThreads) {
      const int r = pair / bk, j = pair % bk;
      float sc = kNegInf;
      if (j < n_valid) {
        const float* qr = qs + r * D;
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + j * kRow);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < D / 2; ++c) {
          const float2 kf = __bfloat1622float2(kr[c]);
          dot = fmaf(qr[2 * c], kf.x, dot);
          dot = fmaf(qr[2 * c + 1], kf.y, dot);
        }
        sc = dot * scale;
      }
      ps[pair] = sc;
    }
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
    for (int idx = tid; idx < g * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D;
      const float* pr = ps + r * bk;
      float pv = 0.f;
      for (int j = 0; j < n_valid; ++j) pv = fmaf(pr[j], __bfloat162float(vs[j * kRow + dd]), pv);
      acc[idx] = acc[idx] * as[r] + pv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * D; idx += kThreads) {
    const int r = idx / D;
    out[q_base + idx] = __float2bfloat16(acc[idx] / fmaxf(ls[r], 1e-30f));
  }
}

}  // namespace decode_tile
