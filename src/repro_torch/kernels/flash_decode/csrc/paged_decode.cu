// Hopper kernel for paged flash decode (K2).
//
// Replaces src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_pallas
// (the Pallas TPU kernel; body _paged_decode_kernel), without its optional
// q_pe / kpe score term (MLA's absorbed latent path, left for that arch).
// One new query token per (batch row, KV head) and its G grouped query heads
// attends to the paged K/V pool (n_pages, Hk, page, d) in place, through the
// row's page table: online softmax over groups of pages_per_program pages,
// positions at or past the row's length masked, groups past it skipped,
// out = acc / max(l, 1e-30), as flash_decode/ops.py::_block_update.
//
// Arithmetic: bf16 loads, float32 dot products, float32 online softmax, as
// the reference.  Page-table entries outside [0, n_pages) are clamped, as the
// reference's gather clamps them.
//
// What bounds it on this card: the bytes.  A decode step reads each live
// row's K and V once (2 * len * d * 2 bytes per KV head) and does about 4 d
// operations per position and query head, so it is far below the ridge of
// either the float32 or the tensor-core rate; the bound is the pool's bytes
// over 3.35 TB/s.  This first kernel does not reach it: one block per
// (row, KV head) gives B * Hk blocks (32 at the CLI's max_batch 4 and
// qwen3-14b's 8 KV heads, 64 at max_batch 8) on 132 SMs, each walking its
// page groups in order with loads and compute not overlapped.  Splitting
// the keys across blocks (split-KV) and overlapping the page loads (cp.async
// or TMA) are the first things a later PR fixes.
//
// Design: grid = (Hk, B), 128 threads.  The block reads its own page ids
// from the page table (Hopper has no scalar prefetch), stages each group of
// pages_per_program pages of K and V in shared memory (positions at or past
// the length zero-filled and never multiplied into the sums), computes the
// G x (ppp * page) scores by (head, key) pairs, runs the online softmax per
// query head in key order, and accumulates p v by (head, d) pairs.  The
// Pallas grid's sequential page-group axis becomes this loop in the block.
// Idle engine slots (length 1, every page the scratch page 0) get a finite
// output.  The kernel launches on the caller's stream, allocates nothing and
// does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPad = 8;  // bf16 padding per K/V row in shared memory
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t smem_bytes(int g, int d, int blk) {
  return static_cast<size_t>(g) * d * 4                  // q (float32)
         + 2 * static_cast<size_t>(blk) * (d + kPad) * 2 // K and V of one group (bf16)
         + static_cast<size_t>(g) * blk * 4              // scores / p
         + static_cast<size_t>(g) * d * 4                // accumulator
         + 3 * static_cast<size_t>(g) * 4;               // m, l, alpha
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, __nv_bfloat16* __restrict__ out,
                    int hk, int g, int n_pages, int page, int npp, int ppp, float scale) {
  constexpr int kRow = D + kPad;
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int blk = ppp * page;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + g * D);
  __nv_bfloat16* vs = ks + blk * kRow;
  float* ps = reinterpret_cast<float*>(vs + blk * kRow);
  float* acc = ps + g * blk;
  float* ms = acc + g * D;
  float* ls = ms + g;
  float* as = ls + g;

  const size_t q_base = (static_cast<size_t>(b) * hk + h) * g * D;
  for (int idx = tid; idx < g * D; idx += kThreads) {
    qs[idx] = __bfloat162float(q[q_base + idx]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < g; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  int len = lengths[b];
  len = len < 0 ? 0 : (len > npp * page ? npp * page : len);
  const int n_groups = (len + blk - 1) / blk;
  const int* table = page_tables + static_cast<size_t>(b) * npp;

  for (int grp = 0; grp < n_groups; ++grp) {
    const int start = grp * blk;
    __syncthreads();  // the previous group's readers are done with ks / vs / ps
    for (int idx = tid; idx < blk * kVec; idx += kThreads) {
      const int j = idx / kVec, c = idx % kVec;
      const int pos = start + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < len) {
        int pid = table[pos / page];  // pos < len <= npp * page
        pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
        const size_t off = ((static_cast<size_t>(pid) * hk + h) * page + pos % page) * D + c * 8;
        kv = *reinterpret_cast<const uint4*>(kp + off);
        vv = *reinterpret_cast<const uint4*>(vp + off);
      }
      *reinterpret_cast<uint4*>(ks + j * kRow + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + j * kRow + c * 8) = vv;
    }
    __syncthreads();
    const int n_valid = min(blk, len - start);
    for (int pair = tid; pair < g * blk; pair += kThreads) {
      const int r = pair / blk, j = pair % blk;
      float s = kNegInf;
      if (j < n_valid) {
        const float* qr = qs + r * D;
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + j * kRow);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < D / 2; ++c) {
          const float2 kv = __bfloat1622float2(kr[c]);
          dot = fmaf(qr[2 * c], kv.x, dot);
          dot = fmaf(qr[2 * c + 1], kv.y, dot);
        }
        s = dot * scale;
      }
      ps[pair] = s;
    }
    __syncthreads();
    for (int r = tid; r < g; r += kThreads) {
      float* pr = ps + r * blk;
      const float m_prev = ms[r];
      float mx = m_prev;
      for (int j = 0; j < n_valid; ++j) mx = fmaxf(mx, pr[j]);
      const float alpha = expf(m_prev - mx);
      float sum = 0.f;
      for (int j = 0; j < blk; ++j) {
        const float e = j < n_valid ? expf(pr[j] - mx) : 0.f;
        pr[j] = e;
        sum += e;
      }
      ls[r] = ls[r] * alpha + sum;
      ms[r] = mx;
      as[r] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < g * D; idx += kThreads) {
      const int r = idx / D, dd = idx % D;
      const float* pr = ps + r * blk;
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

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
           const int* lengths, const int* page_tables, __nv_bfloat16* out, int b, int hk,
           int g, int n_pages, int page, int npp, int ppp, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, D, ppp * page);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hk, b);
  paged_decode_kernel<D><<<grid, kThreads, smem, stream>>>(q, kp, vp, lengths, page_tables, out,
                                                          hk, g, n_pages, page, npp, ppp, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for G query heads, head dim d and a group
// of blk = pages_per_program * page positions.
extern "C" int paged_decode_smem_bytes(int g, int d, int blk) {
  return static_cast<int>(smem_bytes(g, d, blk));
}

// q (B, Hk, G, d) and out (B, Hk, G, d) bf16; k_pages and v_pages
// (n_pages, Hk, page, d) bf16; lengths (B,) int32; page_tables (B, npp)
// int32; all contiguous.  d is a multiple of 16 up to 256.  Returns a
// cudaError_t (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* lengths, const void* page_tables, void* out,
                                   int b, int hk, int g, int d, int n_pages, int page, int npp,
                                   int ppp, float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* pt = static_cast<const int*>(page_tables);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define PAGED_DECODE_CASE(D) \
    case D: return launch<D>(qb, kb, vb, lens, pt, ob, b, hk, g, n_pages, page, npp, ppp, scale, st);
    PAGED_DECODE_CASE(16) PAGED_DECODE_CASE(32) PAGED_DECODE_CASE(48) PAGED_DECODE_CASE(64)
    PAGED_DECODE_CASE(80) PAGED_DECODE_CASE(96) PAGED_DECODE_CASE(112) PAGED_DECODE_CASE(128)
    PAGED_DECODE_CASE(144) PAGED_DECODE_CASE(160) PAGED_DECODE_CASE(176) PAGED_DECODE_CASE(192)
    PAGED_DECODE_CASE(208) PAGED_DECODE_CASE(224) PAGED_DECODE_CASE(240) PAGED_DECODE_CASE(256)
#undef PAGED_DECODE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
