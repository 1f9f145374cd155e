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
// the reference; a row longer than one split is merged from its splits'
// float32 partials (decode_tile.cuh).  Page-table entries outside [0, n_pages) are clamped, as the
// reference's gather clamps them.
//
// What bounds it on this card: the bytes.  A decode step reads each live
// row's K and V once (2 * len * d * 2 bytes per KV head) and does about 4 d
// operations per position and query head, so it is far below the ridge of
// either the float32 or the tensor-core rate; the bound is the pool's bytes
// over 3.35 TB/s.  To come near it the reads have to be spread over the card
// and kept in flight: a grid of one block per (row, KV head) gives only
// B * Hk blocks (64 at max_batch 8 and qwen3-14b's 8 KV heads) on 132 SMs,
// each walking its whole row with loads and compute in turn.  So the keys are
// split across blocks (split-KV) and the page loads overlapped with compute.
//
// Design: grid = (splits, Hk, B), 256 threads; the block body is
// decode_tile.cuh's, shared with K5: each block walks one split of its row
// (a fixed number of page groups of pages_per_program pages, from position 0;
// 6 splits of 3 groups at the long-run shape), staging each group's K/V rows
// through the row's page table with cp.async into a ring of two stages (one
// where a split is one group; the block reads its own page ids: Hopper has no
// scalar prefetch), and writes
// its partial (m, l, acc) to scratch the wrapper allocates; a second launch,
// paged_decode_combine_kernel (decode_tile.cuh's combine_splits), merges the
// partials in split order.  A row within one split writes its output
// directly.  Groups past the row's length are never read.  The Pallas grid's
// sequential page-group axis becomes the splits and each block's loop over
// its groups.  Idle engine slots (length 1, every page the scratch page 0)
// get a finite output.  The kernels launch on the caller's stream, allocate
// nothing and do not synchronise.
#include "decode_tile.cuh"

namespace {

using decode_tile::kThreads;
using decode_tile::n_splits;
using decode_tile::smem_bytes;

// Position pos of one (row, KV head) lies in page table[pos / page] of the
// pool (n_pages, Hk, page, D), at slot pos % page; ids outside the pool clamp.
template <int D>
struct PagedRows {
  const int* table;
  int n_pages, hk, h, page;
  __device__ __forceinline__ size_t operator()(int pos) const {
    int pid = table[pos / page];
    pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
    return ((static_cast<size_t>(pid) * hk + h) * page + pos % page) * D;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
                    const int* __restrict__ page_tables, float* __restrict__ scratch,
                    __nv_bfloat16* __restrict__ out, int hk, int g, int n_pages, int page,
                    int npp, int ppp, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > npp * page ? npp * page : len);
  const PagedRows<D> rows{page_tables + static_cast<size_t>(b) * npp, n_pages, hk, h, page};
  const size_t row = static_cast<size_t>(b) * hk + h;
  decode_tile::decode_split<D>(q, kp, vp, rows, len, out, row * g * D,
                               scratch + row * gridDim.x * g * (D + 2), g, ppp * page, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, int hk, int g, int capacity, int bk,
                     int splits) {
  decode_tile::combine_splits<D>(part, lengths, out, hk, g, capacity, bk, splits);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* kp, const __nv_bfloat16* vp,
           const int* lengths, const int* page_tables, float* scratch, __nv_bfloat16* out,
           int b, int hk, int g, int n_pages, int page, int npp, int ppp, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(g, D, ppp * page);
  cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = n_splits(npp * page, ppp * page);
  paged_decode_kernel<D><<<dim3(splits, hk, b), kThreads, smem, stream>>>(
      q, kp, vp, lengths, page_tables, scratch, out, hk, g, n_pages, page, npp, ppp, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  paged_decode_combine_kernel<D><<<dim3(hk, b), kThreads,
                                   g * (splits + 1) * sizeof(float), stream>>>(
      scratch, lengths, out, hk, g, npp * page, ppp * page, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for G query heads, head dim d and a group
// of blk = pages_per_program * page positions.
extern "C" int paged_decode_smem_bytes(int g, int d, int blk) {
  return static_cast<int>(smem_bytes(g, d, blk));
}

// Splits of a row of `capacity` positions in groups of blk positions: the
// grid's first dimension, and the partials per (row, KV head) in scratch.
extern "C" int paged_decode_splits(int capacity, int blk) { return n_splits(capacity, blk); }

// q (B, Hk, G, d) and out (B, Hk, G, d) bf16; k_pages and v_pages
// (n_pages, Hk, page, d) bf16; lengths (B,) int32; page_tables (B, npp)
// int32; scratch B * Hk * splits * G * (d + 2) float32, splits =
// paged_decode_splits(npp * page, ppp * page); all contiguous and 16-byte
// aligned.  d is a multiple of 16 up to 256.  Returns a cudaError_t (0 on
// success).
extern "C" int paged_decode_launch(const void* q, const void* k_pages, const void* v_pages,
                                   const void* lengths, const void* page_tables, void* scratch,
                                   void* out, int b, int hk, int g, int d, int n_pages,
                                   int page, int npp, int ppp, float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k_pages);
  const auto* vb = static_cast<const __nv_bfloat16*>(v_pages);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* pt = static_cast<const int*>(page_tables);
  auto* sc = static_cast<float*>(scratch);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define PAGED_DECODE_CASE(D)                                                                \
    case D:                                                                                 \
      return launch<D>(qb, kb, vb, lens, pt, sc, ob, b, hk, g, n_pages, page, npp, ppp, scale, \
                       st);
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
