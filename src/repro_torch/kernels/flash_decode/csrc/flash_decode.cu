// Hopper kernel for contiguous flash decode (K5).
//
// Replaces src/repro/kernels/flash_decode/kernel.py::flash_decode_pallas
// (the Pallas TPU kernel; body _decode_kernel).  One new query token per
// (batch row, query head) attends to a contiguous KV cache (B, Hk, S, D) with
// per-row valid lengths: scores q . k * scale in float32, positions at or past
// lengths[b] masked, an online softmax over tiles of block_k positions with
// the running max, sum and accumulator in float32 and p kept in float32,
// out = acc / max(l, 1e-30) in q's type.  A row of length 0 gives zeros, as
// the Pallas kernel does (l stays 0).  Lengths outside [0, S] are clamped.
//
// Grouped KV without a copy: query head h reads KV head h / G (Hq = G * Hk),
// which is what the reference's decode_attention_auto gets from repeating the
// cache G times (flash_decode/ops.py:74-76); G = 1 is the Pallas kernel's own
// contract.
//
// Arithmetic: bf16 loads, float32 dot products, float32 online softmax; a
// row longer than one split is merged from its splits' float32 partials.
//
// What bounds it on this card: the bytes.  A call reads each row's valid K
// and V once per KV head (2 * len * D * 2 bytes) and does about 4 D
// operations per valid position and query head, far below the ridge of any
// of the card's rates; the bound is those bytes over 3.35 TB/s.
//
// Design: the block body is decode_tile.cuh's, shared with K2, with the row's
// K/V at contiguous positions: grid = (splits, Hk, B), 256 threads, each
// block one split (a fixed number of block_k tiles from position 0) of one
// (row, KV head), its tiles staged with cp.async through a ring of two
// stages (one where a split is one tile); the partials of rows longer than one split are merged in split
// order by a second launch (flash_decode_combine_kernel, on decode_tile.cuh's
// combine_splits).  It stops at the row's length: the TPU grid visits every
// block of the padded cache and masks the ones past it, here they are never
// read.  The Pallas grid's sequential KV-block axis becomes the splits and
// each block's loop over its tiles.  The kernels launch on the caller's
// stream, allocate nothing and do not synchronise.
#include "decode_tile.cuh"

namespace {

using decode_tile::kThreads;
using decode_tile::n_splits;
using decode_tile::smem_bytes;

// Position pos of one (row, KV head) lies at base + pos * D.
template <int D>
struct ContiguousRows {
  size_t base;
  __device__ __forceinline__ size_t operator()(int pos) const {
    return base + static_cast<size_t>(pos) * D;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ scratch, __nv_bfloat16* __restrict__ out, int hk, int g,
                    int s, int bk, float scale) {
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > s ? s : len);
  const size_t row = static_cast<size_t>(b) * hk + h;
  decode_tile::decode_split<D>(q, k, v, ContiguousRows<D>{row * s * D}, len, out, row * g * D,
                               scratch + row * gridDim.x * g * (D + 2), g, bk, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                     __nv_bfloat16* __restrict__ out, int hk, int g, int capacity, int bk,
                     int splits) {
  decode_tile::combine_splits<D>(part, lengths, out, hk, g, capacity, bk, splits);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* lengths, float* scratch, __nv_bfloat16* out, int b, int hk, int g,
           int s, int bk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, D, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = n_splits(s, bk);
  flash_decode_kernel<D><<<dim3(splits, hk, b), kThreads, smem, stream>>>(
      q, k, v, lengths, scratch, out, hk, g, s, bk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_decode_combine_kernel<D><<<dim3(hk, b), kThreads,
                                   g * (splits + 1) * sizeof(float), stream>>>(
      scratch, lengths, out, hk, g, s, bk, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for G query heads, head dim d and tiles of
// bk positions.
extern "C" int flash_decode_smem_bytes(int g, int d, int bk) {
  return static_cast<int>(smem_bytes(g, d, bk));
}

// Splits of a row of s positions in tiles of bk: the grid's first dimension,
// and the partials per (row, KV head) in scratch.
extern "C" int flash_decode_splits(int s, int bk) { return n_splits(s, bk); }

// q (B, Hk, G, d) and out (B, Hk, G, d) bf16; k and v (B, Hk, S, d) bf16;
// lengths (B,) int32; scratch B * Hk * splits * G * (d + 2) float32, splits =
// flash_decode_splits(S, bk); all contiguous and 16-byte aligned.  d is a
// multiple of 16 up to 256; 1 <= bk <= S.  Returns a cudaError_t (0 on
// success).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* lengths, void* scratch, void* out, int b, int hk,
                                   int g, int s, int d, int bk, float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* lens = static_cast<const int*>(lengths);
  auto* sc = static_cast<float*>(scratch);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  switch (d) {
#define FLASH_DECODE_CASE(D) \
    case D: return launch<D>(qb, kb, vb, lens, sc, ob, b, hk, g, s, bk, scale, st);
    FLASH_DECODE_CASE(16) FLASH_DECODE_CASE(32) FLASH_DECODE_CASE(48) FLASH_DECODE_CASE(64)
    FLASH_DECODE_CASE(80) FLASH_DECODE_CASE(96) FLASH_DECODE_CASE(112) FLASH_DECODE_CASE(128)
    FLASH_DECODE_CASE(144) FLASH_DECODE_CASE(160) FLASH_DECODE_CASE(176) FLASH_DECODE_CASE(192)
    FLASH_DECODE_CASE(208) FLASH_DECODE_CASE(224) FLASH_DECODE_CASE(240) FLASH_DECODE_CASE(256)
#undef FLASH_DECODE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
