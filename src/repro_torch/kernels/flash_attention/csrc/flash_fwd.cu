// Hopper kernel for the blocked causal flash-attention forward (K3).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd_pallas
// (the Pallas TPU kernel, with its GQA wrapper flash_attention_pallas), and
// computes what the models call through ops.flash_attention
// (flash_attention/ops.py::_flash_fwd_impl): grouped GQA without repeating
// KV (query head h reads KV head h / G), a value dim DV that may differ
// from the key dim DK (MLA's prefill: DK 192, DV 128), per-batch kv_lens, a
// static q_offset, causal masking, online softmax over key tiles of block_k
// positions, fully masked tiles skipped, out = acc / max(l, 1e-30).
//
// Arithmetic: bf16 loads, float32 dot products, float32 online softmax, as
// the reference.  Each query row's result depends only on its own q, the keys
// and values at positions <= its own and < kv_len, and the fixed key tiles of
// block_k positions starting at 0; every sum runs in a fixed order per row
// (dot products over d in order, the tile's max and sum over keys in order,
// p v over keys in order).  So a row gives the same bits whatever Sq, the
// query tiling or the batch: the serve engine's prefix guarantee rests on it.
// Skipping a tile that is fully masked for a row is exact: in the online
// softmax it is a no-op (alpha = 1, p = 0).
//
// What bounds it on this card: at the engine's block_k = 16 and in float32
// (no tensor cores), the operations, 2 Sq^2 (DK + DV) Hq / 2 for a causal prefill,
// run on the CUDA cores from shared memory; the bytes (q, k, v read once,
// out written once) are small beside them.  Against the card's bf16
// tensor-core peak (989 TFLOP/s) the kernel is far off; its float32 path
// peaks at 67 TFLOP/s, and shared-memory loads (about two per multiply-add)
// bound it below that.  Tensor cores (wgmma, with the same per-row order of
// tiles) and TMA loads are later work.
//
// Design: grid = (ceil(Sq / 16), Hk, B); one block of 256 threads holds 16
// query positions of all G query heads of one KV head (G * 16 rows), so each
// key/value tile loaded into shared memory serves G * 16 rows.  The block
// walks the key tiles in order from position 0 up to the causal limit of its
// last row and kv_len; per tile: load K and V (positions at or past kv_len
// are zero-filled), scores by (row, key) pairs, the online softmax by row,
// then acc = acc * alpha + p v by (row, d) pairs.  q, the scores and the
// float32 accumulator live in dynamic shared memory.  The TPU kernel's
// sequential grid axis over key blocks becomes this loop inside the block.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 16;   // query positions per block
constexpr int kPad = 8;      // bf16 padding per K/V row in shared memory
constexpr float kNegInf = -1e30f;

__host__ __device__ inline size_t smem_bytes(int g, int dk, int dv, int bk) {
  const size_t rows = static_cast<size_t>(g) * kTileQ;
  return rows * dk * 2                                     // q (bf16)
         + static_cast<size_t>(bk) * (dk + kPad) * 2      // K tile (bf16)
         + static_cast<size_t>(bk) * (dv + kPad) * 2      // V tile (bf16)
         + rows * bk * 4                                   // scores / p
         + rows * dv * 4                                   // accumulator
         + 3 * rows * 4;                                   // m, l, alpha
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                 __nv_bfloat16* __restrict__ out, int hk, int g, int sq, int skv,
                 int q_offset, int causal, int bk, float scale) {
  static_assert(DK % 8 == 0 && DV % 8 == 0, "16-byte rows");
  constexpr int kRowK = DK + kPad, kRowV = DV + kPad;
  constexpr int kVecK = DK / 8, kVecV = DV / 8;  // 16-byte vectors per row
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rows = g * kTileQ;
  const int hq = hk * g;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + rows * DK;
  __nv_bfloat16* vs = ks + bk * kRowK;
  float* ps = reinterpret_cast<float*>(vs + bk * kRowV);
  float* acc = ps + rows * bk;
  float* ms = acc + rows * DV;
  float* ls = ms + rows;
  float* as = ls + rows;

  // row r = gi * 16 + i: query head h * g + gi at position qt * 16 + i
  for (int idx = tid; idx < rows * kVecK; idx += kThreads) {
    const int r = idx / kVecK, c = idx % kVecK;
    const int gi = r / kTileQ, p = qt * kTileQ + r % kTileQ;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p < sq) {
      const size_t off = ((static_cast<size_t>(b) * hq + h * g + gi) * sq + p) * DK + c * 8;
      val = *reinterpret_cast<const uint4*>(q + off);
    }
    *reinterpret_cast<uint4*>(qs + r * DK + c * 8) = val;
  }
  for (int idx = tid; idx < rows * DV; idx += kThreads) acc[idx] = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int p_last = min(sq, (qt + 1) * kTileQ) - 1;
  int limit = len;
  if (causal) limit = min(limit, q_offset + p_last + 1);
  const int n_tiles = limit > 0 ? (limit + bk - 1) / bk : 0;
  const size_t kv_base = (static_cast<size_t>(b) * hk + h) * skv;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * bk;
    __syncthreads();  // the previous tile's readers are done with ks / vs / ps
    for (int idx = tid; idx < bk * kVecK; idx += kThreads) {
      const int j = idx / kVecK, c = idx % kVecK;
      const int pos = kv0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0);
      if (pos < len) kv = *reinterpret_cast<const uint4*>(k + (kv_base + pos) * DK + c * 8);
      *reinterpret_cast<uint4*>(ks + j * kRowK + c * 8) = kv;
    }
    for (int idx = tid; idx < bk * kVecV; idx += kThreads) {
      const int j = idx / kVecV, c = idx % kVecV;
      const int pos = kv0 + j;
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (pos < len) vv = *reinterpret_cast<const uint4*>(v + (kv_base + pos) * DV + c * 8);
      *reinterpret_cast<uint4*>(vs + j * kRowV + c * 8) = vv;
    }
    __syncthreads();
    // scores of the (row, key) pairs
    for (int pair = tid; pair < rows * bk; pair += kThreads) {
      const int r = pair / bk, j = pair % bk;
      const int p = qt * kTileQ + r % kTileQ;
      const int pos = kv0 + j;
      const bool valid = p < sq && pos < len && (!causal || q_offset + p >= pos);
      float s = kNegInf;
      if (valid) {
        const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(qs + r * DK);
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(ks + j * kRowK);
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < DK / 2; ++c) {
          const float2 qv = __bfloat1622float2(qr[c]);
          const float2 kv = __bfloat1622float2(kr[c]);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
        }
        s = dot * scale;
      }
      ps[pair] = s;
    }
    __syncthreads();
    // online softmax, one row per thread, keys in order
    for (int r = tid; r < rows; r += kThreads) {
      const int p = qt * kTileQ + r % kTileQ;
      const int hi = causal ? min(len, q_offset + p + 1) : len;  // valid keys: pos < hi
      const int n_valid = p < sq ? max(0, min(bk, hi - kv0)) : 0;
      float* pr = ps + r * bk;
      const float m_prev = ms[r];
      float mx = m_prev;
      for (int j = 0; j < n_valid; ++j) mx = fmaxf(mx, pr[j]);
      const float alpha = expf(m_prev - mx);
      float sum = 0.f;
      for (int j = 0; j < bk; ++j) {
        const float e = j < n_valid ? expf(pr[j] - mx) : 0.f;
        pr[j] = e;
        sum += e;
      }
      ls[r] = ls[r] * alpha + sum;
      ms[r] = mx;
      as[r] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + p v
    for (int idx = tid; idx < rows * DV; idx += kThreads) {
      const int r = idx / DV, dd = idx % DV;
      const float* pr = ps + r * bk;
      float pv = 0.f;
      for (int j = 0; j < bk; ++j) pv = fmaf(pr[j], __bfloat162float(vs[j * kRowV + dd]), pv);
      acc[idx] = acc[idx] * as[r] + pv;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * DV; idx += kThreads) {
    const int r = idx / DV, dd = idx % DV;
    const int gi = r / kTileQ, p = qt * kTileQ + r % kTileQ;
    if (p < sq) {
      const size_t off = ((static_cast<size_t>(b) * hq + h * g + gi) * sq + p) * DV + dd;
      out[off] = __float2bfloat16(acc[idx] / fmaxf(ls[r], 1e-30f));
    }
  }
}

template <int DK, int DV>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* kv_lens, __nv_bfloat16* out, int b, int hk, int g, int sq, int skv,
           int q_offset, int causal, int bk, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(g, DK, DV, bk);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTileQ - 1) / kTileQ, hk, b);
  flash_fwd_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_lens, out, hk, g, sq, skv, q_offset, causal, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs for G query heads per KV head, key dim dk,
// value dim dv and key tile bk.
extern "C" int flash_fwd_smem_bytes(int g, int dk, int dv, int bk) {
  return static_cast<int>(smem_bytes(g, dk, dv, bk));
}

// q (B, Hk*G, Sq, dk), k (B, Hk, Skv, dk), v (B, Hk, Skv, dv), out
// (B, Hk*G, Sq, dv): bf16, contiguous; kv_lens (B,) int32.  (dk, dv) is
// (d, d) for d a multiple of 16 up to 256, MLA's (192, 128), or its smoke
// variant's (24, 16).  Returns a cudaError_t (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kv_lens, void* out, int b, int hk, int g,
                                int sq, int skv, int dk, int dv, int q_offset, int causal,
                                int bk, float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* lens = static_cast<const int*>(kv_lens);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(DK, DV)                                                           \
  if (dk == DK && dv == DV)                                                              \
    return launch<DK, DV>(qb, kb, vb, lens, ob, b, hk, g, sq, skv, q_offset, causal, bk, \
                          scale, st);
  FLASH_FWD_CASE(16, 16) FLASH_FWD_CASE(32, 32) FLASH_FWD_CASE(48, 48) FLASH_FWD_CASE(64, 64)
  FLASH_FWD_CASE(80, 80) FLASH_FWD_CASE(96, 96) FLASH_FWD_CASE(112, 112)
  FLASH_FWD_CASE(128, 128) FLASH_FWD_CASE(144, 144) FLASH_FWD_CASE(160, 160)
  FLASH_FWD_CASE(176, 176) FLASH_FWD_CASE(192, 192) FLASH_FWD_CASE(208, 208)
  FLASH_FWD_CASE(224, 224) FLASH_FWD_CASE(240, 240) FLASH_FWD_CASE(256, 256)
  FLASH_FWD_CASE(192, 128) FLASH_FWD_CASE(24, 16)
#undef FLASH_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
