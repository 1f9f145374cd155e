// Hopper kernel for paged flash decode's MLA latent form (K2 with its q_pe
// score term).
//
// Replaces the has_pe branch of
// src/repro/kernels/flash_decode/kernel.py::paged_flash_decode_pallas (body
// _paged_decode_kernel), as flash_decode/ops.py::paged_latent_decode_attention
// calls it for DeepSeek-V2's absorbed-latent decode: one KV head (the latent
// pool is both the keys and the values), all H query heads grouped on it,
// d = kv_lora_rank r and a rope term of width dr.  Per (batch row b, query
// head h), over the row's first lengths[b] positions read through its page
// table:
//   s_j = (q_lat[b,h] . ckv[j] + q_pe[b,h] . kpe[j]) * scale,
// an online softmax over groups of pages_per_program pages, acc += p_j ckv[j],
// and out[b,h] = acc / max(l, 1e-30) rounded to bf16 (a row of length 0
// gives zeros), as flash_decode/ops.py::_block_update with qpe.
//
// Arithmetic: bf16 loads, float32 dot products (the latent term over r in
// order, then the rope term over dr in order, added, then scaled), float32
// online softmax.  Page-table entries outside [0, n_pages) are clamped, as
// the reference's gather clamps them.
//
// What bounds it on this card: the bytes.  A step reads each live row's
// latent rows once ((r + dr) * 2 bytes a position), and the operations,
// 2 H (2 r + dr) a position, are about as many FLOPs as bytes: far below
// the ridge of either the float32 or the tensor-core rate.  This kernel does
// not reach that bound: it runs its products on the CUDA cores in float32,
// and every head group reads the row's pool again (from L2, which holds a
// 1088-position row's 1.25 MB many times over).
//
// Design: the grouped-query block body of K2's GQA form (decode_tile.cuh)
// holds all G heads of a KV head and a float32 accumulator in shared memory,
// which at G 128 and d 512 needs about 676 KB, against the 227 KB a block may
// use.  So the heads split over a grid axis: grid = (ceil(H / 8), B), 256
// threads, 8 heads a block.  Per group of ppp pages: the block stages one
// tile of the latent rows and one of the rope rows in shared memory (the
// latent tile serves both the scores and the p . V sum), scores the tile by
// (position, pair of heads), runs the softmax with one warp a head, then
// sums p . V with each thread owning one column pair of the latent for all
// 8 heads, its accumulators in registers.  Groups past the row's length are
// skipped.  The Pallas grid's sequential page-group axis becomes the block's
// loop over tiles.  The kernel launches on the caller's stream, allocates
// nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8;          // query heads a block
constexpr int kHeadsPerScore = 2;  // heads one thread scores against a position
constexpr int kPad = 8;            // bf16 padding per staged row
constexpr float kNegInf = -1e30f;

// Shared memory one block needs at latent width r, rope width dr and tiles
// of bk = pages_per_program * page positions.
__host__ __device__ inline size_t smem_bytes(int r, int dr, int bk) {
  return static_cast<size_t>(kHeads) * (r + dr) * 4     // q_lat and q_pe (float32)
         + static_cast<size_t>(bk) * (r + kPad) * 2     // latent tile (bf16)
         + static_cast<size_t>(bk) * (dr + kPad) * 2    // rope tile (bf16)
         + static_cast<size_t>(kHeads) * bk * 4         // scores / p
         + 3 * static_cast<size_t>(kHeads) * 4;         // m, l, alpha
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

// Stage positions [start, start + bk) of one row's pool of width W (rows of
// W bf16 values a position, page-major (n_pages, page, W)) into rows of
// W + kPad in shared memory; positions at or past n_valid are zero-filled.
template <int W>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ pool,
                                      __nv_bfloat16* tile, const int* table, int start,
                                      int n_valid, int bk, int page, int n_pages) {
  constexpr int kVec = W / 8;
  for (int idx = threadIdx.x; idx < bk * kVec; idx += kThreads) {
    const int j = idx / kVec, c = idx % kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (j < n_valid) {
      const int pos = start + j;
      int pid = table[pos / page];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      val = *reinterpret_cast<const uint4*>(
          pool + (static_cast<size_t>(pid) * page + pos % page) * W + c * 8);
    }
    *reinterpret_cast<uint4*>(tile + j * (W + kPad) + c * 8) = val;
  }
}

// dot[hh] += q[hh] . row over W values in order, for kHeadsPerScore heads
// whose float32 queries start at q with a stride of W.
template <int W>
__device__ __forceinline__ void dot_row(const float* q, const __nv_bfloat16* row, float* dot) {
#pragma unroll 4
  for (int c = 0; c < W / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + c * 8);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float kf[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pairs[e]);
      kf[2 * e] = f.x;
      kf[2 * e + 1] = f.y;
    }
#pragma unroll
    for (int hh = 0; hh < kHeadsPerScore; ++hh) {
      const float* qr = q + hh * W + c * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) dot[hh] = fmaf(qr[e], kf[e], dot[hh]);
    }
  }
}

template <int R, int DR>
__global__ void __launch_bounds__(kThreads)
paged_latent_decode_kernel(const __nv_bfloat16* __restrict__ q_lat,
                           const __nv_bfloat16* __restrict__ q_pe,
                           const __nv_bfloat16* __restrict__ ckv,
                           const __nv_bfloat16* __restrict__ kpe,
                           const int* __restrict__ lengths, const int* __restrict__ page_tables,
                           __nv_bfloat16* __restrict__ out, int h_total, int n_pages, int page,
                           int npp, int bk, float scale) {
  static_assert(R % 8 == 0 && DR % 8 == 0, "16-byte rows");
  constexpr int kRowC = R + kPad, kRowP = DR + kPad;
  constexpr int kPairs = R / 2;  // column pairs of the latent
  static_assert(kPairs <= kThreads && kThreads % kPairs == 0, "column pairs tile the block");
  constexpr int kSlices = kThreads / kPairs;                   // head slices in p . V
  constexpr int kHeadsPV = (kHeads + kSlices - 1) / kSlices;  // heads a thread sums there
  const int h0 = blockIdx.x * kHeads;
  const int b = blockIdx.y;
  const int gh = min(kHeads, h_total - h0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);    // (kHeads, R)
  float* qps = qs + kHeads * R;                   // (kHeads, DR)
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(qps + kHeads * DR);  // (bk, kRowC)
  __nv_bfloat16* kps = cs + bk * kRowC;           // (bk, kRowP)
  float* ps = reinterpret_cast<float*>(kps + bk * kRowP);  // (kHeads, bk)
  float* ms = ps + kHeads * bk;
  float* ls = ms + kHeads;
  float* as = ls + kHeads;

  const size_t row0 = static_cast<size_t>(b) * h_total + h0;  // (b, h0) in (B, H)
  for (int idx = tid; idx < kHeads * R; idx += kThreads)
    qs[idx] = idx / R < gh ? __bfloat162float(q_lat[row0 * R + idx]) : 0.f;
  for (int idx = tid; idx < kHeads * DR; idx += kThreads)
    qps[idx] = idx / DR < gh ? __bfloat162float(q_pe[row0 * DR + idx]) : 0.f;
  for (int hh = tid; hh < kHeads; hh += kThreads) {
    ms[hh] = kNegInf;
    ls[hh] = 0.f;
  }

  int len = lengths[b];
  len = len < 0 ? 0 : (len > npp * page ? npp * page : len);
  const int* table = page_tables + static_cast<size_t>(b) * npp;

  // this thread's column pair of the latent, for heads slice + i * kSlices
  const int cp = tid % kPairs, slice = tid / kPairs;
  float acc[kHeadsPV][2];
#pragma unroll
  for (int i = 0; i < kHeadsPV; ++i) acc[i][0] = acc[i][1] = 0.f;

  const int n_tiles = (len + bk - 1) / bk;
  for (int t = 0; t < n_tiles; ++t) {
    const int start = t * bk;
    const int n_valid = min(bk, len - start);
    __syncthreads();  // the previous tile's readers are done with cs / kps / ps
    stage<R>(ckv, cs, table, start, n_valid, bk, page, n_pages);
    stage<DR>(kpe, kps, table, start, n_valid, bk, page, n_pages);
    __syncthreads();
    // scores by (position, pair of heads): a warp's lanes take consecutive
    // positions, so the queries they read are one broadcast
    for (int idx = tid; idx < bk * (kHeads / kHeadsPerScore); idx += kThreads) {
      const int j = idx % bk, ha = (idx / bk) * kHeadsPerScore;
      float dot[kHeadsPerScore] = {}, dpe[kHeadsPerScore] = {};
      if (j < n_valid) {
        dot_row<R>(qs + ha * R, cs + j * kRowC, dot);
        dot_row<DR>(qps + ha * DR, kps + j * kRowP, dpe);
      }
#pragma unroll
      for (int hh = 0; hh < kHeadsPerScore; ++hh)
        ps[(ha + hh) * bk + j] = j < n_valid ? (dot[hh] + dpe[hh]) * scale : kNegInf;
    }
    __syncthreads();
    for (int hh = warp; hh < kHeads; hh += kWarps) {  // one warp a head
      float* pr = ps + hh * bk;
      const float m_prev = ms[hh];
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
        ls[hh] = ls[hh] * alpha + sum;
        ms[hh] = mx;
        as[hh] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p . V, V the latent tile the scores read
    float pv[kHeadsPV][2];
#pragma unroll
    for (int i = 0; i < kHeadsPV; ++i) pv[i][0] = pv[i][1] = 0.f;
    for (int j = 0; j < n_valid; ++j) {
      const float2 v =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cs + j * kRowC + 2 * cp));
#pragma unroll
      for (int i = 0; i < kHeadsPV; ++i) {
        const int hh = slice + i * kSlices;
        if (hh < kHeads) {
          const float p = ps[hh * bk + j];
          pv[i][0] = fmaf(p, v.x, pv[i][0]);
          pv[i][1] = fmaf(p, v.y, pv[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kHeadsPV; ++i) {
      const int hh = slice + i * kSlices;
      if (hh < kHeads) {
        const float alpha = as[hh];
        acc[i][0] = acc[i][0] * alpha + pv[i][0];
        acc[i][1] = acc[i][1] * alpha + pv[i][1];
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kHeadsPV; ++i) {
    const int hh = slice + i * kSlices;
    if (hh < gh) {
      const float l = fmaxf(ls[hh], 1e-30f);
      __nv_bfloat16* o = out + (row0 + hh) * R + 2 * cp;
      o[0] = __float2bfloat16(acc[i][0] / l);
      o[1] = __float2bfloat16(acc[i][1] / l);
    }
  }
}

template <int R, int DR>
int launch(const __nv_bfloat16* q_lat, const __nv_bfloat16* q_pe, const __nv_bfloat16* ckv,
           const __nv_bfloat16* kpe, const int* lengths, const int* page_tables,
           __nv_bfloat16* out, int b, int h, int n_pages, int page, int npp, int ppp,
           float scale, cudaStream_t stream) {
  const int bk = ppp * page;
  const size_t smem = smem_bytes(R, DR, bk);
  cudaError_t err = cudaFuncSetAttribute(paged_latent_decode_kernel<R, DR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kHeads - 1) / kHeads, b);
  paged_latent_decode_kernel<R, DR><<<grid, kThreads, smem, stream>>>(
      q_lat, q_pe, ckv, kpe, lengths, page_tables, out, h, n_pages, page, npp, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs at latent width r, rope width dr and a group
// of blk = pages_per_program * page positions.
extern "C" int paged_latent_decode_smem_bytes(int r, int dr, int blk) {
  return static_cast<int>(smem_bytes(r, dr, blk));
}

// q_lat (B, H, r) and out (B, H, r) bf16; q_pe (B, H, dr) bf16; ckv_pages
// (n_pages, page, r) and kpe_pages (n_pages, page, dr) bf16; lengths (B,)
// int32; page_tables (B, npp) int32; all contiguous.  (r, dr) is
// DeepSeek-V2's (512, 64) or its smoke variant's (16, 8).  Returns a
// cudaError_t (0 on success).
extern "C" int paged_latent_decode_launch(const void* q_lat, const void* q_pe,
                                          const void* ckv_pages, const void* kpe_pages,
                                          const void* lengths, const void* page_tables,
                                          void* out, int b, int h, int r, int dr, int n_pages,
                                          int page, int npp, int ppp, float scale,
                                          void* stream) {
  const auto* q = static_cast<const __nv_bfloat16*>(q_lat);
  const auto* qp = static_cast<const __nv_bfloat16*>(q_pe);
  const auto* c = static_cast<const __nv_bfloat16*>(ckv_pages);
  const auto* k = static_cast<const __nv_bfloat16*>(kpe_pages);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* pt = static_cast<const int*>(page_tables);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (r == 512 && dr == 64)
    return launch<512, 64>(q, qp, c, k, lens, pt, o, b, h, n_pages, page, npp, ppp, scale, st);
  if (r == 16 && dr == 8)
    return launch<16, 8>(q, qp, c, k, lens, pt, o, b, h, n_pages, page, npp, ppp, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_latent_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
