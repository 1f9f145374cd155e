// Hopper kernels for the backward of the blocked causal flash attention
// (K3-bwd): dq, dk and dv from the forward's saved log-sum-exp.
//
// Replaces the reference's flash backward, the jax.custom_vjp rule
// src/repro/kernels/flash_attention/ops.py::_flash_bwd (:118), which the
// models' attention gradient runs through on every training step; no Pallas
// kernel holds it.  The same function: for each query row, p = exp(s - lse)
// over the keys the row sees (key < kv_len and, causal, key <= q_offset +
// row), delta = rowsum(dO * O), ds = p (dO V^T - delta); dq = ds K scale,
// dv = sum p^T dO and dk = sum ds^T Q scale, each KV head's sums taken over
// its G query heads (GQA).  Key dim DK (q, k, dq, dk) and value dim DV (v,
// out, dO, dv): equal dims, multiples of 16 up to 128; MLA's (192, 128);
// its smoke variant's (24, 16).
//
// What bounds it on this card: at long sequences the operations.  A causal
// backward does 3 (dq pass: 2 DK, 2 DV, 2 DK FLOPs) and 4 (key side: 2 DK,
// 2 DV, 2 DV, 2 DK) products for each pair a row sees, far above the bf16
// ridge; at MLA's training shape (S 128) the bytes.  The hi/lo split of p
// and ds (below) doubles 1 of the dq pass's 3 products and 2 of the key
// side's 4, so against the plain count the passes cannot pass 3/4 and 2/3
// of the tensor-core peak.
//
// Kernels, launched in order on the caller's stream, each a block of one
// warpgroup (128 threads) that owns 64 rows:
//   * the dq pass: grid (Hq, ceil(Sq / 64), B), the longest causal rows
//     first.  A block computes delta for its 64 query rows (eight lanes a
//     row, 16-byte loads, the lanes' sums in order then a fixed butterfly)
//     while TMA stages its Q and dO, then walks the key tiles of 64
//     positions its rows see: S = Q K^T and dP = dO V^T (wgmma, both
//     operands in shared memory), ds, and dq += ds K (wgmma, ds from
//     registers, K read MN-major);
//   * the key side: grid (split, Hk * B, ceil(Skv / 64)), the earliest keys
//     (the most rows) first.  The walk of key tile j over the G query heads
//     of its KV head and the query tiles that see it, G x n_j steps in
//     (head, tile) order, is cut into `split` chunks of ceil(G n_j / split)
//     steps, one a block; the split blocks of a key tile form a thread-block
//     cluster.  Where dk's and dv's accumulators fit the register file as at
//     D 128 (64 DK-columns' panels plus DV's, at most 256 columns: every
//     equal pair and (24, 16)) it is one launch, the dk/dv pass (pass 1).
//     Per step: S^T = K Q^T and dP^T = V dO^T (shared-shared wgmma); p^T
//     once S^T has landed, while dP^T runs; dv += P^T dO issued before ds^T
//     is computed, so that ds^T's arithmetic runs beside dv's products; then
//     dk += dS^T Q (P^T and dS^T from registers, dO and Q read MN-major).
//     At (192, 128) dk and dv alone would take 160 registers a thread, so
//     the key side is two launches of the same walk, each within the
//     register file: the dv pass (pass 2: S^T, p^T, dv += P^T dO; no V, dP
//     or delta) and the dk pass (pass 3: S^T, dP^T, ds^T, dk += dS^T Q).
//     An uncut walk writes its gradient from the registers; a cut one's
//     float32 partials meet in shared memory and block r of the cluster sums
//     rows [64 r / split, 64 (r + 1) / split) over ranks 0, 1, .. in order
//     (distributed shared memory).  `split` is the smallest of 1, 2, 4, 8
//     whose longest chunk is no longer than the mean load of a slot (the
//     work over 264 slots, 132 SMs x 2 blocks), stopping before chunks fall
//     under 4 steps: a function of the shapes alone (flash_bwd_plan; ops.py's
//     bwd_plan mirrors it).  At qwen3-14b's training shape (40 over 8 heads,
//     S 2048) it is 2: the longest block walks 80 steps, not 160.
// Every sum runs in an order fixed by the shapes: key tiles in order for
// dq; each chunk's steps in order, then the chunks in rank order, for dk
// and dv; each product's k-steps in order.  No atomics: two runs give the
// same bits.
//
// No producer warp: a warpgroup and its twin block already take the
// register file (the dk/dv pass's dk and dv accumulators, 128 registers a
// thread at D 128, with S^T, dP^T and the hi/lo fragments: 244), so there
// are no registers for setmaxnreg to move; one thread of the warpgroup
// issues the next stage's copies (a handful of instructions) at the top of
// each step, and the SM's other block fills the tensor cores while this one
// waits or computes p and ds.  At (192, 128) the dq pass and the dk pass
// stage Q and K 192 wide (three panels): one block an SM; the dv pass, with
// no V, two.
//
// Arithmetic.  The products run on the tensor cores (wgmma, bf16 operands,
// float32 accumulation; a product of two bf16 values is exact in float32).
// p and ds are float32 values the reference multiplies at float32
// precision; a single bf16 copy would err by 2^-9 of each, so each is split
// into two bf16 values, hi = bf16(x) and lo = bf16(x - hi), and both
// products go into the float32 accumulator (hi + lo within about 2^-17 of
// x).  p = 2^(s scale log2(e) - lse log2(e)) by ex2.approx; the masks
// select p and ds to 0, so a masked position contributes exactly nothing
// whatever its inputs.  dq and dk are scaled once at the end; all three are
// written in bf16.
//
// Staging.  TMA copies 64-row tiles through 3-D tensor maps (D, S, B x H)
// into 128-byte-swizzled panels of 64 columns (csrc/hopper.cuh); rows past
// Sq or Skv and columns past D arrive as zeros (DK 24's products run two
// k-steps of 16, the second half zeros).  The fill knows nothing of
// kv_len: in the dq pass, K's rows at or past kv_len in the tile that
// straddles it would meet ds = 0 in ds K, and 0 x NaN is NaN on the tensor
// cores, so those rows are zeroed after the tile lands.  The streamed
// operands (K and V in the dq pass; Q and dO on the key side) go through a
// ring of two stages on mbarriers, one thread issuing the next tile's copies
// while the block computes the current one; the key side's rows' lse and
// delta follow in a ring of their own, a plain load a thread, issued a step
// ahead (not TMA: a 1-D map's box that starts off a 16-byte boundary, as a
// head's rows do when Sq is not a multiple of 4, never completed on the
// card).  Fully masked tiles are not visited.  The kernels allocate
// nothing and do not synchronise.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // query rows or key positions a tile
constexpr int kStages = 2;
constexpr int kPanelBytes = kTile * 128;  // 64 rows of 64 bf16 columns
constexpr float kLog2e = 1.44269504088896340736f;
// The key side's cut (ops.py: BWD_SLOTS, BWD_MAX_SPLIT, BWD_MIN_CHUNK)
constexpr int kSlots = 264;  // 132 SMs x 2 blocks
constexpr int kMaxSplit = 8;
constexpr int kMinChunk = 4;
// Error codes past the runtime's: a failed tensor-map encode (+ its CUresult)
constexpr int kErrEncode = 10000;
// The key side's launches (ops.py: BWD_PASSES): dk and dv in one walk, or
// dv and dk in two
constexpr int kPassDq = 0, kPassDkdv = 1, kPassDv = 2, kPassDk = 3;

template <int D>
constexpr int kPanels = (D + 63) / 64;
template <int D>
constexpr int kDP = 64 * kPanels<D>;  // columns the products run over
template <int D>
constexpr int kKSteps = (D + 15) / 16;  // k-steps of 16 columns over D
template <int D>
constexpr int kTileBytes = kPanels<D> * kPanelBytes;
template <int D>
constexpr int kPartLd = kDP<D> + 8;  // row stride of the float32 partials
// The key side in one launch where dk's and dv's accumulators fit as at D 128
template <int DK, int DV>
constexpr bool kFusedKeys = kDP<DK> + kDP<DV> <= 256;

// dq pass: [0, 1024) the barriers and delta; then Q, dO, two stages of K, of V
constexpr int kDqTiles = 1024;
template <int DK, int DV>
constexpr size_t dq_smem_bytes =
    1024 + kDqTiles + 3 * static_cast<size_t>(kTileBytes<DK> + kTileBytes<DV>);
// key side: [0, 2048) the barriers, the rows' lse and delta stages; then K,
// V (not in the dv pass), two stages of Q, of dO; the partials over the
// stages and past them
constexpr int kKeyTiles = 2048;
template <int D>
constexpr size_t kPartBytes = kTile * static_cast<size_t>(kPartLd<D>) * 4;  // one gradient's
template <int DK, int DV, int PASS>
constexpr size_t key_part_bytes =
    (PASS != kPassDv ? kPartBytes<DK> : 0) + (PASS != kPassDk ? kPartBytes<DV> : 0);
template <int DK, int DV>
constexpr size_t key_stage_bytes = 2 * static_cast<size_t>(kTileBytes<DK> + kTileBytes<DV>);
template <int DK, int DV, int PASS>
constexpr size_t key_smem_bytes =
    1024 + kKeyTiles + kTileBytes<DK> + (PASS != kPassDv ? kTileBytes<DV> : 0) +
    (key_part_bytes<DK, DV, PASS> > key_stage_bytes<DK, DV> ? key_part_bytes<DK, DV, PASS>
                                                             : key_stage_bytes<DK, DV>);

// ---------------------------------------------------------------- the plan

// Query tiles of 64 rows that see key tile j (causal: from the first row
// that sees its first key); 0 when no row does.
__host__ __device__ inline int tiles_seeing(int j, int nq, int sq, int q_offset, int causal) {
  if (!causal) return nq;
  const int first = j * kTile - q_offset;  // the first row that sees key j * 64
  if (first >= sq) return 0;
  return nq - (first > 0 ? first : 0) / kTile;
}

// The key side's split (see the head of this file).
inline int dkdv_split(int b, int hk, int g, int sq, int skv, int q_offset, int causal) {
  const int nq = (sq + kTile - 1) / kTile, nk = (skv + kTile - 1) / kTile;
  long long total = 0;
  int longest = 0;
  for (int j = 0; j < nk; ++j) {
    const int w = g * tiles_seeing(j, nq, sq, q_offset, causal);
    total += w;
    longest = w > longest ? w : longest;
  }
  total *= static_cast<long long>(hk) * b;
  int split = 1;
  while (split < kMaxSplit &&
         static_cast<long long>((longest + split - 1) / split) * kSlots > total &&
         (longest + 2 * split - 1) / (2 * split) >= kMinChunk)
    split *= 2;
  return split;
}

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 64-row tile (rows row .. row + 63 of plane `plane`) into its panels at dst.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row, int plane) {
#pragma unroll
  for (int p = 0; p < kPanels<D>; ++p)
    hopper::tma_load_3d(dst + p * kPanelBytes, map, bar, 64 * p, row, plane);
}

// Descriptor of k-step kk (columns 16 kk ..) of a tile read K-major.
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kPanelBytes + (kk % 4) * 32, 16, 1024);
}
// Descriptor of k-step c (rows 16 c ..) of a tile read MN-major.
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int c) {
  return desc_sw128(tile + c * 2048, kPanelBytes, 1024);
}

// acc (64 x 64) = A B^T over D in k-steps of 16, in order; a and b 64-row
// tiles read K-major.  The caller fences, commits and waits.
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < kKSteps<D>; ++kk)
    hopper::wgmma_ss_n64(acc, kmajor_desc(a, kk), kmajor_desc(b, kk), kk > 0);
}

// The A fragments of columns 16c .. 16c + 15 of a 64 x 64 float32 tile x
// held in wgmma's accumulator layout (thread t of warp w: rows 16w + t/4 and
// + 8, columns 8j + 2(t%4) and + 1 in registers 4j .. 4j + 3), as bf16
// pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_fragments(const float (&x)[32], int c, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int r = 4 * (2 * c + f / 2) + 2 * (f % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[r], x[r + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x[r] - hf.x, x[r + 1] - hf.y);
    hi[f] = *reinterpret_cast<const uint32_t*>(&h);
    lo[f] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc (64 x DP) += X B, X (64 x 64) as its hi and lo fragments, B the 64
// rows of a tile read MN-major: for each k-step of 16 in order, hi then lo.
template <int D>
__device__ __forceinline__ void product_split(float (&acc)[kDP<D> / 2],
                                              const uint32_t (&hi)[4][4],
                                              const uint32_t (&lo)[4][4],
                                              const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t db = mnmajor_desc(b, c);
    hopper::wgmma_rs_t<kDP<D>>(acc, hi[c], db);
    hopper::wgmma_rs_t<kDP<D>>(acc, lo[c], db);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------- dq pass

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ kv_lens,
                    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int hk, int g, int sq, int skv,
                    int q_offset, int causal, float scale) {
  constexpr int TK = kTileBytes<DK>, TV = kTileBytes<DV>, DP = kDP<DK>;
  const int head = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // the longest causal rows first
  const int b = blockIdx.z;
  const int hq = hk * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // 0: Q and dO; 1 + s: stage s
  float* dl_s = reinterpret_cast<float*>(smem + 256);
  unsigned char* qs = smem + kDqTiles;
  unsigned char* dos = qs + TK;
  unsigned char* ks = dos + TV;           // stage s at ks + s * TK
  unsigned char* vs = ks + kStages * TK;  // stage s at vs + s * TV

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int q0 = qt * kTile;
  const int limit = causal ? min(len, q_offset + min(sq, q0 + kTile)) : len;
  const int n_tiles = limit > 0 ? (limit + kTile - 1) / kTile : 0;
  const int bh = b * hq + head, kv_bh = b * hk + head / g;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], TK + TV);
    load_tile<DK>(qs, &tm_q, &bars[0], q0, bh);
    load_tile<DV>(dos, &tm_do, &bars[0], q0, bh);
    if (n_tiles > 0) {
      mbar_expect_tx(&bars[1], TK + TV);
      load_tile<DK>(ks, &tm_k, &bars[1], 0, kv_bh);
      load_tile<DV>(vs, &tm_v, &bars[1], 0, kv_bh);
    }
  }

  // delta = rowsum(dO * O) for the block's rows while the copies fly: a warp
  // takes 16 rows, four at a time, eight lanes a row over its 16-byte
  // chunks in order, then a butterfly over the eight lanes (the same sum in
  // each); written for every row, since the key side reads it
  {
    const int sub = lane / 8, part = lane % 8;
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int r = 16 * warp + 4 * step + sub, row = q0 + r;
      float acc = 0.f;
      if (row < sq) {
        const size_t at = (static_cast<size_t>(bh) * sq + row) * DV;
        const uint4* o_row = reinterpret_cast<const uint4*>(out + at);
        const uint4* do_row = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
        for (int c = part; c < DV / 8; c += 8) {
          const uint4 o8 = o_row[c], d8 = do_row[c];
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o8);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d8);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(o2[e]), y = __bfloat1622float2(d2[e]);
            acc = fmaf(y.x, x.x, acc);
            acc = fmaf(y.y, x.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (part == 0) {
        dl_s[r] = acc;
        if (row < sq) delta[static_cast<size_t>(bh) * sq + row] = acc;
      }
    }
  }

  const int r_loc[2] = {16 * warp + lane / 4, 16 * warp + lane / 4 + 8};
  float ls[2], dl[2];
  int hi[2];  // the row sees keys [0, hi)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_loc[i];
    ls[i] = row < sq ? lse[static_cast<size_t>(bh) * sq + row] * kLog2e : 0.f;
    hi[i] = row < sq ? (causal ? min(len, q_offset + row + 1) : len) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) dl[i] = dl_s[r_loc[i]];
  const float scale_log2 = scale * kLog2e;
  const int col = 2 * (lane % 4);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    if (tid == 0 && t + 1 < n_tiles) {  // the next tile's copies, in flight during this one
      const int st1 = (t + 1) % kStages;
      mbar_expect_tx(&bars[1 + st1], TK + TV);
      load_tile<DK>(ks + st1 * TK, &tm_k, &bars[1 + st1], (t + 1) * kTile, kv_bh);
      load_tile<DV>(vs + st1 * TV, &tm_v, &bars[1 + st1], (t + 1) * kTile, kv_bh);
    }
    mbar_wait(&bars[1 + st], (t / kStages) & 1);
    const int kv0 = t * kTile;
    unsigned char* kt = ks + st * TK;
    const unsigned char* vt = vs + st * TV;
    if (kv0 + kTile > len) {  // K's rows at or past kv_len, which the fill does not zero
      const int from = len - kv0, n_chunks = (kTile - from) * 8;
      for (int idx = tid; idx < kPanels<DK> * n_chunks; idx += kThreads) {
        const int p = idx / n_chunks, rest = idx % n_chunks;
        reinterpret_cast<uint4*>(kt + p * kPanelBytes + (from + rest / 8) * 128)[rest % 8] =
            make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_proxy_async();
      __syncthreads();
    }
    float s[32] = {}, dp[32] = {};
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    product_nt<DK>(s, qs, kt);
    product_nt<DV>(dp, dos, vt);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, key = kv0 + 8 * j + col + e % 2;
        const bool valid = key < hi[i];
        const float p = valid ? ex2(s[4 * j + e] * scale_log2 - ls[i]) : 0.f;
        s[4 * j + e] = valid ? p * (dp[4 * j + e] - dl[i]) : 0.f;  // s becomes ds
      }
    uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) split_fragments(s, c, ds_hi[c], ds_lo[c]);
    fence_regs(acc);
    wgmma_fence();
    product_split<DK>(acc, ds_hi, ds_lo, kt);
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    __syncthreads();  // every thread is done with stage st before it is loaded again
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_loc[i];
    if (row >= sq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(dq + (static_cast<size_t>(bh) * sq + row) * DK);
#pragma unroll
    for (int j = 0; j < DK / 8; ++j)
      dst[(8 * j + col) / 2] = bf16x2(acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------- key side

// Rows [r0, r0 + rows) x 8 columns from c8 of the cluster's partials, summed
// over ranks 0 .. split - 1 in order, into out.
__device__ __forceinline__ void sum_ranks(cg::cluster_group& cluster, float* part, int ld, int r,
                                          int c8, int split, float (&out)[8]) {
  for (int c = 0; c < split; ++c) {
    const float* pk = cluster.map_shared_rank(part, c) + r * ld + 8 * c8;
    const float4 lo = reinterpret_cast<const float4*>(pk)[0];
    const float4 hi = reinterpret_cast<const float4*>(pk)[1];
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = c == 0 ? x[e] : out[e] + x[e];
  }
}

// The key side's kernel: PASS kPassDkdv computes dk and dv, kPassDv dv
// alone, kPassDk dk alone (see the head of this file).
template <int DK, int DV, int PASS>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_key_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int* __restrict__ kv_lens, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int hk, int g, int sq, int skv,
                     int q_offset, int causal, float scale) {
  constexpr bool kDk = PASS != kPassDv, kDv = PASS != kPassDk;
  constexpr int TK = kTileBytes<DK>, TV = kTileBytes<DV>;
  constexpr int DPK = kDP<DK>, DPV = kDP<DV>, LDK = kPartLd<DK>, LDV = kPartLd<DV>;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.x, rank = static_cast<int>(cluster.block_rank());
  const int kvh = blockIdx.y % hk, b = blockIdx.y / hk;
  const int kt = blockIdx.z;  // the earliest keys, which the most rows see, first
  const int hq = hk * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // 0: K and V; 1 + s: stage s
  // stage s: the rows' lse (log2 units) at rows_s + 2 s kTile, delta after it
  float* rows_s = reinterpret_cast<float*>(smem + 256);
  unsigned char* ks = smem + kKeyTiles;
  unsigned char* vs = ks + TK;
  unsigned char* qs = vs + (kDk ? TV : 0);  // stage s at qs + s * TK
  unsigned char* dos = qs + kStages * TK;   // stage s at dos + s * TV
  float* part_dk = reinterpret_cast<float*>(qs);  // after the walk: 64 x LDK
  float* part_dv = part_dk + (kDk ? kTile * LDK : 0);  // 64 x LDV

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int k0 = kt * kTile;
  const int nq = (sq + kTile - 1) / kTile;
  const int per_head = tiles_seeing(kt, nq, sq, q_offset, causal);
  const int qt0 = nq - per_head;
  // this block's chunk of the walk: steps [it0, it0 + n_iters) of the
  // G x per_head steps, step i at query head kvh * g + i / per_head and
  // query tile qt0 + i % per_head; none when every key is at or past kv_len
  const int work = g * per_head, span = (work + split - 1) / split;
  const int it0 = min(work, rank * span);
  const int n_iters = k0 < len ? min(work, it0 + span) - it0 : 0;
  const size_t kv_plane = static_cast<size_t>(b) * hk + kvh;

  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const CUtensorMap *map_q = &tm_q, *map_do = &tm_do;
  auto issue = [&](int local, int st) {  // one thread: step it0 + local into stage st
    const int i = it0 + local;
    const int bh = b * hq + kvh * g + i / per_head, q0 = (qt0 + i % per_head) * kTile;
    mbar_expect_tx(&bars[1 + st], TK + TV);
    load_tile<DK>(qs + st * TK, map_q, &bars[1 + st], q0, bh);
    load_tile<DV>(dos + st * TV, map_do, &bars[1 + st], q0, bh);
  };
  // step it0 + local's lse (log2 units, threads 0-63) or delta (64-127; the
  // dv pass needs none) of row tid % 64, a plain load each thread, in
  // flight during the step before
  auto fetch = [&](int local) -> float {
    const int i = it0 + local;
    const int bh = b * hq + kvh * g + i / per_head, row = (qt0 + i % per_head) * kTile + tid % 64;
    if (row >= sq || (!kDk && tid >= 64)) return 0.f;
    const size_t at = static_cast<size_t>(bh) * sq + row;
    return tid < 64 ? lse[at] * kLog2e : delta[at];
  };
  if (tid == 0 && n_iters > 0) {
    mbar_expect_tx(&bars[0], TK + (kDk ? TV : 0));
    load_tile<DK>(ks, &tm_k, &bars[0], k0, static_cast<int>(kv_plane));
    if (kDk) load_tile<DV>(vs, &tm_v, &bars[0], k0, static_cast<int>(kv_plane));
    issue(0, 0);
  }
  if (n_iters > 0) {
    rows_s[tid] = fetch(0);
    __syncthreads();
  }

  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + 16 * warp + lane / 4 + 8 * i;
  const float scale_log2 = scale * kLog2e;
  const int col = 2 * (lane % 4);

  float acc_dk[DPK / 2], acc_dv[DPV / 2];
#pragma unroll
  for (int i = 0; i < DPK / 2; ++i) acc_dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DPV / 2; ++i) acc_dv[i] = 0.f;

  for (int local = 0; local < n_iters; ++local) {
    const int st = local % kStages;
    if (tid == 0 && local + 1 < n_iters) issue(local + 1, (local + 1) % kStages);
    const float next_row = local + 1 < n_iters ? fetch(local + 1) : 0.f;
    if (local == 0) mbar_wait(&bars[0], 0);
    mbar_wait(&bars[1 + st], (local / kStages) & 1);
    const int q0 = (qt0 + (it0 + local) % per_head) * kTile;
    const unsigned char* qt = qs + st * TK;
    const unsigned char* dot = dos + st * TV;
    const float* ls = rows_s + 2 * kTile * st;
    const float* dl = ls + kTile;
    float s[32] = {}, dp[32] = {};
    fence_regs(s);
    if constexpr (kDk) fence_regs(dp);
    wgmma_fence();
    product_nt<DK>(s, ks, qt);  // S^T: the block's keys x the tile's rows
    wgmma_commit();
    if constexpr (kDk) {
      product_nt<DV>(dp, vs, dot);  // dP^T
      wgmma_commit();
      wgmma_wait<1>();  // S^T has landed: p^T while dP^T runs
    } else {
      wgmma_wait();
    }
    fence_regs(s);
    uint32_t live = 0;  // bit 4j + e: the pair of register 4j + e is seen
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, c = 8 * j + col + e % 2, row = q0 + c;
        const bool valid = key[i] < len && row < sq && (!causal || key[i] <= q_offset + row);
        live |= static_cast<uint32_t>(valid) << (4 * j + e);
        s[4 * j + e] = valid ? ex2(s[4 * j + e] * scale_log2 - ls[c]) : 0.f;  // s becomes p^T
      }
    if constexpr (kDv) {
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) split_fragments(s, c, p_hi[c], p_lo[c]);
      fence_regs(acc_dv);
      wgmma_fence();
      product_split<DV>(acc_dv, p_hi, p_lo, dot);
      wgmma_commit();
    }
    if constexpr (kDk) {
      if constexpr (kDv) wgmma_wait<1>();  // dP^T has landed: ds^T while dv's products run
      else wgmma_wait();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // dp becomes ds^T
          const float dl_c = dl[8 * j + col + e % 2];
          dp[4 * j + e] = live >> (4 * j + e) & 1u ? s[4 * j + e] * (dp[4 * j + e] - dl_c) : 0.f;
        }
      uint32_t ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) split_fragments(dp, c, ds_hi[c], ds_lo[c]);
      fence_regs(acc_dk);
      wgmma_fence();
      product_split<DK>(acc_dk, ds_hi, ds_lo, qt);
      wgmma_commit();
    }
    wgmma_wait();
    if constexpr (kDv) fence_regs(acc_dv);
    if constexpr (kDk) fence_regs(acc_dk);
    rows_s[2 * kTile * ((local + 1) % kStages) + tid] = next_row;  // read in the step before
    __syncthreads();  // every thread is done with stage st before it is loaded again
  }

  if (split == 1) {  // the whole walk: straight from the registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= skv) continue;
      if constexpr (kDk) {
        uint32_t* dk_row = reinterpret_cast<uint32_t*>(dk + (kv_plane * skv + key[i]) * DK);
#pragma unroll
        for (int j = 0; j < DK / 8; ++j)
          dk_row[(8 * j + col) / 2] =
              bf16x2(acc_dk[4 * j + 2 * i] * scale, acc_dk[4 * j + 2 * i + 1] * scale);
      }
      if constexpr (kDv) {
        uint32_t* dv_row = reinterpret_cast<uint32_t*>(dv + (kv_plane * skv + key[i]) * DV);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j)
          dv_row[(8 * j + col) / 2] = bf16x2(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
    }
    return;
  }
  // the chunk's partials into shared memory (over the Q and dO stages, all
  // landed and read), then the cluster's sum, rank by rank in order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * i;
    if constexpr (kDk) {
#pragma unroll
      for (int j = 0; j < DPK / 8; ++j)
        *reinterpret_cast<float2*>(part_dk + r * LDK + 8 * j + col) =
            make_float2(acc_dk[4 * j + 2 * i], acc_dk[4 * j + 2 * i + 1]);
    }
    if constexpr (kDv) {
#pragma unroll
      for (int j = 0; j < DPV / 8; ++j)
        *reinterpret_cast<float2*>(part_dv + r * LDV + 8 * j + col) =
            make_float2(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
    }
  }
  cluster.sync();
  constexpr int C8 = (!kDv || (kDk && DK > DV) ? DK : DV) / 8;  // 8-column groups written
  const int rows = kTile / split, r0 = rank * rows;
  for (int idx = tid; idx < rows * C8; idx += kThreads) {
    const int r = r0 + idx / C8, c8 = idx % C8;
    if (k0 + r >= skv) continue;
    float sum[8];
    if (kDk && 8 * c8 < DK) {
      sum_ranks(cluster, part_dk, LDK, r, c8, split, sum);
      *reinterpret_cast<uint4*>(dk + (kv_plane * skv + k0 + r) * DK + 8 * c8) = make_uint4(
          bf16x2(sum[0] * scale, sum[1] * scale), bf16x2(sum[2] * scale, sum[3] * scale),
          bf16x2(sum[4] * scale, sum[5] * scale), bf16x2(sum[6] * scale, sum[7] * scale));
    }
    if (kDv && 8 * c8 < DV) {
      sum_ranks(cluster, part_dv, LDV, r, c8, split, sum);
      *reinterpret_cast<uint4*>(dv + (kv_plane * skv + k0 + r) * DV + 8 * c8) =
          make_uint4(bf16x2(sum[0], sum[1]), bf16x2(sum[2], sum[3]), bf16x2(sum[4], sum[5]),
                     bf16x2(sum[6], sum[7]));
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// ---------------------------------------------------------------- launches

using KeyKernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, const int*, const float*, const float*,
                           __nv_bfloat16*, __nv_bfloat16*, int, int, int, int, int, int, float);

// The kernel and shared memory of a pass at (DK, DV), or {nullptr, 0} for a
// pass the pair does not run: the dq pass, then the dk/dv pass where the
// accumulators fit (kFusedKeys), else the dv and the dk pass.
template <int DK, int DV>
const void* pass_kernel(int pass, size_t* smem) {
  *smem = 0;
  if (pass == kPassDq) {
    *smem = dq_smem_bytes<DK, DV>;
    return reinterpret_cast<const void*>(flash_bwd_dq_kernel<DK, DV>);
  }
  KeyKernel kernel = nullptr;
  if constexpr (kFusedKeys<DK, DV>) {
    if (pass == kPassDkdv) {
      kernel = flash_bwd_key_kernel<DK, DV, kPassDkdv>;
      *smem = key_smem_bytes<DK, DV, kPassDkdv>;
    }
  } else if (pass == kPassDv) {
    kernel = flash_bwd_key_kernel<DK, DV, kPassDv>;
    *smem = key_smem_bytes<DK, DV, kPassDv>;
  } else if (pass == kPassDk) {
    kernel = flash_bwd_key_kernel<DK, DV, kPassDk>;
    *smem = key_smem_bytes<DK, DV, kPassDk>;
  }
  return reinterpret_cast<const void*>(kernel);
}

template <int DK, int DV>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* kv_lens, const __nv_bfloat16* out, const __nv_bfloat16* dout,
           const float* lse, float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, int pass, int b, int hk, int g, int sq, int skv, int q_offset,
           int causal, float scale, cudaStream_t stream) {
  const int hq = hk * g;
  size_t smem = 0;
  const void* kernel = pass_kernel<DK, DV>(pass, &smem);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // A runtime call before the encodes: it makes the device's context current
  // on this thread (autograd runs a backward on a thread of its own), which
  // cuTensorMapEncodeTiled needs.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int enc = hopper::encode_bf16_3d(&tm_q, q, DK, sq, static_cast<uint64_t>(b) * hq);
  if (enc == 0) enc = hopper::encode_bf16_3d(&tm_do, dout, DV, sq, static_cast<uint64_t>(b) * hq);
  if (enc == 0) enc = hopper::encode_bf16_3d(&tm_k, k, DK, skv, static_cast<uint64_t>(b) * hk);
  if (enc == 0) enc = hopper::encode_bf16_3d(&tm_v, v, DV, skv, static_cast<uint64_t>(b) * hk);
  if (enc != 0) return kErrEncode + enc;
  if (pass == kPassDq) {
    const dim3 grid(hq, (sq + kTile - 1) / kTile, b);
    flash_bwd_dq_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
        tm_q, tm_do, tm_k, tm_v, kv_lens, out, dout, lse, delta, dq, hk, g, sq, skv, q_offset,
        causal, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int split = dkdv_split(b, hk, g, sq, skv, q_offset, causal);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(split, hk * b, (skv + kTile - 1) / kTile);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, reinterpret_cast<KeyKernel>(const_cast<void*>(kernel)), tm_q,
                           tm_do, tm_k, tm_v, kv_lens, lse, delta, dk, dv, hk, g, sq, skv,
                           q_offset, causal, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The (key dim, value dim) pairs the kernels are built for (ops.py: BWD_HEAD_DIMS)
#define FLASH_BWD_DIMS(X)                                                                     \
  X(16, 16) X(32, 32) X(48, 48) X(64, 64) X(80, 80) X(96, 96) X(112, 112) X(128, 128)        \
  X(192, 128) X(24, 16)

// Shared memory of one block of a pass (0: dq, 1: dk/dv, 2: dv, 3: dk) at
// (dk, dv), or 0 for a pair the kernels are not built for or a pass the pair
// does not run.
extern "C" int flash_bwd_smem_bytes(int pass, int dk, int dv) {
  size_t smem = 0;
#define FLASH_BWD_SMEM(DK, DV) \
  if (dk == DK && dv == DV) pass_kernel<DK, DV>(pass, &smem);
  FLASH_BWD_DIMS(FLASH_BWD_SMEM)
#undef FLASH_BWD_SMEM
  return static_cast<int>(smem);
}

// Blocks of a pass that one SM holds at once at (dk, dv)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), in *blocks.  Returns a
// cudaError_t (0 on success).
extern "C" int flash_bwd_occupancy(int pass, int dk, int dv, int* blocks) {
  size_t smem = 0;
  const void* kernel = nullptr;
#define FLASH_BWD_OCC(DK, DV) \
  if (dk == DK && dv == DV) kernel = pass_kernel<DK, DV>(pass, &smem);
  FLASH_BWD_DIMS(FLASH_BWD_OCC)
#undef FLASH_BWD_OCC
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
  return static_cast<int>(err);
}

// The schedule of a pass (0: dq; 1, 2, 3: the key side's, which share it)
// at these shapes: out[0..2] the grid's x, y and z, out[3] the cluster's
// size along x (the key side's split).  Returns a cudaError_t (0 on
// success).
extern "C" int flash_bwd_plan(int pass, int b, int hk, int g, int sq, int skv, int q_offset,
                              int causal, int* out) {
  if (pass < kPassDq || pass > kPassDk || b < 0 || hk <= 0 || g <= 0 || sq < 0 || skv < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pass == kPassDq) {
    out[0] = hk * g;
    out[1] = (sq + kTile - 1) / kTile;
    out[2] = b;
    out[3] = 1;
  } else {
    const int split = dkdv_split(b, hk, g, sq, skv, q_offset, causal);
    out[0] = split;
    out[1] = hk * b;
    out[2] = (skv + kTile - 1) / kTile;
    out[3] = split;
  }
  return 0;
}

// One pass of the backward.  q, dq (B, Hk*G, Sq, dk); out, dout (B, Hk*G,
// Sq, dv); k, dk (B, Hk, Skv, dk); v, dv (B, Hk, Skv, dv): bf16, contiguous,
// 16-byte aligned; kv_lens (B,) int32; lse and delta (B, Hk*G, Sq) float32,
// contiguous (read a float at a time).  Pass 0 (dq) reads q, k, v, kv_lens,
// out, dout and lse and writes delta and dq; pass 1 (dk/dv) reads q, k, v,
// kv_lens, dout, lse and delta and writes dk and dv; pass 2 (dv) reads q, k,
// kv_lens, dout and lse and writes dv; pass 3 (dk) reads what pass 1 does
// and writes dk.  The key side's passes follow pass 0 on the stream.  A pair
// runs pass 1, or passes 2 and 3 (flash_bwd_smem_bytes is 0 for the
// others).  Returns a cudaError_t (0 on success), or 10000 + the CUresult of
// a failed tensor-map encode.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* kv_lens,
                                const void* out, const void* dout, const void* lse, void* delta,
                                void* dq, void* dk, void* dv, int pass, int b, int hk, int g,
                                int sq, int skv, int d_k, int d_v, int q_offset, int causal,
                                float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* lens = static_cast<const int*>(kv_lens);
  const auto* ob = static_cast<const __nv_bfloat16*>(out);
  const auto* dob = static_cast<const __nv_bfloat16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  auto* st = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(DK, DV)                                                              \
  if (d_k == DK && d_v == DV)                                                               \
    return launch<DK, DV>(qb, kb, vb, lens, ob, dob, lf, df, dqb, dkb, dvb, pass, b, hk, g, \
                          sq, skv, q_offset, causal, scale, st);
  FLASH_BWD_DIMS(FLASH_BWD_CASE)
#undef FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int code) {
  if (code >= kErrEncode) return "cuTensorMapEncodeTiled failed (code - 10000 is its CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
