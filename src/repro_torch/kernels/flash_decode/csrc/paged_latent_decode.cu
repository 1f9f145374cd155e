// Hopper kernel for paged flash decode's MLA latent form (K2 with its q_pe
// score term), on the tensor cores (wgmma), split-KV.
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
// an online softmax, out[b,h] = sum_j p_j ckv[j] / max(l, 1e-30) rounded to
// bf16 (a row of length 0 gives zeros), as flash_decode/ops.py::_block_update
// with qpe.  Page-table entries outside [0, n_pages) are clamped, as the
// reference's gather clamps them.
//
// What bounds it on this card: the bytes.  A step reads each live row's
// latent rows once ((r + dr) * 2 bytes a position), and the operations,
// 2 H (2 r + dr) a position, are a few hundred FLOPs a byte at H 128: below
// the bf16 tensor cores' ridge (about 295), far above the float32 cores'.
// The 128 heads of a row all read one latent KV: multi-query attention, a
// matrix product with the heads as its rows.
//
// Design.  Grid (splits, ceil(H / 64), B): a block holds 64 query heads of
// one row, wgmma's M rows (H 20 or 4 is padded with zero queries whose
// outputs are never stored), and one split of the row.  A row's positions are
// cut into tiles of 64 positions (the online-softmax step) from position 0,
// and the tiles into splits of 192 positions from position 0, so a row's
// blocking depends on its own length only, never on B, the other rows, the
// page size or pages_per_program (which the kernel does not take: each
// position finds its pool row through the page table on its own, so a tile
// need not follow page boundaries).  A block of two warpgroups (256 threads,
// one block an SM) stages q = [q_lat | q_pe] (64 x 576 bf16, 72 KB) once and
// its split's latent tiles, [ckv | kpe] (64 x 576), through a ring of two
// stages with 16-byte cp.async copies, the next tile's copies in flight
// while the current one is computed; the split's pool rows (page table read
// once) are computed first.
// Each tile is staged once for all 64 heads and serves as both K and V: the
// pool is read twice a row (once per head group), not once per 8 heads.
// Per tile, each warpgroup runs S = q [ckv | kpe]^T (64 x 64, float32
// registers) as one wgmma chain over the depth 576 in k-steps of 16, both
// operands K-major in shared memory; the online softmax in float32 registers
// (scores in log2 units, exp2), one step per tile; then O += P ckv with A = P
// from registers and B = the tile's ckv columns read in place (MN-major, the
// instruction transposes).  O is 64 x 512 float32, which one warpgroup's
// registers do not hold, so each warpgroup keeps 256 of its columns (128
// registers a thread).  Both warpgroups compute the same S and softmax (the
// same instructions on the same operands, so the same bits): that doubles
// the S products, 36 k-steps a tile against P V's 2 x 64 / 16 of 256 columns
// a warpgroup, and keeps P out of shared memory and the warpgroups free of
// any barrier but the tile's.  At the smoke widths (r 16, dr 8) the depth 24
// is zero-padded to 32 in shared memory, which adds exact zeros.
//
// Arithmetic.  q . k of bf16 values is exact in float32 products, summed in
// float32 in another order than the plain version's.  P V: p is carried as
// two bf16 values, p_hi = bf16(p) and p_lo = bf16(p - p_hi), both multiplied
// into the float32 accumulator, within about 2^-17 of p; a single bf16 p
// would err by 2^-9 of p.  Positions at or past the row's length are
// zero-filled when staged (nothing is read there: memory past a length may
// hold anything, and 0 * NaN is NaN on the tensor cores too) and masked.
//
// Splits.  A row of at most 192 positions (length 0 included) is written by
// its split 0 directly.  A longer row's splits write their partials (m, l in
// log2 units, and acc) in float32 to scratch, and a second launch
// (paged_latent_decode_merge_kernel, a block per (head, row)) merges them in
// split order:
// M = max m_s, w_s = 2^(m_s - M), out = sum_s acc_s w_s / max(sum_s l_s w_s,
// 1e-30).  192 positions a split: at deepseek-v2's long run (B 8, 128 heads,
// 1088 positions) 6 splits x 2 x 8 = 96 blocks, one wave of 132 SMs; a
// split's partials (64 x 512 x 4 = 128 KB) are about as many bytes as its
// 192 latent rows (221 KB), so shorter splits would write more than they
// read.
//
// No branch that the compiler cannot prove uniform over a warpgroup encloses
// a wgmma: the tile loop's bounds depend on the block's row only, and the
// length mask is applied to the scores in registers.  Shared memory holds
// every operand in the canonical layout without swizzle: 8 x 8 core matrices
// of 128 contiguous bytes, the core matrices of one 8-row group side by side.
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeads = 64;  // query heads a block: wgmma's M rows
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 2;
constexpr int kTile = 64;  // positions a tile, from position 0: S's N, P V's depth
constexpr int kSplitPositions = 192;  // positions a split, from position 0: 3 tiles
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int padded_depth(int r, int dr) { return (r + dr + 15) / 16 * 16; }

// Shared memory one block needs: q (64 rows), a ring of two tiles of 64
// positions, both bf16 at the padded depth, and the split's pool rows.
__host__ __device__ inline size_t smem_bytes(int r, int dr) {
  const size_t dkp = padded_depth(r, dr);
  return 2 * (kHeads + kStages * kTile) * dkp + 4 * kSplitPositions;
}

__host__ __device__ inline int n_splits(int capacity) {
  return (capacity + kSplitPositions - 1) / kSplitPositions;
}

// ---------------------------------------------------------------- copies

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's completed shared-memory writes visible to wgmma (the
// async proxy); a barrier follows.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Stages n_rows rows of [a | b] (row i: the A values of a at row(i) * A,
// then the B values of b at row(i) * B) into shared memory in the canonical
// layout without swizzle, DKP columns wide: element (i, c) at ((i / 8) *
// (DKP / 8) + c / 8) * 64 + (i % 8) * 8 + c % 8.  Thread idx copies 16-byte
// chunk idx of that layout, so eight neighbouring threads fill one 128-byte
// core matrix.  A row whose index is negative and the columns at or past
// A + B are zero-filled; nothing is read there.
template <int A, int B, int DKP, class Row>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, const Row& row, int n_rows,
                                           int tid) {
  constexpr int kChunks = DKP / 8;
  for (int idx = tid; idx < n_rows * kChunks; idx += kThreads) {
    const int rest = idx / 8;
    const int i = (rest / kChunks) * 8 + idx % 8, cg = rest % kChunks;
    const int at = row(i);
    const bool valid = at >= 0 && cg < (A + B) / 8;
    const __nv_bfloat16* src = a;
    if (valid)
      src = cg < A / 8 ? a + static_cast<size_t>(at) * A + cg * 8
                       : b + static_cast<size_t>(at) * B + (cg - A / 8) * 8;
    cp_async_16(dst + idx * 8, src, valid);
  }
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor without swizzle (layout type 0): the start
// address, the leading-dimension byte offset and the stride byte offset, each
// in units of 16 bytes.  A K-major operand's leading offset is the step
// between core matrices adjacent along K and its stride offset the step
// between 8-row groups; an MN-major operand's leading offset is the step
// between 8-row groups along K and its stride offset the step between core
// matrices adjacent along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's uses of accumulator registers around the
// asynchronous products: a register is "written" here, after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 64, float32) = A (64 x 16) B (16 x 64) + (scale_d ? D : 0); A and
// B bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[OFF ...] (64 x 8, float32) += A (64 x 16, bf16, in registers) B (16 x 8,
// bf16, in shared memory, MN-major: transposed by the instruction).
template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[M], const uint32_t (&a)[4],
                                            uint64_t db) {
  static_assert(OFF + 4 <= M, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The same at 128 columns.
template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[M], const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(OFF + 64 <= M, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S (64 x 64) = q [ckv | kpe]^T for the block's 64 heads and the tile's 64
// positions: k-steps of 16 in order over DKP (two core matrices, 256 bytes,
// 16 descriptor units a step).  Both operands K-major: core matrices along
// the depth 128 bytes apart, 8-row groups DKP * 16.
template <int DKP>
__device__ __forceinline__ void qk_product(float (&s)[kTile / 2], const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks) {
  const uint64_t dq = smem_desc(qs, 128, DKP * 16), dk = smem_desc(ks, 128, DKP * 16);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) wgmma_ss_n64(s, dq + 16 * kk, dk + 16 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// The A fragments of positions 16c .. 16c + 15 of a 64 x N tile p held in
// wgmma's accumulator layout (thread t of warp w: rows 16w + t/4 and +8,
// columns 8j + 2(t%4) and +1 in registers 4j .. 4j + 3), as bf16 pairs:
// hi = bf16(p), lo = bf16(p - hi).  Fragment f holds row (f % 2) * 8 and
// positions 8 (f / 2) + 2(t%4), +1 of the chunk, low half first.
template <int N>
__device__ __forceinline__ void p_fragments(const float (&p)[N], int c, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int r = 4 * (2 * c + f / 2) + 2 * (f % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[r], p[r + 1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(p[r] - hf.x, p[r + 1] - hf.y);
    hi[f] = *reinterpret_cast<const uint32_t*>(&h);
    lo[f] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// o (64 x RW) += A V_chunk: RW columns of 16 positions' latent rows, in
// wgmma products of 128 columns (8 at the smoke width).
template <int RW>
__device__ __forceinline__ void pv_columns(float (&o)[RW / 2], const uint32_t (&a)[4],
                                           uint64_t dv) {
  static_assert(RW == 256 || RW == 8, "a warpgroup's columns: 256, or 8 at the smoke width");
  if constexpr (RW == 8) {
    wgmma_rs_n8<0>(o, a, dv);
  } else {
    wgmma_rs_n128<0>(o, a, dv);
    wgmma_rs_n128<64>(o, a, dv + 128);  // 16 core matrices of 128 bytes along the columns
  }
}

// o = o * alpha (per row) + P V over the tile's 64 positions (p in wgmma's
// accumulator layout; vs the warpgroup's first column of the tile, rows DKP
// wide: MN-major, 8-position groups DKP * 16 bytes apart, core matrices
// along the columns 128): for each 16-position chunk p_hi V, then p_lo V,
// all into the float32 accumulator, launched together and waited for once.
template <int DKP, int RW>
__device__ __forceinline__ void pv_tile(float (&o)[RW / 2], const float (&p)[kTile / 2],
                                        const float (&alpha)[2], const __nv_bfloat16* vs) {
  uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) p_fragments(p, c, hi[c], lo[c]);
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < RW / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c) {
    const uint64_t dv = smem_desc(vs + c * 16 * DKP, DKP * 16, 128);  // two 8-row groups a chunk
    pv_columns<RW>(o, hi[c], dv);
    pv_columns<RW>(o, lo[c], dv);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step over a tile of scores s (wgmma's accumulator
// layout: this thread's rows i = 0, 1 and, in 8-position group j, positions
// 8j + 2(lane % 4) + cc).  A position at or past lim (counted from this
// thread's first column) is masked; kMask = false when the tile holds no
// such position.  s becomes p = 2^(s scale log2(e) - m); m, l move on; alpha
// is the rescale of the accumulator (1 exactly where the max did not move).
template <bool kMask>
__device__ __forceinline__ void tile_softmax(float (&s)[kTile / 2], float (&alpha)[2],
                                             float (&m)[2], float (&l)[2], int lim,
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float& x = s[4 * j + 2 * i + cc];
        x = !kMask || 8 * j + cc < lim ? x * scale_log2 : kNegInf;
        mx[i] = fmaxf(mx[i], x);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = mx[i] == m[i] ? 1.f : ex2(m[i] - mx[i]);
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float& x = s[4 * j + 2 * i + cc];
        x = !kMask || 8 * j + cc < lim ? ex2(x - mx[i]) : 0.f;
        sum[i] += x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
    m[i] = mx[i];
  }
}

// ---------------------------------------------------------------- kernels

// Split blockIdx.x of head group blockIdx.y of row blockIdx.z.  part holds
// the partials: a record of 64 x (2 + R) floats per (row, head group,
// split), (m, l) per head, then acc per head.
template <int R, int DR>
__global__ void __launch_bounds__(kThreads, 1)
paged_latent_decode_split_kernel(const __nv_bfloat16* __restrict__ q_lat,
                    const __nv_bfloat16* __restrict__ q_pe,
                    const __nv_bfloat16* __restrict__ ckv, const __nv_bfloat16* __restrict__ kpe,
                    const int* __restrict__ lengths, const int* __restrict__ page_tables,
                    float* __restrict__ part, __nv_bfloat16* __restrict__ out, int h_total,
                    int n_pages, int page, int npp, float scale_log2) {
  static_assert(R % 16 == 0 && DR % 8 == 0, "16-byte rows; two warpgroups' columns");
  constexpr int DKP = padded_depth(R, DR);
  constexpr int RW = R / kWarpgroups;  // the context columns a warpgroup accumulates
  constexpr int kPer = kSplitPositions / kTile;
  static_assert(kSplitPositions % kTile == 0, "a split is whole tiles");
  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int h0 = grp * kHeads;
  const int gh = min(kHeads, h_total - h0);
  int len = lengths[b];
  len = len < 0 ? 0 : (len > npp * page ? npp * page : len);
  const int n_tiles = (len + kTile - 1) / kTile;
  const int t0 = split * kPer, t1 = min(t0 + kPer, n_tiles);
  const bool single = n_tiles <= kPer;  // the whole row is split 0
  if (t0 >= t1 && !(single && split == 0)) return;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kHeads * DKP;  // stage s at ks + s * kTile * DKP
  int* rows = reinterpret_cast<int*>(ks + kStages * kTile * DKP);

  const size_t row0 = static_cast<size_t>(b) * h_total + h0;  // (b, h0) in (B, H)
  stage_rows<R, DR, DKP>(qs, q_lat, q_pe,
                         [&](int i) { return i < gh ? static_cast<int>(row0) + i : -1; },
                         kHeads, tid);
  // the split's positions' rows in the pools (pid * page + pos % page), -1
  // at and past the length
  for (int j = tid; j < kSplitPositions; j += kThreads) {
    const int pos = split * kSplitPositions + j;
    int at = -1;
    if (pos < len) {
      int pid = page_tables[static_cast<size_t>(b) * npp + pos / page];
      pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
      at = pid * page + pos % page;
    }
    rows[j] = at;
  }
  __syncthreads();
  if (t0 < t1) stage_rows<R, DR, DKP>(ks, ckv, kpe, [&](int i) { return rows[i]; }, kTile, tid);
  cp_async_commit();

  float o[RW / 2];
#pragma unroll
  for (int i = 0; i < RW / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int col = 2 * (lane % 4);  // this thread's first column of each 8-column group

  for (int t = t0; t < t1; ++t) {
    const int u = t - t0;
    if (t + 1 < t1) {  // the next tile's copies, in flight during this one
      const int* next = rows + (u + 1) * kTile;
      stage_rows<R, DR, DKP>(ks + ((u + 1) % kStages) * kTile * DKP, ckv, kpe,
                             [&](int i) { return next[i]; }, kTile, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile t (and q) have landed
    fence_async_shared();
    __syncthreads();
    const __nv_bfloat16* kt = ks + (u % kStages) * kTile * DKP;
    float s[kTile / 2] = {};
    qk_product<DKP>(s, qs, kt);
    const int n_valid = min(kTile, len - t * kTile);
    float alpha[2];
    if (n_valid < kTile)
      tile_softmax<true>(s, alpha, m, l, n_valid - col, scale_log2);
    else
      tile_softmax<false>(s, alpha, m, l, n_valid - col, scale_log2);
    // this warpgroup's columns wg * RW .. of the tile's latent rows: wg * RW
    // / 8 core matrices along the columns
    pv_tile<DKP, RW>(o, s, alpha, kt + (wg * RW / 8) * 64);
    __syncthreads();  // both warpgroups are done with stage u % kStages
  }
  cp_async_wait<0>();

  const int r0 = 16 * warp + lane / 4;  // this thread's heads r0 and r0 + 8 of the block
  if (single) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r >= gh) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = out + (row0 + r) * R + wg * RW;
#pragma unroll
      for (int j = 0; j < RW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
    }
    return;
  }
  float* rec = part + ((static_cast<size_t>(b) * gridDim.y + grp) * gridDim.x + split) *
                          (kHeads * (2 + R));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (wg == 0 && lane % 4 == 0) {
      rec[2 * r] = m[i];
      rec[2 * r + 1] = l[i];
    }
    float* acc = rec + 2 * kHeads + r * R + wg * RW;
#pragma unroll
    for (int j = 0; j < RW / 8; ++j)
      *reinterpret_cast<float2*>(acc + 8 * j + col) =
          make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
  }
}

// Merges the partials of the rows that took more than one split, in split
// order: grid (H, B), a block per (head, row); (splits + 1) floats of
// dynamic shared memory for the weights w_s = 2^(m_s - M) and
// max(L, 1e-30), L = sum_s l_s w_s, found by one thread in split order.
template <int R>
__global__ void __launch_bounds__(kMergeThreads)
paged_latent_decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int h_total, int capacity, int splits) {
  static_assert(R % 4 == 0, "float4 columns");
  const int h = blockIdx.x, b = blockIdx.y;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > capacity ? capacity : len);
  const int n = (len + kSplitPositions - 1) / kSplitPositions;
  if (n <= 1) return;  // written by its only split
  extern __shared__ float wts[];
  const int groups = (h_total + kHeads - 1) / kHeads;
  const int grp = h / kHeads, r = h % kHeads;
  const size_t rec = static_cast<size_t>(kHeads) * (2 + R);
  const float* base = part + (static_cast<size_t>(b) * groups + grp) * splits * rec;
  if (threadIdx.x == 0) {
    float mx = kNegInf;
    for (int s = 0; s < n; ++s) mx = fmaxf(mx, base[s * rec + 2 * r]);
    float total = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = exp2f(base[s * rec + 2 * r] - mx);
      wts[s] = w;
      total = fmaf(base[s * rec + 2 * r + 1], w, total);
    }
    wts[n] = fmaxf(total, 1e-30f);
  }
  __syncthreads();
  const float denom = wts[n];
  for (int c = 4 * threadIdx.x; c < R; c += 4 * kMergeThreads) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n; ++s) {
      const float4 a =
          *reinterpret_cast<const float4*>(base + s * rec + 2 * kHeads + r * R + c);
      const float w = wts[s];
      o.x = fmaf(a.x, w, o.x);
      o.y = fmaf(a.y, w, o.y);
      o.z = fmaf(a.z, w, o.z);
      o.w = fmaf(a.w, w, o.w);
    }
    __nv_bfloat16* dst = out + (static_cast<size_t>(b) * h_total + h) * R + c;
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.x / denom, o.y / denom);
    *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
        __floats2bfloat162_rn(o.z / denom, o.w / denom);
  }
}

template <int R, int DR>
int launch(const __nv_bfloat16* q_lat, const __nv_bfloat16* q_pe, const __nv_bfloat16* ckv,
           const __nv_bfloat16* kpe, const int* lengths, const int* page_tables, float* part,
           __nv_bfloat16* out, int b, int h, int n_pages, int page, int npp, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(R, DR);
  cudaError_t err = cudaFuncSetAttribute(paged_latent_decode_split_kernel<R, DR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = n_splits(npp * page);
  const dim3 grid(splits, (h + kHeads - 1) / kHeads, b);
  // scores in log2 units, x = s scale log2(e): p = 2^(x - m)
  paged_latent_decode_split_kernel<R, DR><<<grid, kThreads, smem, stream>>>(
      q_lat, q_pe, ckv, kpe, lengths, page_tables, part, out, h, n_pages, page, npp,
      scale * 1.44269504088896340736f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return static_cast<int>(err);
  // (splits + 1) weights: up to 48 KB, 2.3 M positions a row
  paged_latent_decode_merge_kernel<R><<<dim3(h, b), kMergeThreads, (splits + 1) * 4, stream>>>(
      part, lengths, out, h, npp * page, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs at latent width r and rope width dr.
extern "C" int paged_latent_decode_smem_bytes(int r, int dr) {
  return static_cast<int>(smem_bytes(r, dr));
}

// Splits of a row of `capacity` positions (npp * page): the split kernel's
// grid's first dimension, and the partials' count per (row, head group).
extern "C" int paged_latent_decode_splits(int capacity) { return n_splits(capacity); }

// q_lat (B, H, r) and out (B, H, r) bf16; q_pe (B, H, dr) bf16; ckv_pages
// (n_pages, page, r) and kpe_pages (n_pages, page, dr) bf16; lengths (B,)
// int32; page_tables (B, npp) int32; all contiguous and 16-byte aligned.
// part: float32 scratch of B * ceil(H / 64) * splits * 64 * (2 + r) values
// where splits > 1.  (r, dr) is DeepSeek-V2's (512, 64) or its smoke
// variant's (16, 8); any page size.  Returns a cudaError_t (0 on success).
extern "C" int paged_latent_decode_launch(const void* q_lat, const void* q_pe,
                                          const void* ckv_pages, const void* kpe_pages,
                                          const void* lengths, const void* page_tables,
                                          void* part, void* out, int b, int h, int r, int dr,
                                          int n_pages, int page, int npp, float scale,
                                          void* stream) {
  const auto* q = static_cast<const __nv_bfloat16*>(q_lat);
  const auto* qp = static_cast<const __nv_bfloat16*>(q_pe);
  const auto* c = static_cast<const __nv_bfloat16*>(ckv_pages);
  const auto* k = static_cast<const __nv_bfloat16*>(kpe_pages);
  const auto* lens = static_cast<const int*>(lengths);
  const auto* pt = static_cast<const int*>(page_tables);
  auto* pf = static_cast<float*>(part);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (r == 512 && dr == 64)
    return launch<512, 64>(q, qp, c, k, lens, pt, pf, o, b, h, n_pages, page, npp, scale, st);
  if (r == 16 && dr == 8)
    return launch<16, 8>(q, qp, c, k, lens, pt, pf, o, b, h, n_pages, page, npp, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* paged_latent_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
