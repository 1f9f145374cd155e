// Hopper kernel for the blocked causal flash-attention forward (K3), on the
// tensor cores (wgmma).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd_pallas
// (the Pallas TPU kernel, with its GQA wrapper flash_attention_pallas), and
// computes what the models call through ops.flash_attention
// (flash_attention/ops.py::_flash_fwd_impl): grouped GQA without repeating
// KV (query head h reads KV head h / G), a value dim DV that may differ
// from the key dim DK (MLA's prefill: DK 192, DV 128), per-batch kv_lens, a
// static q_offset, causal masking, online softmax over key tiles of block_k
// positions, fully masked tiles skipped, out = acc / max(l, 1e-30); and, when
// the caller passes a buffer, each row's float32 log-sum-exp
// m + log(max(l, 1e-30)) (ops.py:103), which the backward (flash_bwd.cu)
// reads.  The lse is written after the output and changes none of its bits.
//
// Arithmetic.  S = Q K^T: bf16 operands on the tensor cores, float32
// accumulation (each product of two bf16 values is exact in float32).  The
// scale, the masks and the online softmax run in float32 registers, the
// scores in log2 units (s * scale * log2(e), then exp2), which is the same
// function to a few float32 roundings.  P V: the reference multiplies a
// float32 p; a single bf16 p would err by about 2^-9 of max|v|, so p is
// split into two bf16 values, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and
// both products go into one float32 accumulator: p_hi + p_lo is within about
// 2^-17 of p.  The online-softmax step is the caller's block_k (16, 32 or 64
// positions; the serve engine pins 16), taken in order from position 0 inside
// each staged tile, as the plain version's key tiles are: each step's max,
// sum and rescale alpha come in order, and the accumulator's chain
// (..((acc a_0 + P_0 V_0) a_1 + P_1 V_1)..) is written
// acc (a_0 .. a_n) + sum_u P_u (a_{u+1} .. a_n) V_u, so that a tile's P V
// products go out together.
//
// Row independence.  A row's result depends only on its own q, the keys and
// values at positions <= its own and < kv_len, and the fixed block_k tiles
// from position 0: a tensor-core product's row i reads only row i of its A
// operand, and every per-row sum (the dot products over DK in k-steps of 16,
// the tile's max and sum, the P V chain) runs in a fixed order.  So a row
// gives the same bits whatever Sq, the query tiling or the batch: the serve
// engine's prefix guarantee rests on it.  A 64-row warpgroup walks to its
// block's last row's causal limit; for an earlier row a fully masked block_k
// tile is an exact no-op (its max is the running max, so alpha = 1, and
// every p is 0), and a tile no row of the warpgroup sees gets p = 0 without
// statistics, equally exactly.  Key positions at or past kv_len are
// zero-filled when staged: memory there may hold anything, and 0 * NaN is
// NaN on the tensor cores too.
//
// What bounds it on this card: the operations.  A causal prefill does
// 2 Sq^2 (DK + DV) Hq / 2 multiply-adds' worth of FLOPs (P V counted once),
// far above the bf16 ridge; the bytes (q, k, v read once, out written once)
// are small beside them.  The P split doubles the P V products, so against
// the plain count the kernel cannot pass two thirds of the tensor-core peak.
// What holds it below that now is the softmax's float32 work between the
// products, which the tensor cores wait for (no warpgroup takes another's
// turn yet).
//
// Design: grid = (ceil(Sq / 128), Hq, B), heaviest causal tiles first; one
// block of two warpgroups (256 threads) holds 128 query positions of one
// query head, 64 rows a warpgroup, so the G query heads of a KV head read the
// same K and V through the L2; two blocks share an SM where the registers
// allow (DK, DV <= 128).  Q is staged once; K and V tiles of 64 positions go
// through a ring of two stages in shared memory, filled with 16-byte cp.async
// copies (zero-fill past kv_len and past DK), the next tile's copies in
// flight while the current one is computed.  Per tile and warpgroup: S (64 x
// 64, float32 registers) = one wgmma chain over DK in k-steps of 16, both
// operands read from shared memory (K-major); the online softmax per block_k
// tile (quad shuffles for a row's max and sum); then P V as one batch of
// wgmma with A = P (hi, lo) from registers and B = V from shared memory
// (MN-major, transposed in the instruction).  No branch that the compiler
// cannot prove uniform over a warpgroup encloses a wgmma: it would
// serialise them all.  Shared memory holds every operand in the canonical
// layout without swizzle: 8 x 8 core matrices of 128 contiguous bytes, the
// core matrices of one 8-row group side by side.  DK 24 is padded to 32 with
// zero columns.  The output is acc / max(l, 1e-30) rounded to bf16.  The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileQ = 64 * kWarpgroups;  // query positions per block
constexpr int kTileKV = 64;               // key positions per staged tile
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int padded_dk(int dk) { return (dk + 15) / 16 * 16; }

// Blocks an SM holds: two at DK, DV <= 128, where 128 registers a thread
// hold the accumulators (ptxas spills a few bytes at 128) and two blocks'
// shared memory fits; one at wider heads.
template <int DK, int DV>
constexpr int kBlocksPerSm = DK <= 128 && DV <= 128 ? 2 : 1;

__host__ __device__ inline size_t smem_bytes(int dk, int dv) {
  return 2 * (static_cast<size_t>(kTileQ) * padded_dk(dk)                   // q
              + static_cast<size_t>(kStages) * kTileKV * (padded_dk(dk) + dv));  // K, V ring
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

// Stages R rows of a row-major (rows, C) bf16 matrix into shared memory in
// the canonical layout without swizzle, CP columns wide: element (r, c) at
// ((r / 8) * (CP / 8) + c / 8) * 64 + (r % 8) * 8 + c % 8.  Thread idx copies
// 16-byte chunk idx of that layout, so eight neighbouring threads fill one
// 128-byte core matrix.  Rows at or past n_rows and columns at or past C are
// zero-filled; nothing is read there.
template <int R, int CP, int C>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int n_rows, int tid, int n_threads) {
  constexpr int kChunks = CP / 8;
  for (int idx = tid; idx < R * kChunks; idx += n_threads) {
    const int rest = idx / 8;
    const int r = (rest / kChunks) * 8 + idx % 8, cg = rest % kChunks;
    const bool valid = r < n_rows && cg * 8 < C;
    cp_async_16(dst + idx * 8, valid ? src + static_cast<size_t>(r) * C + cg * 8 : src, valid);
  }
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor without swizzle (layout type 0): the start
// address, the leading-dimension byte offset and the stride byte offset, each
// in units of 16 bytes.  In the canonical layouts without swizzle, a K-major
// operand's leading offset is the step between core matrices adjacent along
// K and its stride offset the step between 8-row groups; an MN-major
// operand's leading offset is the step between 8-row groups along K and its
// stride offset the step between core matrices adjacent along M or N.
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

// D (64 x 64, float32) = A (64 x 16) B (16 x 64) + (scale_d ? D : 0); A and B bf16
// in shared memory, both K-major.
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

// D[OFF ...] (64 x N, float32) += A (64 x 16, bf16, in registers) B (16 x N, bf16,
// in shared memory, MN-major: transposed by the instruction).
template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[M], const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(OFF + 8 <= M, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[M], const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(OFF + 16 <= M, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int OFF, int M>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[M], const uint32_t (&a)[4],
                                                uint64_t db) {
  static_assert(OFF + 32 <= M, "accumulator range");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

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


// Byte steps of stage_tile's layout.  Q and K (K-major, DKP columns): core
// matrices along K are 128 bytes apart, 8-row groups DKP * 16.  V (MN-major:
// its rows are the product's K, its DV columns the N): 8-key groups are
// DV * 16 bytes apart, core matrices along DV 128.
template <int DKP>
__device__ __forceinline__ uint64_t qk_desc(const __nv_bfloat16* p) {
  return smem_desc(p, 128, DKP * 16);
}
template <int DV>
__device__ __forceinline__ uint64_t v_desc(const __nv_bfloat16* p) {
  return smem_desc(p, DV * 16, 128);
}

// S (64 x 64) = Q K^T for one warpgroup: qs holds its 64 query rows, ks the
// tile's 64 keys; k-steps of 16 in order over DKP (two core matrices, 256
// bytes, 16 descriptor units a step).
template <int DKP>
__device__ __forceinline__ void qk_product(float (&s)[32], const __nv_bfloat16* qs,
                                           const __nv_bfloat16* ks) {
  const uint64_t dq = qk_desc<DKP>(qs), dk = qk_desc<DKP>(ks);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk) wgmma_ss_n64(s, dq + 16 * kk, dk + 16 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);
}

// The A fragments of keys 16c .. 16c + 15 of a 64 x 64 tile p held in
// wgmma's accumulator layout (thread t of warp w: rows 16w + t/4 and +8,
// columns 8j + 2(t%4) and +1 in registers 4j .. 4j + 3), as bf16 pairs:
// hi = bf16(p), lo = bf16(p - hi).  Fragment f holds row (f % 2) * 8 and
// keys 8 (f / 2) + 2(t%4), +1 of the chunk, low half first.
__device__ __forceinline__ void p_fragments(const float (&p)[32], int c, uint32_t (&hi)[4],
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

// o (64 x DV) += A V_chunk, V_chunk the 16 keys at vs (DV columns), in wgmma
// products of at most 128 columns.
template <int DV, int N0 = 0>
__device__ __forceinline__ void pv_columns(float (&o)[DV / 2], const uint32_t (&a)[4],
                                           uint64_t dv) {
  if constexpr (N0 < DV) {
    constexpr int kN = DV - N0 >= 128 ? 128 : DV - N0 >= 64 ? 64 : DV - N0 >= 32 ? 32 : 16;
    const uint64_t d = dv + (N0 / 8) * 8;  // N0 / 8 core matrices of 128 bytes along DV
    if constexpr (kN == 128) wgmma_rs_n128<N0 / 2>(o, a, d);
    if constexpr (kN == 64) wgmma_rs_n64<N0 / 2>(o, a, d);
    if constexpr (kN == 32) wgmma_rs_n32<N0 / 2>(o, a, d);
    if constexpr (kN == 16) wgmma_rs_n16<N0 / 2>(o, a, d);
    pv_columns<DV, N0 + kN>(o, a, dv);
  }
}

// o = o * scale (per row) + P V over the tile's 64 keys (p in wgmma's
// accumulator layout; vs the tile's V): for each 16-key chunk p_hi V, then
// p_lo V, all into the float32 accumulator, launched together and waited
// for once.
template <int DV>
__device__ __forceinline__ void pv_tile(float (&o)[DV / 2], const float (&p)[32],
                                        const float (&scale)[2], const __nv_bfloat16* vs) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) p_fragments(p, c, hi[c], lo[c]);
  fence_regs(o);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    o[4 * j] *= scale[0];
    o[4 * j + 1] *= scale[0];
    o[4 * j + 2] *= scale[1];
    o[4 * j + 3] *= scale[1];
  }
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t dv = v_desc<DV>(vs + c * 16 * DV);  // two 8-key groups a chunk
    pv_columns<DV>(o, hi[c], dv);
    pv_columns<DV>(o, lo[c], dv);
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

// The online softmax over one staged tile of scores s (64 keys, wgmma's
// accumulator layout: this thread's rows i = 0, 1 and, in 8-key group j,
// keys 8j + 2(lane % 4) + cc), one block_k tile (cps 16-key chunks) at a
// time, in order.  A key at or past lim[i] (counted from this thread's first
// column) is masked; kMask = false when no row of the warpgroup masks any key
// of the tile (then the mask would keep every key: the same bits).  s becomes p, in log2 units (p = 2^(s scale log2(e) - m)); m and
// l move on; alpha[c] is the rescale of the block_k tile starting at chunk c
// (1 at the others).  Chunks at or past `live` are seen by no row: they get
// no statistics, and the caller zeroes their p.
template <bool kMask>
__device__ __forceinline__ void tile_softmax(float (&s)[32], float (&alpha)[4][2], float (&m)[2],
                                             float (&l)[2], const int (&lim)[2], int cps,
                                             int live, float scale_log2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    alpha[c][0] = alpha[c][1] = 1.f;
    if (c % cps || c >= live) continue;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= 4 || e >= cps) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * (c + e) + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[4 * j + 2 * i + cc];
            x = !kMask || 8 * j + cc < lim[i] ? x * scale_log2 : kNegInf;
            mx[i] = fmaxf(mx[i], x);
          }
        }
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[c][i] = mx[i] == m[i] ? 1.f : ex2(m[i] - mx[i]);  // 1 exactly: a no-op
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c + e >= 4 || e >= cps) continue;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * (c + e) + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[4 * j + 2 * i + cc];
            x = !kMask || 8 * j + cc < lim[i] ? ex2(x - mx[i]) : 0.f;
            sum[i] += x;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[c][i] + quad_sum(sum[i]);
      m[i] = mx[i];
    }
  }
}

// ---------------------------------------------------------------- kernel

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<DK, DV>)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int hk, int g,
                 int sq, int skv, int q_offset, int causal, int bk, float scale) {
  static_assert(DK % 8 == 0 && DV % 16 == 0, "16-byte rows; wgmma columns in steps of 16");
  constexpr int DKP = padded_dk(DK);
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = hk * g;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kTileQ * DKP;             // stage s at ks + s * kTileKV * DKP
  __nv_bfloat16* vs = ks + kStages * kTileKV * DKP;  // stage s at vs + s * kTileKV * DV

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int q0 = qt * kTileQ;
  // this thread's rows (positions r0 and r0 + 8) see keys [0, hi[i])
  const int r0 = q0 + 64 * wg + 16 * warp + lane / 4;
  int hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = r0 + 8 * i;
    hi[i] = p < sq ? (causal ? min(len, q_offset + p + 1) : len) : 0;
  }
  // the warpgroup's and the block's key limits: their last rows'
  const int wg_first = q0 + 64 * wg;
  const int wg_limit =
      wg_first < sq ? (causal ? min(len, q_offset + min(sq, wg_first + 64)) : len) : 0;
  // the keys every row of the warpgroup sees: [0, wg_min_hi)
  const int wg_min_hi =
      wg_first + 64 <= sq ? (causal ? min(len, q_offset + wg_first + 1) : len) : 0;
  const int limit = causal ? min(len, q_offset + min(sq, q0 + kTileQ)) : len;
  const int n_tiles = limit > 0 ? (limit + kTileKV - 1) / kTileKV : 0;

  const size_t q_row0 = (static_cast<size_t>(b) * hq + head) * sq + q0;
  const size_t kv_row0 = (static_cast<size_t>(b) * hk + head / g) * skv;
  stage_tile<kTileQ, DKP, DK>(qs, q + q_row0 * DK, sq - q0, tid, kThreads);
  if (n_tiles > 0) {
    stage_tile<kTileKV, DKP, DK>(ks, k + kv_row0 * DK, len, tid, kThreads);
    stage_tile<kTileKV, DV, DV>(vs, v + kv_row0 * DV, len, tid, kThreads);
  }
  cp_async_commit();

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int cps = bk / 16;         // 16-key chunks per block_k tile
  // scores in log2 units, x = s scale log2(e): p = 2^(x - m), m the running max of x
  const float scale_log2 = scale * 1.44269504088896340736f;
  const int col = 2 * (lane % 4);  // this thread's first column of each 8-column group

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next tile's copies, in flight during this one
      const int kv1 = (t + 1) * kTileKV, st1 = (t + 1) % kStages;
      stage_tile<kTileKV, DKP, DK>(ks + st1 * kTileKV * DKP, k + (kv_row0 + kv1) * DK,
                                   len - kv1, tid, kThreads);
      stage_tile<kTileKV, DV, DV>(vs + st1 * kTileKV * DV, v + (kv_row0 + kv1) * DV,
                                  len - kv1, tid, kThreads);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile t (and q) have landed
    fence_async_shared();
    __syncthreads();
    const int kv0 = t * kTileKV;
    const int st = t % kStages;
    float s[32] = {};
    qk_product<DKP>(s, qs + 64 * wg * DKP, ks + st * kTileKV * DKP);
    // Chunks some row of the warpgroup sees; the others are exact no-ops
    // (no statistics, p = 0).  No branch around a wgmma depends on it: a
    // branch the compiler cannot prove uniform over the warpgroup makes it
    // serialise every wgmma.
    const int live = min(4, (wg_limit - kv0 + 15) / 16);
    float alpha[4][2];
    const int lim[2] = {hi[0] - kv0 - col, hi[1] - kv0 - col};
    if (kv0 + kTileKV <= wg_min_hi)  // every row of the warpgroup sees every key
      tile_softmax<false>(s, alpha, m, l, lim, cps, live, scale_log2);
    else
      tile_softmax<true>(s, alpha, m, l, lim, cps, live, scale_log2);
    // acc = (..((acc a_0 + P_0 V_0) a_1 + P_1 V_1)..) a_n + P_n V_n over the
    // block_k tiles, written acc (a_0 .. a_n) + sum_u P_u (a_{u+1} .. a_n) V_u:
    // each tile's p takes the later tiles' rescales, then every product
    // goes out at once.  A fully masked tile has a = 1 and p = 0 and stays
    // an exact no-op.
    float later[2] = {1.f, 1.f};
#pragma unroll
    for (int c = 3; c >= 0; --c) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            float& x = s[4 * (2 * c + jj) + 2 * i + cc];
            x = c < live ? x * later[i] : 0.f;
          }
        }
      }
      later[0] *= alpha[c][0];
      later[1] *= alpha[c][1];
    }
    pv_tile<DV>(o, s, later, vs + st * kTileKV * DV);
    __syncthreads();  // every warpgroup is done with stage t % kStages
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = r0 + 8 * i;
    if (p >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* row = out + ((static_cast<size_t>(b) * hq + head) * sq + p) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
    }
    // the row's log-sum-exp in natural units: m is in log2 units; a row that
    // sees no key (l = 0) gets the reference's -1e30 + log(1e-30) = -1e30
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<size_t>(b) * hq + head) * sq + p] =
          l[i] > 0.f ? m[i] * 0.69314718055994530942f + logf(l[i]) : kNegInf;
  }
}

// One 64 x 64 tile of both products on its own, for the tests: s = q k^T
// (q and k 64 x DK) and o = p v (p 64 x 64 float32, split hi + lo; v 64 x
// DV), through the same staging, descriptors and wgmma calls as the kernel.
template <int DK, int DV>
__global__ void __launch_bounds__(128)
tile_probe_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ p,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int DKP = padded_dk(DK);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + 64 * DKP;
  __nv_bfloat16* vs = ks + 64 * DKP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  stage_tile<64, DKP, DK>(qs, q, 64, tid, 128);
  stage_tile<64, DKP, DK>(ks, k, 64, tid, 128);
  stage_tile<64, DV, DV>(vs, v, 64, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_shared();
  __syncthreads();
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
  float s[32] = {};
  qk_product<DKP>(s, qs, ks);
  float pr[32];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int at = (row + 8 * i) * 64 + 8 * j + col + cc;
        s_out[at] = s[4 * j + 2 * i + cc];
        pr[4 * j + 2 * i + cc] = p[at];
      }
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  const float unit[2] = {1.f, 1.f};
  pv_tile<DV>(o, pr, unit, vs);
#pragma unroll
  for (int j = 0; j < DV / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc)
        o_out[(row + 8 * i) * DV + 8 * j + col + cc] = o[4 * j + 2 * i + cc];
}

template <int DK, int DV>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* kv_lens, __nv_bfloat16* out, float* lse, int b, int hk, int g, int sq,
           int skv, int q_offset, int causal, int bk, float scale, cudaStream_t stream) {
  if (bk != 16 && bk != 32 && bk != 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(DK, DV);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kTileQ - 1) / kTileQ, hk * g, b);
  flash_fwd_kernel<DK, DV><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_lens, out, lse, hk, g, sq, skv, q_offset, causal, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int launch_probe(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 const float* p, float* s_out, float* o_out, cudaStream_t stream) {
  const size_t smem = 2 * (2 * 64 * static_cast<size_t>(padded_dk(DK)) + 64 * DV);
  cudaError_t err = cudaFuncSetAttribute(tile_probe_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_probe_kernel<DK, DV><<<1, 128, smem, stream>>>(q, k, v, p, s_out, o_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block needs at key dim dk and value dim dv: q's 128
// rows and two stages of 64 key and value rows, bf16, DK padded to a
// multiple of 16.  g and bk are taken for the interface's sake; the layout
// does not depend on them.
extern "C" int flash_fwd_smem_bytes(int g, int dk, int dv, int bk) {
  (void)g;
  (void)bk;
  return static_cast<int>(smem_bytes(dk, dv));
}

// q (B, Hk*G, Sq, dk), k (B, Hk, Skv, dk), v (B, Hk, Skv, dv), out
// (B, Hk*G, Sq, dv): bf16, contiguous, 16-byte aligned; kv_lens (B,) int32;
// lse (B, Hk*G, Sq) float32, or null for no log-sum-exp.
// (dk, dv) is (d, d) for d a multiple of 16 up to 256, MLA's (192, 128), or
// its smoke variant's (24, 16); bk is 16, 32 or 64.  Returns a cudaError_t
// (0 on success).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                const void* kv_lens, void* out, void* lse, int b, int hk, int g,
                                int sq, int skv, int dk, int dv, int q_offset, int causal,
                                int bk, float scale, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* lens = static_cast<const int*>(kv_lens);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* lf = static_cast<float*>(lse);
  auto* st = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_CASE(DK, DV)                                                               \
  if (dk == DK && dv == DV)                                                                  \
    return launch<DK, DV>(qb, kb, vb, lens, ob, lf, b, hk, g, sq, skv, q_offset, causal, bk, \
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

// The tile probe: q and k (64, dk), v (64, dv) bf16; p (64, 64), s_out
// (64, 64) and o_out (64, dv) float32; all contiguous.  (dk, dv) is (128,
// 128), (192, 128) or (24, 16).  Returns a cudaError_t (0 on success).
extern "C" int flash_fwd_tile_probe(const void* q, const void* k, const void* v, const void* p,
                                    void* s_out, void* o_out, int dk, int dv, void* stream) {
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* pf = static_cast<const float*>(p);
  auto* so = static_cast<float*>(s_out);
  auto* oo = static_cast<float*>(o_out);
  auto* st = static_cast<cudaStream_t>(stream);
  if (dk == 128 && dv == 128) return launch_probe<128, 128>(qb, kb, vb, pf, so, oo, st);
  if (dk == 192 && dv == 128) return launch_probe<192, 128>(qb, kb, vb, pf, so, oo, st);
  if (dk == 24 && dv == 16) return launch_probe<24, 16>(qb, kb, vb, pf, so, oo, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
