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
// its G query heads (GQA).  Equal head dims D, multiples of 16 up to 128.
//
// Two kernels, launched in order on the caller's stream:
//   * the dq pass: grid (ceil(Sq / 64), Hq, B), a block per 64 query rows of
//     one query head, four warps of 16 rows.  It first writes delta for its
//     rows (one thread a row, a sum over D in order), then walks the key
//     tiles of 64 positions its rows see, recomputing S = Q K^T and
//     dP = dO V^T, and accumulates dq = ds K;
//   * the dk/dv pass: grid (ceil(Skv / 64), Hk, B), a block per 64 keys of
//     one KV head, four warps of 16 keys.  It walks the G query heads of the
//     group and, for each, the 64-row query tiles that see its keys,
//     recomputing S^T = K Q^T and dP^T = V dO^T, and accumulates dv = P^T dO
//     and dk = ds^T Q.  Each block owns its keys' sums over every query head
//     of the group, so GQA needs no atomics.
// The sum order is fixed by the blocking (key tiles in order for dq; query
// heads, then query tiles, in order for dk and dv; each product's k-steps in
// order), so two runs give the same bits.
//
// Arithmetic.  The products run on the tensor cores (mma.sync m16n8k16,
// bf16 operands, float32 accumulation; a product of two bf16 values is exact
// in float32).  Q, K, V and dO are bf16 inputs.  p and ds are float32 values
// the reference multiplies at float32 precision; a single bf16 copy would
// err by 2^-9 of each, so, as in the forward, each is split into two bf16
// values, hi = bf16(x) and lo = bf16(x - hi), and both products go into the
// float32 accumulator (hi + lo within about 2^-17 of x).  p = 2^(s scale
// log2(e) - lse log2(e)) by ex2.approx; the masks select p and ds to 0, so
// a masked position contributes exactly nothing whatever its inputs.  Key
// positions at or past kv_len and query rows at or past Sq are zero-filled
// when staged.  dq and dk are scaled once at the end; all three are written
// in bf16.
//
// Staging: 16-byte cp.async copies into row-major shared-memory tiles whose
// rows are padded by 8 elements (16 bytes), so that the fragment loads of
// eight rows fall on distinct banks.  The streamed operand (K and V in the
// dq pass, Q, dO, lse and delta in the dk/dv pass) goes through a ring of
// two stages, the next tile's copies in flight while the current one is
// computed.  Fully masked tiles are not visited.  The kernels allocate
// nothing and do not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // four warps
constexpr int kTile = 64;      // query rows or key positions a tile
constexpr float kLog2e = 1.44269504088896340736f;

template <int D>
constexpr int kLd = D + 8;  // padded row length of a shared-memory tile, in elements

template <int D>
constexpr size_t tile_elems = static_cast<size_t>(kTile) * kLd<D>;

// dq pass: Q, dO, and two stages of K and V tiles
template <int D>
constexpr size_t dq_smem_bytes = 2 * (2 + 2 * 2) * tile_elems<D>;
// dk/dv pass: K, V, two stages of Q and dO tiles, and of lse and delta
template <int D>
constexpr size_t dkdv_smem_bytes = 2 * (2 + 2 * 2) * tile_elems<D> + 2 * 2 * kTile * 4;

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

// Stages rows [0, kTile) of a row-major (rows, D) bf16 matrix starting at
// src into dst (row stride kLd<D>); rows at or past n_rows are zero-filled
// and not read (their copies read 0 bytes from base, a valid address).
template <int D>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                      const __nv_bfloat16* base, int n_rows, int tid) {
  constexpr int kChunks = D / 8;
  for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool valid = r < n_rows;
    cp_async_16(dst + r * kLd<D> + c * 8, valid ? src + static_cast<size_t>(r) * D + c * 8 : base,
                valid);
  }
}

// ---------------------------------------------------------------- mma

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments, for lane = 4 g + t.  A (16 x 16): a0 (row g, cols 2t, 2t + 1),
// a1 (row g + 8, the same cols), a2 and a3 the same rows at cols + 8.  B (16
// x 8): b0 (k 2t, 2t + 1; n g), b1 (k + 8).  C (16 x 8): c0, c1 (row g, cols
// 2t, 2t + 1), c2, c3 (row g + 8).  The lower half of a bf16 pair holds the
// element of lower index.

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A = m[row0 .., col0 ..] of a row-major tile
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* m, int row0,
                                       int col0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = m + (row0 + g) * kLd<D> + col0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * kLd<D>);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * kLd<D> + 8);
}

// B[k][n] = m[n0 + n][k0 + k]: the tile's rows are B's columns (a product
// with the tile transposed, such as Q K^T with m = K)
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2], const __nv_bfloat16* m, int n0,
                                            int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = m + (n0 + g) * kLd<D> + k0 + 2 * t;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// B[k][n] = m[k0 + k][n0 + n]: the tile's rows are B's k (a product such as
// ds K with m = K)
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2], const __nv_bfloat16* m, int k0,
                                            int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = m + (k0 + 2 * t) * kLd<D> + n0 + g;
  b[0] = pack2(p[0], p[kLd<D>]);
  b[1] = pack2(p[8 * kLd<D>], p[9 * kLd<D>]);
}

// The A fragments (hi and lo bf16 parts) of columns 16 kc .. 16 kc + 15 of a
// 16 x 64 float32 tile held as eight C fragments x[j] (columns 8j .. 8j + 7).
__device__ __forceinline__ void split_a(const float (&x)[8][4], int kc, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const float* c = x[2 * kc + f / 2] + 2 * (f % 2);
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[0], c[1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(c[0] - hf.x, c[1] - hf.y);
    hi[f] = *reinterpret_cast<const uint32_t*>(&h);
    lo[f] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// acc[8][4] (16 rows x 64 cols) = rows row0 .. of a times the 64 rows of b
// transposed, over D in k-steps of 16: S = Q K^T, dP = dO V^T and their
// transposes.
template <int D>
__device__ __forceinline__ void product_nt(float (&acc)[8][4], const __nv_bfloat16* a,
                                           int row0, const __nv_bfloat16* b, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a<D>(af, a, row0, 16 * kk, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t bf[2];
      load_b_rows<D>(bf, b, 8 * j, 16 * kk, lane);
      mma(acc[j], af, bf);
    }
  }
}

// out (16 x D, D / 8 C fragments) += x (16 x 64 float32, as hi + lo) m (64 x
// D tile, its rows the product's k), the 64 in k-steps of 16 in order.
template <int D>
__device__ __forceinline__ void product_split(float (&out)[D / 8][4], const float (&x)[8][4],
                                              const __nv_bfloat16* m, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t hi[4], lo[4];
    split_a(x, kc, hi, lo);
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      uint32_t bf[2];
      load_b_cols<D>(bf, m, 16 * kc, 8 * jd, lane);
      mma(out[jd], hi, bf);
      mma(out[jd], lo, bf);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; results below 2^-126 flush to 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Writes a 16 x D float32 fragment tile, times `scale`, as bf16 rows row0 +
// g and row0 + g + 8 of dst (row stride D); rows at or past n_rows are not
// written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&x)[D / 8][4],
                                           int row0, int n_rows, float scale, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + g + 8 * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r) * D + 8 * jd + 2 * t) =
          __floats2bfloat162_rn(x[jd][2 * i] * scale, x[jd][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------------------- dq pass

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                    const __nv_bfloat16* __restrict__ out, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int hk, int g, int sq, int skv,
                    int q_offset, int causal, float scale) {
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows first
  const int head = blockIdx.y, b = blockIdx.z;
  const int hq = hk * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + tile_elems<D>;
  __nv_bfloat16* ks = dos + tile_elems<D>;      // stage s at ks + s * tile_elems
  __nv_bfloat16* vs = ks + 2 * tile_elems<D>;   // stage s at vs + s * tile_elems

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int q0 = qt * kTile;
  const int limit = causal ? min(len, q_offset + min(sq, q0 + kTile)) : len;
  const int n_tiles = limit > 0 ? (limit + kTile - 1) / kTile : 0;

  const size_t row0 = (static_cast<size_t>(b) * hq + head) * sq + q0;
  const size_t kv_row0 = (static_cast<size_t>(b) * hk + head / g) * skv;
  stage<D>(qs, q + row0 * D, q, sq - q0, tid);
  stage<D>(dos, dout + row0 * D, dout, sq - q0, tid);
  if (n_tiles > 0) {
    stage<D>(ks, k + kv_row0 * D, k, len, tid);
    stage<D>(vs, v + kv_row0 * D, v, len, tid);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) for the block's rows: one thread a row, over D in
  // order; written for every row, since the dk/dv pass reads it
  __shared__ float dl_s[kTile], lse_s[kTile];
  if (tid < kTile) {
    float acc = 0.f, l = 0.f;
    if (q0 + tid < sq) {
      const __nv_bfloat16* o_row = out + (row0 + tid) * D;
      const __nv_bfloat16* do_row = dout + (row0 + tid) * D;
      for (int c = 0; c < D; ++c)
        acc = fmaf(__bfloat162float(do_row[c]), __bfloat162float(o_row[c]), acc);
      delta[row0 + tid] = acc;
      l = lse[row0 + tid] * kLog2e;
    }
    dl_s[tid] = acc;
    lse_s[tid] = l;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int gq = lane / 4, t4 = lane % 4;
  const int r_local[2] = {16 * warp + gq, 16 * warp + gq + 8};
  float dl[2], ls[2];
  int hi[2];  // the row sees keys [0, hi)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = q0 + r_local[i];
    dl[i] = dl_s[r_local[i]];
    ls[i] = lse_s[r_local[i]];
    hi[i] = p < sq ? (causal ? min(len, q_offset + p + 1) : len) : 0;
  }
  const float scale_log2 = scale * kLog2e;

  float acc_dq[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[jd][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next tile's copies, in flight during this one
      const int kv1 = (t + 1) * kTile, st1 = (t + 1) % 2;
      stage<D>(ks + st1 * tile_elems<D>, k + (kv_row0 + kv1) * D, k, len - kv1, tid);
      stage<D>(vs + st1 * tile_elems<D>, v + (kv_row0 + kv1) * D, v, len - kv1, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kv0 = t * kTile, st = t % 2;
    const __nv_bfloat16* kt = ks + st * tile_elems<D>;
    const __nv_bfloat16* vt = vs + st * tile_elems<D>;
    float s[8][4], dp[8][4];
    product_nt<D>(s, qs, 16 * warp, kt, lane);
    product_nt<D>(dp, dos, 16 * warp, vt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, key = kv0 + 8 * j + 2 * t4 + e % 2;
        const bool valid = key < hi[i];
        const float p = valid ? ex2(s[j][e] * scale_log2 - ls[i]) : 0.f;
        s[j][e] = valid ? p * (dp[j][e] - dl[i]) : 0.f;  // s becomes ds
      }
    product_split<D>(acc_dq, s, kt, lane);
    __syncthreads();  // every warp is done with stage t % 2
  }
  cp_async_wait<0>();
  store_rows<D>(dq + row0 * D, acc_dq, 16 * warp, sq - q0, scale, lane);
}

// ---------------------------------------------------------------- dk/dv pass

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_lens,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int hk, int g, int sq, int skv,
                      int q_offset, int causal, float scale) {
  const int kt = blockIdx.x;  // the earliest keys, which the most rows see, first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int hq = hk * g;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + tile_elems<D>;
  __nv_bfloat16* qs = vs + tile_elems<D>;       // stage s at qs + s * tile_elems
  __nv_bfloat16* dos = qs + 2 * tile_elems<D>;  // stage s at dos + s * tile_elems
  float* lse_s = reinterpret_cast<float*>(dos + 2 * tile_elems<D>);  // stage s at + s * kTile
  float* dl_s = lse_s + 2 * kTile;

  int len = kv_lens[b];
  len = len < 0 ? 0 : (len > skv ? skv : len);
  const int k0 = kt * kTile;
  const int nq = (sq + kTile - 1) / kTile;
  // the first query tile that sees key k0; none when every key of the tile
  // is at or past kv_len
  const int qt0 = causal ? max(0, k0 - q_offset) / kTile : 0;
  const int per_head = k0 < len && qt0 < nq ? nq - qt0 : 0;
  const int n_iters = g * per_head;

  const size_t kv_row0 = (static_cast<size_t>(b) * hk + kvh) * skv + k0;
  stage<D>(ks, k + kv_row0 * D, k, len - k0, tid);
  stage<D>(vs, v + kv_row0 * D, v, len - k0, tid);

  // iteration it: query head kvh * g + it / per_head, query tile qt0 + it % per_head
  auto row_of = [&](int it) {
    const int head = kvh * g + it / per_head;
    return (static_cast<size_t>(b) * hq + head) * sq;
  };
  auto stage_iter = [&](int it, int st) {
    const size_t r0 = row_of(it);
    const int q0 = (qt0 + it % per_head) * kTile;
    stage<D>(qs + st * tile_elems<D>, q + (r0 + q0) * D, q, sq - q0, tid);
    stage<D>(dos + st * tile_elems<D>, dout + (r0 + q0) * D, dout, sq - q0, tid);
    if (tid < kTile) {
      const bool in = q0 + tid < sq;
      lse_s[st * kTile + tid] = in ? lse[r0 + q0 + tid] * kLog2e : 0.f;
      dl_s[st * kTile + tid] = in ? delta[r0 + q0 + tid] : 0.f;
    }
  };
  if (n_iters > 0) stage_iter(0, 0);
  cp_async_commit();

  const int gq = lane / 4, t4 = lane % 4;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = k0 + 16 * warp + gq + 8 * i;
  const float scale_log2 = scale * kLog2e;

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[jd][e] = acc_dv[jd][e] = 0.f;

  for (int it = 0; it < n_iters; ++it) {
    if (it + 1 < n_iters) stage_iter(it + 1, (it + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it % 2;
    const int q0 = (qt0 + it % per_head) * kTile;
    const __nv_bfloat16* qt = qs + st * tile_elems<D>;
    const __nv_bfloat16* dot = dos + st * tile_elems<D>;
    const float* ls = lse_s + st * kTile;
    const float* dl = dl_s + st * kTile;
    float s[8][4], dp[8][4];
    product_nt<D>(s, ks, 16 * warp, qt, lane);   // S^T: this warp's keys x the tile's rows
    product_nt<D>(dp, vs, 16 * warp, dot, lane); // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, col = 8 * j + 2 * t4 + e % 2, row = q0 + col;
        const bool valid =
            key[i] < len && row < sq && (!causal || key[i] <= q_offset + row);
        const float p = valid ? ex2(s[j][e] * scale_log2 - ls[col]) : 0.f;
        dp[j][e] = valid ? p * (dp[j][e] - dl[col]) : 0.f;  // dp becomes ds^T
        s[j][e] = p;                                        // s becomes p^T
      }
    product_split<D>(acc_dv, s, dot, lane);
    product_split<D>(acc_dk, dp, qt, lane);
    __syncthreads();  // every warp is done with stage it % 2
  }
  cp_async_wait<0>();
  const size_t out0 = (static_cast<size_t>(b) * hk + kvh) * skv + k0;
  store_rows<D>(dk + out0 * D, acc_dk, 16 * warp, skv - k0, scale, lane);
  store_rows<D>(dv + out0 * D, acc_dv, 16 * warp, skv - k0, 1.f, lane);
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           const int* kv_lens, const __nv_bfloat16* out, const __nv_bfloat16* dout,
           const float* lse, float* delta, __nv_bfloat16* dq, __nv_bfloat16* dk,
           __nv_bfloat16* dv, int pass, int b, int hk, int g, int sq, int skv, int q_offset,
           int causal, float scale, cudaStream_t stream) {
  if (pass == 0) {
    const size_t smem = dq_smem_bytes<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((sq + kTile - 1) / kTile, hk * g, b);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv_lens, out, dout, lse, delta, dq, hk, g, sq, skv, q_offset, causal, scale);
  } else {
    const size_t smem = dkdv_smem_bytes<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((skv + kTile - 1) / kTile, hk, b);
    flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(
        q, k, v, kv_lens, dout, lse, delta, dk, dv, hk, g, sq, skv, q_offset, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of one block of a pass (0: dq, 1: dk/dv) at head dim d, or 0
// for a d the kernels are not built for.
extern "C" int flash_bwd_smem_bytes(int pass, int d) {
#define FLASH_BWD_SMEM(D) \
  if (d == D) return static_cast<int>(pass == 0 ? dq_smem_bytes<D> : dkdv_smem_bytes<D>);
  FLASH_BWD_SMEM(16) FLASH_BWD_SMEM(32) FLASH_BWD_SMEM(48) FLASH_BWD_SMEM(64)
  FLASH_BWD_SMEM(80) FLASH_BWD_SMEM(96) FLASH_BWD_SMEM(112) FLASH_BWD_SMEM(128)
#undef FLASH_BWD_SMEM
  return 0;
}

// One pass of the backward.  q, out, dout, dq (B, Hk*G, Sq, d); k, v, dk, dv
// (B, Hk, Skv, d): bf16, contiguous, 16-byte aligned; kv_lens (B,) int32; lse
// and delta (B, Hk*G, Sq) float32.  Pass 0 (dq) reads q, k, v, kv_lens, out,
// dout and lse and writes delta and dq; pass 1 (dk/dv) reads q, k, v,
// kv_lens, dout, lse and delta and writes dk and dv, and must follow pass 0
// on the stream.  d is a multiple of 16 up to 128.  Returns a cudaError_t (0
// on success).
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v, const void* kv_lens,
                                const void* out, const void* dout, const void* lse, void* delta,
                                void* dq, void* dk, void* dv, int pass, int b, int hk, int g,
                                int sq, int skv, int d, int q_offset, int causal, float scale,
                                void* stream) {
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
  if (pass != 0 && pass != 1) return static_cast<int>(cudaErrorInvalidValue);
#define FLASH_BWD_CASE(D)                                                                   \
  if (d == D)                                                                               \
    return launch<D>(qb, kb, vb, lens, ob, dob, lf, df, dqb, dkb, dvb, pass, b, hk, g, sq, \
                     skv, q_offset, causal, scale, st);
  FLASH_BWD_CASE(16) FLASH_BWD_CASE(32) FLASH_BWD_CASE(48) FLASH_BWD_CASE(64)
  FLASH_BWD_CASE(80) FLASH_BWD_CASE(96) FLASH_BWD_CASE(112) FLASH_BWD_CASE(128)
#undef FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
