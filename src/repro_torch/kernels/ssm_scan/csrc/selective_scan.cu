// Hopper kernel for the Mamba-1 selective scan (K4).
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::selective_scan_pallas (the
// Pallas TPU kernel), and computes what the models call through
// ssm_scan/ops.py::selective_scan (prefill, with an initial state) and
// ops.py::selective_scan_step (the decode step, S = 1):
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t
//   y_t = sum_n C_t[n] h_t[:, n] + D x_t
// with the state h (Bt, Dn, N) float32 read as h0 and overwritten with the
// state after the last step, in place.  So one launch at S = 1 is a layer's
// whole decode-step scan for every slot of the batch.
//
// The recurrence is an associative scan over the pairs (a_t, b_t) =
// (exp(dt_t A), (dt_t x_t) B_t) with (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2),
// the formulation of the reference's model-facing ssm_scan/ops.py::
// selective_scan (a chunked associative scan, _combine).
//
// What bounds it on this card, at the prefill shape (B 1, S 1024, Dn 8192,
// N 16, x and y bf16): the bytes are x and y at 16.8 MB each, dt (float32)
// at 33.6 MB, and A, B, C, D and the state's read and write under 1.2 MB,
// about 68 MB or 0.020 ms at 3.35 TB/s; the operations are S Dn N = 134 M
// exponentials, about 0.032 ms at the special-function units' 16 a clock
// per SM (132 SMs at 1.98 GHz), and about 7 float32 operations per (t, d, n),
// 0.94 GFLOP or 0.014 ms at 67 TFLOP/s.  So the exponentials bound it, at
// about 0.03 ms.  At the decode shape (B 8, S 1) the state's read and write,
// 8.4 MB, bound it at about 2.5 us.
//
// Prefill body (S > 1): threads along time.  A block of 8 warps owns d_block
// channels (8, 16 or 32: the tuner's knob) of one sequence and walks the
// sequence in tiles of 256 positions anchored at position 0.  For each tile
// the block stages B and C (all N states) and the channels' x and dt in
// shared memory as float32, once for all its channels: thread t loads
// position t's rows (16-byte loads where aligned), and a lane reads its 8
// positions of a row in two 16-byte reads (tile_slot).  Staging is not
// overlapped with the scan inside a block: the SM's blocks (three at
// d_block 16) overlap each other instead, as loading a tile ahead into
// registers would cost a block an SM.  Positions past S
// are staged as x = dt = B = C = 0, which gives the pair (1, 0), the scan's
// identity, at its place in the tree.  A warp takes one channel's tile at a
// time (channels c, c + 8, ... of the block), lane l the 8 consecutive
// positions 8 l .. 8 l + 7; for each state n it
//   - forms the 8 pairs (a_i, b_i) and their product in order, serially;
//   - scans the 32 lanes' products with __shfl_up_sync in five stages
//     (Hillis-Steele, an inclusive scan);
//   - applies it to the state carried in from the previous tile (the
//     initial state for the first): the state after lane l - 1 is
//     a_scan * carry + b_scan, and lane l runs its 8 steps h = a_i h + b_i
//     from it, adding C_i[n] h_i into y_i, which stays in registers across n.
// The state after the tile's last position (lane 31's last step) is carried
// to the next tile through shared memory.  So per (t, d, n) there is one
// exponential, a few float32 operations and about 1.3 shuffles, and y needs
// no per-step shuffle tree.  The tile, the 8 positions a lane and every
// level of the tree are fixed in the kernel: they depend on neither S nor
// d_block, so every d_block gives the same bits.  Identity pairs, and the
// pairs (1, +-0) of a padded position (dt = 0), leave every value they meet
// bit for bit, so the state after position n - 1 has the same bits whatever
// the padded length S >= n, and a tile boundary changes nothing but the
// carry.
//
// Decode body (S = 1): one thread a (sequence, channel), its N states read
// and written once (16-byte accesses where aligned), y summed in registers,
// no staging and no barrier; the same operations in the same order as the
// prefill body at S = 1, so the two agree bit for bit.
//
// Arithmetic: float32.  The exponential is ex2.approx on dt (A log2 e)
// (relative error about 2^-22; ex2(0) = 1 exactly, so dt = 0 holds the
// state); each pair's b and each combine's b are one fused multiply-add
// (a b' + b''), y_t's sum over n is fused multiply-adds in order of n, and
// every other operation is rounded on its own (__fmul_rn, __fadd_rn), so the
// compiler contracts nothing and the decode body repeats the prefill body's
// bits.  The association differs from the plain version's serial loop
// by a few float32 roundings a step, which decay with the state.
//
// For training the prefill body also stores the state before each tile
// (h_tiles), from which the backward (selective_scan_bwd.cu) restarts each
// tile; the tile, its lane scan and the staged rows' layout live in
// scan_tile.cuh, which both kernels include.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStepThreads = 256;     // the decode body's block

__host__ __device__ inline size_t smem_bytes(int n, int d_block) {
  // B and C [n][kLd]; x then y, and dt [d_block][kLd]; carries [2][d_block][n]
  return (static_cast<size_t>(2 * n + 2 * d_block) * kLd +
          2 * static_cast<size_t>(d_block) * n) * 4;
}

template <typename T, int N, int DB>
__global__ void __launch_bounds__(kThreads)
selective_scan_tile_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a_mat, const T* __restrict__ b_mat,
                           const T* __restrict__ c_mat, const float* __restrict__ d_vec,
                           float* __restrict__ h, T* __restrict__ y,
                           float* __restrict__ h_tiles, int s, int dn, long long b_sb,
                           long long b_st, long long c_sb, long long c_st, int vec) {
  static_assert(kThreads == kTile, "a thread stages one position of a tile");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;               // [N][kLd]
  float* cs = bs + N * kLd;       // [N][kLd]
  float* xs = cs + N * kLd;       // [DB][kLd], x, then y
  float* dts = xs + DB * kLd;     // [DB][kLd]
  float* hs = dts + DB * kLd;     // [2][DB][N], the carried states

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * DB;
  const size_t row0 = static_cast<size_t>(b) * s;  // row of (b, t = 0) in x, dt, y

  for (int i = tid; i < DB * N; i += kThreads) {
    const int d = d0 + i / N;
    hs[i] = d < dn ? h[(static_cast<size_t>(b) * dn + d) * N + i % N] : 0.f;
  }

  const int n_tiles = (s + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kTile;
    if (h_tiles != nullptr) {  // the state before the tile, for the backward
      // each thread stores the carries it loaded (tile 0) or that a barrier
      // has published since (the tile before's last steps)
      const float* carry = hs + (tile & 1) * DB * N;
      for (int i = tid; i < DB * N; i += kThreads) {
        const int d = d0 + i / N;
        if (d < dn) {
          h_tiles[((static_cast<size_t>(b) * n_tiles + tile) * dn + d) * N + i % N] = carry[i];
        }
      }
    }
    // staging: thread t loads position t0 + t's row of B and C (the N
    // states) and of x and dt (the block's channels), 16 bytes a load where
    // aligned, and stores it where the lanes that scan it read it
    {
      const int t = tid;
      const long long tt = t0 + t;
      const bool in = tt < s;
      const long long row = in ? tt : 0;
      RawRow<T, N> br, cr;
      br.load(b_mat + b * b_sb + row * b_st, in, vec & 1);
      cr.load(c_mat + b * c_sb + row * c_st, in, vec & 1);
      const bool full = in && d0 + DB <= dn;  // a ragged channel block goes one by one
      const size_t off = (row0 + row) * dn + d0;
      RawRow<T, DB> xr;
      RawRow<float, DB> dr;
      if (full) {
        xr.load(x + off, true, vec & 2);
        dr.load(dt + off, true, vec & 2);
      } else {
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          const bool ok = in && d0 + c < dn;
          xs[c * kLd + tile_slot(t)] = ok ? to_float(x[off + c]) : 0.f;
          dts[c * kLd + tile_slot(t)] = ok ? dt[off + c] : 0.f;
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        bs[n * kLd + tile_slot(t)] = br.at(n);
        cs[n * kLd + tile_slot(t)] = cr.at(n);
      }
      if (full) {
#pragma unroll
        for (int c = 0; c < DB; ++c) {
          xs[c * kLd + tile_slot(t)] = xr.at(c);
          dts[c * kLd + tile_slot(t)] = dr.at(c);
        }
      }
    }
    __syncthreads();
    const float* carry_in = hs + (tile & 1) * DB * N;
    float* carry_out = hs + ((tile + 1) & 1) * DB * N;
    for (int c = warp; c < DB; c += kWarps) {
      const int d = d0 + c;
      if (d >= dn) break;  // warp-uniform: channels past Dn
      float dtv[kItems], xv[kItems], dtx[kItems], dx[kItems], acc[kItems];
      const float dd = d_vec[d];
      read8(dts + c * kLd, lane, dtv);
      read8(xs + c * kLd, lane, xv);
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        dtx[i] = __fmul_rn(dtv[i], xv[i]);
        dx[i] = __fmul_rn(dd, xv[i]);
        acc[i] = 0.f;
      }
      const float* arow = a_mat + static_cast<size_t>(d) * N;
      float a_n = arow[0];
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        const float a2 = __fmul_rn(a_n, kLog2e);
        if (n + 1 < N) a_n = arow[n + 1];  // the next state's, ahead of its use
        float av[kItems], bv[kItems], bn[kItems], cn[kItems];
        read8(bs + n * kLd, lane, bn);
        read8(cs + n * kLd, lane, cn);
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          av[i] = ex2(__fmul_rn(dtv[i], a2));
          bv[i] = __fmul_rn(dtx[i], bn[i]);
        }
        float hv = state_before_lane(av, bv, carry_in[c * N + n], lane);
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          hv = __fmaf_rn(av[i], hv, bv[i]);
          acc[i] = __fmaf_rn(cn[i], hv, acc[i]);
        }
        if (lane == 31) carry_out[c * N + n] = hv;
      }
#pragma unroll
      for (int i = 0; i < kItems; ++i) acc[i] = __fadd_rn(acc[i], dx[i]);
      write8(xs + c * kLd, lane, acc);
    }
    __syncthreads();
    {
      const int t = tid;
      if (t0 + t < s) {
        T* dst = y + (row0 + t0 + t) * dn + d0;
        alignas(16) T out[DB];
#pragma unroll
        for (int c = 0; c < DB; ++c) out[c] = from_float<T>(xs[c * kLd + tile_slot(t)]);
        if (RawRow<T, DB>::kWords && (vec & 2) && d0 + DB <= dn) {
#pragma unroll
          for (int q = 0; q < RawRow<T, DB>::kN; ++q) {
            reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(out)[q];
          }
        } else {
#pragma unroll
          for (int c = 0; c < DB; ++c) {
            if (d0 + c < dn) dst[c] = out[c];
          }
        }
      }
    }
    __syncthreads();
  }
  const float* last = hs + (n_tiles & 1) * DB * N;
  for (int i = tid; i < DB * N; i += kThreads) {
    const int d = d0 + i / N;
    if (d < dn) h[(static_cast<size_t>(b) * dn + d) * N + i % N] = last[i];
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kStepThreads)
selective_scan_step_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ a_mat, const T* __restrict__ b_mat,
                           const T* __restrict__ c_mat, const float* __restrict__ d_vec,
                           float* __restrict__ h, T* __restrict__ y, int bt, int dn,
                           long long b_sb, long long c_sb, int vec) {
  const long long i = static_cast<long long>(blockIdx.x) * kStepThreads + threadIdx.x;
  if (i >= static_cast<long long>(bt) * dn) return;
  const int b = static_cast<int>(i / dn);
  const int d = static_cast<int>(i % dn);
  const float dtv = dt[i];
  const float xv = to_float(x[i]);
  const float dtx = __fmul_rn(dtv, xv);
  float hv[N], a2[N];
  float* hrow = h + i * N;
  const float* arow = a_mat + static_cast<size_t>(d) * N;
  if (vec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 hq = reinterpret_cast<const float4*>(hrow)[q];
      const float4 aq = reinterpret_cast<const float4*>(arow)[q];
      hv[4 * q] = hq.x, hv[4 * q + 1] = hq.y, hv[4 * q + 2] = hq.z, hv[4 * q + 3] = hq.w;
      a2[4 * q] = aq.x, a2[4 * q + 1] = aq.y, a2[4 * q + 2] = aq.z, a2[4 * q + 3] = aq.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) hv[n] = hrow[n], a2[n] = arow[n];
  }
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float av = ex2(__fmul_rn(dtv, __fmul_rn(a2[n], kLog2e)));
    const float bv = __fmul_rn(dtx, to_float(b_mat[b * b_sb + n]));
    hv[n] = __fmaf_rn(av, hv[n], bv);
    acc = __fmaf_rn(to_float(c_mat[b * c_sb + n]), hv[n], acc);
  }
  y[i] = from_float<T>(__fadd_rn(acc, __fmul_rn(d_vec[d], xv)));
  if (vec) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      reinterpret_cast<float4*>(hrow)[q] =
          make_float4(hv[4 * q], hv[4 * q + 1], hv[4 * q + 2], hv[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) hrow[n] = hv[n];
  }
}

template <typename T, int N, int DB>
int launch_tile(const void* x, const void* dt, const void* a_mat, const void* b_mat,
                const void* c_mat, const void* d_vec, void* h, void* y, void* h_tiles, int bt,
                int s, int dn, long long b_sb, long long b_st, long long c_sb, long long c_st,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(N, DB);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(selective_scan_tile_kernel<T, N, DB>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte staging: bit 0 for the rows of B and C, bit 1 for x, dt and y
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long sz = sizeof(T);
  const int vec = (a16(b_mat) && a16(c_mat) && (b_sb * sz) % 16 == 0 && (b_st * sz) % 16 == 0 &&
                   (c_sb * sz) % 16 == 0 && (c_st * sz) % 16 == 0) |
                  (a16(x) && a16(dt) && a16(y) && (dn * sz) % 16 == 0 && dn % 4 == 0) << 1;
  const dim3 grid((dn + DB - 1) / DB, bt);
  selective_scan_tile_kernel<T, N, DB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_mat), static_cast<const T*>(b_mat),
      static_cast<const T*>(c_mat), static_cast<const float*>(d_vec),
      static_cast<float*>(h), static_cast<T*>(y), static_cast<float*>(h_tiles), s, dn, b_sb,
      b_st, c_sb, c_st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_n(const void* x, const void* dt, const void* a_mat, const void* b_mat,
             const void* c_mat, const void* d_vec, void* h, void* y, void* h_tiles, int bt, int s,
             int dn, int d_block, long long b_sb, long long b_st, long long c_sb, long long c_st,
             cudaStream_t stream) {
  if (s == 1 && h_tiles == nullptr) {
    const bool vec = ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(a_mat)) &
                      15) == 0;
    const long long threads = static_cast<long long>(bt) * dn;
    const unsigned blocks = static_cast<unsigned>((threads + kStepThreads - 1) / kStepThreads);
    selective_scan_step_kernel<T, N><<<blocks, kStepThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(a_mat), static_cast<const T*>(b_mat),
        static_cast<const T*>(c_mat), static_cast<const float*>(d_vec),
        static_cast<float*>(h), static_cast<T*>(y), bt, dn, b_sb, c_sb, vec);
    return static_cast<int>(cudaGetLastError());
  }
  switch (d_block) {
#define SSM_DB(DB) \
    case DB:                                                                      \
      return launch_tile<T, N, DB>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, h_tiles, bt, s, dn, \
                                   b_sb, b_st, c_sb, c_st, stream);
    SSM_DB(8) SSM_DB(16) SSM_DB(32)
#undef SSM_DB
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_t(const void* x, const void* dt, const void* a_mat, const void* b_mat,
             const void* c_mat, const void* d_vec, void* h, void* y, void* h_tiles, int bt, int s,
             int dn, int n, int d_block, long long b_sb, long long b_st, long long c_sb,
             long long c_st, cudaStream_t stream) {
  switch (n) {
#define SSM_CASE(N) \
    case N:                                                                          \
      return launch_n<T, N>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, h_tiles, bt, s, dn, d_block, \
                            b_sb, b_st, c_sb, c_st, stream);
    SSM_CASE(4) SSM_CASE(8) SSM_CASE(16) SSM_CASE(32)
#undef SSM_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (Bt, S, Dn) bf16 (x_is_bf16 = 1) or float32, contiguous; dt (Bt, S, Dn)
// float32, contiguous; A (Dn, N) and D (Dn,) float32; B and C (Bt, S, N) in
// x's type, element (b, t, n) at b * sb + t * st + n; h (Bt, Dn, N) float32,
// read and overwritten; y (Bt, S, Dn) in x's type.  N is 4, 8, 16 or 32;
// d_block (channels a block of the prefill body) 8, 16 or 32; S = 1 runs the
// decode body, which has no d_block.  h_tiles, when not null, (Bt,
// ceil(S / 256), Dn, N) float32, receives the state before each tile of 256
// positions (the backward's restarts); it takes the prefill body at any S and
// changes no bit of y or h.  Returns a cudaError_t (0 on success).
extern "C" int selective_scan_launch(const void* x, const void* dt, const void* a_mat,
                                     const void* b_mat, const void* c_mat, const void* d_vec,
                                     void* h, void* y, void* h_tiles, int bt, int s, int dn,
                                     int n, int x_is_bf16, int d_block, long long b_sb,
                                     long long b_st, long long c_sb, long long c_st,
                                     void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch_t<__nv_bfloat16>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, h_tiles, bt, s, dn,
                                   n, d_block, b_sb, b_st, c_sb, c_st, st);
  }
  return launch_t<float>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, h_tiles, bt, s, dn, n,
                         d_block, b_sb, b_st, c_sb, c_st, st);
}

// Shared memory one block of the prefill body needs at state size n and
// d_block channels a block.
extern "C" int selective_scan_smem_bytes(int n, int d_block) {
  return static_cast<int>(smem_bytes(n, d_block));
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
