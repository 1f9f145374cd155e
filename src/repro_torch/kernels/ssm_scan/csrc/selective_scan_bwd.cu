// Hopper kernel for the selective scan's backward (K4-bwd).
//
// Replaces no Pallas kernel: the reference differentiates its chunked
// associative scan (src/repro/kernels/ssm_scan/ops.py::selective_scan, the
// chunk body under jax.checkpoint) by JAX autodiff.  It is the gradient of
// K4's forward (selective_scan.cu) for training:
//   h_t = a_t h_{t-1} + b_t,  a_t = exp(dt_t A),  b_t = (dt_t x_t) B_t
//   y_t = sum_n C_t[n] h_t[:, n] + D x_t
// from zero state, given dy.  With the adjoint g_t = dL/dh_t, the reverse
// recurrence g_t = a_{t+1} g_{t+1} + dy_t C_t (g past the end 0):
//   dx_t  = D dy_t + dt_t sum_n g_t[n] B_t[n]
//   ddt_t = sum_n g_t[n] A[n] a_t[n] h_{t-1}[n] + x_t sum_n g_t[n] B_t[n]
//   dA    = sum_{b,t} dt_t g_t a_t h_{t-1}       dD = sum_{b,t} dy_t x_t
//   dB_t[n] = sum_d g_t[d, n] dt_t[d] x_t[d]     dC_t[n] = sum_d dy_t[d] h_t[d, n]
// (ref.py::selective_scan_bwd_ref is the plain version.)
//
// Two launches, no atomics, so the same inputs give the same bits:
//  1. selective_scan_bwd_kernel: a block owns d_block channels (a multiple
//     of 8) of one sequence and walks its tiles of 256 positions in reverse
//     (scan_tile.cuh's tiles).  For each tile it stages B and C (all N
//     states), then takes its channels 8 at a time (a round: warp w the
//     round's channel w), staging their x, dt and dy.  For each state n,
//     in lockstep across the warps:
//       - it recomputes the tile's states h from the state the forward
//         stored before the tile (h_tiles), with the forward's own lane scan
//         (scan_tile.cuh::state_before_lane), so they carry its bits;
//       - it scans the adjoint in reverse as the same kind of lane-parallel
//         associative scan over the pairs (a_{t+1}, dy_t C_t[n]) with
//         __shfl_down_sync; the carry from the tile after is a_{t0'} g_{t0'}
//         at that tile's first position t0', so a tile's last position needs
//         no look ahead past the tile;
//       - it sums dx's and ddt's terms over n in registers, dA's over the
//         lane's 8 positions, then over the warp (xor butterfly), then over
//         tiles in shared memory;
//       - it writes each warp's dB and dC terms to shared memory, and after
//         one barrier thread t sums position t's over the 8 warps in order
//         into the tile's sums (two buffers, so one barrier a state).
//     After a round the warps write dx and ddt; after a tile thread t writes
//     position t's dB and dC sums over the block's channels as the block's
//     partials; at the end the block writes its sequence's dA and dD.
//  2. selective_scan_bwd_reduce_kernel: sums the partials in a fixed order
//     (dB and dC over the channel blocks, dA and dD over the sequences) into
//     the outputs.
// Padded positions (past S: x = dt = dy = B = C = 0) give the pair (1, 0) and
// an adjoint of 0, and channels past Dn zeros: each adds exactly zero.
//
// What bounds it on this card, at the training shape (B 8, S 128, Dn 8192,
// N 16, x and dy bf16): the exponentials, S Dn N B = 134 M, about 0.031 ms at
// the special-function units' 16 a clock per SM (132 SMs at 1.98 GHz);
// the bytes: x, dy and dx (bf16) 16.8 MB each, dt and ddt (float32) 33.6 MB
// each, the tile states 4.2 MB, about 123 MB or 0.037 ms at 3.35 TB/s, which
// bound it.  The design adds the partials of dB and dC, written and read
// again (2 x 2 x Dn / d_block x B S N x 4 bytes: 33.6 MB at d_block 64).  The
// tile of 256 positions is half padding at S 128, so the kernel computes
// twice the exponentials the bound counts; the lockstep barrier a state, and
// one block of 8 warps an SM (its shared memory), hold it further from the
// bound.  A cluster's reduction of the partials through distributed shared
// memory, as K3-bwd's dk/dv pass does, would save their traffic; a correct,
// simple kernel comes first.
//
// Arithmetic: float32, each operation rounded on its own (__fmul_rn,
// __fadd_rn) or fused where written (__fmaf_rn), so the compiler contracts
// nothing.  The kernel launches on the caller's stream, allocates nothing and
// does not synchronise.
#include "scan_tile.cuh"

namespace {

using namespace scan_tile;

constexpr int kWarps = 8;                 // channels a round, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceThreads = 256;

__host__ __device__ inline size_t bwd_smem_bytes(int n, int d_block) {
  // B and C [n][kLd]; x (then dx), dt (then ddt), dy [kWarps][kLd]; the
  // tile's dB and dC sums [2][n][kLd]; the warps' terms [2 buffers][2][kWarps]
  // [kLd]; the adjoint carries [2][d_block][n]; dA's sums [d_block][n]; dD's
  // [d_block]
  const size_t floats = static_cast<size_t>(4 * n + 3 * kWarps + 4 * kWarps) * kLd +
                        3 * static_cast<size_t>(d_block) * n + d_block;
  return floats * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ a_mat, const T* __restrict__ b_mat,
                          const T* __restrict__ c_mat, const float* __restrict__ d_vec,
                          const T* __restrict__ dy, const float* __restrict__ h_tiles,
                          T* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ part_b, float* __restrict__ part_c,
                          float* __restrict__ part_a, float* __restrict__ part_d, int bt, int s,
                          int dn, int d_block, long long b_sb, long long b_st, long long c_sb,
                          long long c_st, int vec) {
  static_assert(kThreads == kTile, "a thread stages one position of a tile");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                         // [N][kLd]
  float* cs = bs + N * kLd;                 // [N][kLd]
  float* xs = cs + N * kLd;                 // [kWarps][kLd]: x, then dx
  float* dts = xs + kWarps * kLd;           // [kWarps][kLd]: dt, then ddt
  float* dys = dts + kWarps * kLd;          // [kWarps][kLd]
  float* sum_b = dys + kWarps * kLd;        // [N][kLd]
  float* sum_c = sum_b + N * kLd;           // [N][kLd]
  float* terms = sum_c + N * kLd;           // [2][2][kWarps][kLd]
  float* gs = terms + 4 * kWarps * kLd;     // [2][d_block][N]
  float* das = gs + 2 * d_block * N;        // [d_block][N]
  float* dds = das + d_block * N;           // [d_block]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int d0 = blk * d_block;
  const int rounds = d_block / kWarps;
  const size_t row0 = static_cast<size_t>(b) * s;  // row of (b, t = 0) in x, dt, dy
  const int n_tiles = (s + kTile - 1) / kTile;
  const int slot = tile_slot(tid);

  for (int i = tid; i < 3 * d_block * N + d_block; i += kThreads) gs[i] = 0.f;  // gs, das, dds
  int step = 0;  // (round, state) steps taken: the terms' buffer parity

  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile;
    const int back = n_tiles - 1 - tile;  // tiles walked before this one
    const float* g_in = gs + (back & 1) * d_block * N;
    float* g_out = gs + ((back + 1) & 1) * d_block * N;
    const bool in = t0 + tid < s;
    const long long row = in ? t0 + tid : 0;
    {  // B and C of position t0 + tid; the tile's sums zeroed (own column)
      RawRow<T, N> br, cr;
      br.load(b_mat + b * b_sb + row * b_st, in, vec & 1);
      cr.load(c_mat + b * c_sb + row * c_st, in, vec & 1);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        bs[n * kLd + slot] = br.at(n);
        cs[n * kLd + slot] = cr.at(n);
        sum_b[n * kLd + slot] = 0.f;
        sum_c[n * kLd + slot] = 0.f;
      }
    }
    for (int r = 0; r < rounds; ++r) {
      const int dr = d0 + r * kWarps;  // the round's first channel
      {  // x, dt and dy of position t0 + tid at the round's 8 channels
        const size_t off = (row0 + row) * dn + dr;
        if (in && dr + kWarps <= dn) {
          RawRow<T, kWarps> xr, yr;
          RawRow<float, kWarps> tr;
          xr.load(x + off, true, vec & 2);
          yr.load(dy + off, true, vec & 2);
          tr.load(dt + off, true, vec & 2);
#pragma unroll
          for (int c = 0; c < kWarps; ++c) {
            xs[c * kLd + slot] = xr.at(c);
            dys[c * kLd + slot] = yr.at(c);
            dts[c * kLd + slot] = tr.at(c);
          }
        } else {  // past S, or a ragged channel round: one by one, zeros outside
#pragma unroll
          for (int c = 0; c < kWarps; ++c) {
            const bool ok = in && dr + c < dn;
            xs[c * kLd + slot] = ok ? to_float(x[off + c]) : 0.f;
            dys[c * kLd + slot] = ok ? to_float(dy[off + c]) : 0.f;
            dts[c * kLd + slot] = ok ? dt[off + c] : 0.f;
          }
        }
      }
      __syncthreads();
      const int c = r * kWarps + warp;  // the warp's channel in the block
      const int d = d0 + c;
      const bool live = d < dn;  // not warp-exiting: every warp meets every barrier
      float dtv[kItems], xv[kItems], dyv[kItems], dtx[kItems], s1[kItems], s2[kItems];
      read8(dts + warp * kLd, lane, dtv);
      read8(xs + warp * kLd, lane, xv);
      read8(dys + warp * kLd, lane, dyv);
      float dd_acc = 0.f;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        dtx[i] = __fmul_rn(dtv[i], xv[i]);
        dd_acc = __fmaf_rn(dyv[i], xv[i], dd_acc);
        s1[i] = 0.f;
        s2[i] = 0.f;
      }
      const float* arow = a_mat + static_cast<size_t>(live ? d : 0) * N;
      const float* hrow = h_tiles + ((static_cast<size_t>(b) * n_tiles + tile) * dn +
                                     (live ? d : 0)) * N;
#pragma unroll 1
      for (int n = 0; n < N; ++n) {
        const float a_n = live ? arow[n] : 0.f;
        const float a2 = __fmul_rn(a_n, kLog2e);
        float av[kItems], bv[kItems], bn[kItems], cn[kItems];
        read8(bs + n * kLd, lane, bn);
        read8(cs + n * kLd, lane, cn);
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          av[i] = ex2(__fmul_rn(dtv[i], a2));
          bv[i] = __fmul_rn(dtx[i], bn[i]);
        }
        // the states: hp[i] before position i of the lane, hp[i + 1] after
        float hp[kItems + 1];
        hp[0] = state_before_lane(av, bv, live ? hrow[n] : 0.f, lane);
#pragma unroll
        for (int i = 0; i < kItems; ++i) hp[i + 1] = __fmaf_rn(av[i], hp[i], bv[i]);
        // the adjoint, g_i = alpha_i g_{i+1} + beta_i with alpha_i = a_{i+1}:
        // the lane's pairs combined from its last position down, then the
        // lanes' suffixes by a Hillis-Steele scan with __shfl_down_sync
        const float carry = g_in[c * N + n];  // a_{t0'} g_{t0'} of the tile after
        float beta[kItems];
#pragma unroll
        for (int i = 0; i < kItems; ++i) beta[i] = __fmul_rn(dyv[i], cn[i]);
        const float a_next = __shfl_down_sync(0xffffffffu, av[0], 1);
        const float alpha_last = lane == 31 ? 1.f : a_next;  // lane 31: the carry has it
        float ra = alpha_last, rb = beta[kItems - 1];
#pragma unroll
        for (int i = kItems - 2; i >= 0; --i) {
          rb = __fmaf_rn(av[i + 1], rb, beta[i]);
          ra = __fmul_rn(ra, av[i + 1]);
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          float qa = __shfl_down_sync(0xffffffffu, ra, off);
          float qb = __shfl_down_sync(0xffffffffu, rb, off);
          qa = lane + off < 32 ? qa : 1.f;
          qb = lane + off < 32 ? qb : 0.f;
          rb = __fmaf_rn(ra, qb, rb);
          ra = __fmul_rn(ra, qa);
        }
        const float g_first = __fmaf_rn(ra, carry, rb);  // g at the lane's first position
        float g_next = __shfl_down_sync(0xffffffffu, g_first, 1);
        if (lane == 31) g_next = carry;
        float gv[kItems];
#pragma unroll
        for (int i = kItems - 1; i >= 0; --i) {
          const float alpha = i == kItems - 1 ? alpha_last : av[i + 1];
          gv[i] = __fmaf_rn(alpha, g_next, beta[i]);
          g_next = gv[i];
        }
        if (lane == 0) g_out[c * N + n] = __fmul_rn(av[0], gv[0]);
        // the terms
        float da_acc = 0.f, eb[kItems], ec[kItems];
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const float q = __fmul_rn(__fmul_rn(gv[i], av[i]), hp[i]);
          s1[i] = __fmaf_rn(gv[i], bn[i], s1[i]);
          s2[i] = __fmaf_rn(a_n, q, s2[i]);
          da_acc = __fmaf_rn(dtv[i], q, da_acc);
          eb[i] = __fmul_rn(gv[i], dtx[i]);
          ec[i] = __fmul_rn(dyv[i], hp[i + 1]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          da_acc = __fadd_rn(da_acc, __shfl_xor_sync(0xffffffffu, da_acc, off));
        }
        if (lane == 0) das[c * N + n] = __fadd_rn(das[c * N + n], da_acc);
        float* tb = terms + (step & 1) * 2 * kWarps * kLd;
        float* tc = tb + kWarps * kLd;
        write8(tb + warp * kLd, lane, eb);
        write8(tc + warp * kLd, lane, ec);
        ++step;
        __syncthreads();
        float sb = tb[slot], sc = tc[slot];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          sb = __fadd_rn(sb, tb[w * kLd + slot]);
          sc = __fadd_rn(sc, tc[w * kLd + slot]);
        }
        sum_b[n * kLd + slot] = __fadd_rn(sum_b[n * kLd + slot], sb);
        sum_c[n * kLd + slot] = __fadd_rn(sum_c[n * kLd + slot], sc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dd_acc = __fadd_rn(dd_acc, __shfl_xor_sync(0xffffffffu, dd_acc, off));
      }
      if (lane == 0) dds[c] = __fadd_rn(dds[c], dd_acc);
      const float dd = live ? d_vec[d] : 0.f;
      float dxv[kItems], ddtv[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        dxv[i] = __fmaf_rn(dtv[i], s1[i], __fmul_rn(dd, dyv[i]));
        ddtv[i] = __fmaf_rn(xv[i], s1[i], s2[i]);
      }
      write8(xs + warp * kLd, lane, dxv);
      write8(dts + warp * kLd, lane, ddtv);
      __syncthreads();
      if (in) {  // dx and ddt of position t0 + tid at the round's channels
        const size_t off = (row0 + t0 + tid) * dn + dr;
        alignas(16) T gx[kWarps];
        alignas(16) float gt[kWarps];
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          gx[k] = from_float<T>(xs[k * kLd + slot]);
          gt[k] = dts[k * kLd + slot];
        }
        if ((vec & 2) && dr + kWarps <= dn) {
#pragma unroll
          for (int q = 0; q < RawRow<T, kWarps>::kN; ++q) {
            reinterpret_cast<uint4*>(dx + off)[q] = reinterpret_cast<const uint4*>(gx)[q];
          }
#pragma unroll
          for (int q = 0; q < kWarps / 4; ++q) {
            reinterpret_cast<float4*>(ddt + off)[q] = reinterpret_cast<const float4*>(gt)[q];
          }
        } else {
#pragma unroll
          for (int k = 0; k < kWarps; ++k) {
            if (dr + k < dn) dx[off + k] = gx[k], ddt[off + k] = gt[k];
          }
        }
      }
      __syncthreads();  // the round's rows are free for the next round's
    }
    if (in) {  // position t0 + tid's dB and dC over the block's channels
      const size_t off = ((static_cast<size_t>(blk) * bt + b) * s + t0 + tid) * N;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        part_b[off + n] = sum_b[n * kLd + slot];
        part_c[off + n] = sum_c[n * kLd + slot];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < d_block * N; i += kThreads) {
    const int d = d0 + i / N;
    if (d < dn) part_a[(static_cast<size_t>(b) * dn + d) * N + i % N] = das[i];
  }
  for (int i = tid; i < d_block; i += kThreads) {
    if (d0 + i < dn) part_d[static_cast<size_t>(b) * dn + d0 + i] = dds[i];
  }
}

// One output of the second pass: out[i] = sum over k of part[k count + i],
// k in order, stored as bf16 or float32.
struct Segment {
  const float* part;
  void* out;
  long long count;
  int n_parts;
  int out_bf16;
};
struct Segments {
  Segment seg[4];
};

__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(Segments segs) {
  const Segment sg = segs.seg[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * kReduceThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
       i < sg.count; i += stride) {
    float acc = sg.part[i];
    for (int k = 1; k < sg.n_parts; ++k) acc = __fadd_rn(acc, sg.part[k * sg.count + i]);
    if (sg.out_bf16) {
      static_cast<__nv_bfloat16*>(sg.out)[i] = __float2bfloat16(acc);
    } else {
      static_cast<float*>(sg.out)[i] = acc;
    }
  }
}

template <typename T, int N>
int launch_bwd(const void* x, const void* dt, const void* a_mat, const void* b_mat,
               const void* c_mat, const void* d_vec, const void* dy, const void* h_tiles,
               void* dx, void* ddt, void* part_b, void* part_c, void* part_a, void* part_d,
               int bt, int s, int dn, int d_block, long long b_sb, long long b_st,
               long long c_sb, long long c_st, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(N, d_block);
  const cudaError_t attr = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, N>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // 16-byte rows: bit 0 for B and C, bit 1 for x, dt, dy, dx and ddt
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long sz = sizeof(T);
  const int vec = (a16(b_mat) && a16(c_mat) && (b_sb * sz) % 16 == 0 && (b_st * sz) % 16 == 0 &&
                   (c_sb * sz) % 16 == 0 && (c_st * sz) % 16 == 0) |
                  (a16(x) && a16(dt) && a16(dy) && a16(dx) && a16(ddt) && (dn * sz) % 16 == 0 &&
                   dn % 4 == 0) << 1;
  const dim3 grid((dn + d_block - 1) / d_block, bt);
  selective_scan_bwd_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a_mat),
      static_cast<const T*>(b_mat), static_cast<const T*>(c_mat),
      static_cast<const float*>(d_vec), static_cast<const T*>(dy),
      static_cast<const float*>(h_tiles), static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(part_b), static_cast<float*>(part_c), static_cast<float*>(part_a),
      static_cast<float*>(part_d), bt, s, dn, d_block, b_sb, b_st, c_sb, c_st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_t(const void* x, const void* dt, const void* a_mat, const void* b_mat,
                 const void* c_mat, const void* d_vec, const void* dy, const void* h_tiles,
                 void* dx, void* ddt, void* part_b, void* part_c, void* part_a, void* part_d,
                 int bt, int s, int dn, int n, int d_block, long long b_sb, long long b_st,
                 long long c_sb, long long c_st, cudaStream_t stream) {
  switch (n) {
#define SSM_BWD_CASE(N)                                                                      \
    case N:                                                                                  \
      return launch_bwd<T, N>(x, dt, a_mat, b_mat, c_mat, d_vec, dy, h_tiles, dx, ddt,        \
                              part_b, part_c, part_a, part_d, bt, s, dn, d_block, b_sb, b_st, \
                              c_sb, c_st, stream);
    SSM_BWD_CASE(4) SSM_BWD_CASE(8) SSM_BWD_CASE(16) SSM_BWD_CASE(32)
#undef SSM_BWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The first pass.  x, dy (Bt, S, Dn) bf16 (x_is_bf16 = 1) or float32 and dt
// (Bt, S, Dn) float32, contiguous; A (Dn, N), D (Dn,) float32; B and C (Bt, S,
// N) in x's type, element (b, t, n) at b * sb + t * st + n; h_tiles (Bt,
// ceil(S / 256), Dn, N) float32, the forward's states before each tile
// (selective_scan_launch's h_tiles).  Writes dx (Bt, S, Dn) in x's type and
// ddt (Bt, S, Dn) float32, and the partials: part_b and part_c (ceil(Dn /
// d_block), Bt, S, N), part_a (Bt, Dn, N), part_d (Bt, Dn), float32.  N is 4,
// 8, 16 or 32; d_block a positive multiple of 8.  Returns a cudaError_t.
extern "C" int selective_scan_bwd_launch(const void* x, const void* dt, const void* a_mat,
                                         const void* b_mat, const void* c_mat,
                                         const void* d_vec, const void* dy, const void* h_tiles,
                                         void* dx, void* ddt, void* part_b, void* part_c,
                                         void* part_a, void* part_d, int bt, int s, int dn,
                                         int n, int x_is_bf16, int d_block, long long b_sb,
                                         long long b_st, long long c_sb, long long c_st,
                                         void* stream) {
  if (d_block <= 0 || d_block % kWarps != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch_bwd_t<__nv_bfloat16>(x, dt, a_mat, b_mat, c_mat, d_vec, dy, h_tiles, dx, ddt,
                                       part_b, part_c, part_a, part_d, bt, s, dn, n, d_block,
                                       b_sb, b_st, c_sb, c_st, st);
  }
  return launch_bwd_t<float>(x, dt, a_mat, b_mat, c_mat, d_vec, dy, h_tiles, dx, ddt, part_b,
                             part_c, part_a, part_d, bt, s, dn, n, d_block, b_sb, b_st, c_sb,
                             c_st, st);
}

// The second pass: dB = sum of part_b over the channel blocks and dC of
// part_c, in block order, in B's type (bf16 when bc_is_bf16); dA = sum of
// part_a and dD of part_d over the sequences in order, float32.
extern "C" int selective_scan_bwd_reduce_launch(const void* part_b, const void* part_c,
                                                const void* part_a, const void* part_d,
                                                void* db, void* dc, void* da, void* dd, int bt,
                                                int s, int dn, int n, int n_blocks,
                                                int bc_is_bf16, void* stream) {
  Segments segs;
  const long long bsn = static_cast<long long>(bt) * s * n;
  segs.seg[0] = {static_cast<const float*>(part_b), db, bsn, n_blocks, bc_is_bf16};
  segs.seg[1] = {static_cast<const float*>(part_c), dc, bsn, n_blocks, bc_is_bf16};
  segs.seg[2] = {static_cast<const float*>(part_a), da, static_cast<long long>(dn) * n, bt, 0};
  segs.seg[3] = {static_cast<const float*>(part_d), dd, dn, bt, 0};
  long long most = bsn > static_cast<long long>(dn) * n ? bsn : static_cast<long long>(dn) * n;
  long long blocks = (most + kReduceThreads - 1) / kReduceThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  selective_scan_bwd_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), 4), kReduceThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block of the first pass needs at state size n and
// d_block channels a block.
extern "C" int selective_scan_bwd_smem_bytes(int n, int d_block) {
  return static_cast<int>(bwd_smem_bytes(n, d_block));
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
