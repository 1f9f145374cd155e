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
//  1. selective_scan_bwd_kernel: a block of 8 warps owns d_block channels of
//     one sequence and walks its tiles of 256 positions in reverse
//     (scan_tile.cuh's tiles).  A channel's tile is scanned by L lanes of 8
//     positions each: L = 32 in general, and L = 16 when S <= 128, where a
//     tile's second half is padding, so that each half-warp takes a channel
//     of its own and no lane scans padding (a half tile of 128 positions).
//     For each tile the block stages B and C (all N states); then it takes
//     its channels a round at a time (8 warps x 32 / L channels), staging
//     their x, dt and dy, which each lane then keeps in registers with dx's
//     and ddt's sums over n.  For the states n, two at a time (two
//     independent chains, which the compiler may overlap):
//       - it recomputes the tile's states h from the state the forward
//         stored before the tile (h_tiles), with the forward's own lane scan
//         (scan_tile.cuh::state_before_lane at L lanes), so they carry its
//         bits;
//       - it scans the adjoint in reverse as the same kind of lane-parallel
//         associative scan over the pairs (a_{t+1}, dy_t C_t[n]) with
//         __shfl_down_sync; the carry from the tile after is a_{t0'} g_{t0'}
//         at that tile's first position t0', so a tile's last position needs
//         no look ahead past the tile;
//       - it sums dx's and ddt's terms over n in registers, dA's over the
//         lane's 8 positions, then over the channel's lanes (xor butterfly),
//         then over tiles in shared memory;
//       - each warp adds its two channels' dB and dC terms at L = 16 (one
//         shuffle: the lower half-warp keeps dB's sum, the upper dC's) and
//         writes them to shared memory; after one barrier the block sums
//         the 8 warps' terms in warp order into the tile's sums over its
//         channels (the first round's sums written, later rounds' added).
//     So a block meets one barrier a pair of states in a round at L = 16 (two
//     buffers of terms), two at L = 32 (one buffer), and 5 a round besides.
//     After a round the warps write dx and ddt.  After a tile, the blocks of
//     one sequence that own consecutive channel blocks form a thread-block
//     cluster and add their tile's sums through distributed shared memory in
//     rank order, each rank a share of the positions, into one partial of dB
//     and dC per cluster.  The plan takes clusters of 2: at two blocks an SM
//     an H100 holds 132 of them at once, every slot, but only 62 of 4 and 30
//     of 8, which leave a wave part-empty.  At the end the block writes its
//     sequence's dA and dD.
//  2. selective_scan_bwd_reduce_kernel: sums the partials in a fixed order
//     (dB and dC over the clusters, dA and dD over the sequences) into the
//     outputs.
// The sums of dB and dC over the channels thus run: at L = 16 a warp's two
// channels, then the 8 warps in order, then the rounds in order, then the
// cluster's ranks in order, then the clusters in order (ref.py::_channel_sum).
// Padded positions (past S: x = dt = dy = B = C = 0) give the pair (1, 0) and
// an adjoint of 0, and channels past Dn zeros: each adds exactly zero, and a
// half-warp or block past Dn meets every barrier and cluster sync.
//
// What bounds it on this card, at the training shape (B 8, S 128, Dn 8192,
// N 16, x and dy bf16): the exponentials, S Dn N B = 134 M, about 0.032 ms
// at the special-function units' 16 a clock per SM (132 SMs at 1.98 GHz);
// the bytes: x, dy and dx (bf16) 16.8 MB each, dt and ddt (float32) 33.6 MB
// each, about 119 MB or 0.035 ms at 3.35 TB/s, which bound it.  The work of
// a (position, channel, state) is one exponential, about 16 float32
// operations and, per lane of 8 positions, some 20 shuffles of the two lane
// scans and the butterfly; it runs at the SM's rate for those instructions
// where enough independent chains are in flight: two blocks of 8 warps an SM
// (107.5 KB of shared memory a block at the training shape, d_block 256;
// 115 KB at L = 32, d_block 32, N 16; registers capped at 128 a thread by the
// launch bounds).  The design adds to the function's bytes the tile states
// it reads (4.2 MB at the training shape) and the partials of dB and dC,
// written and read again: 2 x 2 x (clusters) x B S N x 4 bytes, 4.2 MB at the
// training shape (16 clusters of 2 blocks of 256 channels a sequence).  The
// channels a block (ops.py::default_bwd_d_block) halve while the grid would
// not cover the SMs once, which keeps every SM busy at B 1 and long S.
//
// Arithmetic: float32, each operation rounded on its own (__fmul_rn,
// __fadd_rn) or fused where written (__fmaf_rn), so the compiler contracts
// nothing.  The kernel launches on the caller's stream, allocates nothing and
// does not synchronise.
#include <cooperative_groups.h>

#include "scan_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace scan_tile;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceThreads = 256;
constexpr int kBatch = 8;       // partials a thread of the reduction loads at once
constexpr int kMaxCluster = 8;  // blocks a cluster, the portable limit
constexpr unsigned kFull = 0xffffffffu;

// A block's layout at L lanes a channel's tile.
template <int L>
struct Geometry {
  static constexpr int kPerWarp = 32 / L;             // channels a warp takes at once
  static constexpr int kRound = kWarps * kPerWarp;    // channels a round
  static constexpr int kPos = kItems * L;             // positions of a (half) tile
  static constexpr int kLd = kPos + kPos / 8;         // a staged row (tile_slot's range)
  static constexpr int kBufs = L == 16 ? 2 : 1;       // buffers of the warps' terms
  static constexpr int kBufRows = 2 * kWarps * 2;     // [state of the pair][warp][dB, dC]
  static constexpr int kTermRows = kBufs * kBufRows;
  static_assert(3 * kRound <= kTermRows, "a round's x, dt and dy go over the terms");
};

__host__ __device__ inline size_t bwd_smem_bytes(int n, int d_block, int lanes) {
  // B and C [n][ld]; the tile's dB and dC sums [2][n][ld]; the warps' terms
  // [bufs][2][kWarps][2][ld] (a round's x, dt, dy [3][round][ld] over them);
  // the adjoint carries and dA's sums [d_block][n]; dD's [d_block]
  const int pos = kItems * lanes;
  const size_t ld = pos + pos / 8;
  const size_t rows = 4 * static_cast<size_t>(n) + (lanes == 16 ? 2 : 1) * 2 * kWarps * 2;
  return (rows * ld + 2 * static_cast<size_t>(d_block) * n + d_block) * 4;
}

// Value of state n (uniform) from the L lanes that hold a row of N values,
// lane j values j and j + L.
template <int L, int K>
__device__ __forceinline__ float lane_value(const float (&v)[K], int n) {
  const float held = (K > 1 && n >= L) ? v[K - 1] : v[0];
  return __shfl_sync(kFull, held, n & (L - 1), L);
}

template <typename T, int N, int L>
__global__ void __launch_bounds__(kThreads, 2)
selective_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ a_mat, const T* __restrict__ b_mat,
                          const T* __restrict__ c_mat, const float* __restrict__ d_vec,
                          const T* __restrict__ dy, const float* __restrict__ h_tiles,
                          T* __restrict__ dx, float* __restrict__ ddt,
                          float* __restrict__ part_b, float* __restrict__ part_c,
                          float* __restrict__ part_a, float* __restrict__ part_d, int bt, int s,
                          int dn, int d_block, long long b_sb, long long b_st, long long c_sb,
                          long long c_st, int vec) {
  using G = Geometry<L>;
  constexpr int P = G::kPos, LD = G::kLd, R = G::kRound;
  constexpr int KN = (N + L - 1) / L;  // A's and h's values a lane holds
  static_assert(P * (R / 8) == kThreads, "a thread stages 8 channels at one position");
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                       // [N][LD]
  float* cs = bs + N * LD;                // [N][LD]
  float* sums = cs + N * LD;              // [2][N][LD]: the tile's dB, dC over the block
  float* terms = sums + 2 * N * LD;       // [kBufs][2][kWarps][2][LD]
  float* stage = terms;                   // [3][R][LD]: a round's x (then dx), dt (then ddt), dy
  float* gs = terms + G::kTermRows * LD;  // [d_block][N]: a_t0 g_t0 of the tile after
  float* das = gs + d_block * N;          // [d_block][N]
  float* dds = das + d_block * N;         // [d_block]

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = lane & (L - 1);  // the lane within its channel's lanes
  const int half = lane / L;       // the warp's channel (0, or 1 at L 16)
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * d_block;
  const int rounds = d_block / R;
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int group = blockIdx.x / csize;
  const size_t row0 = static_cast<size_t>(b) * s;  // row of (b, t = 0) in x, dt, dy
  const int n_tiles = (s + kTile - 1) / kTile;

  for (int i = tid; i < 2 * d_block * N + d_block; i += kThreads) gs[i] = 0.f;  // gs, das, dds
  int pairs = 0;  // pairs of states taken: the terms' buffer at L 16

  for (int tile = n_tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * kTile;
    for (int v = tid; v < 2 * P; v += kThreads) {  // B (then C) of position t0 + v % P
      const int p = v % P;
      const bool in = t0 + p < s;
      const long long row = in ? t0 + p : 0;
      RawRow<T, N> rr;
      if (v < P) {
        rr.load(b_mat + b * b_sb + row * b_st, in, vec & 1);
      } else {
        rr.load(c_mat + b * c_sb + row * c_st, in, vec & 1);
      }
      float* dst = (v < P ? bs : cs) + tile_slot(p);
#pragma unroll
      for (int n = 0; n < N; ++n) dst[n * LD] = rr.at(n);
    }
    for (int r = 0; r < rounds; ++r) {
      const int dr = d0 + r * R;  // the round's first channel
      const int sp = tid % P, sk = tid / P;  // the staged position and 8 channels
      const bool s_in = t0 + sp < s;
      const size_t s_off = (row0 + (s_in ? t0 + sp : 0)) * dn + dr + 8 * sk;
      const bool s_vec = (vec & 2) && dr + 8 * sk + 8 <= dn;
      __syncthreads();  // the round before read the terms and rows
      {  // x, dt and dy of position t0 + sp at channels dr + 8 sk ..
        float* xs = stage + (8 * sk) * LD + tile_slot(sp);
        float* dts = xs + R * LD;
        float* dys = dts + R * LD;
        if (s_in && s_vec) {
          RawRow<T, 8> xr, yr;
          RawRow<float, 8> tr;
          xr.load(x + s_off, true, true);
          yr.load(dy + s_off, true, true);
          tr.load(dt + s_off, true, true);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            xs[c * LD] = xr.at(c);
            dys[c * LD] = yr.at(c);
            dts[c * LD] = tr.at(c);
          }
        } else {  // past S, or a ragged channel round: one by one, zeros outside
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const bool ok = s_in && dr + 8 * sk + c < dn;
            xs[c * LD] = ok ? to_float(x[s_off + c]) : 0.f;
            dys[c * LD] = ok ? to_float(dy[s_off + c]) : 0.f;
            dts[c * LD] = ok ? dt[s_off + c] : 0.f;
          }
        }
      }
      __syncthreads();
      const int cl = warp * G::kPerWarp + half;  // the channel in the round
      const int c = r * R + cl;                  // ... in the block
      const int d = dr + cl;
      const bool live = d < dn;  // not exiting: every lane meets every barrier
      float dtv[kItems], xv[kItems], dyv[kItems];
      read8(stage + cl * LD, seg, xv);
      read8(stage + (R + cl) * LD, seg, dtv);
      read8(stage + (2 * R + cl) * LD, seg, dyv);
      float a_row[KN], h_row[KN];  // lane j: A's and h's state j (and j + L)
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        const int j = seg + k * L;
        const bool ok = live && j < N;
        a_row[k] = ok ? a_mat[static_cast<size_t>(d) * N + j] : 0.f;
        h_row[k] = ok ? h_tiles[((static_cast<size_t>(b) * n_tiles + tile) * dn + d) * N + j]
                      : 0.f;
      }
      __syncthreads();  // the rows are read: the terms go over them
      float dtx[kItems], s1[kItems], s2[kItems];
      float dd_acc = 0.f;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        dtx[i] = __fmul_rn(dtv[i], xv[i]);
        dd_acc = __fmaf_rn(dyv[i], xv[i], dd_acc);
        s1[i] = 0.f;
        s2[i] = 0.f;
      }
#pragma unroll 1
      for (int n0 = 0; n0 < N; n0 += 2) {
        // the warp's terms of states n0 and n0 + 1 go to buf as they come
        if (G::kBufs == 1 && n0 > 0) __syncthreads();  // the pair before is summed
        float* buf = terms + (G::kBufs == 2 ? (pairs & 1) : 0) * G::kBufRows * LD;
        ++pairs;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int n = n0 + k;
          const float a_n = lane_value<L>(a_row, n);
          const float h_in = lane_value<L>(h_row, n);
          const float carry = gs[c * N + n];  // a_{t0'} g_{t0'} of the tile after
          const float a2 = __fmul_rn(a_n, kLog2e);
          float av[kItems], bv[kItems], bn[kItems], cn[kItems];
          read8(bs + n * LD, seg, bn);
          read8(cs + n * LD, seg, cn);
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
            av[i] = ex2(__fmul_rn(dtv[i], a2));
            bv[i] = __fmul_rn(dtx[i], bn[i]);
          }
          // the states: hp[i] before position i of the lane, hp[i + 1] after
          float hp[kItems + 1];
          hp[0] = state_before_lane<L>(av, bv, h_in, seg);
#pragma unroll
          for (int i = 0; i < kItems; ++i) hp[i + 1] = __fmaf_rn(av[i], hp[i], bv[i]);
          // the adjoint, g_i = alpha_i g_{i+1} + beta_i with alpha_i = a_{i+1}:
          // the lane's pairs combined from its last position down, then the
          // lanes' suffixes by a Hillis-Steele scan with __shfl_down_sync
          float beta[kItems];
#pragma unroll
          for (int i = 0; i < kItems; ++i) beta[i] = __fmul_rn(dyv[i], cn[i]);
          const bool last = seg == L - 1;
          const float a_next = __shfl_down_sync(kFull, av[0], 1, L);
          const float alpha_last = last ? 1.f : a_next;  // the last lane: the carry has it
          float ra = alpha_last, rb = beta[kItems - 1];
#pragma unroll
          for (int i = kItems - 2; i >= 0; --i) {
            rb = __fmaf_rn(av[i + 1], rb, beta[i]);
            ra = __fmul_rn(ra, av[i + 1]);
          }
#pragma unroll
          for (int off = 1; off < L; off <<= 1) {
            float qa = __shfl_down_sync(kFull, ra, off, L);
            float qb = __shfl_down_sync(kFull, rb, off, L);
            qa = seg + off < L ? qa : 1.f;
            qb = seg + off < L ? qb : 0.f;
            rb = __fmaf_rn(ra, qb, rb);
            ra = __fmul_rn(ra, qa);
          }
          const float g_first = __fmaf_rn(ra, carry, rb);  // g at the lane's first position
          float g_next = __shfl_down_sync(kFull, g_first, 1, L);
          if (last) g_next = carry;
          float gv[kItems];
#pragma unroll
          for (int i = kItems - 1; i >= 0; --i) {
            const float alpha = i == kItems - 1 ? alpha_last : av[i + 1];
            gv[i] = __fmaf_rn(alpha, g_next, beta[i]);
            g_next = gv[i];
          }
          if (seg == 0) gs[c * N + n] = __fmul_rn(av[0], gv[0]);  // every lane read it
          // the terms
          float da_acc = 0.f, tb[kItems], tc[kItems];  // dB's and dC's terms
#pragma unroll
          for (int i = 0; i < kItems; ++i) {
            const float q = __fmul_rn(__fmul_rn(gv[i], av[i]), hp[i]);
            s1[i] = __fmaf_rn(gv[i], bn[i], s1[i]);
            s2[i] = __fmaf_rn(a_n, q, s2[i]);
            da_acc = __fmaf_rn(dtv[i], q, da_acc);
            tb[i] = __fmul_rn(gv[i], dtx[i]);
            tc[i] = __fmul_rn(dyv[i], hp[i + 1]);
          }
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1) {
            da_acc = __fadd_rn(da_acc, __shfl_xor_sync(kFull, da_acc, off));
          }
          if (seg == 0) das[c * N + n] = __fadd_rn(das[c * N + n], da_acc);
          float* row = buf + (k * kWarps + warp) * 2 * LD;
          if constexpr (L == 16) {
            // the warp's two channels: the lower half keeps dB's sum, the upper dC's
            float sum[kItems];
#pragma unroll
            for (int i = 0; i < kItems; ++i) {
              const float other = __shfl_xor_sync(kFull, half ? tb[i] : tc[i], 16);
              sum[i] = __fadd_rn(half ? tc[i] : tb[i], other);
            }
            write8(row + half * LD, seg, sum);
          } else {
            write8(row, lane, tb);
            write8(row + LD, lane, tc);
          }
        }
        __syncthreads();
        for (int v = tid; v < 2 * 2 * P; v += kThreads) {  // [state of the pair][dB, dC][p]
          const int k = v / (2 * P), which = (v / P) & 1, p = v % P;
          const float* src = buf + (k * kWarps * 2 + which) * LD + tile_slot(p);
          float acc = src[0];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, src[w * 2 * LD]);
          float* dst = sums + (which * N + n0 + k) * LD + tile_slot(p);
          *dst = r == 0 ? acc : __fadd_rn(*dst, acc);
        }
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        dd_acc = __fadd_rn(dd_acc, __shfl_xor_sync(kFull, dd_acc, off));
      }
      if (seg == 0) dds[c] = __fadd_rn(dds[c], dd_acc);
      const float dd = live ? d_vec[d] : 0.f;
      float dxv[kItems], ddtv[kItems];
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        dxv[i] = __fmaf_rn(dtv[i], s1[i], __fmul_rn(dd, dyv[i]));
        ddtv[i] = __fmaf_rn(xv[i], s1[i], s2[i]);
      }
      __syncthreads();  // the terms are summed: the rows go over them
      write8(stage + cl * LD, seg, dxv);
      write8(stage + (R + cl) * LD, seg, ddtv);
      __syncthreads();
      if (s_in) {  // dx and ddt of position t0 + sp at channels dr + 8 sk ..
        alignas(16) T gx[8];
        alignas(16) float gt[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          gx[k] = from_float<T>(stage[(8 * sk + k) * LD + tile_slot(sp)]);
          gt[k] = stage[(R + 8 * sk + k) * LD + tile_slot(sp)];
        }
        if (s_vec) {
#pragma unroll
          for (int q = 0; q < RawRow<T, 8>::kN; ++q) {
            reinterpret_cast<uint4*>(dx + s_off)[q] = reinterpret_cast<const uint4*>(gx)[q];
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            reinterpret_cast<float4*>(ddt + s_off)[q] = reinterpret_cast<const float4*>(gt)[q];
          }
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (dr + 8 * sk + k < dn) dx[s_off + k] = gx[k], ddt[s_off + k] = gt[k];
          }
        }
      }
    }
    // the cluster's sums of the tile, rank by rank in order: each rank adds a
    // share of the (dB or dC, 4 states, position) items over the ranks
    cluster.sync();
    constexpr int kItemsAll = 2 * (N / 4) * P;
    const int share = (kItemsAll + csize - 1) / csize;
    const int end = min(kItemsAll, (rank + 1) * share);
    for (int it = rank * share + tid; it < end; it += kThreads) {
      const int p = it % P, n4 = (it / P) % (N / 4), which = it / (P * (N / 4));
      if (t0 + p >= s) continue;
      float acc[4];
      for (int q = 0; q < csize; ++q) {
        const float* src =
            cluster.map_shared_rank(sums, q) + (which * N + 4 * n4) * LD + tile_slot(p);
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = q == 0 ? src[k * LD] : __fadd_rn(acc[k], src[k * LD]);
      }
      float* part = (which ? part_c : part_b) +
                    ((static_cast<size_t>(group) * bt + b) * s + t0 + p) * N + 4 * n4;
      *reinterpret_cast<float4*>(part) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    cluster.sync();  // no block writes its sums again, or leaves, while another reads them
  }
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

// V consecutive floats of a part: one 16-byte load at V = 4.
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

// A segment's outputs V at a time (V = 4 where its count allows): each
// output the sum of its parts in order, the parts' loads kBatch at a time
// in flight before their additions.
template <int V>
__device__ void reduce_segment(const Segment& sg) {
  const long long items = sg.count / V;
  const long long stride = static_cast<long long>(gridDim.x) * kReduceThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
       i < items; i += stride) {
    float acc[V];
    load_v<V>(sg.part + i * V, acc);
    for (int k = 1; k < sg.n_parts; k += kBatch) {
      float v[kBatch][V];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (k + j < sg.n_parts) load_v<V>(sg.part + (k + j) * sg.count + i * V, v[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (k + j < sg.n_parts) acc[e] = __fadd_rn(acc[e], v[j][e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (sg.out_bf16) {
        static_cast<__nv_bfloat16*>(sg.out)[i * V + e] = __float2bfloat16(acc[e]);
      } else {
        static_cast<float*>(sg.out)[i * V + e] = acc[e];
      }
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
selective_scan_bwd_reduce_kernel(Segments segs) {
  const Segment sg = segs.seg[blockIdx.y];
  if (sg.count % 4 == 0) {
    reduce_segment<4>(sg);
  } else {
    reduce_segment<1>(sg);
  }
}

template <typename T, int N, int L>
const void* bwd_kernel() {
  return reinterpret_cast<const void*>(selective_scan_bwd_kernel<T, N, L>);
}

// The kernel of (x's type, N, lanes), or null where none is built.
const void* pick_kernel(int x_is_bf16, int n, int lanes) {
#define SSM_BWD_PICK(N)                                                            \
  if (n == N) {                                                                    \
    if (x_is_bf16) {                                                               \
      return lanes == 16 ? bwd_kernel<__nv_bfloat16, N, 16>()                      \
                         : bwd_kernel<__nv_bfloat16, N, 32>();                     \
    }                                                                              \
    return lanes == 16 ? bwd_kernel<float, N, 16>() : bwd_kernel<float, N, 32>();  \
  }
  if (lanes != 16 && lanes != 32) return nullptr;
  SSM_BWD_PICK(4) SSM_BWD_PICK(8) SSM_BWD_PICK(16) SSM_BWD_PICK(32)
#undef SSM_BWD_PICK
  return nullptr;
}

// The launch's configuration: grid (ceil(blocks / cluster) x cluster, Bt),
// clusters of ``cluster`` blocks along x.
struct LaunchShape {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
};

cudaError_t prepare(LaunchShape* ls, const void* kernel, int bt, int dn, int n, int d_block,
                    int lanes, int cluster, cudaStream_t stream) {
  const int round = kWarps * (32 / lanes);
  if (kernel == nullptr || d_block <= 0 || d_block % round != 0 || cluster < 1 ||
      cluster > kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = bwd_smem_bytes(n, d_block, lanes);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return attr;
  const int blocks = (dn + d_block - 1) / d_block;
  const int groups = (blocks + cluster - 1) / cluster;
  ls->config = {};
  ls->config.gridDim = dim3(groups * cluster, bt);
  ls->config.blockDim = dim3(kThreads);
  ls->config.dynamicSmemBytes = smem;
  ls->config.stream = stream;
  ls->attr[0].id = cudaLaunchAttributeClusterDimension;
  ls->attr[0].val.clusterDim.x = cluster;
  ls->attr[0].val.clusterDim.y = 1;
  ls->attr[0].val.clusterDim.z = 1;
  ls->config.attrs = ls->attr;
  ls->config.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
int launch_bwd_t(const void* x, const void* dt, const void* a_mat, const void* b_mat,
                 const void* c_mat, const void* d_vec, const void* dy, const void* h_tiles,
                 void* dx, void* ddt, void* part_b, void* part_c, void* part_a, void* part_d,
                 int bt, int s, int dn, int n, int d_block, int lanes, int cluster,
                 long long b_sb, long long b_st, long long c_sb, long long c_st,
                 cudaStream_t stream) {
  const void* kernel = pick_kernel(sizeof(T) == 2, n, lanes);
  if (lanes == 16 && s > kTile / 2) return static_cast<int>(cudaErrorInvalidValue);
  LaunchShape ls;
  const cudaError_t err = prepare(&ls, kernel, bt, dn, n, d_block, lanes, cluster, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte rows: bit 0 for B and C, bit 1 for x, dt, dy, dx and ddt
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const long long sz = sizeof(T);
  const int vec = (a16(b_mat) && a16(c_mat) && (b_sb * sz) % 16 == 0 && (b_st * sz) % 16 == 0 &&
                   (c_sb * sz) % 16 == 0 && (c_st * sz) % 16 == 0) |
                  (a16(x) && a16(dt) && a16(dy) && a16(dx) && a16(ddt) && (dn * sz) % 16 == 0 &&
                   dn % 4 == 0) << 1;
  void* args[] = {&x,      &dt,     &a_mat,  &b_mat, &c_mat, &d_vec,   &dy,   &h_tiles,
                  &dx,     &ddt,    &part_b, &part_c, &part_a, &part_d, &bt,   &s,
                  &dn,     &d_block, &b_sb,  &b_st,  &c_sb,  &c_st,    const_cast<int*>(&vec)};
  const cudaError_t launch = cudaLaunchKernelExC(&ls.config, kernel, args);
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The first pass.  x, dy (Bt, S, Dn) bf16 (x_is_bf16 = 1) or float32 and dt
// (Bt, S, Dn) float32, contiguous; A (Dn, N), D (Dn,) float32; B and C (Bt, S,
// N) in x's type, element (b, t, n) at b * sb + t * st + n; h_tiles (Bt,
// ceil(S / 256), Dn, N) float32, the forward's states before each tile
// (selective_scan_launch's h_tiles).  Writes dx (Bt, S, Dn) in x's type and
// ddt (Bt, S, Dn) float32, and the partials: part_b and part_c (groups, Bt,
// S, N) with groups = ceil(ceil(Dn / d_block) / cluster), part_a (Bt, Dn, N),
// part_d (Bt, Dn), float32.  N is 4, 8, 16 or 32; lanes 16 (S <= 128 only)
// or 32; d_block a positive multiple of 8 x 32 / lanes; cluster 1 to 8.
// Returns a cudaError_t.
extern "C" int selective_scan_bwd_launch(const void* x, const void* dt, const void* a_mat,
                                         const void* b_mat, const void* c_mat,
                                         const void* d_vec, const void* dy, const void* h_tiles,
                                         void* dx, void* ddt, void* part_b, void* part_c,
                                         void* part_a, void* part_d, int bt, int s, int dn,
                                         int n, int x_is_bf16, int d_block, int lanes,
                                         int cluster, long long b_sb, long long b_st,
                                         long long c_sb, long long c_st, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch_bwd_t<__nv_bfloat16>(x, dt, a_mat, b_mat, c_mat, d_vec, dy, h_tiles, dx, ddt,
                                       part_b, part_c, part_a, part_d, bt, s, dn, n, d_block,
                                       lanes, cluster, b_sb, b_st, c_sb, c_st, st);
  }
  return launch_bwd_t<float>(x, dt, a_mat, b_mat, c_mat, d_vec, dy, h_tiles, dx, ddt, part_b,
                             part_c, part_a, part_d, bt, s, dn, n, d_block, lanes, cluster, b_sb,
                             b_st, c_sb, c_st, st);
}

// The second pass: dB = sum of part_b over its first axis (the clusters) and
// dC of part_c, in order, in B's type (bf16 when bc_is_bf16); dA = sum of
// part_a and dD of part_d over the sequences in order, float32.
extern "C" int selective_scan_bwd_reduce_launch(const void* part_b, const void* part_c,
                                                const void* part_a, const void* part_d,
                                                void* db, void* dc, void* da, void* dd, int bt,
                                                int s, int dn, int n, int n_parts,
                                                int bc_is_bf16, void* stream) {
  Segments segs;
  const long long bsn = static_cast<long long>(bt) * s * n;
  segs.seg[0] = {static_cast<const float*>(part_b), db, bsn, n_parts, bc_is_bf16};
  segs.seg[1] = {static_cast<const float*>(part_c), dc, bsn, n_parts, bc_is_bf16};
  segs.seg[2] = {static_cast<const float*>(part_a), da, static_cast<long long>(dn) * n, bt, 0};
  segs.seg[3] = {static_cast<const float*>(part_d), dd, dn, bt, 0};
  long long most = bsn > static_cast<long long>(dn) * n ? bsn : static_cast<long long>(dn) * n;
  long long blocks = (most / 4 + kReduceThreads - 1) / kReduceThreads;  // 4 outputs a thread
  if (blocks > 132 * 8) blocks = 132 * 8;
  if (blocks < 1) blocks = 1;
  selective_scan_bwd_reduce_kernel<<<dim3(static_cast<unsigned>(blocks), 4), kReduceThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one block of the first pass needs at state size n, d_block
// channels a block and lanes a channel's tile.
extern "C" int selective_scan_bwd_smem_bytes(int n, int d_block, int lanes) {
  return static_cast<int>(bwd_smem_bytes(n, d_block, lanes));
}

// What the card makes of the first pass's kernel at (x's type, n, lanes,
// d_block, cluster): out[0] its blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] the clusters the
// card runs at once (cudaOccupancyMaxActiveClusters), out[2] its registers a
// thread.  Returns a cudaError_t.
extern "C" int selective_scan_bwd_occupancy(int x_is_bf16, int n, int lanes, int d_block,
                                            int cluster, int dn, int* out) {
  const void* kernel = pick_kernel(x_is_bf16, n, lanes);
  LaunchShape ls;
  cudaError_t err = prepare(&ls, kernel, 1, dn, n, d_block, lanes, cluster, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, kThreads,
                                                      ls.config.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(&out[1], kernel, &ls.config);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  out[2] = fa.numRegs;
  return static_cast<int>(err);
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
