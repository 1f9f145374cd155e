// Hopper kernel for the local-SGD worker chain (K6).
//
// No Pallas kernel stands behind it.  It is the port's counterpart of the
// JAX package's compiled scan: the worker of
// src/repro/optim/sgd.py::_local_sgd_step (:106-129, its jax.lax.scan at
// :129) and of src/repro/optim/simcluster.py::_ssp_outer_step (:59-78),
// which XLA compiles into one loop on the device.  Eager PyTorch launches
// about ten kernels a step instead, some 37 000 a round at the paper's
// 60000 x 784 and m = 16.
//
// Each of the m workers runs H dependent SGD steps on its own (nl, d) shard
// from its own start vector w (row k of W0; SSP passes stale copies):
//   z = y_j <x_j, w>
//   hinge:        gz = z < 1 ? -1 : 0
//   smooth hinge: gz = z >= 1 ? 0 : (z <= 1 - gamma ? -1 : (z - 1) / gamma)
//   logistic:     gz = -1 / (1 + exp(z))                   (-sigmoid(-z))
//   g = (gz y_j) x_j + lam w;  lr = lr0 / (lam ((t h + i) + t0));  w -= lr g
// for i = 0 .. steps - 1 (steps = idx's width), and writes the m vectors.
// h is the round's length in the step size; the reference's callers run
// steps = h, and a run of fewer steps is that round's prefix.
//
// What bounds it on this card: the dependent chain, as K1's.  Step i + 1's
// dot product needs the w that step i wrote, so no bandwidth shortens it.
// The bytes bound, every row of X read once (188 MB at 60000 x 784, about
// 56 us at 3.35 TB/s), is far below H times one step's latency (a dot
// product, a butterfly, a scalar and an axpy), and the flops (about 7 d a
// step) further below.  So the design keeps the rows' loads off the chain.
//
// Design: grid (m,), one warp of 32 threads a worker, no block barrier.
//   - Lane l owns w's entries l, l + 32, ...: E a lane in registers where
//     d <= 32 E for a compiled E (1 to 40, so d <= 1280; 25 at d = 784, 1 at
//     the chaos run's d = 32), otherwise in shared memory with the same
//     ownership (d <= kMaxD).  Entries past d are 0 in w and in every row,
//     and stay 0.
//   - A step: each lane's partial <x_j, w> over its entries (four
//     accumulators, entry e into e % 4 in order of e, fused multiply-adds,
//     added pairwise), one xor butterfly of shuffles (offsets 16, 8, 4, 2,
//     1), after which every lane holds the same bits and computes gz itself;
//     then each lane updates its own entries.  The update of step t is fused
//     with the partial dot of step t + 1's row, whose entries the register
//     path keeps in registers for the next update.
//   - Rows arrive well before they are needed: the order is known for the
//     whole round, so a ring of the next P rows sits in shared memory, row r
//     in slot r % P, each slot 32 E floats (the tail past d zeroed once).
//     Where d % 4 == 0 and the shard is 16-byte aligned, a row is one bulk
//     copy (cp.async.bulk, the copy engine) completing on its slot's
//     mbarrier, and the register path stages four rows every four steps,
//     one lane issuing each, since a step's issue of copies costs about as
//     much as the rest of its work; otherwise every lane issues 4-byte
//     cp.async copies and arrives on the barrier once they land (the d = 33
//     case, or a tensor with a storage offset).  A step waits on the next
//     row's barrier phase only, and a slot is refilled only after every lane
//     has read its row.  P = min(16, 64 KB / row) for the register path (16
//     at d = 784 and d = 32, 12 at 1280), 4 or 2 for the shared-memory path,
//     whose w takes a row's room too.  X and y are only read, so a row drawn
//     twice in a round (h > nl) is simply copied twice.
//   - Rounds of at most kDirectSteps steps (the chaos run's SSP rounds of 1
//     or 2) skip the ring, whose set-up and first copy's round trip cost
//     more than such a round: their rows are loaded into registers before
//     the first step, with no shared memory (direct_round).
//   - The order's indices, labels and step sizes are off the chain: lane l
//     holds idx[b + l], y[idx[b + l]] and step b + l's size for the current
//     block of 32 steps (b = 32 (t / 32)) and the next, loaded and computed
//     a block ahead; a step takes its label and size from lane t % 32 by a
//     shuffle, and a row's staging its index.
// Arithmetic: every elementwise operation is the reference's, in its order,
// rounded as written (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nothing
// contracted into a fused multiply-add), lr in float32 as the reference
// computes it.  The only differences from the reference are the order of
// the dot product's sum and, for the logistic loss, expf's last bit.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kAll = 0xffffffffu;
// The widest row the kernel takes (w and a two-row ring in shared memory
// would go further; every width the kernel ever took is kept).
constexpr int kMaxD = 12224;
constexpr int kRingBytes = 64 * 1024;  // staged rows of the register path
constexpr int kMaxRing = 16;
constexpr int kSmemLimit = 232448;     // shared memory one block may use (227 KB)
constexpr int kDefaultSmem = 48 * 1024;  // a block's without opting in
constexpr int kBarrierBytes = 128;     // the ring's barriers, 8 bytes a slot, room for 16

__host__ __device__ constexpr int clamp_ring(int p) {
  return p < 2 ? 2 : (p > kMaxRing ? kMaxRing : p);
}
// Ring depth of the register path at E entries a lane (rows of 128 E bytes).
__host__ __device__ constexpr int ring_rows(int e) { return clamp_ring(kRingBytes / (128 * e)); }
// Rows staged together: four every four steps where the ring holds at
// least eight (at least four then stay staged ahead), else one a step.
__host__ __device__ constexpr int refill_rows(int p) { return p >= 8 ? 4 : 1; }
// The longest round the register path runs without its ring.
constexpr int kDirectSteps = 2;

// Entries a lane of the register path, for the compiled E at or above k.
__host__ inline int register_entries(int k) {
  constexpr int kCompiled[] = {1, 2, 4, 6, 8, 12, 16, 20, 25, 32, 40};
  for (int e : kCompiled) {
    if (k <= e) return e;
  }
  return 0;  // shared-memory path
}

struct Plan {
  int e;      // entries a lane in registers (0: w in shared memory)
  int k;      // entries a lane (a ring slot holds 32 k floats)
  int ring;   // rows in the ring
  int batch;  // rows staged together
  size_t smem;
};

__host__ inline Plan plan_for(int d) {
  const int k = (d + kLanes - 1) / kLanes;
  Plan p{register_entries(k), k, 0, 0, 0};
  if (p.e > 0) {
    p.k = p.e;
    p.ring = ring_rows(p.e);
    p.smem = kBarrierBytes + static_cast<size_t>(p.ring) * 128 * p.e;
  } else {
    const size_t row = static_cast<size_t>(128) * k;
    p.ring = kBarrierBytes + 5 * row <= kSmemLimit ? 4 : 2;  // the ring and w
    p.smem = kBarrierBytes + (p.ring + 1) * row;
  }
  p.batch = refill_rows(p.ring);
  return p;
}

// A round's constants, the same for every step and worker.
struct Consts {
  float th;     // t * h, rounded to float32
  float lr0;
  float t0;
  float lam;
  int loss;     // 0 hinge, 1 smooth hinge, 2 logistic
  float edge;   // 1 - gamma, rounded to float32 once
  float gamma;
};

// Step i's size: lr0 / (lam ((t h + i) + t0)), every operation in float32.
__device__ __forceinline__ float step_size(const Consts& c, int i) {
  const float den = __fmul_rn(c.lam, __fadd_rn(__fadd_rn(c.th, static_cast<float>(i)), c.t0));
  return __fdiv_rn(c.lr0, den);
}

// d loss / d z, the reference's branches.
__device__ __forceinline__ float slope(float z, const Consts& c) {
  if (c.loss == 0) return z < 1.f ? -1.f : 0.f;
  if (c.loss == 1) {
    return z >= 1.f ? 0.f : (z <= c.edge ? -1.f : __fdiv_rn(__fsub_rn(z, 1.f), c.gamma));
  }
  return -__fdiv_rn(1.f, __fadd_rn(1.f, expf(z)));
}

// The sum of the 32 lanes' partials: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kAll, s, off);
  return s;
}

// A lane's four accumulators added pairwise, then over the warp.
__device__ __forceinline__ float dot_sum(const float (&acc)[4]) {
  return warp_sum(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])));
}

// One step of the chain probe's register path on row x (its label yj) with
// size lr: the dot, then the update.
template <int E>
__device__ __forceinline__ void sgd_step(float (&w)[E], const float (&x)[E], float yj, float lr,
                                         const Consts& c) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e & 3] = __fmaf_rn(x[e], w[e], acc[e & 3]);
  const float s = dot_sum(acc);
  const float z = __fmul_rn(yj, s);
  const float coef = __fmul_rn(slope(z, c), yj);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float g = __fadd_rn(__fmul_rn(coef, x[e]), __fmul_rn(c.lam, w[e]));
    w[e] = __fsub_rn(w[e], __fmul_rn(lr, g));
  }
}

// PTX helpers, the same as the SDCA kernel's (csrc/sdca.cu).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// One arrival on the barrier once this lane's earlier cp.async copies land.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// If go, bytes from src into dst as one bulk copy, completing on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar, bool go) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %4, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      " @p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n}\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)),
      "r"(static_cast<uint32_t>(go))
      : "memory");
}

// The round's order, 32 steps a block: lane l holds step b + l's row index
// j, its label y_j and its size lr, for the current block (b = 32 (t / 32))
// and the next.  The next block's indices and sizes are taken when the
// current one starts, its labels half a block later, so no step waits on a
// load of the order.
struct Order {
  const int* ik;
  const float* yk;
  int steps, lane;
  int j, nj;
  float y, ny, lr, nlr;

  __device__ __forceinline__ int index(int i) const { return i < steps ? __ldg(ik + i) : 0; }

  __device__ __forceinline__ void init(const int* ik_, const float* yk_, int steps_, int lane_,
                                       const Consts& c) {
    ik = ik_;
    yk = yk_;
    steps = steps_;
    lane = lane_;
    j = index(lane);
    y = lane < steps ? __ldg(yk + j) : 0.f;
    lr = step_size(c, lane);
    nj = index(kLanes + lane);
    nlr = step_size(c, kLanes + lane);
    ny = 0.f;
  }

  // At step t: a new block starts (t % 32 == 0), or the next block's labels
  // are read (t % 32 == 16).
  __device__ __forceinline__ void advance(int t, const Consts& c) {
    if ((t & (kLanes - 1)) == 0 && t > 0) {
      j = nj;
      y = ny;
      lr = nlr;
      nj = index(t + kLanes + lane);
      nlr = step_size(c, t + kLanes + lane);
    } else if ((t & (kLanes - 1)) == kLanes / 2) {
      const int i = t + kLanes / 2 + lane;
      ny = i < steps ? __ldg(yk + nj) : 0.f;
    }
  }

  // Step t's label and size (every lane the same).
  __device__ __forceinline__ float label(int t) const { return __shfl_sync(kAll, y, t & 31); }
  __device__ __forceinline__ float size(int t) const { return __shfl_sync(kAll, lr, t & 31); }

  // Row r's index at step t, for this lane's r (in the current block or the
  // next); last, the same in every lane, is the furthest row asked for.
  __device__ __forceinline__ int row(int r, int t, int last) const {
    const int a = __shfl_sync(kAll, j, r & 31);
    if ((last >> 5) == (t >> 5)) return a;  // all in the current block
    const int b = __shfl_sync(kAll, nj, r & 31);
    return (r >> 5) == (t >> 5) ? a : b;
  }
};

// The ring in shared memory: P barriers, then P slots of `stride` floats.
template <int P>
struct Ring {
  uint64_t* bars;
  float* slots;
  int stride;
  const float* Xk;
  int d;
  bool bulk;

  __device__ __forceinline__ float* slot(int r) const { return slots + (r % P) * stride; }

  // Zero every slot's tail past d and set up the barriers: one arrival (the
  // issuing lane's, with the row's bytes) a bulk copy, or every lane's.
  __device__ __forceinline__ void init(int lane) const {
    for (int s = 0; s < P; ++s) {
      for (int i = d + lane; i < stride; i += kLanes) slots[s * stride + i] = 0.f;
    }
    if (lane < P) {
      mbar_init(&bars[lane], bulk ? 1 : kLanes);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
  }

  // Wait until row r has landed in its slot: its barrier's (r / P)-th phase.
  __device__ __forceinline__ void wait(int r) const {
    mbar_wait(&bars[r % P], static_cast<uint32_t>((r / P) & 1));
  }

  // Stage rows first .. first + count - 1 (those below the order's steps)
  // into their slots at step t.  Bulk: lane i issues row first + i, so up
  // to 32 rows cost one issue of the warp.  Otherwise every lane copies
  // its entries 4 bytes at a time and arrives once they land, a row after
  // another; E > 0 bounds d by 32 E, so the loop unrolls.
  template <int E>
  __device__ __forceinline__ void stage(const Order& ord, int t, int first, int count,
                                        int lane) const {
    if (bulk) {
      const int r = first + lane;
      const int j = ord.row(r, t, first + count - 1);
      bulk_copy(slot(r), Xk + static_cast<size_t>(j) * d, 4 * d, &bars[r % P],
                lane < count && r < ord.steps);
      return;
    }
    for (int i = 0; i < count && first + i < ord.steps; ++i) {
      const int r = first + i;
      float* dst = slot(r);
      const float* src = Xk + static_cast<size_t>(ord.row(r, t, r)) * d;
      if constexpr (E > 0) {
#pragma unroll
        for (int q = 0; q < E; ++q) {
          const int e = lane + kLanes * q;
          if (e < d) cp_async_4(dst + e, src + e);
        }
      } else {
        for (int e = lane; e < d; e += kLanes) cp_async_4(dst + e, src + e);
      }
      mbar_arrive_on_copies(&bars[r % P]);
    }
  }
};

// A round of at most kDirectSteps steps on the register path: every row
// loaded into registers first, then the steps (sgd_step: the ring step's
// operations in the same order, so the same bits).
template <int E>
__device__ __forceinline__ void direct_round(const float* W0k, const float* Xk, const float* yk,
                                             const int* ik, float* Wk, int d, int steps,
                                             int lane, const Consts& c) {
  float w[E], x[kDirectSteps][E], yj[kDirectSteps];
#pragma unroll
  for (int t = 0; t < kDirectSteps; ++t) {
    const int j = t < steps ? __ldg(ik + t) : 0;
    yj[t] = t < steps ? __ldg(yk + j) : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + kLanes * e;
      x[t][e] = t < steps && i < d ? __ldg(Xk + static_cast<size_t>(j) * d + i) : 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    w[e] = i < d ? W0k[i] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < kDirectSteps; ++t) {
    if (t < steps) sgd_step<E>(w, x[t], yj[t], step_size(c, t), c);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    if (i < d) Wk[i] = w[e];
  }
}

// What the register path does with its ring.  kRing is the kernel; the
// other two are local_sgd_probe_launch's, for timing only, and compute
// something else: kPrefilled stages rows 0 .. P - 1 once and never refills
// or waits (step t reads slot t % P), kNoWait refills as the kernel does but
// never waits before a read (only at the end, for the copies in flight).
enum RingMode { kRing, kPrefilled, kNoWait };

// One step t of the register path: x holds row t's entries, acc row t's
// partial dot.  Refills the slots of rows t - B + 1 .. t (every lane read
// them in earlier steps) every B steps, reads row t + 1 into xn, and
// updates w fused with row t + 1's partial dot.
template <int E, int P, RingMode M>
__device__ __forceinline__ void ring_step(int t, float (&w)[E], const float (&x)[E],
                                          float (&xn)[E], float (&acc)[4], const Ring<P>& ring,
                                          Order& ord, int lane, const Consts& c) {
  constexpr int B = refill_rows(P);
  ord.advance(t, c);
  const int nx = t + 1;
  if (M != kPrefilled && nx % B == 0) {
    __syncwarp();  // every lane is done with the slots refilled
    ring.template stage<E>(ord, t, t + P - B + 1, B, lane);
  }
  if (M == kRing && nx < ord.steps) ring.wait(nx);
  const float* nxt = ring.slot(nx);  // past the last step: stale, unused
#pragma unroll
  for (int e = 0; e < E; ++e) xn[e] = nxt[lane + kLanes * e];
  const float yj = ord.label(t);
  const float lr = ord.size(t);
  const float z = __fmul_rn(yj, dot_sum(acc));
  const float coef = __fmul_rn(slope(z, c), yj);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float g = __fadd_rn(__fmul_rn(coef, x[e]), __fmul_rn(c.lam, w[e]));
    w[e] = __fsub_rn(w[e], __fmul_rn(lr, g));
    acc[e & 3] = __fmaf_rn(xn[e], w[e], acc[e & 3]);
  }
}

// E entries a lane in registers, a ring of P rows.
template <int E, int P, RingMode M = kRing>
__global__ void __launch_bounds__(kLanes)
local_sgd_kernel(const float* __restrict__ W0, const float* __restrict__ X,
                 const float* __restrict__ y, const int* __restrict__ idx, float* __restrict__ W,
                 int nl, int d, int steps, int /*k_lane*/, Consts c) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const size_t k = blockIdx.x;
  const float* Xk = X + k * nl * d;
  if (M == kRing && steps <= kDirectSteps) {  // launched without shared memory
    direct_round<E>(W0 + k * d, Xk, y + k * nl, idx + k * steps, W + k * d, d, steps, lane, c);
    return;
  }
  const Ring<P> ring{reinterpret_cast<uint64_t*>(smem), smem + kBarrierBytes / 4, kLanes * E, Xk,
                     d, d % 4 == 0 && reinterpret_cast<uintptr_t>(Xk) % 16 == 0};
  Order ord;
  ord.init(idx + k * steps, y + k * nl, steps, lane, c);
  ring.init(lane);
  ring.template stage<E>(ord, 0, 0, P, lane);

  float w[E], xa[E], xb[E];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    w[e] = i < d ? W0[k * d + i] : 0.f;
    xb[e] = 0.f;
  }
  for (int r = 0; r < (M == kPrefilled ? P : 1) && r < steps; ++r) ring.wait(r);
  const float* row0 = ring.slot(0);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    xa[e] = row0[lane + kLanes * e];
    acc[e & 3] = __fmaf_rn(xa[e], w[e], acc[e & 3]);
  }
  // step t's row is in xa for even t, xb for odd t
  for (int t = 0; t < steps; t += 2) {
    ring_step<E, P, M>(t, w, xa, xb, acc, ring, ord, lane, c);
    if (t + 1 < steps) ring_step<E, P, M>(t + 1, w, xb, xa, acc, ring, ord, lane, c);
  }
  if (M == kNoWait) {  // no block exits with copies into its ring in flight
    for (int r = steps > P ? steps - P : 1; r < steps; ++r) ring.wait(r);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    if (i < d) W[k * d + i] = w[e];
  }
}

// w in shared memory after the ring, k_lane entries a lane with the same
// ownership and order of sums (lane l's q-th entry l + 32 q into
// accumulator q % 4), row t read from its slot in the update.  Each lane
// touches only its own entries of w, so no barrier is needed for it.
template <int P>
__global__ void __launch_bounds__(kLanes)
local_sgd_smem_kernel(const float* __restrict__ W0, const float* __restrict__ X,
                      const float* __restrict__ y, const int* __restrict__ idx,
                      float* __restrict__ W, int nl, int d, int steps, int k_lane, Consts c) {
  extern __shared__ __align__(16) float smem[];
  constexpr int B = refill_rows(P);
  const int lane = threadIdx.x;
  const size_t k = blockIdx.x;
  const float* Xk = X + k * nl * d;
  const int stride = kLanes * k_lane;
  const Ring<P> ring{reinterpret_cast<uint64_t*>(smem), smem + kBarrierBytes / 4, stride, Xk, d,
                     d % 4 == 0 && reinterpret_cast<uintptr_t>(Xk) % 16 == 0};
  float* ws = ring.slots + P * stride;
  Order ord;
  ord.init(idx + k * steps, y + k * nl, steps, lane, c);
  ring.init(lane);
  ring.template stage<0>(ord, 0, 0, P, lane);
  for (int i = lane; i < d; i += kLanes) ws[i] = W0[k * d + i];

  // a lane's partial dot of row r with ws, its entries in groups of four
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (steps > 0) ring.wait(0);
  const float* row0 = ring.slot(0);
  for (int e0 = 0; e0 < k_lane; e0 += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = lane + kLanes * (e0 + q);
      if (i < d) acc[q] = __fmaf_rn(row0[i], ws[i], acc[q]);
    }
  }
  for (int t = 0; t < steps; ++t) {
    ord.advance(t, c);
    const int nx = t + 1;
    if (nx < steps) ring.wait(nx);
    const float* cur = ring.slot(t);
    const float* nxt = ring.slot(nx);  // past the last step: stale, unused
    const float yj = ord.label(t);
    const float lr = ord.size(t);
    const float z = __fmul_rn(yj, dot_sum(acc));
    const float coef = __fmul_rn(slope(z, c), yj);
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = 0.f;
    for (int e0 = 0; e0 < k_lane; e0 += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = lane + kLanes * (e0 + q);
        if (i < d) {
          const float g = __fadd_rn(__fmul_rn(coef, cur[i]), __fmul_rn(c.lam, ws[i]));
          const float wi = __fsub_rn(ws[i], __fmul_rn(lr, g));
          ws[i] = wi;
          acc[q] = __fmaf_rn(nxt[i], wi, acc[q]);
        }
      }
    }
    __syncwarp();  // every lane is done with row t's slot
    if (nx % B == 0) ring.template stage<0>(ord, t, t + P - B + 1, B, lane);
  }
  for (int i = lane; i < d; i += kLanes) W[k * d + i] = ws[i];
}

// The register path's dependent chain without its memory traffic: h steps
// of the hinge on one fixed row held in registers.  Its time a step is the
// least latency of a step of this design (chip_smoke.py's chain floor).
template <int E>
__global__ void __launch_bounds__(kLanes) local_sgd_chain_kernel(int h, Consts c, float* out) {
  const int lane = threadIdx.x;
  float w[E], x[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    w[e] = 0.f;
    x[e] = 1e-3f * static_cast<float>(lane + kLanes * e + 1);
  }
  for (int i = 0; i < h; ++i) sgd_step<E>(w, x, 1.f, step_size(c, i), c);
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) s += w[e];
  s = warp_sum(s);
  if (lane == 0) out[0] = s;
}

Consts make_consts(float t, int h, float lr0, float t0, float lam, int loss, float edge,
                   float gamma) {
  // the host's float32 product, as the reference's t * h
  const float th = t * static_cast<float>(h);
  return Consts{th, lr0, t0, lam, loss, edge, gamma};
}

using KernelFn = void (*)(const float*, const float*, const float*, const int*, float*, int, int,
                          int, int, Consts);

int launch(KernelFn kernel, size_t smem, const Plan& p, const float* W0, const float* X,
           const float* y, const int* idx, float* W, int m, int nl, int d, int steps,
           const Consts& c, cudaStream_t stream) {
  if (smem > kDefaultSmem) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<m, kLanes, smem, stream>>>(W0, X, y, idx, W, nl, d, steps, p.k, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// W0 (m, d), X (m, nl, d), y (m, nl) float32, idx (m, steps) int32 in [0, nl),
// all contiguous; W (m, d) written.  loss 0 is the hinge, 1 the smooth
// hinge, 2 the logistic loss; edge is 1 - gamma rounded to float32.
// d <= local_sgd_max_d().  Returns a cudaError_t (0 on success).
extern "C" int local_sgd_launch(const float* W0, const float* X, const float* y, const int* idx,
                                float* W, int m, int nl, int d, int steps, float t, int h,
                                float lr0, float t0, float lam, int loss, float edge,
                                float gamma, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  if (d < 1 || d > kMaxD || loss < 0 || loss > 2) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const Consts c = make_consts(t, h, lr0, t0, lam, loss, edge, gamma);
  const Plan p = plan_for(d);
  KernelFn kernel = nullptr;
  switch (p.e) {
#define LOCAL_SGD_CASE(E) \
    case E: kernel = local_sgd_kernel<E, ring_rows(E)>; break;
    LOCAL_SGD_CASE(1) LOCAL_SGD_CASE(2) LOCAL_SGD_CASE(4) LOCAL_SGD_CASE(6) LOCAL_SGD_CASE(8)
    LOCAL_SGD_CASE(12) LOCAL_SGD_CASE(16) LOCAL_SGD_CASE(20) LOCAL_SGD_CASE(25)
    LOCAL_SGD_CASE(32) LOCAL_SGD_CASE(40)
#undef LOCAL_SGD_CASE
    default: kernel = p.ring == 4 ? local_sgd_smem_kernel<4> : local_sgd_smem_kernel<2>;
  }
  const size_t smem = p.e > 0 && steps <= kDirectSteps ? 0 : p.smem;  // direct_round's
  return launch(kernel, smem, p, W0, X, y, idx, W, m, nl, d, steps, c, st);
}

// local_sgd_launch's register path (d <= 1280) in a probe's mode: 1
// kPrefilled, 2 kNoWait (RingMode).  For timing the ring's parts only: W is
// not the chain's result.
extern "C" int local_sgd_probe_launch(const float* W0, const float* X, const float* y,
                                      const int* idx, float* W, int m, int nl, int d, int steps,
                                      float t, int h, float lr0, float t0, float lam, int mode,
                                      void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  const Plan p = plan_for(d);
  if (d < 1 || p.e == 0 || (mode != kPrefilled && mode != kNoWait)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Consts c = make_consts(t, h, lr0, t0, lam, 0, 0.f, 1.f);
  KernelFn kernel = nullptr;
  switch (p.e) {
#define LOCAL_SGD_PROBE(E)                                                                   \
    case E:                                                                                  \
      kernel = mode == kPrefilled ? local_sgd_kernel<E, ring_rows(E), kPrefilled>            \
                                  : local_sgd_kernel<E, ring_rows(E), kNoWait>;              \
      break;
    LOCAL_SGD_PROBE(1) LOCAL_SGD_PROBE(2) LOCAL_SGD_PROBE(4) LOCAL_SGD_PROBE(6)
    LOCAL_SGD_PROBE(8) LOCAL_SGD_PROBE(12) LOCAL_SGD_PROBE(16) LOCAL_SGD_PROBE(20)
    LOCAL_SGD_PROBE(25) LOCAL_SGD_PROBE(32) LOCAL_SGD_PROBE(40)
#undef LOCAL_SGD_PROBE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(kernel, p.smem, p, W0, X, y, idx, W, m, nl, d, steps, c,
                static_cast<cudaStream_t>(stream));
}

// One warp runs h hinge steps of local_sgd_chain_kernel at width d's
// register entries (d <= 1280), writing one float to out.
extern "C" int local_sgd_chain_launch(int d, int h, float lr0, float t0, float lam, float* out,
                                      void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  const Consts c = make_consts(0.f, h, lr0, t0, lam, 0, 0.f, 1.f);
  switch (register_entries((d + kLanes - 1) / kLanes)) {
#define LOCAL_SGD_CHAIN(E) \
    case E: local_sgd_chain_kernel<E><<<1, kLanes, 0, st>>>(h, c, out); break;
    LOCAL_SGD_CHAIN(1) LOCAL_SGD_CHAIN(2) LOCAL_SGD_CHAIN(4) LOCAL_SGD_CHAIN(6)
    LOCAL_SGD_CHAIN(8) LOCAL_SGD_CHAIN(12) LOCAL_SGD_CHAIN(16) LOCAL_SGD_CHAIN(20)
    LOCAL_SGD_CHAIN(25) LOCAL_SGD_CHAIN(32) LOCAL_SGD_CHAIN(40)
#undef LOCAL_SGD_CHAIN
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's plan at width d: out[0] w's entries a lane in registers (0:
// w in shared memory), out[1] rows in the ring, out[2] rows staged
// together, out[3] shared memory in bytes.  Returns cudaErrorInvalidValue
// for d outside 1 .. local_sgd_max_d().
extern "C" int local_sgd_plan(int d, int* out) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(d);
  out[0] = p.e;
  out[1] = p.ring;
  out[2] = p.batch;
  out[3] = static_cast<int>(p.smem);
  return static_cast<int>(cudaSuccess);
}

// w's entries a lane in registers at width d (0: w in shared memory), and
// the widest d the kernel takes.
extern "C" int local_sgd_register_entries(int d) {
  return register_entries((d + kLanes - 1) / kLanes);
}
extern "C" int local_sgd_max_d() { return kMaxD; }

extern "C" const char* local_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
