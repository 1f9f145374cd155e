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
// step) further below.
//
// Design: grid (m,), one warp of 32 threads a worker, no block barrier.
//   - Lane l owns w's entries l, l + 32, ...: E a lane in registers where
//     d <= 32 E for a compiled E (1 to 40, so d <= 1280; 25 at d = 784, 1 at
//     the chaos run's d = 32: w and three rows in flight take 4 E
//     registers), otherwise in shared memory with the same ownership
//     (d <= kMaxD).  Entries past d are 0 in w and in every row, and stay
//     0.
//   - A step: each lane's partial <x_j, w> over its entries (four
//     accumulators, entry e into e % 4 in order of e, fused multiply-adds,
//     added pairwise), one xor butterfly of shuffles (offsets 16, 8, 4, 2,
//     1), after which every lane holds the same bits and computes gz and lr
//     itself; then each lane updates its own entries.
//   - Rows arrive before they are needed (register path): the order is
//     known for the whole round, so row i + 2 is loaded into registers
//     while step i computes.  Three row buffers rotate by name (the loop is
//     unrolled by three), so no register copy waits on a load.  The
//     shared-memory path reads its rows as it goes.
// Arithmetic: every elementwise operation is the reference's, in its order,
// rounded as written (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nothing
// contracted into a fused multiply-add), lr in float32 as the reference
// computes it.  The only differences from the reference are the order of
// the dot product's sum and, for the logistic loss, expf's last bit.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
// The widest row the kernel takes: w in shared memory stays under the 48 KB
// a block gets without opting in.
constexpr int kMaxD = 12224;

// Entries a lane of the register path, for the compiled E at or above k.
__host__ inline int register_entries(int k) {
  constexpr int kCompiled[] = {1, 2, 4, 6, 8, 12, 16, 20, 25, 32, 40};
  for (int e : kCompiled) {
    if (k <= e) return e;
  }
  return 0;  // shared-memory path
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
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// One step of the register path on row x (its label yj) with size lr.
template <int E>
__device__ __forceinline__ void sgd_step(float (&w)[E], const float (&x)[E], float yj, float lr,
                                         const Consts& c) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e & 3] = __fmaf_rn(x[e], w[e], acc[e & 3]);
  const float s = warp_sum(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])));
  const float z = __fmul_rn(yj, s);
  const float coef = __fmul_rn(slope(z, c), yj);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float g = __fadd_rn(__fmul_rn(coef, x[e]), __fmul_rn(c.lam, w[e]));
    w[e] = __fsub_rn(w[e], __fmul_rn(lr, g));
  }
}

template <int E>
__device__ __forceinline__ void load_row(float (&x)[E], float& yj, const float* Xk,
                                         const float* yk, int j, int d, int lane) {
  const float* src = Xk + static_cast<size_t>(j) * d;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    x[e] = i < d ? __ldg(src + i) : 0.f;
  }
  yj = __ldg(yk + j);
}

// Where a worker is in its chain: its shard, its order, and the index of the
// row two steps ahead (read one step before its row's loads are issued).
struct Chain {
  const float* Xk;
  const float* yk;
  const int* ik;
  int steps, d, lane;
  int j_ahead;
};

// Step i on row cur, after issuing the loads of row i + 2 into spare (free
// since step i - 1 used it).
template <int E>
__device__ __forceinline__ void advance(int i, float (&w)[E], const float (&cur)[E], float y_cur,
                                        float (&spare)[E], float& y_spare, Chain& ch,
                                        const Consts& c) {
  if (i + 2 < ch.steps) load_row<E>(spare, y_spare, ch.Xk, ch.yk, ch.j_ahead, ch.d, ch.lane);
  ch.j_ahead = i + 3 < ch.steps ? __ldg(ch.ik + i + 3) : 0;
  sgd_step<E>(w, cur, y_cur, step_size(c, i), c);
}

// E entries a lane in registers.
template <int E>
__global__ void __launch_bounds__(kLanes)
local_sgd_kernel(const float* __restrict__ W0, const float* __restrict__ X,
                 const float* __restrict__ y, const int* __restrict__ idx, float* __restrict__ W,
                 int nl, int d, int steps, Consts c) {
  const int lane = threadIdx.x;
  const size_t k = blockIdx.x;
  Chain ch{X + k * nl * d, y + k * nl, idx + k * steps, steps, d, lane, 0};
  float w[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    w[e] = i < d ? W0[k * d + i] : 0.f;
  }
  float xa[E], xb[E], xc[E];
  float ya = 0.f, yb = 0.f, yc = 0.f;
  if (steps > 0) load_row<E>(xa, ya, ch.Xk, ch.yk, __ldg(ch.ik), d, lane);
  if (steps > 1) load_row<E>(xb, yb, ch.Xk, ch.yk, __ldg(ch.ik + 1), d, lane);
  ch.j_ahead = steps > 2 ? __ldg(ch.ik + 2) : 0;
  // step i's row is in xa, xb, xc for i % 3 = 0, 1, 2
  for (int i = 0; i < steps; i += 3) {
    advance<E>(i, w, xa, ya, xc, yc, ch, c);
    if (i + 1 < steps) advance<E>(i + 1, w, xb, yb, xa, ya, ch, c);
    if (i + 2 < steps) advance<E>(i + 2, w, xc, yc, xb, yb, ch, c);
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = lane + kLanes * e;
    if (i < d) W[k * d + i] = w[e];
  }
}

// w in shared memory, the same ownership and order of sums: lane l's q-th
// entry l + 32 q goes into accumulator q % 4.  Each lane touches only its
// own entries, so no barrier is needed.
__global__ void __launch_bounds__(kLanes)
local_sgd_smem_kernel(const float* __restrict__ W0, const float* __restrict__ X,
                      const float* __restrict__ y, const int* __restrict__ idx,
                      float* __restrict__ W, int nl, int d, int steps, Consts c) {
  extern __shared__ float ws[];
  const int lane = threadIdx.x;
  const size_t k = blockIdx.x;
  const float* Xk = X + k * nl * d;
  const float* yk = y + k * nl;
  const int* ik = idx + k * steps;
  for (int i = lane; i < d; i += kLanes) ws[i] = W0[k * d + i];
  for (int s = 0; s < steps; ++s) {
    const int j = __ldg(ik + s);
    const float* row = Xk + static_cast<size_t>(j) * d;
    const float yj = __ldg(yk + j);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int q = 0;
    for (int i = lane; i < d; i += kLanes, ++q) {
      acc[q & 3] = __fmaf_rn(__ldg(row + i), ws[i], acc[q & 3]);
    }
    const float sum = warp_sum(__fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3])));
    const float z = __fmul_rn(yj, sum);
    const float coef = __fmul_rn(slope(z, c), yj);
    const float lr = step_size(c, s);
    for (int i = lane; i < d; i += kLanes) {
      const float g = __fadd_rn(__fmul_rn(coef, __ldg(row + i)), __fmul_rn(c.lam, ws[i]));
      ws[i] = __fsub_rn(ws[i], __fmul_rn(lr, g));
    }
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
  switch (register_entries((d + kLanes - 1) / kLanes)) {
#define LOCAL_SGD_CASE(E) \
    case E: local_sgd_kernel<E><<<m, kLanes, 0, st>>>(W0, X, y, idx, W, nl, d, steps, c); break;
    LOCAL_SGD_CASE(1) LOCAL_SGD_CASE(2) LOCAL_SGD_CASE(4) LOCAL_SGD_CASE(6) LOCAL_SGD_CASE(8)
    LOCAL_SGD_CASE(12) LOCAL_SGD_CASE(16) LOCAL_SGD_CASE(20) LOCAL_SGD_CASE(25)
    LOCAL_SGD_CASE(32) LOCAL_SGD_CASE(40)
#undef LOCAL_SGD_CASE
    default:
      local_sgd_smem_kernel<<<m, kLanes, d * sizeof(float), st>>>(W0, X, y, idx, W, nl, d,
                                                                  steps, c);
  }
  return static_cast<int>(cudaGetLastError());
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

// w's entries a lane in registers at width d (0: w in shared memory), and
// the widest d the kernel takes.
extern "C" int local_sgd_register_entries(int d) {
  return register_entries((d + kLanes - 1) / kLanes);
}
extern "C" int local_sgd_max_d() { return kMaxD; }

extern "C" const char* local_sgd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
