// Hopper kernel for the CoCoA local SDCA inner loop (K1).
//
// Replaces src/repro/kernels/sdca/kernel.py::local_sdca_pallas (the Pallas
// TPU kernel), and adds the smooth-hinge update of
// src/repro/optim/cocoa.py::_local_sdca, which the Pallas kernel lacks.
//
// Each of the m workers runs H sequential dual-coordinate updates on its own
// (nl, d) shard:
//   q = s' ||x_j||^2 / (lam n);  margin = y_j <v, x_j>
//   hinge:        a_j <- clip(a_j + (1 - margin) / q, 0, 1)
//   smooth hinge: a_j <- clip(a_j + (1 - margin - g a_j) / (q + g), 0, 1)
//   Delta = 0 when ||x_j|| = 0 (zero-padded rows);  v += s' Delta y_j x_j / (lam n)
// and returns a and dw = (v - w) / s'.
//
// What bounds it on this card: the dependent chain of H steps.  No bandwidth
// shortens it: step t + 1's dot product needs the v that step t's update
// wrote.  The bytes bound, every row of X read once (n d 4 bytes, 188 MB at
// 60000 x 784, about 56 us at 3.35 TB/s), is far below the chain, and the
// flops (about 7 d per step) further below.  So the design makes each link
// of the chain as short as one warp can make it.
//
// Design: grid = (m,), one warp of 32 threads per worker, no block barrier.
//   - Lane l owns v's entries l, l + 32, ...: E a lane in registers when
//     d <= 32 E for a compiled E (up to 64, so d <= 2048; 25 at the paper's
//     d = 784), otherwise in shared memory with the same ownership.  The
//     entries past d are 0 and stay 0.
//   - A step: each lane forms its partial ||x_j||^2 and <v, x_j> over its
//     entries (four accumulators, entry e into e % 4 in order, added
//     pairwise; fused multiply-adds), and one xor butterfly of warp shuffles
//     (offsets 16, 8, 4, 2, 1) reduces both, their stages interleaved.  An
//     xor butterfly leaves the same bits in every lane (float addition
//     commutes), so every lane computes Delta itself with the reference's
//     guards and no broadcast is needed.  Each lane then updates its own v
//     entries; the update of step t is fused with the partial dot products
//     of step t + 1's row, whose entries the lane keeps in registers for the
//     next update.
//   - The update's division by lam n is exact and has no branch (div_by):
//     the compiler's division branches per element, which serialised a
//     lane's updates.  div_by is exact in a domain of the products coef x,
//     which each lane checks as it divides; one warp vote a step sends a
//     step with any product outside it to '/'.
//   - Rows arrive before they are needed: the coordinate order idx is known
//     for the whole round, so a ring of the next P rows sits in shared memory.
//     Where d % 4 == 0 and X is 16-byte aligned, a row is one bulk copy
//     (cp.async.bulk, the copy engine) completing on its slot's mbarrier,
//     and the register path stages four rows every four steps, one lane
//     issuing each, since a step's issue of copies costs about as much as
//     the rest of its work; otherwise every lane issues 4-byte cp.async
//     copies and arrives on the barrier once they land (the d = 33 case).
//     A step waits on the next row's barrier phase only.  P = min(16,
//     64 KB / row) rows for the register path (16 at d = 784, 8 at 2048;
//     ring_rows), 4 or 2 for the shared-memory path, whose v takes a row's
//     room too.
//   - a_j must be the value of the last write to it.  Every lane stores a_j's
//     new value (the same bits) and reads a and y itself, two steps ahead of
//     their use to hide the latency: step t + 2's at the start of step t,
//     after the stores of steps up to t - 1 in the lane's own program order.
//     Where step t + 1's coordinate recurs in step t or t - 1, whose stores
//     that read missed, the value is forwarded from them (coordinates repeat
//     when H > nl draws with replacement).  a is copied to a_out first and
//     updated there in place; a padded row (||x|| = 0) adds Delta = 0 and
//     leaves a_j's bits.
// Arithmetic follows the reference's order inside each step (true division
// by lam n, no fast math); the only difference from it is the order of the
// two sums (32 lane partials, each strided over d, then the butterfly).
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kRingBytes = 64 * 1024;  // staged rows of the register path
constexpr int kMaxRing = 16;
constexpr int kSmemLimit = 232448;     // shared memory one block may use (227 KB)
constexpr int kBarrierBytes = 128;     // the ring's barriers, 8 bytes a slot, room for 16

__host__ __device__ constexpr int clamp_ring(int p) {
  return p < 2 ? 2 : (p > kMaxRing ? kMaxRing : p);
}
// Ring depth of the register path at E entries a lane (rows of 128 E bytes).
__host__ __device__ constexpr int ring_rows(int e) { return clamp_ring(kRingBytes / (128 * e)); }

// Entries a lane of the register path, for the compiled E at or above k.
__host__ inline int register_entries(int k) {
  constexpr int kCompiled[] = {1, 2, 4, 6, 8, 12, 16, 20, 25, 32, 40, 48, 56, 64};
  for (int e : kCompiled) {
    if (k <= e) return e;
  }
  return 0;  // shared-memory path
}

struct Plan {
  int e;      // entries a lane in registers (0: v in shared memory)
  int k;      // entries a lane (the row's stride is 32 k floats)
  int ring;   // rows in the ring
  size_t smem;
};

__host__ inline Plan plan_for(int d) {
  const int k = (d + kLanes - 1) / kLanes;
  Plan p{register_entries(k), k, 0, 0};
  if (p.e > 0) {
    p.k = p.e;
    p.ring = ring_rows(p.e);
    p.smem = kBarrierBytes + static_cast<size_t>(p.ring) * 128 * p.e;
  } else {
    const size_t row = static_cast<size_t>(128) * k;
    p.ring = kBarrierBytes + 5 * row <= kSmemLimit ? 4 : 2;  // the ring and v
    p.smem = kBarrierBytes + (p.ring + 1) * row;
  }
  return p;
}

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
// Stage rows first .. first + count - 1 (those below h) of the round's
// order into their ring slots (row r in slot r % P), each completing on its
// slot's barrier.  Where rows are 16-byte aligned and a multiple of 16 bytes
// (bulk), lane i issues row first + i as one bulk copy, so count <= 32 rows
// cost one issue of the warp; otherwise every lane copies 4 bytes at a time
// and arrives once its copies land, a row after another.  E > 0 bounds d by
// 32 E, so the loop unrolls.
template <int E, int P>
__device__ __forceinline__ void stage_rows(float* ring, uint64_t* bars, int stride,
                                           const float* Xk, const int* ik, int first,
                                           int count, int h, int d, bool bulk, int lane) {
  if (bulk) {
    const int r = first + lane;
    const bool go = lane < count && r < h;
    const int slot = r % P;
    const float* src = Xk + static_cast<size_t>(go ? ik[r] : 0) * d;
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.u32 p, %4, 0;\n"
        " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
        " @p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n}\n"
        ::"r"(smem_addr(ring + slot * stride)), "l"(src), "r"(4 * d),
        "r"(smem_addr(&bars[slot])), "r"(static_cast<uint32_t>(go))
        : "memory");
    return;
  }
  for (int i = 0; i < count && first + i < h; ++i) {
    const int r = first + i;
    float* dst = ring + (r % P) * stride;
    const float* src = Xk + static_cast<size_t>(ik[r]) * d;
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

struct Step {
  float delta;  // the accepted change of a_j
  float coef;   // s' Delta y_j
};

// a / b rounded to nearest, without the branch of the compiler's division:
// for b > 0 and normal, r = RN(1 / b) (the host's float division), and a in
// div_domain.  q = RN(a r) is within 2 ulp of a / b; one correction
// q + (a - b q) r, the remainder exact by a fused multiply-add, brings it
// within 1 ulp, and a second rounds it correctly (Markstein's theorem:
// r within half an ulp of 1 / b, q within 1 ulp of a / b).  The quotient
// takes a's sign (b > 0), which keeps -0 / b = -0.
// tests/test_torch_sdca_gpu.py holds it against '/' bit for bit.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  float q = __fmul_rn(a, r);
  float e = __fmaf_rn(-q, b, a);
  q = __fmaf_rn(e, r, q);
  e = __fmaf_rn(-q, b, a);
  q = __fmaf_rn(e, r, q);
  return copysignf(q, a);  // the sign of a / b, also for a = -0
}
// Where div_by is exact for 2^-20 <= b <= 2^20 (the launcher passes r = 0,
// which no a passes, for any other lam n): 0, or 2^-100 <= |a| <= 2^100, so
// that no step overflows and no remainder falls below the normal range.
// Anything else (inf, NaN, extremes) goes to '/'.
__device__ __forceinline__ bool div_domain(float a, float r) {
  const float m = fabsf(a);
  return r != 0.f && m <= 0x1p100f && (m >= 0x1p-100f || a == 0.f);
}

// The reference's update of one coordinate from the reduced sums.
__device__ __forceinline__ Step sdca_step(float sxx, float sxv, float aj, float yj,
                                          float sigma_prime, float lam_n, float r_lam_n,
                                          bool smooth, float gamma) {
  const float sq = sigma_prime * sxx;
  const float q = div_domain(sq, r_lam_n) ? div_by(sq, lam_n, r_lam_n) : sq / lam_n;
  const float margin = yj * sxv;
  float delta_raw;
  if (smooth) {
    delta_raw = (1.f - margin - gamma * aj) / (q + gamma);
  } else {
    delta_raw = q > 0.f ? (1.f - margin) / fmaxf(q, 1e-30f) : 0.f;
  }
  const float a_new = fminf(fmaxf(aj + delta_raw, 0.f), 1.f);
  const float delta = sxx > 0.f ? a_new - aj : 0.f;
  return {delta, sigma_prime * delta * yj};
}

// A lane's partial ||x||^2 and <v, x>: its entry e goes into accumulator
// e % 4 in order of e; the four are added pairwise at the end.
struct Partial {
  float xx[4] = {0.f, 0.f, 0.f, 0.f};
  float xv[4] = {0.f, 0.f, 0.f, 0.f};
  __device__ __forceinline__ void add(int e, float x, float v) {
    xx[e & 3] = __fmaf_rn(x, x, xx[e & 3]);
    xv[e & 3] = __fmaf_rn(v, x, xv[e & 3]);
  }
  __device__ __forceinline__ float sum_xx() const { return (xx[0] + xx[1]) + (xx[2] + xx[3]); }
  __device__ __forceinline__ float sum_xv() const { return (xv[0] + xv[1]) + (xv[2] + xv[3]); }
};

// Both sums over the warp: one xor butterfly, the two reductions' stages
// interleaved; every lane ends with the same bits.
__device__ __forceinline__ void warp_sums(float& xx, float& xv) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    xx += __shfl_xor_sync(0xffffffffu, xx, off);
    xv += __shfl_xor_sync(0xffffffffu, xv, off);
  }
}

// The register path's update of v by step t's row xc, fused with the
// partial sums of the next row nxt (whose entries replace xc):
// v += (coef x) / lam_n, the reference's operations, its division by
// div_by where every lane's products are in its domain, else by '/'.
template <int E>
__device__ __forceinline__ Partial update_and_dot(float (&v)[E], float (&xc)[E],
                                                  const float* nxt, int lane, float coef,
                                                  float lam_n, float r_lam_n) {
  Partial p;
  if (coef != 0.f) {  // adding 0 * x leaves v as it is
    float u[E];
    bool ok = true;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float a = __fmul_rn(coef, xc[e]);
      u[e] = div_by(a, lam_n, r_lam_n);
      ok &= div_domain(a, r_lam_n);
    }
    if (!__all_sync(0xffffffffu, ok)) {
#pragma unroll
      for (int e = 0; e < E; ++e) u[e] = __fmul_rn(coef, xc[e]) / lam_n;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = v[e] + u[e];
      const float xn = nxt[lane + kLanes * e];
      p.add(e, xn, v[e]);
      xc[e] = xn;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xn = nxt[lane + kLanes * e];
      p.add(e, xn, v[e]);
      xc[e] = xn;
    }
  }
  return p;
}

// E > 0: v in registers, E entries a lane.  E == 0: v in shared memory,
// k = ceil(d / 32) entries a lane.  P: rows in the ring.
template <int E, int P>
__global__ void __launch_bounds__(kLanes)
sdca_kernel(const float* __restrict__ X, const float* __restrict__ y,
            const float* __restrict__ a_in, const float* __restrict__ w,
            const int* __restrict__ idx, float* a_out, float* __restrict__ dw, int nl, int d,
            int h, int k_lane, float sigma_prime, float lam_n, float r_lam_n, int smooth,
            float gamma) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kRegs = E > 0;
  // rows staged together: a step's issue of copies costs about as much as
  // its arithmetic, so the register path issues four rows every four steps
  // (P >= 8 leaves at least four staged ahead)
  constexpr int kB = P >= 8 ? 4 : 1;
  const int kk = kRegs ? E : k_lane;
  const int stride = kLanes * kk;  // floats a ring slot
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [P], one a slot
  float* ring = smem + kBarrierBytes / 4;               // [P][stride]
  float* vs = ring + P * stride;                        // [stride], the shared-memory path's v

  const int lane = threadIdx.x;
  const size_t k = blockIdx.x;
  const float* Xk = X + k * nl * d;
  const float* yk = y + k * nl;
  const int* ik = idx + k * h;
  float* ak = a_out + k * nl;
  const bool bulk = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(Xk) % 16 == 0);
  const bool sm = smooth != 0;

  // the slots' entries past d stay 0; the copies never write them
  for (int s = 0; s < P; ++s) {
    for (int i = d + lane; i < stride; i += kLanes) ring[s * stride + i] = 0.f;
  }
  if (lane == 0) {
    for (int s = 0; s < P; ++s) mbar_init(&bars[s], bulk ? 1 : kLanes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // row t sits in slot t % P; its barrier's (t / P)-th phase completes when
  // it has landed.  Rows 0 .. P - 1 now; then, every kB steps, the kB rows
  // whose slots the steps since have freed.
  stage_rows<E, P>(ring, bars, stride, Xk, ik, 0, P, h, d, bulk, lane);
  for (int i = lane; i < nl; i += kLanes) ak[i] = a_in[k * nl + i];

  float v[kRegs ? E : 1];
  float xc[kRegs ? E : 1];  // the register path's current row
  if constexpr (kRegs) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + kLanes * e;
      v[e] = i < d ? w[i] : 0.f;
    }
  } else {
    for (int i = lane; i < stride; i += kLanes) vs[i] = i < d ? w[i] : 0.f;
  }
  if (h > 0) mbar_wait(&bars[0], 0);  // row 0
  __syncwarp();  // every lane's zeros and a_out writes visible to all

  // step 0's partial sums, and its coordinate, a and y
  Partial p;
  if constexpr (kRegs) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      xc[e] = ring[lane + kLanes * e];
      p.add(e, xc[e], v[e]);
    }
  } else {
    for (int e0 = 0; e0 < kk; e0 += 4) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = lane + kLanes * (e0 + r);
        if (e0 + r < kk) p.add(r, ring[i], vs[i]);
      }
    }
  }
  // Steps t, t + 1 and t + 2's coordinates; a and y of step t and t + 1
  // (a1 read before the stores of steps t - 1 and t, so it is taken from
  // them where the coordinate recurs: a_prev, a_new).
  int j = h > 0 ? ik[0] : 0;
  float aj = h > 0 ? ak[j] : 0.f;
  float yj = h > 0 ? yk[j] : 0.f;
  int j1 = h > 1 ? ik[1] : 0;
  float a1 = h > 1 ? ak[j1] : 0.f;
  float y1 = h > 1 ? yk[j1] : 0.f;
  int j2 = h > 2 ? ik[2] : 0;
  int j_prev = -1;
  float a_prev = 0.f;

  for (int t = 0; t < h; ++t) {
    // step t + 2's a and y, read two steps ahead of their use, before this
    // step's store (after the earlier ones, in this lane's program order)
    const bool far2 = t + 2 < h;
    const float a2 = far2 ? ak[j2] : 0.f;
    const float y2 = far2 ? yk[j2] : 0.f;
    const int j3 = t + 3 < h ? ik[t + 3] : 0;

    float sxx = p.sum_xx(), sxv = p.sum_xv();
    warp_sums(sxx, sxv);
    const Step st = sdca_step(sxx, sxv, aj, yj, sigma_prime, lam_n, r_lam_n, sm, gamma);
    const float a_new = aj + st.delta;
    ak[j] = a_new;  // every lane stores the same bits
    // step t + 1's a: the last write to its coordinate
    const float a_next = j1 == j ? a_new : (j1 == j_prev ? a_prev : a1);

    if (t + 1 < h) mbar_wait(&bars[(t + 1) % P], ((t + 1) / P) & 1);  // row t + 1
    __syncwarp();  // every lane is done with row t's slot (the register path)
    const float* nxt = ring + ((t + 1) % P) * stride;
    const float coef = st.coef;
    if constexpr (kRegs) {
      // rows up to t are consumed (row t is in xc): their slots take the
      // rows up to t + P
      if ((t + 1) % kB == 0) {
        stage_rows<E, P>(ring, bars, stride, Xk, ik, t + P - kB + 1, kB, h, d, bulk, lane);
      }
      p = update_and_dot<E>(v, xc, nxt, lane, coef, lam_n, r_lam_n);
    } else {
      const float* cur = ring + (t % P) * stride;
      p = Partial();
      for (int e0 = 0; e0 < kk; e0 += 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = lane + kLanes * (e0 + r);
          if (e0 + r < kk) {
            float vi = vs[i];
            if (coef != 0.f) {
              vi = vi + __fmul_rn(coef, cur[i]) / lam_n;
              vs[i] = vi;
            }
            p.add(r, nxt[i], vi);
          }
        }
      }
      __syncwarp();  // every lane is done with row t's slot
      if ((t + 1) % kB == 0) {
        stage_rows<E, P>(ring, bars, stride, Xk, ik, t + P - kB + 1, kB, h, d, bulk, lane);
      }
    }
    j_prev = j;
    a_prev = a_new;
    j = j1;
    aj = a_next;
    yj = y1;
    j1 = j2;
    a1 = a2;
    y1 = y2;
    j2 = j3;
  }
  if constexpr (kRegs) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane + kLanes * e;
      if (i < d) dw[k * d + i] = (v[e] - w[i]) / sigma_prime;
    }
  } else {
    for (int i = lane; i < d; i += kLanes) dw[k * d + i] = (vs[i] - w[i]) / sigma_prime;
  }
}

// The dependent chain of the register path's step without its memory
// traffic: h steps of the butterfly, the scalar update and the fused update
// of v and next partial sums, on one fixed row held in registers (the ring
// slot of the next row is that row, in shared memory), the update always
// taken.  Its time a step is the least dependent latency of a step that
// moves a_j (chip_smoke.py's chain floor).
template <int E>
__global__ void __launch_bounds__(kLanes)
sdca_chain_kernel(int h, float lam_n, float r_lam_n, float* out) {
  __shared__ float row[kLanes * E];
  const int lane = threadIdx.x;
  float v[E], xc[E];
  Partial p;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    v[e] = 0.f;
    xc[e] = 1e-3f * static_cast<float>(lane + kLanes * e + 1);
    row[lane + kLanes * e] = xc[e];
    p.add(e, xc[e], v[e]);
  }
  __syncwarp();
  float aj = 0.f;
  for (int t = 0; t < h; ++t) {
    float sxx = p.sum_xx(), sxv = p.sum_xv();
    warp_sums(sxx, sxv);
    const Step st = sdca_step(sxx, sxv, aj, 1.f, 1.f, lam_n, r_lam_n, false, 1.f);
    aj = aj + st.delta;
    // the update always taken: a coefficient that is never 0
    const float coef = st.coef == 0.f ? 1e-20f : st.coef;
    p = update_and_dot<E>(v, xc, row, lane, coef, lam_n, r_lam_n);
  }
  if (lane == 0) out[0] = p.sum_xv() + aj;
}

// q[i] = a[i] / b as the kernel divides: div_by in its domain, '/' else.
__global__ void sdca_divide_kernel(const float* __restrict__ a, float* __restrict__ q, int n,
                                   float b, float r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) q[i] = div_domain(a[i], r) ? div_by(a[i], b, r) : a[i] / b;
}

template <int E, int P>
int launch(const float* X, const float* y, const float* a, const float* w, const int* idx,
           float* a_out, float* dw, int m, int nl, int d, int h, int k_lane,
           float sigma_prime, float lam_n, int smooth, float gamma, size_t smem,
           cudaStream_t stream) {
  // the host's IEEE division; 0 keeps every division on '/'
  const float r_lam_n = lam_n >= 0x1p-20f && lam_n <= 0x1p20f ? 1.f / lam_n : 0.f;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        sdca_kernel<E, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sdca_kernel<E, P><<<m, kLanes, smem, stream>>>(X, y, a, w, idx, a_out, dw, nl, d, h,
                                                 k_lane, sigma_prime, lam_n, r_lam_n, smooth,
                                                 gamma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X (m, nl, d), y, a (m, nl) and w (d,) float32, idx (m, h) int32, all
// contiguous; a_out (m, nl) and dw (m, d) written.  loss 0 is the hinge, 1
// the smooth hinge.  d <= sdca_max_d().  Returns a cudaError_t (0 on success).
extern "C" int sdca_launch(const float* X, const float* y, const float* a,
                           const float* w, const int* idx, float* a_out,
                           float* dw, int m, int nl, int d, int h,
                           float sigma_prime, float lam_n, int loss,
                           float gamma, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  const Plan p = plan_for(d);
  if (d < 1 || p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const int smooth = loss == 1;
  switch (p.e) {
#define SDCA_CASE(E) \
    case E: return launch<E, ring_rows(E)>(X, y, a, w, idx, a_out, dw, m, nl, d, h, p.k, \
                                           sigma_prime, lam_n, smooth, gamma, p.smem, st);
    SDCA_CASE(1) SDCA_CASE(2) SDCA_CASE(4) SDCA_CASE(6) SDCA_CASE(8) SDCA_CASE(12)
    SDCA_CASE(16) SDCA_CASE(20) SDCA_CASE(25) SDCA_CASE(32) SDCA_CASE(40) SDCA_CASE(48)
    SDCA_CASE(56) SDCA_CASE(64)
#undef SDCA_CASE
    case 0:
      if (p.ring == 4) {
        return launch<0, 4>(X, y, a, w, idx, a_out, dw, m, nl, d, h, p.k, sigma_prime, lam_n,
                            smooth, gamma, p.smem, st);
      }
      return launch<0, 2>(X, y, a, w, idx, a_out, dw, m, nl, d, h, p.k, sigma_prime, lam_n,
                          smooth, gamma, p.smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One warp runs h steps of sdca_chain_kernel at width d's register entries
// (d <= 2048), writing one float to out.
extern "C" int sdca_chain_launch(int d, int h, float lam_n, float* out, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  const float r_lam_n = lam_n >= 0x1p-20f && lam_n <= 0x1p20f ? 1.f / lam_n : 0.f;
  switch (plan_for(d).e) {
#define SDCA_CHAIN(E) \
    case E: sdca_chain_kernel<E><<<1, kLanes, 0, st>>>(h, lam_n, r_lam_n, out); break;
    SDCA_CHAIN(1) SDCA_CHAIN(2) SDCA_CHAIN(4) SDCA_CHAIN(6) SDCA_CHAIN(8) SDCA_CHAIN(12)
    SDCA_CHAIN(16) SDCA_CHAIN(20) SDCA_CHAIN(25) SDCA_CHAIN(32) SDCA_CHAIN(40)
    SDCA_CHAIN(48) SDCA_CHAIN(56) SDCA_CHAIN(64)
#undef SDCA_CHAIN
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's division of n floats by b into q (tests hold it against '/').
extern "C" int sdca_divide_launch(const float* a, float* q, int n, float b, void* stream) {
  const float r = b >= 0x1p-20f && b <= 0x1p20f ? 1.f / b : 0.f;
  if (n > 0) {
    sdca_divide_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(a, q, n,
                                                                                      b, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one worker's block needs at width d: the ring's rows, plus v
// on the shared-memory path.
extern "C" int sdca_smem_bytes(int d) { return static_cast<int>(plan_for(d).smem); }

// Rows in the ring at width d, and v's entries a lane in registers (0: v in
// shared memory).
extern "C" int sdca_ring_rows(int d) { return plan_for(d).ring; }
extern "C" int sdca_register_entries(int d) { return plan_for(d).e; }

extern "C" const char* sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
