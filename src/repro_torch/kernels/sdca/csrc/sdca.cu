// Hopper kernel for the CoCoA local SDCA inner loop.
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
// What bounds it on this card: the dependent chain of H steps.  Each step
// loads one row x_j and reduces ||x_j||^2 and <v, x_j> across the block (warp
// shuffles, then shared memory) before one thread can compute Delta, and the
// axpy into v must finish before the next step's dot product.  So a worker
// costs H times (row-load latency + two barriers + a shuffle reduction), some
// microseconds a step.  The bytes bound, every row of X read once
// (n d 4 bytes, 188 MB at 60000 x 784, about 56 us at 3.35 TB/s), is far
// below that chain, and the flops (about 7 d per step) are further below.
//
// Design: grid = (m,), one block of 256 threads per worker; workers are
// independent, so with m < 132 most SMs idle and m = 1 runs all n steps on
// one SM.  v (d floats) lives in dynamic shared memory; each thread owns the
// entries i = tid + k * 256, so the dot product and the axpy touch only the
// thread's own entries and need no barrier between them.  a is copied to
// a_out first and updated there in place.  Thread 0 computes Delta with the
// reference's guards and broadcasts s' Delta y_j through shared memory; the
// two barriers a step order every read of a_out[j] after the last write to
// it, which matters when indices repeat (h > nl).  Arithmetic follows the
// reference's order (true division by lam n, no fast math) so that the only
// difference from it is the order of the two sums.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float x) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, offset);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
sdca_kernel(const float* __restrict__ X, const float* __restrict__ y,
            const float* __restrict__ a_in, const float* __restrict__ w,
            const int* __restrict__ idx, float* __restrict__ a_out,
            float* __restrict__ dw, int nl, int d, int h, float sigma_prime,
            float lam_n, int smooth, float gamma) {
  extern __shared__ float v[];       // (d,) the worker's local view of w
  __shared__ float partial[2][kWarps];  // per-warp ||x||^2 and <v, x>
  __shared__ float coef_shared;      // s' * Delta * y_j of this step

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t k = blockIdx.x;
  const float* Xk = X + k * nl * d;
  const float* yk = y + k * nl;
  const int* ik = idx + k * h;
  float* ak = a_out + k * nl;

  for (int i = tid; i < nl; i += kThreads) ak[i] = a_in[k * nl + i];
  for (int i = tid; i < d; i += kThreads) v[i] = w[i];
  __syncthreads();

  for (int t = 0; t < h; ++t) {
    const int j = ik[t];
    const float* x = Xk + static_cast<size_t>(j) * d;
    float xx = 0.f;
    float xv = 0.f;
    for (int i = tid; i < d; i += kThreads) {
      const float xi = x[i];
      xx += xi * xi;
      xv += v[i] * xi;
    }
    xx = warp_sum(xx);
    xv = warp_sum(xv);
    if (lane == 0) {
      partial[0][warp] = xx;
      partial[1][warp] = xv;
    }
    __syncthreads();
    if (tid == 0) {
      float sxx = 0.f;
      float sxv = 0.f;
      for (int r = 0; r < kWarps; ++r) {
        sxx += partial[0][r];
        sxv += partial[1][r];
      }
      const float yj = yk[j];
      const float aj = ak[j];
      const float q = sigma_prime * sxx / lam_n;
      const float margin = yj * sxv;
      float delta_raw;
      if (smooth) {
        delta_raw = (1.f - margin - gamma * aj) / (q + gamma);
      } else {
        delta_raw = q > 0.f ? (1.f - margin) / fmaxf(q, 1e-30f) : 0.f;
      }
      const float a_new = fminf(fmaxf(aj + delta_raw, 0.f), 1.f);
      const float delta = sxx > 0.f ? a_new - aj : 0.f;
      ak[j] = aj + delta;
      coef_shared = sigma_prime * delta * yj;
    }
    __syncthreads();
    const float coef = coef_shared;
    if (coef != 0.f) {  // adding 0 * x leaves v as it is
      for (int i = tid; i < d; i += kThreads) v[i] = v[i] + coef * x[i] / lam_n;
    }
  }
  for (int i = tid; i < d; i += kThreads) dw[k * d + i] = (v[i] - w[i]) / sigma_prime;
}

}  // namespace

extern "C" int sdca_launch(const float* X, const float* y, const float* a,
                           const float* w, const int* idx, float* a_out,
                           float* dw, int m, int nl, int d, int h,
                           float sigma_prime, float lam_n, int loss,
                           float gamma, void* stream) {
  if (m == 0) return static_cast<int>(cudaSuccess);
  sdca_kernel<<<m, kThreads, d * sizeof(float),
                static_cast<cudaStream_t>(stream)>>>(
      X, y, a, w, idx, a_out, dw, nl, d, h, sigma_prime, lam_n, loss == 1,
      gamma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sdca_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
