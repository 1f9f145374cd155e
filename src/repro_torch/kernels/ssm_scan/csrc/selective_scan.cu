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
// Arithmetic: float32 throughout, each step in the reference's order with
// one rounding per operation (decay = expf(dt A); h = decay h + (dt x) B;
// y = sum_n h C + D x), spelled with __fmul_rn / __fadd_rn so the compiler
// does not contract them into fused multiply-adds, and the true expf (no
// fast math).  The sum over n is a butterfly of warp shuffles, which for
// lane 0 is the order in which the plain version (ref.py) halves the state
// axis.  dt = 0 gives decay = 1 and (dt x) B = 0, so a padded position
// holds the state bit for bit.
//
// What bounds it on this card, at the prefill shape (B 1, S 1024, Dn 8192,
// N 16, x and y bf16): the bytes are x and y at 16.8 MB each, dt (float32)
// at 33.6 MB, and A, B, C, D and the state's read and write under 1.2 MB,
// about 68 MB or 0.020 ms at 3.35 TB/s; the operations are S Dn N = 134 M
// exponentials, about 0.032 ms at the special-function units' 16 a clock
// per SM (132 SMs at 1.98 GHz), and about 7 float32 operations per (t, d, n),
// 0.94 GFLOP or 0.014 ms at 67 TFLOP/s.  So the exponentials bound it, at
// about 0.03 ms.  At the decode shape (B 8, S 1) the state's read and write,
// 8.4 MB, bound it at about 2.5 us.  This first kernel is far from either:
// each step of a channel is a dependent chain (expf, two products, a
// shuffle tree of log2 N steps), and the loop over t is serial.  A chunked
// parallel scan on the tensor cores is later work.
//
// Design: grid = (ceil(Dn / (256 / N)), Bt); a block of 256 threads owns
// 256 / N channels of one sequence (16 at N = 16), and each channel's N
// states sit in N neighbouring lanes' registers for the whole sequence.  The
// block walks t in chunks of `chunk` steps (32 unless the caller passes
// another; the autotuner's ssm_scan family sweeps it): it stages the chunk's
// x and dt
// (channels contiguous, so rows of whole 32-byte sectors at N = 16) and B
// and C (strided rows: the model passes views of x_proj's output, with their
// batch and time strides) in shared memory as float32, steps the
// recurrence, and writes the chunk's y from shared memory.  The staging
// arrays are dynamic shared memory, chunk * (3 * 256 / N + 2 N) floats.  The
// chunk changes only how many steps are staged at once: the loop over t runs
// the same steps in the same order, so y and the state are bit-identical for
// every chunk.  N is a power of
// two up to 32, so a channel's lanes lie in one warp.  At B 1, S 1024 that is
// 131k threads in 512 blocks on 132 SMs.  The TPU kernel's sequential grid
// axis over chunks, with the state in scratch memory, becomes this loop
// inside the block with the state in registers.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline size_t smem_bytes(int n, int chunk) {
  return static_cast<size_t>(chunk) * (3 * (kThreads / n) + 2 * n) * 4;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_mat, const T* __restrict__ b_mat,
                      const T* __restrict__ c_mat, const float* __restrict__ d_vec,
                      float* __restrict__ h, T* __restrict__ y, int s, int dn, int chunk,
                      long long b_sb, long long b_st, long long c_sb, long long c_st) {
  constexpr int kCh = kThreads / N;  // channels per block
  extern __shared__ float smem[];
  float* xs = smem;                // [chunk][kCh]
  float* dts = xs + chunk * kCh;   // [chunk][kCh]
  float* ys = dts + chunk * kCh;   // [chunk][kCh]
  float* bs = ys + chunk * kCh;    // [chunk][N]
  float* cs = bs + chunk * N;      // [chunk][N]

  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < dn;
  const size_t h_off = (static_cast<size_t>(b) * dn + d) * N + n;
  float hv = live ? h[h_off] : 0.f;
  const float a = live ? a_mat[static_cast<size_t>(d) * N + n] : 0.f;
  const float dd = live ? d_vec[d] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * s;  // row of (b, t = 0) in x, dt, y

  for (int t0 = 0; t0 < s; t0 += chunk) {
    const int nt = min(chunk, s - t0);
    for (int i = tid; i < chunk * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      const bool ok = tt < nt && d0 + cc < dn;
      const size_t off = (row0 + t0 + tt) * dn + d0 + cc;
      xs[i] = ok ? to_float(x[off]) : 0.f;
      dts[i] = ok ? dt[off] : 0.f;
    }
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int tt = i / N, nn = i % N;
      const bool ok = tt < nt;
      const long long t = t0 + tt;
      bs[i] = ok ? to_float(b_mat[b * b_sb + t * b_st + nn]) : 0.f;
      cs[i] = ok ? to_float(c_mat[b * c_sb + t * c_st + nn]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float dtv = dts[tt * kCh + c], xv = xs[tt * kCh + c];
      const float decay = expf(__fmul_rn(dtv, a));
      hv = __fadd_rn(__fmul_rn(decay, hv), __fmul_rn(__fmul_rn(dtv, xv), bs[tt * N + n]));
      float p = __fmul_rn(hv, cs[tt * N + n]);
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
      }
      if (n == 0) ys[tt * kCh + c] = __fadd_rn(p, __fmul_rn(dd, xv));
    }
    __syncthreads();
    for (int i = tid; i < nt * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (d0 + cc < dn) y[(row0 + t0 + tt) * dn + d0 + cc] = from_float<T>(ys[i]);
    }
    __syncthreads();
  }
  if (live) h[h_off] = hv;
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* a_mat, const void* b_mat,
           const void* c_mat, const void* d_vec, void* h, void* y, int bt, int s, int dn,
           int chunk, long long b_sb, long long b_st, long long c_sb, long long c_st,
           cudaStream_t stream) {
  constexpr int kCh = kThreads / N;
  const size_t smem = smem_bytes(N, chunk);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    cudaError_t err = cudaFuncSetAttribute(selective_scan_kernel<T, N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((dn + kCh - 1) / kCh, bt);
  selective_scan_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_mat), static_cast<const T*>(b_mat),
      static_cast<const T*>(c_mat), static_cast<const float*>(d_vec),
      static_cast<float*>(h), static_cast<T*>(y), s, dn, chunk, b_sb, b_st, c_sb, c_st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* a_mat, const void* b_mat,
             const void* c_mat, const void* d_vec, void* h, void* y, int bt, int s, int dn,
             int n, int chunk, long long b_sb, long long b_st, long long c_sb, long long c_st,
             cudaStream_t stream) {
  switch (n) {
#define SSM_CASE(N) \
    case N: return launch<T, N>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, bt, s, dn, chunk, b_sb, b_st, c_sb, c_st, stream);
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
// chunk >= 1 time steps staged at once, within
// selective_scan_smem_bytes(n, chunk) <= 232,448.  Returns a cudaError_t (0
// on success).
extern "C" int selective_scan_launch(const void* x, const void* dt, const void* a_mat,
                                     const void* b_mat, const void* c_mat, const void* d_vec,
                                     void* h, void* y, int bt, int s, int dn, int n,
                                     int x_is_bf16, int chunk, long long b_sb, long long b_st,
                                     long long c_sb, long long c_st, void* stream) {
  auto* st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return launch_n<__nv_bfloat16>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, bt, s, dn, n,
                                   chunk, b_sb, b_st, c_sb, c_st, st);
  }
  return launch_n<float>(x, dt, a_mat, b_mat, c_mat, d_vec, h, y, bt, s, dn, n, chunk, b_sb,
                         b_st, c_sb, c_st, st);
}

// Shared memory one block needs for state size n and chunk staged steps.
extern "C" int selective_scan_smem_bytes(int n, int chunk) {
  return static_cast<int>(smem_bytes(n, chunk));
}

extern "C" const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
