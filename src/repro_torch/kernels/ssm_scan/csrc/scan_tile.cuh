// The tile of the selective scan's time-parallel bodies, shared by K4's
// forward (selective_scan.cu) and its backward (selective_scan_bwd.cu): the
// tile geometry, the staged rows' layout, the conversions, and the forward
// lane scan.  The backward recomputes each tile's states with the forward's
// own code, so its states carry the forward's bits.
//
// A tile is 256 positions anchored at position 0; a warp scans one channel's
// tile, lane l the 8 consecutive positions 8 l .. 8 l + 7.  A staged row of a
// tile holds position t at tile_slot(t) = t + 4 (t / 32), so lane l's 8
// positions are two 16-byte reads and a quarter warp's reads cover all 32
// banks once; 292 floats keep every row 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace scan_tile {

constexpr int kItems = 8;             // consecutive positions a lane
constexpr int kTile = 32 * kItems;    // positions a warp scans together
constexpr int kLd = kTile + 4 * (kTile / 32) + 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ int tile_slot(int t) { return t + 4 * (t >> 5); }

// Lane l's 8 consecutive values of a staged row, and their store.
__device__ __forceinline__ void read8(const float* row, int lane, float (&v)[kItems]) {
  const float4* p = reinterpret_cast<const float4*>(row + tile_slot(kItems * lane));
  const float4 lo = p[0], hi = p[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}
__device__ __forceinline__ void write8(float* row, int lane, const float (&v)[kItems]) {
  float4* p = reinterpret_cast<float4*>(row + tile_slot(kItems * lane));
  p[0] = make_float4(v[0], v[1], v[2], v[3]);
  p[1] = make_float4(v[4], v[5], v[6], v[7]);
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

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A row of K contiguous elements of a T array as raw 16-byte words, or one
// element a word where the row is not 16-byte aligned (vec false) or K
// elements do not fill whole words.
template <typename T, int K>
struct RawRow {
  static constexpr int kPer = 16 / sizeof(T);   // elements a 16-byte word
  static constexpr bool kWords = K % kPer == 0;
  static constexpr int kN = kWords ? K / kPer : K;
  uint4 w[kWords ? K / kPer : 1];
  float f[kWords ? 1 : K];

  __device__ __forceinline__ void load(const T* src, bool in, bool vec) {
    if constexpr (kWords) {
      if (vec) {
#pragma unroll
        for (int q = 0; q < kN; ++q) {
          w[q] = in ? reinterpret_cast<const uint4*>(src)[q] : make_uint4(0, 0, 0, 0);
        }
        return;
      }
      const T* p = src;
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        alignas(16) T e[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) e[k] = in ? p[q * kPer + k] : T(0.f);
        w[q] = *reinterpret_cast<const uint4*>(e);
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) f[k] = in ? to_float(src[k]) : 0.f;
    }
  }
  // element k as float32 (exact for bf16)
  __device__ __forceinline__ float at(int k) const {
    if constexpr (!kWords) {
      return f[k];
    } else if constexpr (sizeof(T) == 4) {
      const uint4& u = w[k / 4];
      const unsigned b = (k % 4 == 0) ? u.x : (k % 4 == 1) ? u.y : (k % 4 == 2) ? u.z : u.w;
      return __uint_as_float(b);
    } else {
      const uint4& u = w[k / 8];
      const int j = (k % 8) / 2;
      const unsigned b = j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
      return __uint_as_float(k % 2 == 0 ? b << 16 : b & 0xffff0000u);
    }
  }
};

// The forward lane scan of one (channel, state) over a tile: given the
// lane's 8 pairs (a_i, b_i) and the state carried into the tile, returns
// the state after the lane before (the carry itself at lane 0), from which
// the lane runs its 8 steps h = a_i h + b_i.  The lane's pairs are combined
// in order, serially; the kLanes lanes' products by an inclusive
// Hillis-Steele scan with __shfl_up_sync (five stages at 32 lanes), the
// lanes below the offset combining with the identity (1, 0), which leaves
// them as they are.  kLanes 16 scans each half-warp on its own (``lane`` is
// the lane within it): K4-bwd's half tiles of 128 positions, whose values
// are those of the 32-lane scan with (1, 0) pairs in lanes 16-31.
template <int kLanes = 32>
__device__ __forceinline__ float state_before_lane(const float (&av)[kItems],
                                                   const float (&bv)[kItems], float carry,
                                                   int lane) {
  float pa = av[0], pb = bv[0];
#pragma unroll
  for (int i = 1; i < kItems; ++i) {
    pb = __fmaf_rn(av[i], pb, bv[i]);
    pa = __fmul_rn(pa, av[i]);
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    float qa = __shfl_up_sync(0xffffffffu, pa, off, kLanes);
    float qb = __shfl_up_sync(0xffffffffu, pb, off, kLanes);
    qa = lane >= off ? qa : 1.f;
    qb = lane >= off ? qb : 0.f;
    pb = __fmaf_rn(pa, qb, pb);
    pa = __fmul_rn(qa, pa);
  }
  float hv = __fmaf_rn(pa, carry, pb);                   // the state after this lane
  hv = __shfl_up_sync(0xffffffffu, hv, 1, kLanes);       // ... after the lane before
  return lane == 0 ? carry : hv;
}

}  // namespace scan_tile
