// K9 splat_points — replaces tendrils_tpu/ops/splat_pallas.py:
// splat_accumulate (_kernel), the generic point splat that paints the
// pointer flow-line ribbons into the flow grid (engine._inject_flow).
//
// One thread per sample (x, y, alpha, C payload values). Each computes the
// four bilinear corners and weights exactly as ops/splat._bilinear_corners
// does (pixel centres at +0.5, a validity test per corner) and adds, for
// each in-grid corner of weight w,
//   num[k]  += value[k] * (alpha * w)      for k < C,
//   wsum    += alpha * w,
//   logt    += log1p(-min(alpha, 1 - 1e-4)) * w
// into an UNPADDED [C + 2, H, W] accumulator.
// The TPU kernel pads the grid, clamps samples into the margin and zeroes
// the alpha of samples the clamp moved, so that its tile-region DMAs stay in
// bounds; that computes the same function as the per-corner validity test,
// which this kernel uses, and it never writes outside the grid. A sample
// within 1 px outside the grid deposits its in-grid corners only; one
// further out deposits nothing. Samples of alpha 0 (pad segments, masked
// crest rows) add only zeros and return early.
//
// The sums are int64 fixed point, as K2's (common.cuh: `fixed_shift`), so
// they do not depend on the order of the adds and a frame replays bit for
// bit. The payload has no static bound, so a first launch reduces each
// channel's largest |add| on the device (`atomicMax` on the bits of a
// non-negative float, which order as the floats do; a max does not depend
// on the order either): |value x alpha| for the payload, |alpha| for wsum,
// |log1p(-alpha)| for logt (the bilinear weights are <= 1 and only shrink
// an add). A sample adds at most once to a texel (its 4 corners are
// distinct), so a texel receives at most M adds. The second launch adds
// into an int64 [C + 2, H, W] scratch, the third converts it to the f32
// accumulator.
//
// Bound: bytes. Each sample reads 12 + 4C bytes (twice: the bounds, the
// adds); the accumulator is written once, (C + 2) x H x W x 4 bytes: 22.1
// MB for C = 4 on the 720 x 1280 flow grid, ~6.6 us at 3.35 TB/s, which
// dominates at the few thousand samples of a pointer frame (the scratch
// adds its zeroing and one read, 2 x 8 B a texel). The TPU sorts samples
// by tile and multiplies one-hot bf16 matrices on the MXU because it has
// no fast scatter; Hopper's 64-bit integer atomicAdd into L2 (RED.ADD.64)
// computes the same sums.
#include "common.cuh"

namespace {

using namespace tt;

// The bilinear footprint of sample i: false when it adds nothing (alpha
// 0, no corner in the grid, or NaN); else its corner (x0i, y0i), weights
// and alpha.
struct Corners {
  int x0i, y0i;
  float wgt[4], a;
};

__device__ __forceinline__ bool corners_of(const float* __restrict__ xs,
                                           const float* __restrict__ ys,
                                           const float* __restrict__ alpha,
                                           int i, int h, int w, Corners& k) {
  k.a = alpha[i];
  if (k.a == 0.0f) return false;
  const float gx = xs[i] - 0.5f;
  const float gy = ys[i] - 0.5f;
  const float x0 = floorf(gx);
  const float y0 = floorf(gy);
  // No corner in the grid (or NaN): nothing to add, and the int casts
  // below stay in range.
  if (!(x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f &&
        y0 <= (float)(h - 1))) {
    return false;
  }
  const float fx = gx - x0;
  const float fy = gy - y0;
  k.x0i = (int)x0;
  k.y0i = (int)y0;
  k.wgt[0] = (1.0f - fx) * (1.0f - fy);
  k.wgt[1] = fx * (1.0f - fy);
  k.wgt[2] = (1.0f - fx) * fy;
  k.wgt[3] = fx * fy;
  return true;
}

__device__ __forceinline__ float log1a_of(float a) {
  return log1pf(-fminf(a, (float)(1.0 - 1e-4)));
}

// Launch 1: bits[k] = the float bits of channel k's largest |add|.
__global__ void splat_points_bound_kernel(const float* __restrict__ xs,
                                          const float* __restrict__ ys,
                                          const float* __restrict__ values,
                                          const float* __restrict__ alpha,
                                          int c, int m, int h, int w,
                                          int* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Corners k;
  const bool on = i < m && corners_of(xs, ys, alpha, i, h, w, k);
  for (int ch = 0; ch < c + 2; ++ch) {
    float v = 0.0f;
    if (on) {
      v = ch < c ? fabsf(values[(long long)ch * m + i] * k.a)
                 : (ch == c ? fabsf(k.a) : fabsf(log1a_of(k.a)));
    }
    for (int off = 16; off > 0; off >>= 1) {
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if ((threadIdx.x & 31) == 0 && v > 0.0f) {
      atomicMax(bits + ch, __float_as_int(v));
    }
  }
}

// 2^S_k of channel k: M adds at most of at most the reduced bound.
__device__ __forceinline__ float points_scale(const int* __restrict__ bits,
                                              int k, int m, int sign) {
  return pow2f(sign * fixed_shift(__int_as_float(bits[k]), m));
}

// Launch 2: for each in-grid corner of weight w,
//   num[k] += value[k] * (alpha * w) for k < C, wsum += alpha * w,
//   logt += log1p(-min(alpha, 1 - 1e-4)) * w,
// each quantised at its channel's scale.
__global__ void splat_points_kernel(const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    const float* __restrict__ values,
                                    const float* __restrict__ alpha, int c,
                                    int m, int h, int w,
                                    const int* __restrict__ bits,
                                    long long* __restrict__ fix) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Corners k;
  if (i >= m || !corners_of(xs, ys, alpha, i, h, w, k)) return;
  const float log1a = log1a_of(k.a);
  const long long plane = (long long)h * w;
  for (int j = 0; j < 4; ++j) {
    const int cx = k.x0i + (j & 1);
    const int cy = k.y0i + (j >> 1);
    if (cx < 0 || cx >= w || cy < 0 || cy >= h) continue;
    unsigned long long* texel =
        reinterpret_cast<unsigned long long*>(fix) + (long long)cy * w + cx;
    const float aw = k.a * k.wgt[j];
    for (int ch = 0; ch < c; ++ch) {
      atomicAdd(texel + ch * plane,
                (unsigned long long)quantise(
                    values[(long long)ch * m + i] * aw,
                    points_scale(bits, ch, m, 1)));
    }
    atomicAdd(texel + c * plane,
              (unsigned long long)quantise(aw, points_scale(bits, c, m, 1)));
    atomicAdd(texel + (c + 1) * plane,
              (unsigned long long)quantise(log1a * k.wgt[j],
                                           points_scale(bits, c + 1, m, 1)));
  }
}

// Launch 3: the f32 accumulator from the scratch, one thread a texel.
__global__ void splat_points_convert_kernel(const long long* __restrict__ fix,
                                            const int* __restrict__ bits,
                                            int c, int m, long long plane,
                                            float* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(c + 2) * plane) return;
  acc[i] = __ll2float_rn(__ldcs(fix + i)) *
           points_scale(bits, (int)(i / plane), m, -1);
}

}  // namespace

// `bits`: i32[C + 2] and `fix`: int64 [C + 2, H, W] scratch, zeroed here;
// `accum`: f32 [C + 2, H, W], every texel written.
extern "C" int tt_splat_points(const float* x, const float* y,
                               const float* values, const float* alpha,
                               int c, int m, int h, int w, int* bits,
                               long long* fix, float* accum, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long plane = (long long)h * w;
  cudaMemsetAsync(bits, 0, (c + 2) * sizeof(int), s);
  cudaMemsetAsync(fix, 0, (c + 2) * plane * sizeof(long long), s);
  if (m > 0) {
    splat_points_bound_kernel<<<blocks_for(m), THREADS, 0, s>>>(
        x, y, values, alpha, c, m, h, w, bits);
    splat_points_kernel<<<blocks_for(m), THREADS, 0, s>>>(
        x, y, values, alpha, c, m, h, w, bits, fix);
  }
  splat_points_convert_kernel<<<blocks_for((c + 2) * plane), THREADS, 0,
                                s>>>(fix, bits, c, m, plane, accum);
  return (int)cudaGetLastError();
}
