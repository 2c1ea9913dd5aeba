// K9 splat_points — replaces tendrils_tpu/ops/splat_pallas.py:
// splat_accumulate (_kernel), the generic point splat that paints the
// pointer flow-line ribbons into the flow grid (engine._inject_flow).
//
// Each sample (x, y, alpha, C payload values) has four bilinear corners and
// weights computed exactly as ops/splat._bilinear_corners does (pixel
// centres at +0.5, a validity test per corner) and adds, for each in-grid
// corner of weight w,
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
// bit. The payload has no static bound, so each channel's largest |add| is
// reduced on the device first (a max does not depend on the order either):
// |value x alpha| for the payload, |alpha| for wsum, |log1p(-alpha)| for
// logt (the bilinear weights are <= 1 and only shrink an add). A sample adds
// at most once to a texel (its 4 corners are distinct), so a texel receives
// at most M adds.
//
// The int64 scratch is the caller's and is kept between calls, all zero
// (ops/splat_cuda.py allocates it zeroed once). The grid is cut into
// POINT_TILE_H x POINT_TILE_W tiles; every in-grid corner stores `epoch`
// (the caller's call counter) into its tile's mark, so a tile counts as
// touched in this call iff its mark equals this call's epoch, and marks of
// earlier calls need no clearing. The conversion reads and zeroes the
// scratch of marked tiles only (clear-on-read keeps it zero for the next
// call) and writes 0 elsewhere without reading.
//   M > 0: three launches (and a 24 B memset of the bounds): the bounds
//     (`atomicMax` on the bits of a non-negative float, which order as the
//     floats do), the adds and marks, the conversion.
//   M == 0: the conversion alone (no tile is marked: all zeros).
//
// Bound: bytes. Each sample reads 12 + 4C bytes; the accumulator is written
// once, (C + 2) x H x W x 4 bytes: 22.1 MB for C = 4 on the 720 x 1280 flow
// grid, ~6.6 us at 3.35 TB/s, which dominates at the few hundred samples of
// a pointer frame. The scratch adds 16 B a texel (one read, one zeroing
// write) in the marked tiles only: a pointer frame's 480 samples mark 431
// of the 7,200 8 x 16 tiles at 720 x 1280 (2.6 MB read and zeroed, where
// the memset and the full read moved 88 MB). Where earlier kernels have
// filled L2 with their written lines, as in a frame, the conversion takes
// ~3x its time alone (PERF.md section 6). The TPU sorts samples by tile and multiplies
// one-hot bf16 matrices on the MXU because it has no fast scatter; Hopper's
// 64-bit integer atomicAdd into L2 (RED.ADD.64) computes the same sums.
#include <algorithm>

#include "common.cuh"

namespace {

using namespace tt;

constexpr int POINT_TILE_H = 8;
constexpr int POINT_TILE_W = 16;

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

// 2^S_k of channel k: M adds at most of at most the reduced bound.
__device__ __forceinline__ float points_scale(const int* __restrict__ bits,
                                              int k, int m, int sign) {
  return pow2f(sign * fixed_shift(__int_as_float(bits[k]), m));
}

// Launch 1: bits[k] = the float bits of channel k's largest |add| (zeroed
// by the caller).
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

// Launch 2: one thread a sample, its adds, each quantised at its
// channel's scale, then the marks of the tiles its in-grid corners lie in
// (one store a tile, skipped where this call's epoch is already there).
// Dynamic shared memory: C + 2 scales.
__global__ void splat_points_kernel(const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    const float* __restrict__ values,
                                    const float* __restrict__ alpha, int c,
                                    int m, int h, int w,
                                    const int* __restrict__ bits,
                                    long long* __restrict__ fix,
                                    int* __restrict__ marks, int epoch) {
  extern __shared__ float scale[];
  for (int ch = threadIdx.x; ch < c + 2; ch += blockDim.x) {
    scale[ch] = points_scale(bits, ch, m, 1);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Corners k;
  if (i >= m || !corners_of(xs, ys, alpha, i, h, w, k)) return;
  const float log1a = log1a_of(k.a);
  const long long plane = (long long)h * w;
  const int tiles_w = (w + POINT_TILE_W - 1) / POINT_TILE_W;
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
                    values[(long long)ch * m + i] * aw, scale[ch]));
    }
    atomicAdd(texel + c * plane,
              (unsigned long long)quantise(aw, scale[c]));
    atomicAdd(texel + (c + 1) * plane,
              (unsigned long long)quantise(log1a * k.wgt[j], scale[c + 1]));
  }
  int last = -1;
  for (int j = 0; j < 4; ++j) {
    const int cx = k.x0i + (j & 1);
    const int cy = k.y0i + (j >> 1);
    if (cx < 0 || cx >= w || cy < 0 || cy >= h) continue;
    const int t = (cy / POINT_TILE_H) * tiles_w + cx / POINT_TILE_W;
    if (t != last && marks[t] != epoch) marks[t] = epoch;
    last = t;
  }
}

// The conversion, 4 consecutive texels of a row at a time, grid-stride
// over the quads of the [C + 2, H, W] grid (a quad never spans rows; 32-bit
// index arithmetic: (C + 2) x H x W < 2^31): a texel of a tile marked in
// this call gets f32(sum) x 2^-S, its scratch read and zeroed (so the
// scratch is all zero again for the next call); any other texel gets 0,
// unread. VEC (W % 4 == 0): the 4 texels lie in one tile, one float4 store
// and two 16-byte scratch loads.
template <bool VEC>
__global__ void splat_points_convert_kernel(long long* __restrict__ fix,
                                            const int* __restrict__ bits,
                                            const int* __restrict__ marks,
                                            int epoch, int c, int m, int h,
                                            int w, float* __restrict__ acc) {
  const unsigned qpr = (w + 3) / 4;  // quads a row
  const unsigned quads = qpr * h * (c + 2);
  const int tiles_w = (w + POINT_TILE_W - 1) / POINT_TILE_W;
  for (unsigned q = blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += gridDim.x * blockDim.x) {
    const unsigned row = q / qpr;  // ch x H + y
    const int x0 = (int)(q - row * qpr) * 4;
    const int ch = (int)(row / h);
    const int* mrow = marks + ((int)row - ch * h) / POINT_TILE_H * tiles_w;
    const unsigned base = row * w + x0;
    if (VEC) {
      float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (__ldg(mrow + x0 / POINT_TILE_W) == epoch) {
        longlong2* p = reinterpret_cast<longlong2*>(fix + base);
        const longlong2 a = __ldcs(p);
        const longlong2 b = __ldcs(p + 1);
        p[0] = make_longlong2(0, 0);
        p[1] = make_longlong2(0, 0);
        const float s = points_scale(bits, ch, m, -1);
        out = make_float4(__ll2float_rn(a.x) * s, __ll2float_rn(a.y) * s,
                          __ll2float_rn(b.x) * s, __ll2float_rn(b.y) * s);
      }
      *reinterpret_cast<float4*>(acc + base) = out;
      continue;
    }
    for (int x = x0; x < x0 + 4 && x < w; ++x) {
      float v = 0.0f;
      if (__ldg(mrow + x / POINT_TILE_W) == epoch) {
        const unsigned e = row * w + x;
        v = __ll2float_rn(__ldcs(fix + e)) * points_scale(bits, ch, m, -1);
        fix[e] = 0;
      }
      acc[row * w + x] = v;
    }
  }
}

}  // namespace

// `fix`: int64 [C + 2, H, W], all zero on entry and left all zero;
// `marks`: i32[ceil(H / 8) x ceil(W / 16)], no entry equal to `epoch` on
// entry; `bits`: i32[C + 2] scratch; `accum`: f32 [C + 2, H, W], every
// texel written. `blocks`: the most blocks of the grid-stride conversion
// (the caller's choice from the card's SM count).
extern "C" int tt_splat_points(const float* x, const float* y,
                               const float* values, const float* alpha,
                               int c, int m, int h, int w, int epoch,
                               int blocks, int* bits, long long* fix,
                               int* marks, float* accum, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t scales = (c + 2) * sizeof(int);
  if (m > 0) {
    cudaMemsetAsync(bits, 0, scales, s);
    splat_points_bound_kernel<<<blocks_for(m), THREADS, 0, s>>>(
        x, y, values, alpha, c, m, h, w, bits);
    splat_points_kernel<<<blocks_for(m), THREADS, scales, s>>>(
        x, y, values, alpha, c, m, h, w, bits, fix, marks, epoch);
  }
  const long long quads = (long long)(w + 3) / 4 * h * (c + 2);
  const int grid = (int)std::min<long long>(blocks_for(quads), blocks);
  if (w % 4 == 0) {
    splat_points_convert_kernel<true><<<grid, THREADS, 0, s>>>(
        fix, bits, marks, epoch, c, m, h, w, accum);
  } else {
    splat_points_convert_kernel<false><<<grid, THREADS, 0, s>>>(
        fix, bits, marks, epoch, c, m, h, w, accum);
  }
  return (int)cudaGetLastError();
}
