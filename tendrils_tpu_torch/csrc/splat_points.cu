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
// into an UNPADDED f32[C + 2, H, W] accumulator that the wrapper zero-fills.
// The TPU kernel pads the grid, clamps samples into the margin and zeroes
// the alpha of samples the clamp moved, so that its tile-region DMAs stay in
// bounds; that computes the same function as the per-corner validity test,
// which this kernel uses, and it never writes outside the grid. A sample
// within 1 px outside the grid deposits its in-grid corners only; one
// further out deposits nothing. Samples of alpha 0 (pad segments, masked
// crest rows) add only zeros and return early.
//
// Bound: bytes. Each sample reads 12 + 4C bytes; the accumulator is written
// once, (C + 2) x H x W x 4 bytes: 22.1 MB for C = 4 on the 720 x 1280
// flow grid, ~6.6 us at 3.35 TB/s, which dominates at the few thousand
// samples of a pointer frame. The TPU sorts samples by tile and multiplies
// one-hot bf16 matrices on the MXU because it has no fast scatter; Hopper's
// float atomicAdd into L2 computes the same sums in f32, in an order that
// changes from run to run (|d| <= 1e-5 x the channel's max against the
// plain version).
#include "common.cuh"

namespace {

using namespace tt;

__global__ void splat_points_kernel(const float* __restrict__ xs,
                                    const float* __restrict__ ys,
                                    const float* __restrict__ values,
                                    const float* __restrict__ alpha, int c,
                                    int m, int h, int w,
                                    float* __restrict__ acc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const float a = alpha[i];
  if (a == 0.0f) return;
  const float gx = xs[i] - 0.5f;
  const float gy = ys[i] - 0.5f;
  const float x0 = floorf(gx);
  const float y0 = floorf(gy);
  // No corner in the grid (or NaN): nothing to add, and the int casts
  // below stay in range.
  if (!(x0 >= -1.0f && x0 <= (float)(w - 1) && y0 >= -1.0f &&
        y0 <= (float)(h - 1))) {
    return;
  }
  const float fx = gx - x0;
  const float fy = gy - y0;
  const int x0i = (int)x0;
  const int y0i = (int)y0;
  const float wgt[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                        (1.0f - fx) * fy, fx * fy};
  const float log1a = log1pf(-fminf(a, (float)(1.0 - 1e-4)));
  const long long plane = (long long)h * w;
  for (int k = 0; k < 4; ++k) {
    const int cx = x0i + (k & 1);
    const int cy = y0i + (k >> 1);
    if (cx < 0 || cx >= w || cy < 0 || cy >= h) continue;
    float* texel = acc + (long long)cy * w + cx;
    const float aw = a * wgt[k];
    for (int ch = 0; ch < c; ++ch) {
      atomicAdd(texel + ch * plane, values[(long long)ch * m + i] * aw);
    }
    atomicAdd(texel + c * plane, aw);
    atomicAdd(texel + (c + 1) * plane, log1a * wgt[k]);
  }
}

}  // namespace

extern "C" int tt_splat_points(const float* x, const float* y,
                               const float* values, const float* alpha,
                               int c, int m, int h, int w, float* accum,
                               void* stream) {
  if (m > 0) {
    splat_points_kernel<<<blocks_for(m), THREADS, 0,
                          (cudaStream_t)stream>>>(x, y, values, alpha, c, m,
                                                  h, w, accum);
  }
  return (int)cudaGetLastError();
}
