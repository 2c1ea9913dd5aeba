// K4 gather + reconstruct — replaces
// tendrils_tpu/ops/gather_pallas.py:gather_reconstruct_p1 (body _kernel with
// recon, plus draw_pallas.reconstruct_rows).
// K5 bilinear gather — replaces gather_pallas.py:bilinear_gather (_kernel).
//
// K4, one thread per sorted row: unpack the fixed-point p1 word, clamp it
// to the content edge, bilinearly sample the 2-channel decayed flow `eff`
// (content layout) there — the next step's force — and rebuild the row's
// particle state: position from the exact sorted positions, velocity
// un-quantised from the q15 word, previous = (pos - vel for live rows,
// vel).
// K5, one thread per point: CLAMP_TO_EDGE bilinear sampling of a C-channel
// grid at arbitrary f32 texel coords (contract: ops/sample.bilinear_sample).
//
// Bound: memory latency of the four corner reads. Rows arrive sorted by
// tile (K4), so neighbouring threads read neighbouring texels and most
// corners hit L1/L2; K5's points arrive in particle order. The TPU kernel
// sorts points by tile, DMAs each tile's region and gathers with MXU
// matmuls because Mosaic has no vector gather; a plain load per corner
// computes the same function, so the port needs no sort and no un-sort.
// Corner indices are clamped into the grid (common.cuh:bilerp_at).
#include "common.cuh"

namespace {

using namespace tt;

__global__ void gather_reconstruct_kernel(
    const float* __restrict__ eff, int h, int w, const int* __restrict__ p1w,
    const float* __restrict__ npx, const float* __restrict__ npy,
    const int* __restrict__ vlw, const float* __restrict__ sl_ptr, int n,
    float inv_p, float* __restrict__ force, float* __restrict__ part,
    float* __restrict__ prev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Next step's force at the packed p1, CLAMP_TO_EDGE, in content coords.
  const int p1 = p1w[i];
  const float xcl = clampf((float)(p1 & HALF) * inv_p, (float)PAD_LO_W + 0.5f,
                           (float)(PAD_LO_W + w) - 0.5f);
  const float ycl = clampf((float)(p1 >> 15) * inv_p, (float)PAD_LO_H + 0.5f,
                           (float)(PAD_LO_H + h) - 0.5f);
  const Bilerp b = bilerp_at(h, w, xcl - (float)PAD_LO_W,
                             ycl - (float)PAD_LO_H);
  force[i] = bilerp(eff, b);
  force[n + i] = bilerp(eff + (long long)h * w, b);

  // State reassembly (draw_pallas.reconstruct_rows).
  const float sl = sl_ptr[0];
  const int vel_u = vlw[i] & ((1 << 30) - 1);
  const float nvx = unq15(vel_u & HALF) * sl;
  const float nvy = unq15(vel_u >> 15) * sl;
  const float x = npx[i];
  const float y = npy[i];
  const bool alive = (x != INERT) || (y != INERT);
  part[i] = x;
  part[n + i] = y;
  part[2 * n + i] = nvx;
  part[3 * n + i] = nvy;
  prev[i] = alive ? x - nvx : x;
  prev[n + i] = alive ? y - nvy : y;
  prev[2 * n + i] = nvx;
  prev[3 * n + i] = nvy;
}

__global__ void bilinear_gather_kernel(const float* __restrict__ grid, int c,
                                       int h, int w,
                                       const float* __restrict__ xs,
                                       const float* __restrict__ ys, int m,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const Bilerp b = bilerp_at(h, w, xs[i], ys[i]);
  const long long plane = (long long)h * w;
  for (int k = 0; k < c; ++k) {
    out[(long long)k * m + i] = bilerp(grid + k * plane, b);
  }
}

}  // namespace

extern "C" int tt_gather_reconstruct(const float* eff, int h, int w,
                                     const int* p1, const float* npx,
                                     const float* npy, const int* vl,
                                     const float* sl, int n, float inv_p,
                                     float* force, float* particles,
                                     float* previous, void* stream) {
  if (n > 0) {
    gather_reconstruct_kernel<<<blocks_for(n), THREADS, 0,
                                (cudaStream_t)stream>>>(
        eff, h, w, p1, npx, npy, vl, sl, n, inv_p, force, particles,
        previous);
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_bilinear_gather(const float* grid, int c, int h, int w,
                                  const float* x, const float* y, int m,
                                  float* out, void* stream) {
  if (m > 0) {
    bilinear_gather_kernel<<<blocks_for(m), THREADS, 0,
                             (cudaStream_t)stream>>>(grid, c, h, w, x, y, m,
                                                     out);
  }
  return (int)cudaGetLastError();
}
