// K4 gather + reconstruct — replaces
// tendrils_tpu/ops/gather_pallas.py:gather_reconstruct_p1 (body _kernel with
// recon, plus draw_pallas.reconstruct_rows).
// K5 bilinear gather — replaces gather_pallas.py:bilinear_gather (_kernel).
// K6 reconstruct — replaces draw_pallas.py:reconstruct_resident
// (_reconstruct_kernel).
// K8 keyed p1 gather — replaces gather_pallas.py:bilinear_gather_keyed_p1
// (_kernel with from_p1).
//
// K4, one thread per sorted row: unpack the fixed-point p1 word, clamp it
// to the content edge, bilinearly sample the 2-channel decayed flow `eff`
// (content layout) there — the next step's force — and rebuild the row's
// particle state. K8 is K4's gather half alone (C channels) and K6 its
// reassembly half alone; the resident frame runs them apart when flow is
// injected between the draw and the gather. All three call the same
// device functions (common.cuh: bilerp_p1, reconstruct_row), so K4 equals
// K8 + K6 bit for bit.
// K5, one thread per point: CLAMP_TO_EDGE bilinear sampling of a C-channel
// grid at arbitrary f32 texel coords (contract: ops/sample.bilinear_sample).
//
// Bound: bytes. K6 reads npx, npy, vl (12 B/row) and writes particles and
// previous (32 B/row): 44 B x 262,144 rows = 11.5 MB, ~3.4 us at 3.35 TB/s
// for config 4; it does a few flops per row, far below the f32 rate. The
// gathers also read the four corner texels of each row; rows arrive sorted
// by tile (K4, K8), so neighbouring threads read neighbouring texels and
// most corners hit L1/L2; K5's points arrive in particle order. The TPU
// kernels sort points by tile, DMA each tile's region and gather with MXU
// matmuls because Mosaic has no vector gather; a plain load per corner
// computes the same function, so the port needs no sort, no un-sort and no
// tile keys. Corner indices are clamped into the grid
// (common.cuh:bilerp_at).
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
  const Bilerp b = bilerp_p1(h, w, p1w[i], inv_p);
  force[i] = bilerp(eff, b);
  force[n + i] = bilerp(eff + (long long)h * w, b);
  reconstruct_row(i, n, sl_ptr[0], npx[i], npy[i], vlw[i], part, prev);
}

__global__ void reconstruct_kernel(const float* __restrict__ npx,
                                   const float* __restrict__ npy,
                                   const int* __restrict__ vlw,
                                   const float* __restrict__ sl_ptr, int n,
                                   float* __restrict__ part,
                                   float* __restrict__ prev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  reconstruct_row(i, n, sl_ptr[0], npx[i], npy[i], vlw[i], part, prev);
}

__global__ void gather_keyed_p1_kernel(const float* __restrict__ grid, int c,
                                       int h, int w,
                                       const int* __restrict__ p1w, int n,
                                       float inv_p, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Bilerp b = bilerp_p1(h, w, p1w[i], inv_p);
  const long long plane = (long long)h * w;
  for (int k = 0; k < c; ++k) {
    out[(long long)k * n + i] = bilerp(grid + k * plane, b);
  }
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

extern "C" int tt_reconstruct(const float* npx, const float* npy,
                              const int* vl, const float* sl, int n,
                              float* particles, float* previous,
                              void* stream) {
  if (n > 0) {
    reconstruct_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        npx, npy, vl, sl, n, particles, previous);
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_gather_keyed_p1(const float* grid, int c, int h, int w,
                                  const int* p1, int n, float inv_p,
                                  float* out, void* stream) {
  if (n > 0) {
    gather_keyed_p1_kernel<<<blocks_for(n), THREADS, 0,
                             (cudaStream_t)stream>>>(grid, c, h, w, p1, n,
                                                     inv_p, out);
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
