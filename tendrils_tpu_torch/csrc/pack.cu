// K1 pack — replaces tendrils_tpu/ops/draw_pallas.py:_pack_kernel
// (body _pack_core; launched from fused_draw_accumulate), in the variant the
// resident frame runs: p0 derived in the splat (key_recon), colours computed
// in the splat (scalar colour map), and the combined sort key of gather
// mode 1 (`tile << 20 | row id`).
//
// Per segment it writes three int32 words:
//   keym: the tile of the segment's bounding-box top-left corner (minus the
//         half line width), re-derived from the quantised p1 and the
//         round-tripped q15 velocity exactly as the splat will re-derive p0,
//         joined with the row id;
//   p1:   the end point at 1/pscale px fixed point, y << 15 | x;
//   vl:   velocity / speedLimit as two q15 fields, live flag in bit 30.
//
// Bound: memory. 24 bytes in (p1 xy, velocity xy, live, id) and 12 bytes out
// per segment; one thread per segment, neighbouring threads on neighbouring
// words, so every access is coalesced. The words are integers and must
// match the plain version bit for bit, so the arithmetic mirrors it op for
// op: --fmad=false keeps `p1 - vxr * k` from contracting into an FMA,
// rintf rounds half to even like jnp.round, and constants JAX writes as
// Python expressions are rounded once from double.
#include "common.cuh"

namespace {

using namespace tt;

__device__ __forceinline__ int q15(float v) {
  // jnp.round(clip((v - -1) / (1 - -1), 0, 1) * HALF)
  const float t = clampf((v + 1.0f) / 2.0f, 0.0f, 1.0f);
  return (int)rintf(t * (float)HALF);
}

__global__ void pack_kernel(const float* __restrict__ scal,
                            const float* __restrict__ p1_pix,
                            const float* __restrict__ vel,
                            const float* __restrict__ live,
                            const int* __restrict__ idx, int n, int h, int w,
                            int tiles_x, float pscale,
                            int* __restrict__ keym_out,
                            int* __restrict__ p1_out,
                            int* __restrict__ vl_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float sl_raw = scal[0];
  const float sl = fmaxf(sl_raw, 1e-12f);
  const float inv_p = 1.0f / pscale;  // a power of two: exact

  // Quantised end point, clamped into the padded margin.
  const float xp = clampf(p1_pix[2 * i] + (float)PAD_LO_W, 1.0f,
                          (float)(PAD_LO_W + w) + 1.0f);
  const float yp = clampf(p1_pix[2 * i + 1] + (float)PAD_LO_H, 1.0f,
                          (float)(PAD_LO_H + h) + 1.0f);
  const int x1q = (int)rintf(xp * pscale);
  const int y1q = (int)rintf(yp * pscale);
  p1_out[i] = y1q * (HALF + 1) + x1q;

  const int qx = q15(vel[i] / sl);
  const int qy = q15(vel[n + i] / sl);
  const int live_bit = live[i] > 0.5f ? (1 << 30) : 0;
  vl_out[i] = live_bit + qy * (HALF + 1) + qx;

  // Segment key from the p0 the splat will reconstruct.
  const float hwm = fmaxf(clampf(scal[2], 1.0f, KMAX_WIDTH),
                          clampf(scal[3], 1.0f, KMAX_WIDTH)) * 0.5f;
  const float vxr = unq15(qx) * sl_raw;
  const float vyr = unq15(qy) * sl_raw;
  const float p1xd = (float)x1q * inv_p;
  const float p1yd = (float)y1q * inv_p;
  const float p0xd = clampf(p1xd - vxr * (scal[30] * 0.5f * (float)w), 1.0f,
                            (float)(PAD_LO_W + w) + 1.0f);
  const float p0yd = clampf(p1yd - vyr * (scal[31] * 0.5f * (float)h), 1.0f,
                            (float)(PAD_LO_H + h) + 1.0f);
  const float top_x = fmaxf(fminf(p0xd, p1xd) - hwm, 0.0f);
  const float top_y = fmaxf(fminf(p0yd, p1yd) - hwm, 0.0f);
  // top >= 0, so C's truncating division is the floor division JAX uses.
  const int krow = (int)floorf(top_y) / TILE_H;
  const int kcol = (int)floorf(top_x) / TILE_W;
  keym_out[i] = (krow * tiles_x + kcol) * (1 << 20) + idx[i];
}

}  // namespace

extern "C" int tt_pack(const float* scal, const float* p1_pix,
                       const float* vel, const float* live, const int* idx,
                       int n, int h, int w, int tiles_x, float pscale,
                       int* keym, int* p1, int* vl, void* stream) {
  if (n > 0) {
    pack_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        scal, p1_pix, vel, live, idx, n, h, w, tiles_x, pscale, keym, p1,
        vl);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
