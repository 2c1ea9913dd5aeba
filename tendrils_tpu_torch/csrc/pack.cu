// K1 pack — replaces tendrils_tpu/ops/draw_pallas.py:_pack_kernel
// (body _pack_core; launched from fused_draw_accumulate), in every variant
// the engine runs, switched per launch by null pointers (one kernel, no
// copy per variant):
//   p0_pix given: emit the exact p0 word and key the segment by it
//                 (emit_p0; non-resident draws); else key it by the p0 the
//                 splat re-derives from p1 and the velocity (key_recon;
//                 the resident frame);
//   mapped given: pack the render colour model to an rgba8 word
//                 (emit_rgba; textured colour maps, non-resident draws);
//                 else the splat computes it from a 1x1 map's scalars;
//   idx given:    the combined key `tile << idx_bits | (id & (2^idx_bits -
//                 1))`: idx_bits 20 in gather mode 1 (the whole id), 19 in
//                 gather mode 3 (the id's low bits; draw_cuda hides its
//                 high bits in the riding positions' mantissa LSBs);
//                 else the tile alone (gather mode 0, and mode 2, where
//                 the id rides the sort as a stream of its own).
//
// Per segment it writes up to five int32 words:
//   keym: the tile of the segment's bounding-box top-left corner (minus the
//         half line width), joined with the row id in gather modes 1, 3;
//   p0, p1: the end points at 1/pscale px fixed point, y << 15 | x;
//   vl:   velocity / speedLimit as two q15 fields, live flag in bit 30;
//   rgba: r, g, b in 255 levels and a in 127 levels of [0, COLOR_MAX]
//         (bit 31 stays clear). The vignette reads the NDC positions `pos`.
//
// Bound: memory. At most 52 bytes in (p0 and p1 xy, velocity xy, pos xy,
// the 4 colour-map values, live, id) and 20 bytes out per segment; one
// thread per segment, neighbouring threads on neighbouring words, so every
// access but the interleaved xy pairs is coalesced. The words are integers
// and must match the plain version bit for bit, so the arithmetic mirrors
// it op for op: --fmad=false keeps `p1 - vxr * k` and the colour model's
// sums of products from contracting into FMAs, rintf rounds half to even
// like jnp.round, and constants JAX writes as Python expressions are
// rounded once from double.
#include "common.cuh"

namespace {

using namespace tt;

__device__ __forceinline__ int q15(float v) {
  // jnp.round(clip((v - -1) / (1 - -1), 0, 1) * HALF)
  const float t = clampf((v + 1.0f) / 2.0f, 0.0f, 1.0f);
  return (int)rintf(t * (float)HALF);
}

__device__ __forceinline__ int q8(float v, float levels) {
  return (int)rintf(clampf(v / COLOR_MAX, 0.0f, 1.0f) * levels);
}

// The render colour model (common.cuh:color_model) as an rgba8 word:
// draw_pallas._emit_render_rgba.
__device__ __forceinline__ int render_rgba(const float* __restrict__ scal,
                                           float vnx, float vny, float posx,
                                           float posy, float mr, float mg,
                                           float mb, float ma) {
  float c[4];
  color_model(scal, vnx, vny, posx, posy, mr, mg, mb, ma, c);
  return q8(c[0], 255.0f) + q8(c[1], 255.0f) * 256 +
         q8(c[2], 255.0f) * 65536 + q8(c[3], 127.0f) * 16777216;
}

__global__ void pack_kernel(const float* __restrict__ scal,
                            const float* __restrict__ p1_pix,
                            const float* __restrict__ vel,
                            const float* __restrict__ live,
                            const int* __restrict__ idx,
                            const float* __restrict__ p0_pix,
                            const float* __restrict__ pos,
                            const float* __restrict__ mapped, int n, int h,
                            int w, int tiles_x, int idx_bits, float pscale,
                            int* __restrict__ keym_out,
                            int* __restrict__ p1_out,
                            int* __restrict__ vl_out,
                            int* __restrict__ p0_out,
                            int* __restrict__ rgba_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float sl_raw = scal[0];
  const float sl = fmaxf(sl_raw, 1e-12f);
  const float inv_p = 1.0f / pscale;  // a power of two: exact
  const float x_hi = (float)(PAD_LO_W + w) + 1.0f;
  const float y_hi = (float)(PAD_LO_H + h) + 1.0f;

  // Quantised end point, clamped into the padded margin.
  const float xp = clampf(p1_pix[2 * i] + (float)PAD_LO_W, 1.0f, x_hi);
  const float yp = clampf(p1_pix[2 * i + 1] + (float)PAD_LO_H, 1.0f, y_hi);
  const int x1q = (int)rintf(xp * pscale);
  const int y1q = (int)rintf(yp * pscale);
  p1_out[i] = y1q * (HALF + 1) + x1q;

  const float vnx = vel[i] / sl;
  const float vny = vel[n + i] / sl;
  const int qx = q15(vnx);
  const int qy = q15(vny);
  const int live_bit = live[i] > 0.5f ? (1 << 30) : 0;
  vl_out[i] = live_bit + qy * (HALF + 1) + qx;
  if (mapped != nullptr) {
    rgba_out[i] = render_rgba(scal, vnx, vny, pos[i], pos[n + i], mapped[i],
                              mapped[n + i], mapped[2 * n + i],
                              mapped[3 * n + i]);
  }

  const float hwm = fmaxf(clampf(scal[2], 1.0f, KMAX_WIDTH),
                          clampf(scal[3], 1.0f, KMAX_WIDTH)) * 0.5f;
  float top_x, top_y;
  if (p0_pix == nullptr) {
    // Segment key from the p0 the splat will reconstruct.
    const float vxr = unq15(qx) * sl_raw;
    const float vyr = unq15(qy) * sl_raw;
    const float p1xd = (float)x1q * inv_p;
    const float p1yd = (float)y1q * inv_p;
    const float p0xd =
        clampf(p1xd - vxr * (scal[30] * 0.5f * (float)w), 1.0f, x_hi);
    const float p0yd =
        clampf(p1yd - vyr * (scal[31] * 0.5f * (float)h), 1.0f, y_hi);
    top_x = fmaxf(fminf(p0xd, p1xd) - hwm, 0.0f);
    top_y = fmaxf(fminf(p0yd, p1yd) - hwm, 0.0f);
  } else {
    // Segment key from the exact quantised p0.
    const float x0p = clampf(p0_pix[2 * i] + (float)PAD_LO_W, 1.0f, x_hi);
    const float y0p = clampf(p0_pix[2 * i + 1] + (float)PAD_LO_H, 1.0f, y_hi);
    const int x0q = (int)rintf(x0p * pscale);
    const int y0q = (int)rintf(y0p * pscale);
    p0_out[i] = y0q * (HALF + 1) + x0q;
    top_x = fmaxf((float)min(x0q, x1q) * inv_p - hwm, 0.0f);
    top_y = fmaxf((float)min(y0q, y1q) * inv_p - hwm, 0.0f);
  }
  // top >= 0, so C's truncating division is the floor division JAX uses.
  const int key = ((int)floorf(top_y) / TILE_H) * tiles_x +
                  (int)floorf(top_x) / TILE_W;
  const int id_mask = (1 << idx_bits) - 1;
  keym_out[i] = idx == nullptr ? key
                               : key * (1 << idx_bits) + (idx[i] & id_mask);
}

}  // namespace

extern "C" int tt_pack(const float* scal, const float* p1_pix,
                       const float* vel, const float* live, const int* idx,
                       const float* p0_pix, const float* pos,
                       const float* mapped, int n, int h, int w, int tiles_x,
                       int idx_bits, float pscale, int* keym, int* p1, int* vl,
                       int* p0, int* rgba, void* stream) {
  if (n > 0) {
    pack_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        scal, p1_pix, vel, live, idx, p0_pix, pos, mapped, n, h, w, tiles_x,
        idx_bits, pscale, keym, p1, vl, p0, rgba);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
