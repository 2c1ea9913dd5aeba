// Shared constants and device helpers of the port's kernels.
//
// Every kernel here is a plain one-thread-per-item CUDA C++ kernel for
// Hopper (sm_90a). The library is compiled with --fmad=false: several
// outputs (the packed words and tile keys of pack.cu) must match the plain
// PyTorch versions bit for bit, and a contracted multiply-add would round
// differently from the separate multiply and add those versions execute.
#pragma once

#include <cuda_runtime.h>

namespace tt {

// Fixed-point and padded-grid geometry (tendrils_tpu_torch/ops/tile_geom.py).
constexpr int HALF = 32767;
constexpr int TILE_H = 16;
constexpr int TILE_W = 256;
constexpr int PAD_LO_H = 16;
constexpr int PAD_LO_W = 256;
// A sample keyed by a tile fits when its footprint lies in the tile's
// REGION_H x REGION_W region, from the tile's origin (K2's tile pass).
constexpr int REGION_H = 32;
constexpr int REGION_W = 384;
constexpr float INERT = -1.0e6f;
constexpr float KMAX_WIDTH = 8.0f;
constexpr float COLOR_MAX = 4.0f;
constexpr int N_CHAN = 11;  // flow (vx.a, vy.a, wf.a, a, log(1-a)) + view (r.a, g.a, b.a, a.a, a, log(1-a))
constexpr int N_FLOW = 5;
// Footprint span of a box of width <= KMAX_WIDTH, in texels.
constexpr int KSPAN = 9;
constexpr int THREADS = 256;

// jnp.clip(v, lo, hi) == minimum(maximum(v, lo), hi).
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// q15 velocity field back to [-1, 1] (draw_pallas `unq` / reconstruct_rows):
// q * f32(2 / HALF) - 1, the constant rounded once from double as JAX does.
__device__ __forceinline__ float unq15(int q) {
  return (float)q * (float)(2.0 / 32767.0) - 1.0f;
}

// CLAMP_TO_EDGE bilinear footprint at texel coords (x, y) of an h x w plane
// ((0.5, 0.5) is the centre of texel [0, 0]); the contract of
// ops/sample.bilinear_sample. The +1 corners are clamped into the plane:
// after the edge clamp they can fall one past the last row or column, where
// their weight is exactly 0 but a raw read would leave the plane.
struct Bilerp {
  int i00, i01, i10, i11;
  float fx, fy;
};

__device__ __forceinline__ Bilerp bilerp_at(int h, int w, float x, float y) {
  const float gx = clampf(x, 0.5f, (float)w - 0.5f) - 0.5f;
  const float gy = clampf(y, 0.5f, (float)h - 0.5f) - 0.5f;
  const float x0 = floorf(gx);
  const float y0 = floorf(gy);
  Bilerp b;
  b.fx = gx - x0;
  b.fy = gy - y0;
  const int x0i = min(max((int)x0, 0), w - 1);
  const int x1i = min(x0i + 1, w - 1);
  const int y0i = min(max((int)y0, 0), h - 1);
  const int y1i = min(y0i + 1, h - 1);
  b.i00 = y0i * w + x0i;
  b.i01 = y0i * w + x1i;
  b.i10 = y1i * w + x0i;
  b.i11 = y1i * w + x1i;
  return b;
}

// The same lerps, in the same order, as bilinear_sample.
__device__ __forceinline__ float bilerp(const float* plane, const Bilerp& b) {
  const float v00 = plane[b.i00];
  const float v01 = plane[b.i01];
  const float v10 = plane[b.i10];
  const float v11 = plane[b.i11];
  const float top = v00 + (v01 - v00) * b.fx;
  const float bot = v10 + (v11 - v10) * b.fx;
  return top + (bot - top) * b.fy;
}

// Unpack a fixed-point p1 word (x in the low 15 bits, y above, at `inv_p`
// padded px), clamp it to the content edge and return its bilinear
// footprint in content coordinates (gather_pallas.py:107-112) — the gather
// half of K4 and all of K8, shared so the two cannot diverge.
__device__ __forceinline__ Bilerp bilerp_p1(int h, int w, int p1,
                                            float inv_p) {
  const float xcl = clampf((float)(p1 & HALF) * inv_p,
                           (float)PAD_LO_W + 0.5f,
                           (float)(PAD_LO_W + w) - 0.5f);
  const float ycl = clampf((float)(p1 >> 15) * inv_p,
                           (float)PAD_LO_H + 0.5f,
                           (float)(PAD_LO_H + h) - 0.5f);
  return bilerp_at(h, w, xcl - (float)PAD_LO_W, ycl - (float)PAD_LO_H);
}

// Render colour model (src/render/index.vert:57-94) of a segment with
// velocity / speedLimit (vnx, vny) at NDC position (posx, posy) and the
// colour-map value (mr, mg, mb, ma): (r, g, b, a) into c[0..3], before any
// clamp or quantisation. Op for op as draw_pallas's `_emit_render_rgba`
// (K1's rgba8 word) and the splat's scalar colour (K2), which share it.
__device__ __forceinline__ void color_model(const float* __restrict__ scal,
                                            float vnx, float vny, float posx,
                                            float posy, float mr, float mg,
                                            float mb, float ma, float* c) {
  const float speed_rate =
      fminf((vnx * vnx + vny * vny) / fmaxf(scal[4], 1e-12f), 1.0f);
  const float al0 = vnx;
  const float al1 = vnx * -0.5f + vny * (float)-0.8660254037844385;
  const float al2 = vnx * -0.5f + vny * (float)0.8660254037844387;
  const float k1 = 1.0f - scal[6];
  const float sin_decay = scal[5];
  const float fa0 = (al0 + (al1 * k1 - al0) * sin_decay) * 0.5f + 0.5f;
  const float fa1 = (al1 + (al2 * k1 - al1) * sin_decay) * 0.5f + 0.5f;
  const float fa2 = (al2 + (al0 * k1 - al2) * sin_decay) * 0.5f + 0.5f;
  const float b0 = scal[7], b1 = scal[8], b2 = scal[9], b3 = scal[10];
  const float f0 = scal[11], f1 = scal[12], f2 = scal[13], f3 = scal[14];
  c[0] = clampf(b0 * b3, 0.f, 1.f) + clampf(mr * ma, 0.f, 1.f) +
         clampf(f0 * fa0 * f3, 0.f, 1.f);
  c[1] = clampf(b1 * b3, 0.f, 1.f) + clampf(mg * ma, 0.f, 1.f) +
         clampf(f1 * fa1 * f3, 0.f, 1.f);
  c[2] = clampf(b2 * b3, 0.f, 1.f) + clampf(mb * ma, 0.f, 1.f) +
         clampf(f2 * fa2 * f3, 0.f, 1.f);
  const float ca =
      clampf(b3, 0.f, 1.f) + clampf(ma, 0.f, 1.f) + clampf(f3, 0.f, 1.f);
  // Alpha: speed rate x clamped radial bezier vignette.
  const float d = sqrtf(posx * posx + posy * posy);
  const float amt = fminf(1.0f - d, 1.0f);
  const float ut = 1.0f - amt;
  const float bz = (0.2f * ut + amt) * ut + amt;
  const float vig = clampf(fmaxf(bz, 0.0f), 0.2f, 1.0f);
  c[3] = ca * speed_rate * vig;
}

// Resident-stream state reassembly of row i of n (draw_pallas
// reconstruct_rows): position from the exact sorted positions, velocity
// un-quantised from the q15 word, previous = (pos - vel for live rows, vel).
// Shared by K4 and K6, as the JAX package shares reconstruct_rows, so the
// live-bit / q15 semantics cannot diverge.
__device__ __forceinline__ void reconstruct_row(int i, int n, float sl,
                                                float x, float y, int vl,
                                                float* __restrict__ part,
                                                float* __restrict__ prev) {
  const int vel_u = vl & ((1 << 30) - 1);
  const float nvx = unq15(vel_u & HALF) * sl;
  const float nvy = unq15(vel_u >> 15) * sl;
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

inline int blocks_for(long long n) {
  return (int)((n + THREADS - 1) / THREADS);
}

}  // namespace tt
