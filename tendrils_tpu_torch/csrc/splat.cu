// K2 splat — replaces tendrils_tpu/ops/draw_pallas.py:_kernel (launched
// from _bin_and_splat), with the flow channels on, in every variant the
// engine runs: the p0 word stream and the rgba8 colour stream are each
// optional (null pointers), as the TPU kernel's derive_p0 and scalar_color.
//
// One thread per (sorted segment, sample). Each thread re-derives its
// segment from the packed words exactly as the TPU kernel does: p0 from
// its word or as p1 - vel * viewScale (derive_p0), the colours from the
// rgba8 word or as the render colour model of a 1x1 colour map, the
// deposit mass from the major extent, the zero-weight rule for samples the
// margin clamp moved, and the sample centre quantised to 1/pscale px. It
// then adds separable box footprints (width flowWidth for the 5 flow
// channels, lineWidth for the 6 view channels, each <= KMAX_WIDTH, so at
// most 9 x 9 texels) into the PADDED f32[11, hp, wp] accumulator, the
// layout the resolve reads.
//
// Bound: atomics. At config 2 that is ~2M samples x (36 texels x 5 flow
// channels + 4 texels x 6 view channels) ~ 400M float atomicAdds per frame
// at the default flowWidth 5. The TPU kernel bins samples by tile and
// multiplies bf16 cover matrices on the MXU because it has no fast scatter;
// Hopper does, so this kernel drops the sort-binned tiles, region DMAs and
// parity passes and adds each texel's share straight into L2. The sorted
// input keeps neighbouring threads on neighbouring texels. Sums are f32
// (the TPU's matmul operands are bf16), and float atomics add in an order
// that changes from run to run, so the accumulator is not bit-reproducible.
#include "common.cuh"

namespace {

using namespace tt;

// Box-overlap coverage of texel `idx` by the footprint [lo, hi).
__device__ __forceinline__ float cover(float idx, float lo, float hi) {
  return clampf(fminf(idx + 1.0f, hi) - fmaxf(idx, lo), 0.0f, 1.0f);
}

// Add chans[0..nch) x box(width 2*hw) around (gx, gy) into nch planes.
template <int NCH>
__device__ __forceinline__ void deposit(float* __restrict__ acc, int hp,
                                        int wp, const float* chans, float gx,
                                        float gy, float hw, float inv_w) {
  const float lo_y = gy + (0.5f - hw);
  const float hi_y = gy + (0.5f + hw);
  const float lo_x = gx + (0.5f - hw);
  const float hi_x = gx + (0.5f + hw);
  const float r0 = floorf(lo_y);
  const float c0 = floorf(lo_x);
  const long long plane = (long long)hp * wp;
  for (int dy = 0; dy < KSPAN; ++dy) {
    const float rf = r0 + (float)dy;
    const float wr = cover(rf, lo_y, hi_y) * inv_w;
    const int r = (int)rf;
    if (wr <= 0.0f || r < 0 || r >= hp) continue;
    for (int dx = 0; dx < KSPAN; ++dx) {
      const float cf = c0 + (float)dx;
      const float wc = cover(cf, lo_x, hi_x);
      const int c = (int)cf;
      if (wc <= 0.0f || c < 0 || c >= wp) continue;
      float* texel = acc + (long long)r * wp + c;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        atomicAdd(texel + k * plane, (wr * chans[k]) * wc);
      }
    }
  }
}

// Render colour model of a 1x1 colour map (draw_pallas `_kernel`
// scalar_color; common.cuh:color_model) from the un-quantised velocity, the
// vignette position derived from p1: (r, g, b, a) into c[0..3].
__device__ __forceinline__ void scalar_colors(const float* __restrict__ scal,
                                              float vx, float vy, float p1x,
                                              float p1y, int h, int w,
                                              float* c) {
  const float inv_sl = 1.0f / fmaxf(scal[0], 1e-12f);
  const float posx = ((p1x - (float)PAD_LO_W) * (float)(2.0 / w) - 1.0f) /
                     fmaxf(scal[30], 1e-12f);
  const float posy = ((p1y - (float)PAD_LO_H) * (float)(2.0 / h) - 1.0f) /
                     fmaxf(scal[31], 1e-12f);
  color_model(scal, vx * inv_sl, vy * inv_sl, posx, posy, scal[16],
              scal[17], scal[18], scal[19], c);
  for (int k = 0; k < 4; ++k) c[k] = clampf(c[k], 0.0f, COLOR_MAX);
}

__global__ void splat_kernel(const float* __restrict__ scal,
                             const int* __restrict__ p1w,
                             const int* __restrict__ vlw,
                             const int* __restrict__ p0w,
                             const int* __restrict__ rgbaw, int n,
                             int samples, int h, int w, int hp, int wp,
                             float pscale, float* __restrict__ acc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * samples) return;
  const int i = (int)(t / samples);
  const int s = (int)(t - (long long)i * samples);

  const float speed_limit = scal[0];
  const float width_f = clampf(scal[2], 1.0f, KMAX_WIDTH);
  const float width_v = clampf(scal[3], 1.0f, KMAX_WIDTH);
  const float inv_p = 1.0f / pscale;

  const int p1 = p1w[i];
  const int vl = vlw[i];
  const float p1x = (float)(p1 & HALF) * inv_p;
  const float p1y = (float)(p1 >> 15) * inv_p;
  const float live = (float)(vl >> 30);
  const int vel_u = vl & ((1 << 30) - 1);
  const float vx = unq15(vel_u & HALF) * speed_limit;
  const float vy = unq15(vel_u >> 15) * speed_limit;
  float p0x, p0y;
  if (p0w == nullptr) {
    // derive_p0: Euler inverse in pixel space.
    p0x = clampf(p1x - vx * (scal[30] * 0.5f * (float)w), 1.0f,
                 (float)(PAD_LO_W + w) + 1.0f);
    p0y = clampf(p1y - vy * (scal[31] * 0.5f * (float)h), 1.0f,
                 (float)(PAD_LO_H + h) + 1.0f);
  } else {
    const int p0 = p0w[i];
    p0x = (float)(p0 & HALF) * inv_p;
    p0y = (float)(p0 >> 15) * inv_p;
  }
  const float dx = p1x - p0x;
  const float dy = p1y - p0y;
  // GL's DDA lights one fragment per major-axis pixel: mass ~ major extent.
  const float ascale = live * fmaxf(fmaxf(fabsf(dx), fabsf(dy)), 1.0f) /
                       (float)samples;

  const float ts = (float)((s + 0.5) / samples);  // as JAX: double, rounded once
  const float xu = p0x + dx * ts;
  const float yu = p0y + dy * ts;
  const float xp = clampf(xu, 1.0f, (float)(PAD_LO_W + w) + 1.0f);
  const float yp = clampf(yu, 1.0f, (float)(PAD_LO_H + h) + 1.0f);
  const float a = (xu != xp || yu != yp) ? 0.0f : ascale;
  if (a == 0.0f) return;  // every channel of the sample is exactly 0
  const float gx = (float)(int)rintf(xp * pscale) * inv_p - 0.5f;
  const float gy = (float)(int)rintf(yp * pscale) * inv_p - 0.5f;

  float c[4];
  if (rgbaw != nullptr) {
    // The rgba8 word K1 packed (draw_pallas.py:323-329).
    const int rgba = rgbaw[i];
    const float c8 = (float)(4.0 / 255.0);
    c[0] = (float)(rgba & 255) * c8;
    c[1] = (float)((rgba >> 8) & 255) * c8;
    c[2] = (float)((rgba >> 16) & 255) * c8;
    c[3] = (float)((rgba >> 24) & 127) * (float)(4.0 / 127.0);
  } else {
    scalar_colors(scal, vx, vy, p1x, p1y, h, w, c);
  }

  const float wf = fminf(sqrtf(vx * vx + vy * vy) / speed_limit, 1.0f);
  const float af = fminf(wf * a, (float)(1.0 - 1e-4));
  const float av = clampf(c[3] * a, 0.0f, (float)(1.0 - 1e-4));
  const long long plane = (long long)hp * wp;
  if (af > 0.0f) {
    const float fch[N_FLOW] = {vx * af, vy * af, wf * af, af, log1pf(-af)};
    deposit<N_FLOW>(acc, hp, wp, fch, gx, gy, width_f * 0.5f,
                    1.0f / width_f);
  }
  if (av > 0.0f) {
    const float vch[N_CHAN - N_FLOW] = {c[0] * av, c[1] * av, c[2] * av,
                                        c[3] * av, av,        log1pf(-av)};
    deposit<N_CHAN - N_FLOW>(acc + N_FLOW * plane, hp, wp, vch, gx, gy,
                             width_v * 0.5f, 1.0f / width_v);
  }
}

}  // namespace

extern "C" int tt_splat(const float* scal, const int* p1, const int* vl,
                        const int* p0, const int* rgba, int n, int samples,
                        int h, int w, int hp, int wp, float pscale,
                        float* accum, void* stream) {
  const long long items = (long long)n * samples;
  if (items > 0) {
    splat_kernel<<<blocks_for(items), THREADS, 0, (cudaStream_t)stream>>>(
        scal, p1, vl, p0, rgba, n, samples, h, w, hp, wp, pscale, accum);
  }
  return (int)cudaGetLastError();
}
