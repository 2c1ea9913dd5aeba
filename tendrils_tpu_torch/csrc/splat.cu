// K2 splat — replaces tendrils_tpu/ops/draw_pallas.py:_kernel (launched
// from _bin_and_splat), in the resident frame's variant (derive_p0,
// scalar_color, flow channels on).
//
// One thread per (sorted segment, sample). Each thread re-derives its
// segment from the packed words exactly as the TPU kernel does: p0 as
// p1 - vel * viewScale, the render colour model of a 1x1 colour map, the
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

__global__ void splat_kernel(const float* __restrict__ scal,
                             const int* __restrict__ p1w,
                             const int* __restrict__ vlw, int n, int samples,
                             int h, int w, int hp, int wp, float pscale,
                             float* __restrict__ acc) {
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
  // derive_p0: Euler inverse in pixel space.
  const float p0x = clampf(p1x - vx * (scal[30] * 0.5f * (float)w), 1.0f,
                           (float)(PAD_LO_W + w) + 1.0f);
  const float p0y = clampf(p1y - vy * (scal[31] * 0.5f * (float)h), 1.0f,
                           (float)(PAD_LO_H + h) + 1.0f);
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

  // Render colour model of a 1x1 colour map (src/render/index.vert:57-94).
  const float inv_sl = 1.0f / fmaxf(speed_limit, 1e-12f);
  const float vnx = vx * inv_sl;
  const float vny = vy * inv_sl;
  const float mr = scal[16], mg = scal[17], mb = scal[18], ma = scal[19];
  const float speed_alpha = scal[4];
  const float sin_decay = scal[5];
  const float k1 = 1.0f - scal[6];
  const float speed_rate =
      fminf((vnx * vnx + vny * vny) / fmaxf(speed_alpha, 1e-12f), 1.0f);
  const float al0 = vnx;
  const float al1 = vnx * -0.5f + vny * (float)-0.8660254037844385;
  const float al2 = vnx * -0.5f + vny * (float)0.8660254037844387;
  const float fa0 = (al0 + (al1 * k1 - al0) * sin_decay) * 0.5f + 0.5f;
  const float fa1 = (al1 + (al2 * k1 - al1) * sin_decay) * 0.5f + 0.5f;
  const float fa2 = (al2 + (al0 * k1 - al2) * sin_decay) * 0.5f + 0.5f;
  const float b0 = scal[7], b1 = scal[8], b2 = scal[9], b3 = scal[10];
  const float f0 = scal[11], f1 = scal[12], f2 = scal[13], f3 = scal[14];
  float cr = clampf(b0 * b3, 0.f, 1.f) + clampf(mr * ma, 0.f, 1.f) +
             clampf(f0 * fa0 * f3, 0.f, 1.f);
  float cg = clampf(b1 * b3, 0.f, 1.f) + clampf(mg * ma, 0.f, 1.f) +
             clampf(f1 * fa1 * f3, 0.f, 1.f);
  float cb = clampf(b2 * b3, 0.f, 1.f) + clampf(mb * ma, 0.f, 1.f) +
             clampf(f2 * fa2 * f3, 0.f, 1.f);
  float ca = clampf(b3, 0.f, 1.f) + clampf(ma, 0.f, 1.f) + clampf(f3, 0.f, 1.f);
  // Alpha: speed rate x clamped radial bezier vignette.
  const float posx = ((p1x - (float)PAD_LO_W) * (float)(2.0 / w) - 1.0f) /
                     fmaxf(scal[30], 1e-12f);
  const float posy = ((p1y - (float)PAD_LO_H) * (float)(2.0 / h) - 1.0f) /
                     fmaxf(scal[31], 1e-12f);
  const float d2 = sqrtf(posx * posx + posy * posy);
  const float amt = fminf(1.0f - d2, 1.0f);
  const float ut = 1.0f - amt;
  const float bz = (0.2f * ut + amt) * ut + amt;
  const float vig = clampf(fmaxf(bz, 0.0f), 0.2f, 1.0f);
  ca = ca * speed_rate * vig;
  cr = clampf(cr, 0.0f, COLOR_MAX);
  cg = clampf(cg, 0.0f, COLOR_MAX);
  cb = clampf(cb, 0.0f, COLOR_MAX);
  ca = clampf(ca, 0.0f, COLOR_MAX);

  const float wf = fminf(sqrtf(vx * vx + vy * vy) / speed_limit, 1.0f);
  const float af = fminf(wf * a, (float)(1.0 - 1e-4));
  const float av = clampf(ca * a, 0.0f, (float)(1.0 - 1e-4));
  const long long plane = (long long)hp * wp;
  if (af > 0.0f) {
    const float fch[N_FLOW] = {vx * af, vy * af, wf * af, af, log1pf(-af)};
    deposit<N_FLOW>(acc, hp, wp, fch, gx, gy, width_f * 0.5f,
                    1.0f / width_f);
  }
  if (av > 0.0f) {
    const float vch[N_CHAN - N_FLOW] = {cr * av, cg * av, cb * av,
                                        ca * av, av,      log1pf(-av)};
    deposit<N_CHAN - N_FLOW>(acc + N_FLOW * plane, hp, wp, vch, gx, gy,
                             width_v * 0.5f, 1.0f / width_v);
  }
}

}  // namespace

extern "C" int tt_splat(const float* scal, const int* p1, const int* vl,
                        int n, int samples, int h, int w, int hp, int wp,
                        float pscale, float* accum, void* stream) {
  const long long items = (long long)n * samples;
  if (items > 0) {
    splat_kernel<<<blocks_for(items), THREADS, 0, (cudaStream_t)stream>>>(
        scal, p1, vl, n, samples, h, w, hp, wp, pscale, accum);
  }
  return (int)cudaGetLastError();
}
