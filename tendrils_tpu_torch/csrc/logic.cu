// K13 logic step — the particle step of src/logic.frag:45-101 in one pass.
//
// No TPU kernel replaces this one: the JAX package leaves the step to XLA,
// which fuses it under jit (tendrils_tpu/ops/logic.py). Its plain version
// is ops/logic.py's `step_with_force` after state.particle_coords_from_idx,
// some 850 elementwise PyTorch launches, each of which writes an N-float
// temporary and reads it back.
//
// One thread per particle. It reads the particle (x, y, vx, vy), the
// targets' xy, the flow force (absent: the flow term adds 0.0, as the plain
// code's Python 0.0 does) and the row's original index; derives uv and
// index01 from the index; evaluates the two simplex-noise wander calls, the
// parameter variance, damping, the flow and wander accumulation, the target
// term, the speed clamp, the Euler step and the inert mask; and writes the
// new particle. Every load and store is one row of a channel-major [C, N]
// tensor, coalesced across the warp.
//
// Bits: each float32 operation is the plain version's, in its order, so
// the output equals the plain version's bit for bit on the card. Each
// PyTorch elementwise op rounds once (its float opmath), and the library
// is compiled with --fmad=false, so nothing here contracts into an FMA.
// Python float constants are rounded to float32 as PyTorch rounds them
// ((float) of the double); a tensor divided by a Python number on the card
// is PyTorch's multiply by the float32 reciprocal (its division kernel's
// CPU-scalar path); minimum and clamp propagate NaN as PyTorch's do.
//
// Cost: ~700 float32 instructions a particle (two noise evaluations of
// ~300, ~38 floors each) against 52 bytes of traffic: the issue of the
// instructions is about as long as the bytes' transfer at 3.35 TB/s.
#include "common.cuh"

namespace {

using namespace tt;

// The 0-d float32 device tensors the step reads, in the order of
// logic_cuda.PARAM_KEYS followed by time and dt.
enum Param {
  NOISE_SCALE, VARY_NOISE_SCALE, NOISE_SPEED, VARY_NOISE_SPEED, FORCE_WEIGHT,
  VARY_FORCE, FLOW_WEIGHT, VARY_FLOW, NOISE_WEIGHT, VARY_NOISE, DAMPING,
  TARGET, VARY_TARGET, SPEED_LIMIT, TIME, DT, N_PARAMS
};

struct Params {
  const float* p[N_PARAMS];
};

// ops/noise.py's constants, as float32: the Python doubles rounded once, the
// `ns_*` values as that module computes them.
constexpr float C_X = (float)(1.0 / 6.0);
constexpr float C_Y = (float)(1.0 / 3.0);
constexpr float INV_289 = (float)(1.0 / 289.0);
constexpr float NS_X = (float)(2.0 / 7.0);
constexpr float NS_Y = (float)(0.5 / 7.0 - 1.0);
constexpr float NS_Z = (float)(1.0 / 7.0);
constexpr float NS_ZZ = NS_Z * NS_Z;
constexpr float TAYLOR_A = (float)1.79284291400159;
constexpr float TAYLOR_B = (float)0.85373472095314;
constexpr float FALLOFF_R2 = (float)0.6;
constexpr float ZB_OFFSET = (float)1234.5678;
constexpr float MIN_SPEED = (float)1e-12;

// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.minimum: NaN if either is NaN.
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float mod289(float x) {
  return x - floorf(x * INV_289) * 289.0f;
}

__device__ __forceinline__ float permute(float x) {
  return mod289(((x * 34.0f) + 1.0f) * x);
}

__device__ __forceinline__ float step_ge(float a, float b) {
  return a >= b ? 1.0f : 0.0f;
}

// Gradient of corner hash p, dotted with the offset (xc, yc, zc): 7x7
// points over a square mapped onto an octahedron (noise.py `gradient`).
__device__ __forceinline__ float gradient(float p, float xc, float yc,
                                          float zc) {
  const float j = p - 49.0f * floorf(p * NS_ZZ);
  const float x_ = floorf(j * NS_Z);
  const float y_ = floorf(j - 7.0f * x_);
  const float x = x_ * NS_X + NS_Y;
  const float y = y_ * NS_X + NS_Y;
  const float h = 1.0f - fabsf(x) - fabsf(y);
  const float sx = floorf(x) * 2.0f + 1.0f;
  const float sy = floorf(y) * 2.0f + 1.0f;
  const float sh = -(h <= 0.0f ? 1.0f : 0.0f);
  const float ax = x + sx * sh;
  const float ay = y + sy * sh;
  const float norm = TAYLOR_A - TAYLOR_B * (ax * ax + ay * ay + h * h);
  return (ax * norm) * xc + (ay * norm) * yc + (h * norm) * zc;
}

__device__ __forceinline__ float falloff(float x, float y, float z) {
  float m = clamp_min(FALLOFF_R2 - (x * x + y * y + z * z), 0.0f);
  m = m * m;
  return m * m;
}

// Simplex 3D noise (noise.py `snoise3_xyz`), op for op.
__device__ __forceinline__ float snoise3(float vx, float vy, float vz) {
  // First corner.
  const float s = (vx + vy + vz) * C_Y;
  float ix = floorf(vx + s);
  float iy = floorf(vy + s);
  float iz = floorf(vz + s);
  const float t = (ix + iy + iz) * C_X;
  const float x0x = vx - ix + t;
  const float x0y = vy - iy + t;
  const float x0z = vz - iz + t;

  // Other corners.
  const float gx = step_ge(x0x, x0y);
  const float gy = step_ge(x0y, x0z);
  const float gz = step_ge(x0z, x0x);
  const float lx = 1.0f - gx;
  const float ly = 1.0f - gy;
  const float lz = 1.0f - gz;
  const float i1x = fminf(gx, lz);
  const float i1y = fminf(gy, lx);
  const float i1z = fminf(gz, ly);
  const float i2x = fmaxf(gx, lz);
  const float i2y = fmaxf(gy, lx);
  const float i2z = fmaxf(gz, ly);

  const float x1x = x0x - i1x + C_X;
  const float x1y = x0y - i1y + C_X;
  const float x1z = x0z - i1z + C_X;
  const float x2x = x0x - i2x + C_Y;
  const float x2y = x0y - i2y + C_Y;
  const float x2z = x0z - i2z + C_Y;
  const float x3x = x0x - 0.5f;
  const float x3y = x0y - 0.5f;
  const float x3z = x0z - 0.5f;

  // Permutations (4 corners).
  ix = mod289(ix);
  iy = mod289(iy);
  iz = mod289(iz);
  const float p0 =
      permute(permute(permute(iz + 0.0f) + iy + 0.0f) + ix + 0.0f);
  const float p1 = permute(permute(permute(iz + i1z) + iy + i1y) + ix + i1x);
  const float p2 = permute(permute(permute(iz + i2z) + iy + i2y) + ix + i2x);
  const float p3 =
      permute(permute(permute(iz + 1.0f) + iy + 1.0f) + ix + 1.0f);

  const float d0 = gradient(p0, x0x, x0y, x0z);
  const float d1 = gradient(p1, x1x, x1y, x1z);
  const float d2 = gradient(p2, x2x, x2y, x2z);
  const float d3 = gradient(p3, x3x, x3y, x3z);

  return 42.0f * (falloff(x0x, x0y, x0z) * d0 + falloff(x1x, x1y, x1z) * d1 +
                  falloff(x2x, x2y, x2z) * d2 + falloff(x3x, x3y, x3z) * d3);
}

// logic.vary: base + offset * variance * base.
__device__ __forceinline__ float vary(float base, float offset,
                                      float variance) {
  return base + (offset * variance * base);
}

__global__ void __launch_bounds__(THREADS)
    logic_step_kernel(const float* __restrict__ particles,
                      const float* __restrict__ targets,
                      const float* __restrict__ force,
                      const int* __restrict__ idx, int n, int root_num,
                      Params prm, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long nn = n;
  const float px = particles[i];
  const float py = particles[nn + i];
  const float vx = particles[2 * nn + i];
  const float vy = particles[3 * nn + i];
  const float tx = targets[i];
  const float ty = targets[nn + i];
  const float fx = force != nullptr ? force[i] : 0.0f;
  const float fy = force != nullptr ? force[nn + i] : 0.0f;

  // state.particle_coords_from_idx: uv and index01 (idx >= 0, so torch.fmod
  // is the floored mod).
  const float r = (float)root_num;
  const float inv_r = 1.0f / r;
  const float inv_rr = 1.0f / (float)((long long)root_num * root_num);
  const float idf = (float)idx[i];
  const float ix = fmodf(idf, r);
  const float iy = floorf(idf * inv_r);
  const float uv0 = (ix + 0.5f) * inv_r;
  const float uv1 = (iy + 0.5f) * inv_r;
  const float index01 = ((ix + 0.5f) + (iy + 0.5f) * r) * inv_rr;

  const float time = __ldg(prm.p[TIME]);
  const float dt = __ldg(prm.p[DT]);
  const bool alive = (px != INERT) || (py != INERT);

  // Wander force (logic.wander_force).
  const float noise_scale =
      vary(__ldg(prm.p[NOISE_SCALE]), index01, __ldg(prm.p[VARY_NOISE_SCALE]));
  const float noise_speed =
      vary(__ldg(prm.p[NOISE_SPEED]), index01, __ldg(prm.p[VARY_NOISE_SPEED]));
  const float npx = px * noise_scale;
  const float npy = py * noise_scale;
  const float noise_time = time * noise_speed;
  const float za = uv0 + noise_time;
  const float zb = uv1 + noise_time + ZB_OFFSET;
  const float wx = snoise3(npx, npy, za);
  const float wy = snoise3(npx, npy, zb);

  const float force_w =
      vary(__ldg(prm.p[FORCE_WEIGHT]), index01, __ldg(prm.p[VARY_FORCE]));
  const float flow_w =
      vary(__ldg(prm.p[FLOW_WEIGHT]), index01, __ldg(prm.p[VARY_FLOW]));
  const float noise_w =
      vary(__ldg(prm.p[NOISE_WEIGHT]), index01, __ldg(prm.p[VARY_NOISE]));
  const float damping = __ldg(prm.p[DAMPING]);

  float nvx = vx * damping * dt +
              force_w * (fx * dt * flow_w + wx * dt * noise_w);
  float nvy = vy * damping * dt +
              force_w * (fy * dt * flow_w + wy * dt * noise_w);

  // Target seek.
  const float target_w =
      vary(__ldg(prm.p[TARGET]), index01, __ldg(prm.p[VARY_TARGET]));
  nvx = nvx + (tx - px) * target_w;
  nvy = nvy + (ty - py) * target_w;

  // Speed clamp (zero velocity stays zero), Euler step, inert mask.
  const float speed = sqrtf(nvx * nvx + nvy * nvy);
  const float scale = minimum(speed, __ldg(prm.p[SPEED_LIMIT])) /
                      clamp_min(speed, MIN_SPEED);
  nvx = nvx * scale;
  nvy = nvy * scale;

  out[i] = alive ? px + nvx : px;
  out[nn + i] = alive ? py + nvy : py;
  out[2 * nn + i] = alive ? nvx : vx;
  out[3 * nn + i] = alive ? nvy : vy;
}

}  // namespace

// `particles`, `out` f32 [4, n]; `targets` f32 [4, n] (rows 0-1 read);
// `force` f32 [2, n] or null; `idx` i32 [n]; then the 16 parameter pointers
// (Param's order); `out` must not alias `particles`.
extern "C" int tt_logic_step(
    const float* particles, const float* targets, const float* force,
    const int* idx, int n, int root_num, const float* noise_scale,
    const float* vary_noise_scale, const float* noise_speed,
    const float* vary_noise_speed, const float* force_weight,
    const float* vary_force, const float* flow_weight, const float* vary_flow,
    const float* noise_weight, const float* vary_noise, const float* damping,
    const float* target, const float* vary_target, const float* speed_limit,
    const float* time, const float* dt, float* out, void* stream) {
  const Params prm = {{noise_scale, vary_noise_scale, noise_speed,
                       vary_noise_speed, force_weight, vary_force, flow_weight,
                       vary_flow, noise_weight, vary_noise, damping, target,
                       vary_target, speed_limit, time, dt}};
  if (n > 0) {
    logic_step_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        particles, targets, force, idx, n, root_num, prm, out);
  }
  return (int)cudaGetLastError();
}
