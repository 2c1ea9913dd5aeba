// K4 gather + reconstruct — replaces
// tendrils_tpu/ops/gather_pallas.py:gather_reconstruct_p1 (body _kernel with
// recon, plus draw_pallas.reconstruct_rows).
// K5 bilinear gather — replaces gather_pallas.py:bilinear_gather (_kernel).
// K6 reconstruct — replaces draw_pallas.py:reconstruct_resident
// (_reconstruct_kernel).
// K8 keyed p1 gather — replaces gather_pallas.py:bilinear_gather_keyed_p1
// (_kernel with from_p1).
// K7 keyed q15 gather — replaces gather_pallas.py:bilinear_gather_keyed_q15
// (_kernel with from_p1 and pack).
// K12 keyed gather — replaces gather_pallas.py:bilinear_gather_keyed
// (_kernel on padded float coords).
//
// K4, one thread per sorted row: unpack the fixed-point p1 word, clamp it
// to the content edge, bilinearly sample the 2-channel decayed flow `eff`
// (content layout) there — the next step's force — and rebuild the row's
// particle state. K8 is K4's gather half alone (C channels, in K7's
// blocks) and K6 its reassembly half alone; the resident frame runs them
// apart when flow is injected between the draw and the gather. All three
// call the same device functions (common.cuh: bilerp_p1,
// reconstruct_row), so K4 equals K8 + K6 bit for bit. Once a target spawn
// has made the targets live, their xy rows ride the draw's sort, and K4
// and K6 also re-stack them as (tx, ty, 0, 0) (draw_pallas.py:1487-1512,
// gather_pallas.py:481-550): an instance of each kernel of its own
// (TARGETS), so the launch without targets is unchanged.
// K5: CLAMP_TO_EDGE bilinear sampling of a C-channel grid at arbitrary f32
// texel coords (contract: ops/sample.bilinear_sample). For each pair of
// channels `interleave_pair_kernel` copies the pair's planes into one
// texel-major f32[H, W, 2] scratch, then `bilinear_gather_pair_kernel`,
// one thread a point, reads each corner's two values with one 8-byte
// load: random points cost L2 sectors, and the pair shares one
// (PERF.md section 6 has the variants that were timed). An odd last
// channel is gathered from its plane (`bilinear_gather_kernel`).
// K7: K8's gather of the 2-channel decayed flow, then the force packed as
// two q15 fields over +-speedLimit, y << 15 | x (gather_pallas.py:222-232),
// the one word the non-resident frame un-sorts into row order. `inv_sl` is
// a device scalar, 1 / max(speedLimit, 1e-12) in f32 as the engine
// computes it. K7 and K8 run in blocks of KEYED_THREADS threads over
// KEYED_THREADS x r consecutive sorted rows (r = 1..8, from n and the
// card's SMs: `gather_cuda.keyed_layout`), so one SM's L1 serves one
// stretch of tiles, where blocks of 256 rows scattered each SM's reads
// over several distant tiles; no shared memory (staging the rows' tile
// region there was slower in every form timed, PERF.md section 6).
// K12: the gather on padded-grid float coords (x + PAD_LO_W, y +
// PAD_LO_H), with the TPU kernel's arithmetic: weights 1 - frac and 1 -
// that, summed per row then across rows; a corner outside the content
// contributes 0, as the TPU's zero padding and its clamped region DMA both
// give (gather_pallas.py:134-148). Inside [0.5, w - 0.5] x [0.5, h - 0.5]
// of the content, where every caller clamps its points, that is
// CLAMP_TO_EDGE sampling. Its points are the draw's tile-sorted stream
// (gather_pallas.py:310-318), so it runs in K7's blocks (PERF.md section
// 6 has it timed beside blocks of 256 threads, one point a thread).
//
// Bound: bytes. K6 reads npx, npy, vl (12 B/row) and writes particles and
// previous (32 B/row): 44 B x 262,144 rows = 11.5 MB, ~3.4 us at 3.35 TB/s
// for config 4; it does a few flops per row, far below the f32 rate. The
// targets add 8 B read and 16 B written a row to K4 and K6 (68 B a row,
// ~5.3 us for K6 at config 4). One thread a row, as without them: the
// loads and stores of a warp are coalesced, and the copy adds no
// arithmetic. K7
// reads p1 (4 B a row) and writes one word (4 B a row); K12 reads two
// coords (8 B) and writes C values a point. The gathers also read the four
// corner texels of each row; rows arrive sorted by tile (K4, K7, K8), so
// neighbouring threads read neighbouring texels and most corners hit
// L1/L2 (K12's points too, by its contract); K5's arrive in the caller's
// order. The TPU kernels sort points by tile, DMA each tile's region and
// gather with MXU matmuls because Mosaic has no vector gather; a plain
// load per corner computes the same function, so the port needs no sort,
// no un-sort and no tile keys. Corner indices are clamped into the grid
// (common.cuh:bilerp_at).
#include "common.cuh"

namespace {

using namespace tt;

// The live targets of row i, re-stacked as (tx, ty, 0, 0)
// (draw_pallas.reconstruct_rows' targ_ref): a copy, equal to the plain
// version bit for bit.
__device__ __forceinline__ void restack_targets(
    int i, int n, const float* __restrict__ tx, const float* __restrict__ ty,
    float* __restrict__ targ) {
  targ[i] = tx[i];
  targ[n + i] = ty[i];
  targ[2 * n + i] = 0.0f;
  targ[3 * n + i] = 0.0f;
}

// K4 and K6 with TARGETS: the same rows, plus the targets that rode the
// sort (tx, ty) re-stacked into `targ`.
template <bool TARGETS>
__global__ void gather_reconstruct_kernel(
    const float* __restrict__ eff, int h, int w, const int* __restrict__ p1w,
    const float* __restrict__ npx, const float* __restrict__ npy,
    const int* __restrict__ vlw, const float* __restrict__ sl_ptr,
    const float* __restrict__ tx, const float* __restrict__ ty, int n,
    float inv_p, float* __restrict__ force, float* __restrict__ part,
    float* __restrict__ prev, float* __restrict__ targ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Bilerp b = bilerp_p1(h, w, p1w[i], inv_p);
  force[i] = bilerp(eff, b);
  force[n + i] = bilerp(eff + (long long)h * w, b);
  reconstruct_row(i, n, sl_ptr[0], npx[i], npy[i], vlw[i], part, prev);
  if (TARGETS) restack_targets(i, n, tx, ty, targ);
}

template <bool TARGETS>
__global__ void reconstruct_kernel(
    const float* __restrict__ npx, const float* __restrict__ npy,
    const int* __restrict__ vlw, const float* __restrict__ sl_ptr,
    const float* __restrict__ tx, const float* __restrict__ ty, int n,
    float* __restrict__ part, float* __restrict__ prev,
    float* __restrict__ targ) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  reconstruct_row(i, n, sl_ptr[0], npx[i], npy[i], vlw[i], part, prev);
  if (TARGETS) restack_targets(i, n, tx, ty, targ);
}

// K7, K8 and K12: a block of KEYED_THREADS threads takes KEYED_THREADS x r
// consecutive sorted rows (`span`), so one SM's L1 serves one stretch of
// tiles; blocks stride over the spans past the first two waves. Thread j
// takes rows base + j + k x KEYED_THREADS, k < r: a warp's loads and
// stores are coalesced (a run of r consecutive rows a thread was slower,
// PERF.md section 6).
constexpr int KEYED_THREADS = 1024;

__global__ void __launch_bounds__(KEYED_THREADS, 2)
    gather_keyed_p1_kernel(const float* __restrict__ grid, int c, int h,
                           int w, const int* __restrict__ p1w, int n, int r,
                           float inv_p, float* __restrict__ out) {
  const long long span = (long long)KEYED_THREADS * r;
  const long long plane = (long long)h * w;
  for (long long base = blockIdx.x * span; base < n;
       base += gridDim.x * span) {
    for (int k = 0; k < r; ++k) {
      const long long i = base + threadIdx.x + (long long)k * KEYED_THREADS;
      if (i >= n) break;
      const Bilerp b = bilerp_p1(h, w, p1w[i], inv_p);
      for (int ch = 0; ch < c; ++ch) {
        out[(long long)ch * n + i] = bilerp(grid + ch * plane, b);
      }
    }
  }
}

// K5, the first launch for a pair of channels: planes a and b as one
// texel-major f32[hw, 2] copy.
__global__ void interleave_pair_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b, int hw,
                                       float2* __restrict__ pair) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= hw) return;
  pair[i] = make_float2(__ldcs(a + i), __ldcs(b + i));
}

// K5, the second: both channels of the pair at each point.
__global__ void bilinear_gather_pair_kernel(const float2* __restrict__ pair,
                                            int h, int w,
                                            const float* __restrict__ xs,
                                            const float* __restrict__ ys,
                                            int m, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const Bilerp b = bilerp_at(h, w, __ldcs(xs + i), __ldcs(ys + i));
  const float2 v00 = __ldg(pair + b.i00);
  const float2 v01 = __ldg(pair + b.i01);
  const float2 v10 = __ldg(pair + b.i10);
  const float2 v11 = __ldg(pair + b.i11);
  __stcs(out + i, lerp2d(v00.x, v01.x, v10.x, v11.x, b.fx, b.fy));
  __stcs(out + m + i, lerp2d(v00.y, v01.y, v10.y, v11.y, b.fx, b.fy));
}

// K5 for an odd last channel: its plane, one thread a point.
__global__ void bilinear_gather_kernel(const float* __restrict__ plane, int h,
                                       int w, const float* __restrict__ xs,
                                       const float* __restrict__ ys, int m,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  __stcs(out + i, bilerp(plane, bilerp_at(h, w, __ldcs(xs + i),
                                          __ldcs(ys + i))));
}

// jnp.round(clip(v * inv_sl, -1, 1) * 0.5 + 0.5) * HALF) of the q15 pack.
__device__ __forceinline__ int q15_force(float v, float inv_sl) {
  const float t = clampf(v * inv_sl, -1.0f, 1.0f) * 0.5f + 0.5f;
  return (int)rintf(t * (float)HALF);
}

__global__ void __launch_bounds__(KEYED_THREADS, 2)
    gather_keyed_q15_kernel(const float* __restrict__ eff, int h, int w,
                            const int* __restrict__ p1w,
                            const float* __restrict__ inv_sl_ptr, int n,
                            int r, float inv_p, int* __restrict__ out) {
  const float inv_sl = inv_sl_ptr[0];
  const long long span = (long long)KEYED_THREADS * r;
  for (long long base = blockIdx.x * span; base < n;
       base += gridDim.x * span) {
    for (int k = 0; k < r; ++k) {
      const long long i = base + threadIdx.x + (long long)k * KEYED_THREADS;
      if (i >= n) break;
      const Bilerp b = bilerp_p1(h, w, p1w[i], inv_p);
      const float fx = bilerp(eff, b);
      const float fy = bilerp(eff + (long long)h * w, b);
      out[i] = q15_force(fy, inv_sl) * (HALF + 1) + q15_force(fx, inv_sl);
    }
  }
}

// K12 in K7's blocks (its input is the draw's tile-sorted stream, so the
// same locality holds). Per point, once: the floor, the weights, the two
// corner rows and columns and the four in-content predicates; then per
// channel four predicated read-only loads and the TPU kernel's expression
// order. The coords and the output take plain loads and stores: with
// evict-first hints (`__ldcs`/`__stcs`) it ran slower warm and no faster
// after a clean L2 (PERF.md, section 6).
__global__ void __launch_bounds__(KEYED_THREADS, 2)
    gather_keyed_kernel(const float* __restrict__ grid, int c, int h, int w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ys, int m, int r,
                        float* __restrict__ out) {
  const long long span = (long long)KEYED_THREADS * r;
  const long long plane = (long long)h * w;
  for (long long base = blockIdx.x * span; base < m;
       base += gridDim.x * span) {
    for (int k = 0; k < r; ++k) {
      const long long i = base + threadIdx.x + (long long)k * KEYED_THREADS;
      if (i >= m) break;
      const float gx = xs[i] - 0.5f;
      const float gy = ys[i] - 0.5f;
      const float c0f = floorf(gx);
      const float r0f = floorf(gy);
      const float wx0 = 1.0f - (gx - c0f);
      const float wy0 = 1.0f - (gy - r0f);
      const float wx1 = 1.0f - wx0;
      const float wy1 = 1.0f - wy0;
      const int c0 = (int)c0f - PAD_LO_W;
      const int r0 = (int)r0f - PAD_LO_H;
      const bool col0 = c0 >= 0 && c0 < w;
      const bool col1 = c0 + 1 >= 0 && c0 + 1 < w;
      const bool row0 = r0 >= 0 && r0 < h;
      const bool row1 = r0 + 1 >= 0 && r0 + 1 < h;
      const bool p00 = row0 && col0, p01 = row0 && col1;
      const bool p10 = row1 && col0, p11 = row1 && col1;
      const long long o00 = (long long)r0 * w + c0;
      const long long o10 = o00 + w;
      for (int ch = 0; ch < c; ++ch) {
        const float* g = grid + ch * plane;
        const float t00 = p00 ? __ldg(g + o00) : 0.0f;
        const float t01 = p01 ? __ldg(g + o00 + 1) : 0.0f;
        const float t10 = p10 ? __ldg(g + o10) : 0.0f;
        const float t11 = p11 ? __ldg(g + o10 + 1) : 0.0f;
        const float top = t00 * wx0 + t01 * wx1;
        const float bot = t10 * wx0 + t11 * wx1;
        out[(long long)ch * m + i] = top * wy0 + bot * wy1;
      }
    }
  }
}

}  // namespace

// K4 and K6: `tx`, `ty` and `targets` are all null (no targets ride) or
// all given (the TARGETS instance).
extern "C" int tt_gather_reconstruct(const float* eff, int h, int w,
                                     const int* p1, const float* npx,
                                     const float* npy, const int* vl,
                                     const float* sl, const float* tx,
                                     const float* ty, int n, float inv_p,
                                     float* force, float* particles,
                                     float* previous, float* targets,
                                     void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (targets) {
      gather_reconstruct_kernel<true><<<blocks_for(n), THREADS, 0, s>>>(
          eff, h, w, p1, npx, npy, vl, sl, tx, ty, n, inv_p, force,
          particles, previous, targets);
    } else {
      gather_reconstruct_kernel<false><<<blocks_for(n), THREADS, 0, s>>>(
          eff, h, w, p1, npx, npy, vl, sl, tx, ty, n, inv_p, force,
          particles, previous, targets);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_reconstruct(const float* npx, const float* npy,
                              const int* vl, const float* sl,
                              const float* tx, const float* ty, int n,
                              float* particles, float* previous,
                              float* targets, void* stream) {
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (targets) {
      reconstruct_kernel<true><<<blocks_for(n), THREADS, 0, s>>>(
          npx, npy, vl, sl, tx, ty, n, particles, previous, targets);
    } else {
      reconstruct_kernel<false><<<blocks_for(n), THREADS, 0, s>>>(
          npx, npy, vl, sl, tx, ty, n, particles, previous, targets);
    }
  }
  return (int)cudaGetLastError();
}

// K8 and K7: `r` rows a thread, `blocks` blocks of KEYED_THREADS
// (`gather_cuda.keyed_layout`).
extern "C" int tt_gather_keyed_p1(const float* grid, int c, int h, int w,
                                  const int* p1, int n, int r, int blocks,
                                  float inv_p, float* out, void* stream) {
  if (n > 0) {
    gather_keyed_p1_kernel<<<blocks, KEYED_THREADS, 0,
                             (cudaStream_t)stream>>>(grid, c, h, w, p1, n,
                                                     r, inv_p, out);
  }
  return (int)cudaGetLastError();
}

// K5: `pair` is f32[H, W, 2] scratch (unused when c == 1); one
// interleave and one gather a pair of channels, one gather for an odd last
// channel.
extern "C" int tt_bilinear_gather(const float* grid, int c, int h, int w,
                                  const float* x, const float* y, int m,
                                  float* pair, float* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int hw = h * w;
  if (m > 0 && hw > 0) {
    float2* pair2 = reinterpret_cast<float2*>(pair);
    for (int k = 0; k + 1 < c; k += 2) {
      interleave_pair_kernel<<<blocks_for(hw), THREADS, 0, s>>>(
          grid + (long long)k * hw, grid + (long long)(k + 1) * hw, hw,
          pair2);
      bilinear_gather_pair_kernel<<<blocks_for(m), THREADS, 0, s>>>(
          pair2, h, w, x, y, m, out + (long long)k * m);
    }
    if (c % 2) {
      bilinear_gather_kernel<<<blocks_for(m), THREADS, 0, s>>>(
          grid + (long long)(c - 1) * hw, h, w, x, y, m,
          out + (long long)(c - 1) * m);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int tt_gather_keyed_q15(const float* eff, int h, int w,
                                   const int* p1, const float* inv_sl, int n,
                                   int r, int blocks, float inv_p, int* out,
                                   void* stream) {
  if (n > 0) {
    gather_keyed_q15_kernel<<<blocks, KEYED_THREADS, 0,
                              (cudaStream_t)stream>>>(eff, h, w, p1, inv_sl,
                                                      n, r, inv_p, out);
  }
  return (int)cudaGetLastError();
}

// K12: `r` points a thread, `blocks` blocks of KEYED_THREADS
// (`gather_cuda.keyed_layout`).
extern "C" int tt_gather_keyed(const float* grid, int c, int h, int w,
                               const float* xs, const float* ys, int m,
                               int r, int blocks, float* out, void* stream) {
  if (m > 0) {
    gather_keyed_kernel<<<blocks, KEYED_THREADS, 0, (cudaStream_t)stream>>>(
        grid, c, h, w, xs, ys, m, r, out);
  }
  return (int)cudaGetLastError();
}
