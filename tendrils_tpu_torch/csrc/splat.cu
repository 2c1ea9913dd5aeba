// K2 splat — replaces tendrils_tpu/ops/draw_pallas.py:_kernel (launched
// from _bin_and_splat), with the flow channels on, in every variant the
// engine runs: the p0 word stream and the rgba8 colour stream are each
// optional (null pointers), as the TPU kernel's derive_p0 and scalar_color.
//
// Each (sorted segment, sample) is re-derived from the packed words exactly
// as the TPU kernel does (`sample_geo`, `group_channels`): p0 from its word
// or as p1 - vel * viewScale (derive_p0), the colours from the rgba8 word or
// as the render colour model of a 1x1 colour map, the deposit mass from the
// major extent, the zero weight of samples the margin clamp moved, and the
// sample centre quantised to 1/pscale px. Its separable box footprints
// (width flowWidth for the 5 flow channels, lineWidth for the 6 view
// channels, each <= KMAX_WIDTH, so at most 9 x 9 texels) add into the
// PADDED f32[11, hp, wp] accumulator, the layout the resolve reads.
//
// Bound: deposits. At config 2 that is ~2M samples x (36 texels x 5 flow
// channels + 4 texels x 6 view channels) ~ 4.3e8 adds a frame. Added with
// float atomics straight into global memory they take 6.4 ms of the frame
// (an H100 at 700 W); this kernel adds them in shared memory, on the
// reference's own contract (draw_pallas.py:82-85, :255-263): the segments
// arrive sorted by a key whose tile is the top-left corner of their
// bounding box, and a sample whose footprint lies inside that key tile's
// REGION_H x REGION_W region (from the tile's origin) only touches the
// 2 x 2 output tiles (ty..ty+1, tx..tx+1). Three launches, stream-ordered:
//
//   1. `splat_plan_kernel`, one block per output tile: binary-searches the
//      sorted keys for the rows of its <= 4 source tiles (ty-1..ty,
//      tx-1..tx; two contiguous runs), splits a tile whose rows weigh more
//      than `chunk` (INFO: a clustered tile's own rows are its work) into
//      parts, queues them (their blocks run first, so a heavy tile is not
//      the tail) and zeroes the split tile's texels. (Searching in the
//      wrapper instead, with `torch.searchsorted`, left the tile pass 0.1
//      ms slower in a config-2 frame on an H100, for reasons not found.)
//   2. `splat_tile_kernel`, one block per (tile part, channel group): zeroes
//      its tile in shared memory (16 x 256 texels x 5 or 6 channels, 84 or
//      101 KB, rows padded to 264 floats), deposits every FITTING sample of
//      its rows into the texels of its own tile with shared-memory
//      atomics, and writes the tile out with 16-byte stores (a split tile:
//      coalesced global atomics into the zeroed tile). Every texel of the
//      accumulator is written, so nothing zeroes it first. A warp gathers
//      its depositing samples and puts ks lanes on each, one a footprint
//      column (ks = 6 at flowWidth 5, so 5 samples a round; 16 at
//      lineWidth 1), each walking its column's rows: a sample's adds fall
//      on distinct texels at once, where one sample a lane put
//      neighbouring sorted samples on the same texels (1.4x slower on an
//      H100). Bound here: the shared adds, which are compare-and-swap
//      loops (ATOMS.CAST.SPIN), and their bank conflicts;
//   3. `splat_stray_kernel`, one thread per (segment, sample): the samples
//      that do NOT fit their key tile's region (long segments, such as a p0
//      far from p1 after a respawn) with global atomicAdd, counted.
//
// Every sample is deposited once, by pass 2 or pass 3; the fit test
// (`fits_key_tile`) reads the tile from the sorted key itself, as the
// plan's searches do, so the run a row is found in and the region its fit
// is tested against cannot disagree. Sums are f32 (the TPU's matmul operands
// are bf16); shared and global float atomics add in an order that changes
// from run to run, so the accumulator is not bit-reproducible.
#include "common.cuh"

namespace {

using namespace tt;

constexpr int N_VIEW = N_CHAN - N_FLOW;
constexpr int TILE_THREADS = 512;
constexpr int PLAN_THREADS = 256;
// Shared tile rows, padded by 8 floats: the rows of a footprint start 8
// banks apart; 16-byte aligned for the vector stores.
constexpr int SROW = TILE_W + 8;
constexpr int SPLANE = TILE_H * SROW;
constexpr int TILE_SMEM = N_VIEW * SPLANE * (int)sizeof(float);  // 101,376 B
// Per-tile plan words: the starts of its source tiles' runs, above-left,
// above, left and its own, and their end (a0, am, a1, b0, bm, b1), the
// parts and the weighted rows w. A part's work is the samples that land
// in the tile, not its rows: nearly all of the tile's own rows do, about
// half of the row above's (boxes across the tile edge), few of the left
// and above-left tiles' (a 256-texel edge), so rows weigh 16, 8, 1 and 1
// sixteenths (their sum, 26, sizes draw_cuda.queue_cap).
constexpr int INFO = 8;
constexpr int W_DIAG = 1, W_ABOVE = 8, W_LEFT = 1, W_OWN = 16;

struct Params {
  const float* scal;
  const int* keys;
  const int* p1w;
  const int* vlw;
  const int* p0w;
  const int* rgbaw;
  int n, samples, h, w, hp, wp, tiles_x, bits;
  float pscale;
};

// Box-overlap coverage of texel `idx` by the footprint [lo, hi).
__device__ __forceinline__ float cover(float idx, float lo, float hi) {
  return clampf(fminf(idx + 1.0f, hi) - fmaxf(idx, lo), 0.0f, 1.0f);
}

// One sample's placement: the quantised centre (gx, gy), its deposit mass
// a, and what its channels need.
struct Geo {
  float gx, gy, a, vx, vy, p1x, p1y;
};

// Sample s of sorted segment i, op for op as the TPU kernel. False when
// its mass is 0 (a dead row, or a sample the margin clamp moved): every
// channel of it is exactly 0.
__device__ __forceinline__ bool sample_geo(const Params& P, int i, int s,
                                           Geo& g) {
  const float* scal = P.scal;
  const float speed_limit = scal[0];
  const float inv_p = 1.0f / P.pscale;
  const int p1 = P.p1w[i];
  const int vl = P.vlw[i];
  const float p1x = (float)(p1 & HALF) * inv_p;
  const float p1y = (float)(p1 >> 15) * inv_p;
  const float live = (float)(vl >> 30);
  const int vel_u = vl & ((1 << 30) - 1);
  const float vx = unq15(vel_u & HALF) * speed_limit;
  const float vy = unq15(vel_u >> 15) * speed_limit;
  float p0x, p0y;
  if (P.p0w == nullptr) {
    // derive_p0: Euler inverse in pixel space.
    p0x = clampf(p1x - vx * (scal[30] * 0.5f * (float)P.w), 1.0f,
                 (float)(PAD_LO_W + P.w) + 1.0f);
    p0y = clampf(p1y - vy * (scal[31] * 0.5f * (float)P.h), 1.0f,
                 (float)(PAD_LO_H + P.h) + 1.0f);
  } else {
    const int p0 = P.p0w[i];
    p0x = (float)(p0 & HALF) * inv_p;
    p0y = (float)(p0 >> 15) * inv_p;
  }
  const float dx = p1x - p0x;
  const float dy = p1y - p0y;
  // GL's DDA lights one fragment per major-axis pixel: mass ~ major extent.
  const float ascale = live * fmaxf(fmaxf(fabsf(dx), fabsf(dy)), 1.0f) /
                       (float)P.samples;
  // As JAX: (s + 0.5) / samples in double, rounded once.
  const float ts = (float)((s + 0.5) / P.samples);
  const float xu = p0x + dx * ts;
  const float yu = p0y + dy * ts;
  const float xp = clampf(xu, 1.0f, (float)(PAD_LO_W + P.w) + 1.0f);
  const float yp = clampf(yu, 1.0f, (float)(PAD_LO_H + P.h) + 1.0f);
  g.a = (xu != xp || yu != yp) ? 0.0f : ascale;
  g.gx = (float)(int)rintf(xp * P.pscale) * inv_p - 0.5f;
  g.gy = (float)(int)rintf(yp * P.pscale) * inv_p - 0.5f;
  g.vx = vx;
  g.vy = vy;
  g.p1x = p1x;
  g.p1y = p1y;
  return g.a != 0.0f;
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

// The NCH channel values of one channel group of a placed sample: the
// flow's (vx.a, vy.a, wf.a, a, log(1-a)) or the view's (r.a, g.a, b.a,
// a.a, a, log(1-a)). False when the group's alpha is 0 (nothing to add).
template <int NCH>
__device__ __forceinline__ bool group_channels(const Params& P, int i,
                                               const Geo& g, float* ch) {
  if (NCH == N_FLOW) {
    const float wf = fminf(sqrtf(g.vx * g.vx + g.vy * g.vy) / P.scal[0],
                           1.0f);
    const float af = fminf(wf * g.a, (float)(1.0 - 1e-4));
    if (!(af > 0.0f)) return false;
    ch[0] = g.vx * af;
    ch[1] = g.vy * af;
    ch[2] = wf * af;
    ch[3] = af;
    ch[4] = log1pf(-af);
    return true;
  }
  float c[4];
  if (P.rgbaw != nullptr) {
    // The rgba8 word K1 packed (draw_pallas.py:323-329).
    const int rgba = P.rgbaw[i];
    const float c8 = (float)(4.0 / 255.0);
    c[0] = (float)(rgba & 255) * c8;
    c[1] = (float)((rgba >> 8) & 255) * c8;
    c[2] = (float)((rgba >> 16) & 255) * c8;
    c[3] = (float)((rgba >> 24) & 127) * (float)(4.0 / 127.0);
  } else {
    scalar_colors(P.scal, g.vx, g.vy, g.p1x, g.p1y, P.h, P.w, c);
  }
  const float av = clampf(c[3] * g.a, 0.0f, (float)(1.0 - 1e-4));
  if (!(av > 0.0f)) return false;
  ch[0] = c[0] * av;
  ch[1] = c[1] * av;
  ch[2] = c[2] * av;
  ch[3] = c[3] * av;
  ch[4] = av;
  if (NCH > 5) ch[NCH - 1] = log1pf(-av);
  return true;
}

// Clamped box width of channel group `NCH` (flowWidth or lineWidth) and
// half the wider of the two: the footprint the fit test bounds.
template <int NCH>
__device__ __forceinline__ float group_width(const float* scal) {
  return clampf(scal[NCH == N_FLOW ? 2 : 3], 1.0f, KMAX_WIDTH);
}

__device__ __forceinline__ float half_widest(const float* scal) {
  return fmaxf(clampf(scal[2], 1.0f, KMAX_WIDTH),
               clampf(scal[3], 1.0f, KMAX_WIDTH)) * 0.5f;
}

// Whether a sample's footprint (the wider box, half-width hwm) lies in the
// region of its sorted key's tile (tests/test_torch_splat_tiles.py holds a
// transcription to the reference's rule). At the grid's top and left edges
// the region reaches out past them: texels there do not exist, in either
// pass.
__device__ __forceinline__ bool fits_key_tile(const Params& P, int key,
                                              float gx, float gy,
                                              float hwm) {
  const int tile = key >> P.bits;
  const int ty = tile / P.tiles_x;
  const float row0 = (float)(ty * TILE_H);
  const float col0 = (float)((tile - ty * P.tiles_x) * TILE_W);
  return (row0 == 0.0f || gy + (0.5f - hwm) >= row0) &&
         gy + (0.5f + hwm) <= row0 + REGION_H &&
         (col0 == 0.0f || gx + (0.5f - hwm) >= col0) &&
         gx + (0.5f + hwm) <= col0 + REGION_W;
}

// --- pass 1: the plan --------------------------------------------------------

// `queue`: the count of queued parts, the count of strays (pass 3), then
// (tile, part) pairs.
constexpr int QUEUE_HEAD = 2;

// First row of the tile-sorted keys whose tile is >= `tile`.
__device__ __forceinline__ int tile_start(const int* __restrict__ keys, int n,
                                          int bits, int tile) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((keys[mid] >> bits) < tile) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void splat_plan_kernel(const int* __restrict__ keys, int n,
                                  int bits, int tiles_x, int hp, int wp,
                                  int chunk,
                                  int* __restrict__ info,
                                  int* __restrict__ queue, int queue_cap,
                                  float* __restrict__ acc) {
  const int t = blockIdx.x;
  const int ty = t / tiles_x;
  const int tx = t - ty * tiles_x;
  __shared__ int parts_s;
  if (threadIdx.x == 0) {
    // Source tiles (ty-1..ty, tx-1..tx): one run of rows in each tile row.
    const int lo = tx > 0 ? tx - 1 : 0;
    int a0 = 0, am = 0, a1 = 0;
    if (ty > 0) {
      a0 = tile_start(keys, n, bits, (ty - 1) * tiles_x + lo);
      am = tile_start(keys, n, bits, (ty - 1) * tiles_x + tx);
      a1 = tile_start(keys, n, bits, (ty - 1) * tiles_x + tx + 1);
    }
    const int b0 = tile_start(keys, n, bits, ty * tiles_x + lo);
    const int bm = tile_start(keys, n, bits, t);
    const int b1 = tile_start(keys, n, bits, t + 1);
    const long long w = (long long)W_DIAG * (am - a0) +
                        (long long)W_ABOVE * (a1 - am) +
                        (long long)W_LEFT * (bm - b0) +
                        (long long)W_OWN * (b1 - bm);
    const int parts = w > chunk ? (int)((w + chunk - 1) / chunk) : 1;
    int* in = info + INFO * t;
    in[0] = a0;
    in[1] = am;
    in[2] = a1;
    in[3] = b0;
    in[4] = bm;
    in[5] = b1;
    in[6] = parts;
    in[7] = w < 2147483647LL ? (int)w : 2147483647;
    if (parts > 1) {
      const int base = atomicAdd(queue, parts);
      for (int j = 0; j < parts && base + j < queue_cap; ++j) {
        queue[QUEUE_HEAD + 2 * (base + j)] = t;
        queue[QUEUE_HEAD + 1 + 2 * (base + j)] = j;
      }
    }
    parts_s = parts;
  }
  __syncthreads();
  if (parts_s == 1) return;
  // A split tile: its parts add into it with global atomics, so zero it.
  const long long plane = (long long)hp * wp;
  float* tile0 = acc + (long long)(ty * TILE_H) * wp + tx * TILE_W;
  constexpr int Q = TILE_W / 4;
  for (int k = threadIdx.x; k < N_CHAN * TILE_H * Q; k += blockDim.x) {
    const int c4 = k % Q;
    const int r = (k / Q) % TILE_H;
    const int ch = k / (Q * TILE_H);
    *reinterpret_cast<float4*>(tile0 + ch * plane + (long long)r * wp +
                               4 * c4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The first of a tile's source rows, laid end to end (above-left, above,
// left, own: n1..n4 rows), whose weighted start is at least x: part j of
// `parts` takes the rows from at(w * j / parts) to at(w * (j + 1) /
// parts).
__device__ __forceinline__ int weighted_row(long long x, int n1, int n2,
                                            int n3) {
  const long long c1 = (long long)W_DIAG * n1;
  const long long c2 = c1 + (long long)W_ABOVE * n2;
  const long long c3 = c2 + (long long)W_LEFT * n3;
  if (x <= c1) return (int)((x + W_DIAG - 1) / W_DIAG);
  if (x <= c2) return n1 + (int)((x - c1 + W_ABOVE - 1) / W_ABOVE);
  if (x <= c3) return n1 + n2 + (int)((x - c2 + W_LEFT - 1) / W_LEFT);
  return n1 + n2 + n3 + (int)((x - c3 + W_OWN - 1) / W_OWN);
}

// --- pass 2: the tile pass ---------------------------------------------------

// A sample's box of half-width hw around (gx, gy): its extent and the
// rows and columns it can touch from (r0, c0), at most KSPAN each, as the
// stray pass and the plain version iterate them.
struct Box {
  float lo_y, hi_y, lo_x, hi_x, r0, c0;
  int nr, nc;
};

__device__ __forceinline__ Box box_of(float gx, float gy, float hw) {
  Box b;
  b.lo_y = gy + (0.5f - hw);
  b.hi_y = gy + (0.5f + hw);
  b.lo_x = gx + (0.5f - hw);
  b.hi_x = gx + (0.5f + hw);
  b.r0 = floorf(b.lo_y);
  b.c0 = floorf(b.lo_x);
  b.nr = min((int)(ceilf(b.hi_y) - b.r0), KSPAN);
  b.nc = min((int)(ceilf(b.hi_x) - b.c0), KSPAN);
  return b;
}

// Add v[0..NCH) into the NCH planes of shared texel t. Hopper has no
// shared-memory float add: each atomicAdd is a compare-and-swap loop
// (ATOMS.CAST.SPIN), still cheaper than one 64-bit compare-and-swap a
// channel pair or a loop of our own with every channel in flight.
template <int NCH>
__device__ __forceinline__ void add_texel(float* t, const float* v) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) atomicAdd(t + k * SPLANE, v[k]);
}

// Column dx of box b, channels ch, into the shared tile at (row0, col0):
// the texels of that column that lie in the tile, row by row.
template <int NCH>
__device__ __forceinline__ void tile_column(float* __restrict__ sm,
                                            const float* ch, const Box& b,
                                            int dx, float inv_w, int row0,
                                            int col0) {
  const float cf = b.c0 + (float)dx;
  const int c = (int)cf - col0;
  const float wc = cover(cf, b.lo_x, b.hi_x);
  if (c < 0 || c >= TILE_W || wc <= 0.0f) return;
  for (int dy = 0; dy < b.nr; ++dy) {
    const float rf = b.r0 + (float)dy;
    const int r = (int)rf - row0;
    if (r < 0 || r >= TILE_H) continue;
    const float wr = cover(rf, b.lo_y, b.hi_y) * inv_w;
    if (wr <= 0.0f) continue;
    float v[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) v[k] = (wr * ch[k]) * wc;
    add_texel<NCH>(sm + r * SROW + c, v);
  }
}

template <int NCH>
__device__ __forceinline__ void tile_body(const Params& P, int t, int part,
                                          const int* __restrict__ info,
                                          float* __restrict__ sm,
                                          float* __restrict__ acc) {
  const int ty = t / P.tiles_x;
  const int row0 = ty * TILE_H;
  const int col0 = (t - ty * P.tiles_x) * TILE_W;
  float4* sm4 = reinterpret_cast<float4*>(sm);
  for (int k = threadIdx.x; k < NCH * SPLANE / 4; k += blockDim.x) {
    sm4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const int* in = info + INFO * t;
  const int a0 = in[0], na = in[2] - in[0], b0 = in[3];
  const int parts = in[6];
  const int n1 = in[1] - in[0], n2 = in[2] - in[1], n3 = in[4] - in[3];
  const long long w = (long long)W_DIAG * n1 + (long long)W_ABOVE * n2 +
                      (long long)W_LEFT * n3 +
                      (long long)W_OWN * (in[5] - in[4]);
  const int lo = weighted_row(w * part / parts, n1, n2, n3);
  const int hi = weighted_row(w * (part + 1) / parts, n1, n2, n3);
  const float width = group_width<NCH>(P.scal);
  const float hw = width * 0.5f;
  const float inv_w = 1.0f / width;
  const float hwm = half_widest(P.scal);
  // Lanes over footprint columns: `per` samples a round, ks lanes on each
  // (ks the columns a box of this width touches, but where float rounding
  // adds one: those boxes go whole to their own thread), every lane
  // walking its column's rows.
  const int ks = min((int)ceilf(width) + 1, KSPAN);
  const int lane = threadIdx.x & 31;
  const int per = 32 / ks;
  const int slot = lane / ks;
  const int dcol = lane - slot * ks;
  const long long items = (long long)(hi - lo) * P.samples;
  // Uniform trip count over the block: the lane mapping shuffles.
  for (long long base = 0; base < items; base += blockDim.x) {
    const long long it = base + threadIdx.x;
    bool dep = false;
    Geo g;
    g.gx = g.gy = 0.0f;
    float ch[NCH];
    if (it < items) {
      const int k = lo + (int)(it / P.samples);
      const int s = (int)(it - (long long)(k - lo) * P.samples);
      const int i = k < na ? a0 + k : b0 + (k - na);
      if (sample_geo(P, i, s, g) &&
          fits_key_tile(P, P.keys[i], g.gx, g.gy, hwm)) {
        // Does its box touch this tile?
        const Box b = box_of(g.gx, g.gy, hw);
        dep = b.hi_y > (float)row0 && b.lo_y < (float)(row0 + TILE_H) &&
              b.hi_x > (float)col0 && b.lo_x < (float)(col0 + TILE_W) &&
              group_channels<NCH>(P, i, g, ch);
        if (dep && b.nc > ks) {
          for (int dx = 0; dx < b.nc; ++dx) {
            tile_column<NCH>(sm, ch, b, dx, inv_w, row0, col0);
          }
          dep = false;
        }
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, dep);
    // This lane holds the rank-`lane` sample's source lane.
    const int rank_src = (int)__fns(mask, 0, lane + 1);
    const int ndep = __popc(mask);
    for (int s0 = 0; s0 < ndep; s0 += per) {
      const int r = s0 + slot;
      const bool act = slot < per && r < ndep;
      const int src = __shfl_sync(0xffffffffu, rank_src, act ? r : 0) & 31;
      const float sgx = __shfl_sync(0xffffffffu, g.gx, src);
      const float sgy = __shfl_sync(0xffffffffu, g.gy, src);
      float sch[NCH];
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        sch[k] = __shfl_sync(0xffffffffu, dep ? ch[k] : 0.0f, src);
      }
      if (act) {
        const Box b = box_of(sgx, sgy, hw);
        if (dcol < b.nc) {
          tile_column<NCH>(sm, sch, b, dcol, inv_w, row0, col0);
        }
      }
    }
  }
  __syncthreads();

  // Write the tile out: 16-byte stores, or coalesced atomics into a split
  // (zeroed) tile.
  const long long plane = (long long)P.hp * P.wp;
  float* tile0 = acc + (long long)row0 * P.wp + col0;
  constexpr int Q = TILE_W / 4;
  for (int k = threadIdx.x; k < NCH * TILE_H * Q; k += blockDim.x) {
    const int c4 = k % Q;
    const int r = (k / Q) % TILE_H;
    const int c = k / (Q * TILE_H);
    const float4 v = sm4[(c * SPLANE + r * SROW) / 4 + c4];
    float* dst = tile0 + c * plane + (long long)r * P.wp + 4 * c4;
    if (parts == 1) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      atomicAdd(dst, v.x);
      atomicAdd(dst + 1, v.y);
      atomicAdd(dst + 2, v.z);
      atomicAdd(dst + 3, v.w);
    }
  }
}

// Blocks [0, queue_cap) take the queued parts of split tiles (first, so
// the heavy work starts early; the unused ones exit), blocks [queue_cap,
// queue_cap + tiles) the tiles that are not split. blockIdx.y: the
// channel group (0 flow, 1 view).
__global__ void __launch_bounds__(TILE_THREADS, 2)
    splat_tile_kernel(Params P, const int* __restrict__ info,
                      const int* __restrict__ queue, int queue_cap,
                      float* __restrict__ acc) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x;
  int t = b - queue_cap, part = 0;
  if (b < queue_cap) {
    if (b >= queue[0]) return;
    t = queue[QUEUE_HEAD + 2 * b];
    part = queue[QUEUE_HEAD + 1 + 2 * b];
  } else if (info[INFO * t + 6] > 1) {
    return;
  }
  if (blockIdx.y == 0) {
    tile_body<N_FLOW>(P, t, part, info, sm, acc);
  } else {
    tile_body<N_VIEW>(P, t, part, info, sm,
                      acc + N_FLOW * (long long)P.hp * P.wp);
  }
}

// --- pass 3: the strays ------------------------------------------------------

// Add chans[0..nch) x box(width 2*hw) around (gx, gy) into nch planes of
// the global accumulator.
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

__global__ void splat_stray_kernel(Params P, int* __restrict__ strays,
                                   float* __restrict__ acc) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)P.n * P.samples) return;
  const int i = (int)(t / P.samples);
  const int s = (int)(t - (long long)i * P.samples);
  Geo g;
  if (!sample_geo(P, i, s, g)) return;
  if (fits_key_tile(P, P.keys[i], g.gx, g.gy, half_widest(P.scal))) return;
  atomicAdd(strays, 1);
  float ch[N_VIEW];
  if (group_channels<N_FLOW>(P, i, g, ch)) {
    const float width = group_width<N_FLOW>(P.scal);
    deposit<N_FLOW>(acc, P.hp, P.wp, ch, g.gx, g.gy, width * 0.5f,
                    1.0f / width);
  }
  if (group_channels<N_VIEW>(P, i, g, ch)) {
    const float width = group_width<N_VIEW>(P.scal);
    deposit<N_VIEW>(acc + N_FLOW * (long long)P.hp * P.wp, P.hp, P.wp, ch,
                    g.gx, g.gy, width * 0.5f, 1.0f / width);
  }
}

Params make_params(const float* scal, const int* keys, const int* p1,
                   const int* vl, const int* p0, const int* rgba, int n,
                   int samples, int h, int w, int hp, int wp, int bits,
                   float pscale) {
  return Params{scal, keys, p1, vl, p0, rgba, n, samples, h, w, hp, wp,
                wp / TILE_W, bits, pscale};
}

}  // namespace

// Pass 1. `keys`: i32[n], tile-sorted, `tile << bits | id`; `info`:
// i32[INFO x tiles]; `queue`: i32[QUEUE_HEAD + 2 x queue_cap]; `chunk`:
// the most weighted rows a part takes.
extern "C" int tt_splat_plan(const int* keys, int n, int bits, int hp, int wp,
                             int chunk, int* info, int* queue, int queue_cap,
                             float* accum, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(queue, 0, QUEUE_HEAD * sizeof(int), s);
  const int tiles = (hp / TILE_H) * (wp / TILE_W);
  splat_plan_kernel<<<tiles, PLAN_THREADS, 0, s>>>(
      keys, n, bits, wp / TILE_W, hp, wp, chunk, info, queue, queue_cap,
      accum);
  return (int)cudaGetLastError();
}

// Pass 2, after pass 1 on the same stream.
extern "C" int tt_splat_tiles(const float* scal, const int* keys,
                              const int* p1, const int* vl, const int* p0,
                              const int* rgba, int n, int samples, int h,
                              int w, int hp, int wp, int bits, float pscale,
                              const int* info, const int* queue,
                              int queue_cap, float* accum, void* stream) {
  const Params P = make_params(scal, keys, p1, vl, p0, rgba, n, samples, h,
                               w, hp, wp, bits, pscale);
  const dim3 grid(queue_cap + (hp / TILE_H) * (wp / TILE_W), 2);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaFuncSetAttribute(splat_tile_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILE_SMEM);
  splat_tile_kernel<<<grid, TILE_THREADS, TILE_SMEM, s>>>(P, info, queue,
                                                          queue_cap, accum);
  return (int)cudaGetLastError();
}

// Pass 3, after pass 2 on the same stream; counts the strays into
// queue[1].
extern "C" int tt_splat_strays(const float* scal, const int* keys,
                               const int* p1, const int* vl, const int* p0,
                               const int* rgba, int n, int samples, int h,
                               int w, int hp, int wp, int bits, float pscale,
                               int* queue, float* accum, void* stream) {
  const long long items = (long long)n * samples;
  if (items > 0) {
    splat_stray_kernel<<<blocks_for(items), THREADS, 0,
                         (cudaStream_t)stream>>>(
        make_params(scal, keys, p1, vl, p0, rgba, n, samples, h, w, hp, wp,
                    bits, pscale),
        queue + 1, accum);
  }
  return (int)cudaGetLastError();
}
