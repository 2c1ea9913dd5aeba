// K3 resolve — replaces tendrils_tpu/ops/draw_pallas.py:_resolve_kernel
// (launched from resolve_fused).
//
// One thread per content pixel. It reads the pixel's 11 accumulated
// channels from the PADDED accumulator at (PAD_LO_H + y, PAD_LO_W + x) and
// blends both grids order-independently: T = exp(sum log(1 - a) * s),
// new = old * T + (sum c.a * s / max(sum a * s, eps)) * (1 - T), with the
// flow's stamp numerator time * wsum, and the view cleared (autoClearView)
// and faded before its blend. It also emits `eff`, the new flow's velocity
// decayed to the next step's read time, for the next force gather.
//
// Bound: memory, ~29 floats per pixel (11 accumulator + 8 old grid reads,
// 8 new grid + 2 eff writes), all coalesced along a row. The TPU kernel's
// row blocks and double-buffered DMAs have no counterpart here. Each thread
// reads all of its pixel before writing it, so the kernel may run in place
// (new_flow == flow, new_view == view), as the TPU kernel does through
// input_output_aliases; the pointers are therefore not __restrict__.
//
// The view-only variant (`resolve_view_kernel`, flow_off: `flowWeight ==
// 0`) reads the 6 planes of K2's view-only accumulator and the old view and
// writes the new view: no flow, no eff (the engine passes the flow grid
// through untouched). The TPU kernel takes the view in its flow slot
// (draw_pallas.py:1302-1313), a calling detail of Pallas; here it has its
// own entry. Bound: 14 floats a pixel (6 + 4 read, 4 written).
#include "common.cuh"

namespace {

using namespace tt;

constexpr int N_VIEW = N_CHAN - N_FLOW;

// The view's blend of pixel i over the cleared + faded previous view: `av`,
// its six accumulated channels (r.a, g.a, b.a, a.a, a, log(1-a)), into nv.
__device__ __forceinline__ void blend_view(const float* __restrict__ rscal,
                                           const float* av, const float* view,
                                           int hw, int i, float* nv) {
  const float clear = rscal[3];
  const float sv = rscal[9];
  const float eps = rscal[10];
  const float fa = rscal[7];
  const float wsum_v = av[4] * sv;
  const float t_v = expf(av[5] * sv);
  const float gain_v = (1.0f - t_v) / fmaxf(wsum_v, eps);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v0 = view[k * hw + i] * (1.0f - clear);
    v0 = rscal[4 + k] * fa + v0 * (1.0f - fa);
    nv[k] = v0 * t_v + (av[k] * sv) * gain_v;
  }
}

// rscal (the JAX resolve's scal): [0] time, [1] read_time, [2] flowDecay,
// [3] autoClearView, [4..7] fadeColor * autoFade, [8] flow width scale,
// [9] view width scale, [10] eps.
__global__ void resolve_kernel(const float* __restrict__ rscal,
                               const float* __restrict__ acc, const float* flow,
                               const float* view, int h, int w, int hp,
                               int wp, float* new_flow, float* new_view,
                               float* eff) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = h * w;
  if (i >= hw) return;
  const int y = i / w;
  const int x = i - y * w;
  const long long plane = (long long)hp * wp;
  const float* a = acc + (long long)(PAD_LO_H + y) * wp + (PAD_LO_W + x);
  float ac[N_CHAN];
#pragma unroll
  for (int k = 0; k < N_CHAN; ++k) ac[k] = a[k * plane];

  const float time = rscal[0];
  const float read_time = rscal[1];
  const float fdecay = rscal[2];
  const float sf = rscal[8];
  const float eps = rscal[10];

  // Flow (splat.composite_over semantics; stamp num = time * wsum).
  const float wsum_f = ac[3] * sf;
  const float t_f = expf(ac[4] * sf);
  const float gain_f = (1.0f - t_f) / fmaxf(wsum_f, eps);
  const float fnum[4] = {ac[0] * sf, ac[1] * sf, time * wsum_f, ac[2] * sf};
  float nf[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nf[k] = flow[k * hw + i] * t_f + fnum[k] * gain_f;
  }

  // View over the cleared + faded previous view.
  float nv[4];
  blend_view(rscal, ac + N_FLOW, view, hw, i, nv);

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    new_flow[k * hw + i] = nf[k];
    new_view[k * hw + i] = nv[k];
  }
  if (eff != nullptr) {
    const float decay = fmaxf(0.0f, 1.0f - (read_time - nf[2]) * fdecay);
    eff[i] = nf[0] * decay;
    eff[hw + i] = nf[1] * decay;
  }
}

// The view-only resolve: `acc` holds the view's N_VIEW planes alone.
__global__ void resolve_view_kernel(const float* __restrict__ rscal,
                                    const float* __restrict__ acc,
                                    const float* view, int h, int w, int hp,
                                    int wp, float* new_view) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int hw = h * w;
  if (i >= hw) return;
  const int y = i / w;
  const int x = i - y * w;
  const long long plane = (long long)hp * wp;
  const float* a = acc + (long long)(PAD_LO_H + y) * wp + (PAD_LO_W + x);
  float av[N_VIEW];
#pragma unroll
  for (int k = 0; k < N_VIEW; ++k) av[k] = a[k * plane];
  float nv[4];
  blend_view(rscal, av, view, hw, i, nv);
#pragma unroll
  for (int k = 0; k < 4; ++k) new_view[k * hw + i] = nv[k];
}

}  // namespace

extern "C" int tt_resolve(const float* rscal, const float* accum,
                          const float* flow, const float* view, int h, int w,
                          int hp, int wp, float* new_flow, float* new_view,
                          float* eff, void* stream) {
  if (h * w > 0) {
    resolve_kernel<<<blocks_for((long long)h * w), THREADS, 0,
                     (cudaStream_t)stream>>>(rscal, accum, flow, view, h, w,
                                             hp, wp, new_flow, new_view, eff);
  }
  return (int)cudaGetLastError();
}

// The view-only variant: `accum` f32 [N_VIEW, hp, wp], `view` and
// `new_view` f32 [4, h, w].
extern "C" int tt_resolve_view(const float* rscal, const float* accum,
                               const float* view, int h, int w, int hp,
                               int wp, float* new_view, void* stream) {
  if (h * w > 0) {
    resolve_view_kernel<<<blocks_for((long long)h * w), THREADS, 0,
                          (cudaStream_t)stream>>>(rscal, accum, view, h, w,
                                                  hp, wp, new_view);
  }
  return (int)cudaGetLastError();
}
