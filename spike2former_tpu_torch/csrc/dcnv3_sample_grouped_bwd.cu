// DCNv3 deformable bilinear sampling in the grouped layout, backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dcnv3_sample_pallas_t_bwd (body
// _sampling_kernel_t_bwd) in spike2former_tpu/ops/pallas/dcnv3_kernel.py,
// the backward of the forward in dcnv3_sample_grouped.cu.  It computes the
// gradient, not the TPU algorithm: the Pallas kernel builds one-hot
// selectors, runs five matmuls per point and carries dfeat from one output
// tile to the next in its sequential grid.  Here each thread owns one
// (n, g, o) column, loads its Cg upstream gradients dout[n, g, :, o] once,
// and loops over the P points.  For each of the four floor-based taps
// inside the map, with s = <F_tap, dout>:
//
//   dfeat[n, g, tap, c] += m * wy * wx * dout[c]   (atomicAdd)
//   dmask += wy * wx * s
//   dpy   += m * (dwy/dpy) * wx * s,   dwy/dpy = -1 (row y0), +1 (row y0+1)
//   dpx   += m * wy * (dwx/dpx) * s,   likewise
//
// Taps off the map give 0 to every term.  The coordinate gradient stays
// floor-based at exact integer coordinates (F[y0+1] - F[y0]), as the TPU
// kernel's compare-based s0/s1, t0/t1 selectors keep it.  Blocks run in no
// order, so the TPU's accumulation across output tiles becomes atomics
// into a dfeat that the caller zeroes; their summation order varies from
// run to run (f32 rounding only).
//
// Layouts: feat and dfeat [N, G, H, W*Cg] (c fastest); py/px/mask and
// dpy/dpx/dmask [N, G, P, HoWo]; dout [N, G, Cg, HoWo].  Neighbouring
// threads read and write neighbouring o of every [.., HoWo] tensor, so
// those accesses coalesce.
//
// Bound: memory.  Per call it must read the feature map, 3 * N*G*P*HoWo*4
// bytes of coordinates and mask and the upstream gradient, and write dfeat
// and 3 * N*G*P*HoWo*4 bytes of coordinate and mask gradients: the same
// bytes as dcnv3_sample_bwd.cu.  The arithmetic (about 4 taps * 4 * Cg
// flops per point) is far below the f32 rate.  This first version scatters
// with scalar atomics straight to device memory, as dcnv3_sample_bwd.cu
// does; accumulating a group's dfeat in shared memory is left for later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// One tap at a pixel known to lie inside the map: scatter wt * dout into
// dfeat and return <F(pixel), dout>.
template <int CG>
__device__ __forceinline__ float tap(const float* __restrict__ map,
                                     float* __restrict__ dmap,
                                     const float (&d)[CG], int offset,
                                     float wt) {
  float s = 0.f;
  if constexpr (CG % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CG; c += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(map + offset + c));
      s += f.x * d[c] + f.y * d[c + 1] + f.z * d[c + 2] + f.w * d[c + 3];
    }
  } else {
#pragma unroll
    for (int c = 0; c < CG; ++c) s += __ldg(map + offset + c) * d[c];
  }
#pragma unroll
  for (int c = 0; c < CG; ++c) atomicAdd(dmap + offset + c, wt * d[c]);
  return s;
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
dcnv3_sample_grouped_bwd_kernel(const float* __restrict__ feat,
                                const float* __restrict__ py,
                                const float* __restrict__ px,
                                const float* __restrict__ mask,
                                const float* __restrict__ dout,
                                float* __restrict__ dfeat,
                                float* __restrict__ dpy,
                                float* __restrict__ dpx,
                                float* __restrict__ dmask, int cols,
                                int howo, int points, int h, int w) {
  const int col = blockIdx.x * kThreads + threadIdx.x;  // (n, g, o)
  if (col >= cols) return;
  const int o = col % howo;
  const int ng = col / howo;
  const size_t base = static_cast<size_t>(ng) * h * w * CG;
  const float* __restrict__ map = feat + base;
  float* __restrict__ dmap = dfeat + base;
  const size_t coord = static_cast<size_t>(ng) * points * howo + o;

  float d[CG];
  const float* __restrict__ dsrc =
      dout + static_cast<size_t>(ng) * CG * howo + o;
#pragma unroll
  for (int c = 0; c < CG; ++c) d[c] = __ldg(dsrc + static_cast<size_t>(c) * howo);

  for (int p = 0; p < points; ++p) {
    const size_t i = coord + static_cast<size_t>(p) * howo;
    const float y = py[i];
    const float x = px[i];
    const float m = mask[i];
    float gy = 0.f, gx = 0.f, gm = 0.f;
    const float y0f = floorf(y);
    const float x0f = floorf(x);
    // some tap inside the map (this also drops NaN coordinates)
    if (y0f >= -1.f && y0f <= h - 1.f && x0f >= -1.f && x0f <= w - 1.f) {
      const int y0 = static_cast<int>(y0f);
      const int x0 = static_cast<int>(x0f);
      const float fy = y - y0f;
      const float fx = x - x0f;
      const float wy0 = 1.f - fy, wx0 = 1.f - fx;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < h;
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < w;
      const int r0 = y0 * w;  // pixel index of (y0, 0)
      const int r1 = r0 + w;
      if (in_y0 && in_x0) {
        const float s = tap<CG>(map, dmap, d, (r0 + x0) * CG, m * wy0 * wx0);
        gm += wy0 * wx0 * s;
        gy -= wx0 * s;
        gx -= wy0 * s;
      }
      if (in_y0 && in_x1) {
        const float s = tap<CG>(map, dmap, d, (r0 + x0 + 1) * CG, m * wy0 * fx);
        gm += wy0 * fx * s;
        gy -= fx * s;
        gx += wy0 * s;
      }
      if (in_y1 && in_x0) {
        const float s = tap<CG>(map, dmap, d, (r1 + x0) * CG, m * fy * wx0);
        gm += fy * wx0 * s;
        gy += wx0 * s;
        gx -= fy * s;
      }
      if (in_y1 && in_x1) {
        const float s = tap<CG>(map, dmap, d, (r1 + x0 + 1) * CG, m * fy * fx);
        gm += fy * fx * s;
        gy += fx * s;
        gx += fy * s;
      }
    }
    dpy[i] = m * gy;
    dpx[i] = m * gx;
    dmask[i] = gm;
  }
}

template <int CG>
cudaError_t launch(const float* feat, const float* py, const float* px,
                   const float* mask, const float* dout, float* dfeat,
                   float* dpy, float* dpx, float* dmask, int n, int howo,
                   int groups, int points, int h, int w,
                   cudaStream_t stream) {
  const int cols = n * groups * howo;
  const int blocks = (cols + kThreads - 1) / kThreads;
  dcnv3_sample_grouped_bwd_kernel<CG><<<blocks, kThreads, 0, stream>>>(
      feat, py, px, mask, dout, dfeat, dpy, dpx, dmask, cols, howo, points,
      h, w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and does
// not synchronise; returns the cudaError_t of the launch.  `dfeat` must
// hold zeros.
extern "C" int dcnv3_sample_grouped_bwd_f32(
    const void* feat, const void* py, const void* px, const void* mask,
    const void* dout, void* dfeat, void* dpy, void* dpx, void* dmask, int n,
    int howo, int groups, int points, int h, int w, int cg, void* stream) {
  const auto* f = static_cast<const float*>(feat);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  const auto* d = static_cast<const float*>(dout);
  auto* df = static_cast<float*>(dfeat);
  auto* dy = static_cast<float*>(dpy);
  auto* dx = static_cast<float*>(dpx);
  auto* dm = static_cast<float*>(dmask);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * groups * howo == 0) return cudaSuccess;
  switch (cg) {
#define DCNV3_GROUPED_BWD_CASE(CG)                                           \
  case CG:                                                                   \
    return launch<CG>(f, y, x, m, d, df, dy, dx, dm, n, howo, groups,        \
                      points, h, w, s);
    DCNV3_GROUPED_BWD_CASE(1)
    DCNV3_GROUPED_BWD_CASE(2)
    DCNV3_GROUPED_BWD_CASE(4)
    DCNV3_GROUPED_BWD_CASE(8)
    DCNV3_GROUPED_BWD_CASE(16)
    DCNV3_GROUPED_BWD_CASE(32)
#undef DCNV3_GROUPED_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
