// DCNv3 deformable bilinear sampling, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel dcnv3_sample_pallas_t5_bwd (body
// _sampling_kernel_t5_bwd, tent=True) in
// spike2former_tpu/ops/pallas/dcnv3_kernel.py.  It computes the gradient of
// the forward in dcnv3_sample.cu, not the TPU algorithm: the Pallas kernel
// builds one-hot row/column selectors and runs three batched matmuls plus a
// pltpu.repeat channel expansion because scalar gathers serialize on a TPU.
// Here each thread owns one (n, o, g) row, loads its Cg upstream gradients
// dout[n, o, g*Cg:(g+1)*Cg] once, and loops over the P points.  For each of
// the four floor-based taps inside the map, with s = <F_tap, dout>:
//
//   dvalue[n, tap, g*Cg + c] += m * wy * wx * dout[c]   (atomicAdd)
//   dmask += wy * wx * s
//   dpy   += m * (dwy/dpy) * wx * s,   dwy/dpy = -1 (row y0), +1 (row y0+1)
//   dpx   += m * wy * (dwx/dpx) * s,   likewise
//
// Taps off the map give 0 to every term.  The coordinate gradient stays
// floor-based at exact integer coordinates (F[y0+1] - F[y0]): zero offsets
// at init put every coordinate there, and the TPU kernel keeps the same
// convention (dcnv3_kernel.py, compare-based s0/s1 taps).
//
// Layouts as the forward: value and dvalue [N, H, W, G*Cg] channels-last;
// py/px/mask and dpy/dpx/dmask [N, HoWo, G, P]; dout [N, HoWo, G*Cg].
// dvalue must be zeroed by the caller.  The atomics make the summation
// order of dvalue vary from run to run (f32 rounding only).
//
// Bound: memory.  Per call it must read the value map, 3 * N*HoWo*G*P*4
// bytes of coordinates and mask and the upstream gradient, and write dvalue
// and 3 * N*HoWo*G*P*4 bytes of coordinate and mask gradients.  The
// arithmetic (about 4 taps * 4 * Cg flops per point) is far below the f32
// rate.  This first version scatters with scalar atomics straight to
// global memory; shared-memory tiling of dvalue, vector atomics and fusing
// the coordinate math are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int CG>
__device__ __forceinline__ void load_row(float (&dst)[CG],
                                         const float* __restrict__ src) {
  if constexpr (CG % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CG; c += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + c));
      dst[c] = f.x;
      dst[c + 1] = f.y;
      dst[c + 2] = f.z;
      dst[c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CG; ++c) dst[c] = __ldg(src + c);
  }
}

// One tap at (y, x), known to lie inside the map: scatter wt * dout into
// dvalue and return <F(y, x), dout>.
template <int CG>
__device__ __forceinline__ float tap(const float* __restrict__ feat,
                                     float* __restrict__ dfeat,
                                     const float (&d)[CG], long long offset,
                                     float wt) {
  float f[CG];
  load_row<CG>(f, feat + offset);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    s += f[c] * d[c];
    atomicAdd(dfeat + offset + c, wt * d[c]);
  }
  return s;
}

template <int CG>
__global__ void __launch_bounds__(kThreads)
dcnv3_sample_bwd_kernel(const float* __restrict__ value,
                        const float* __restrict__ py,
                        const float* __restrict__ px,
                        const float* __restrict__ mask,
                        const float* __restrict__ dout,
                        float* __restrict__ dvalue,
                        float* __restrict__ dpy,
                        float* __restrict__ dpx,
                        float* __restrict__ dmask, int rows, int howo,
                        int groups, int points, int h, int w) {
  const int row = blockIdx.x * kThreads + threadIdx.x;  // (n, o, g)
  if (row >= rows) return;
  const int g = row % groups;
  const int n = row / (groups * howo);
  const int c_all = groups * CG;
  const size_t base = static_cast<size_t>(n) * h * w * c_all + g * CG;
  const float* __restrict__ feat = value + base;
  float* __restrict__ dfeat = dvalue + base;
  const size_t coord = static_cast<size_t>(row) * points;

  float d[CG];
  load_row<CG>(d, dout + static_cast<size_t>(row) * CG);

  for (int p = 0; p < points; ++p) {
    const float y = py[coord + p];
    const float x = px[coord + p];
    const float m = mask[coord + p];
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
      const long long r0 = static_cast<long long>(y0) * w;  // pixel index
      const long long r1 = r0 + w;
      if (in_y0 && in_x0) {
        const float s = tap<CG>(feat, dfeat, d, (r0 + x0) * c_all,
                                m * wy0 * wx0);
        gm += wy0 * wx0 * s;
        gy -= wx0 * s;
        gx -= wy0 * s;
      }
      if (in_y0 && in_x1) {
        const float s = tap<CG>(feat, dfeat, d, (r0 + x0 + 1) * c_all,
                                m * wy0 * fx);
        gm += wy0 * fx * s;
        gy -= fx * s;
        gx += wy0 * s;
      }
      if (in_y1 && in_x0) {
        const float s = tap<CG>(feat, dfeat, d, (r1 + x0) * c_all,
                                m * fy * wx0);
        gm += fy * wx0 * s;
        gy += wx0 * s;
        gx -= fy * s;
      }
      if (in_y1 && in_x1) {
        const float s = tap<CG>(feat, dfeat, d, (r1 + x0 + 1) * c_all,
                                m * fy * fx);
        gm += fy * fx * s;
        gy += fx * s;
        gx += fy * s;
      }
    }
    dpy[coord + p] = m * gy;
    dpx[coord + p] = m * gx;
    dmask[coord + p] = gm;
  }
}

template <int CG>
cudaError_t launch(const float* value, const float* py, const float* px,
                   const float* mask, const float* dout, float* dvalue,
                   float* dpy, float* dpx, float* dmask, int n, int howo,
                   int groups, int points, int h, int w,
                   cudaStream_t stream) {
  const int rows = n * howo * groups;
  const int blocks = (rows + kThreads - 1) / kThreads;
  dcnv3_sample_bwd_kernel<CG><<<blocks, kThreads, 0, stream>>>(
      value, py, px, mask, dout, dvalue, dpy, dpx, dmask, rows, howo,
      groups, points, h, w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and does
// not synchronise; returns the cudaError_t of the launch.  `dvalue` must
// hold zeros.
extern "C" int dcnv3_sample_bwd_f32(const void* value, const void* py,
                                    const void* px, const void* mask,
                                    const void* dout, void* dvalue,
                                    void* dpy, void* dpx, void* dmask, int n,
                                    int howo, int groups, int points, int h,
                                    int w, int cg, void* stream) {
  const auto* v = static_cast<const float*>(value);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  const auto* d = static_cast<const float*>(dout);
  auto* dv = static_cast<float*>(dvalue);
  auto* dy = static_cast<float*>(dpy);
  auto* dx = static_cast<float*>(dpx);
  auto* dm = static_cast<float*>(dmask);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * howo * groups == 0) return cudaSuccess;
  switch (cg) {
#define DCNV3_BWD_CASE(CG)                                                  \
  case CG:                                                                  \
    return launch<CG>(v, y, x, m, d, dv, dy, dx, dm, n, howo, groups,       \
                      points, h, w, s);
    DCNV3_BWD_CASE(1)
    DCNV3_BWD_CASE(2)
    DCNV3_BWD_CASE(4)
    DCNV3_BWD_CASE(8)
    DCNV3_BWD_CASE(16)
    DCNV3_BWD_CASE(32)
#undef DCNV3_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
