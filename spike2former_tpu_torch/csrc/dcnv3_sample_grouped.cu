// DCNv3 deformable bilinear sampling in the grouped layout, forward, for
// Hopper (sm_90a).
//
// Replaces four TPU kernels of spike2former_tpu/ops/pallas/dcnv3_kernel.py:
// dcnv3_sample_pallas_t (body _sampling_kernel_t), dcnv3_sample_pallas
// (_sampling_kernel), dcnv3_sample_pallas_t4 (_sampling_kernel_t4) and
// dcnv3_sample_pallas_tg (_sampling_kernel_tg).  The four compute one
// function and differ only in how the TPU builds it: one-hot selector
// matmuls, a matmul or a pltpu.repeat channel expansion, one program per
// group or one per batch.  dcnv3_sample_pallas alone writes another output
// layout.  Here each thread owns one (n, g, o) output column and loops over
// the P points:
//
//   out[n, g, c, o] = sum_p m * bilinear(feat[n, g, :, :, c]; py, px)
//
// with floor-based taps (y0 = floor(py), y0 + 1; likewise x), zero padding
// outside [0, H) x [0, W), and f32 accumulation in registers.  Floor-based
// taps hold at exact integer coordinates too, as in dcnv3_sample.cu.
//
// Layouts: feat [N, G, H, W*Cg] (c fastest), so one tap of Cg = 8 f32
// channels is two 16-byte loads; py/px/mask [N, G, P, HoWo], so neighbouring
// threads read neighbouring o and the coordinate loads coalesce; out
// [N, G, Cg, HoWo] ("gchw", where a warp's store of channel c coalesces) or
// [N, G, HoWo, Cg] ("ghwc", 16-byte stores when Cg % 4 == 0).
//
// Bound: memory.  Per call it must read 3 * N*G*P*HoWo*4 bytes of
// coordinates and mask, the feature map once (N*G*H*W*Cg*4 bytes; taps of
// neighbouring columns hit in L1/L2) and write N*G*Cg*HoWo*4 bytes: the
// same bytes as dcnv3_sample.cu.  The arithmetic (about 4 taps * Cg * 2
// flops per point) is far below the f32 rate.  A group's whole map is
// contiguous (45 KB at the flagship serve shape); staging it in shared
// memory is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int CG>
__device__ __forceinline__ void tap(float (&acc)[CG],
                                    const float* __restrict__ src, float wt) {
  if constexpr (CG % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CG; c += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src + c));
      acc[c] += wt * f.x;
      acc[c + 1] += wt * f.y;
      acc[c + 2] += wt * f.z;
      acc[c + 3] += wt * f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] += wt * __ldg(src + c);
  }
}

template <int CG, bool GCHW>
__global__ void __launch_bounds__(kThreads)
dcnv3_sample_grouped_kernel(const float* __restrict__ feat,
                            const float* __restrict__ py,
                            const float* __restrict__ px,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int cols, int howo,
                            int points, int h, int w) {
  const int col = blockIdx.x * kThreads + threadIdx.x;  // (n, g, o)
  if (col >= cols) return;
  const int o = col % howo;
  const int ng = col / howo;
  const float* __restrict__ map =
      feat + static_cast<size_t>(ng) * h * w * CG;
  const size_t coord = static_cast<size_t>(ng) * points * howo + o;

  float acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = 0.f;

  for (int p = 0; p < points; ++p) {
    const size_t i = coord + static_cast<size_t>(p) * howo;
    const float y = py[i];
    const float x = px[i];
    const float m = mask[i];
    const float y0f = floorf(y);
    const float x0f = floorf(x);
    // every tap off the map (this also drops NaN coordinates)
    if (!(y0f >= -1.f && y0f <= h - 1.f && x0f >= -1.f && x0f <= w - 1.f))
      continue;
    const int y0 = static_cast<int>(y0f);
    const int x0 = static_cast<int>(x0f);
    const float fy = y - y0f;
    const float fx = x - x0f;
    const float wy0 = 1.f - fy, wx0 = 1.f - fx;
    if (y0 >= 0) {
      const float* r = map + static_cast<size_t>(y0) * w * CG;
      if (x0 >= 0) tap<CG>(acc, r + x0 * CG, m * wy0 * wx0);
      if (x0 + 1 < w) tap<CG>(acc, r + (x0 + 1) * CG, m * wy0 * fx);
    }
    if (y0 + 1 < h) {
      const float* r = map + static_cast<size_t>(y0 + 1) * w * CG;
      if (x0 >= 0) tap<CG>(acc, r + x0 * CG, m * fy * wx0);
      if (x0 + 1 < w) tap<CG>(acc, r + (x0 + 1) * CG, m * fy * fx);
    }
  }

  if constexpr (GCHW) {
    float* __restrict__ dst =
        out + static_cast<size_t>(ng) * CG * howo + o;
#pragma unroll
    for (int c = 0; c < CG; ++c) dst[static_cast<size_t>(c) * howo] = acc[c];
  } else if constexpr (CG % 4 == 0) {
    float* __restrict__ dst = out + static_cast<size_t>(col) * CG;
#pragma unroll
    for (int c = 0; c < CG; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else {
    float* __restrict__ dst = out + static_cast<size_t>(col) * CG;
#pragma unroll
    for (int c = 0; c < CG; ++c) dst[c] = acc[c];
  }
}

template <int CG>
cudaError_t launch(const float* feat, const float* py, const float* px,
                   const float* mask, float* out, int n, int howo, int groups,
                   int points, int h, int w, int gchw, cudaStream_t stream) {
  const int cols = n * groups * howo;
  const int blocks = (cols + kThreads - 1) / kThreads;
  if (gchw)
    dcnv3_sample_grouped_kernel<CG, true><<<blocks, kThreads, 0, stream>>>(
        feat, py, px, mask, out, cols, howo, points, h, w);
  else
    dcnv3_sample_grouped_kernel<CG, false><<<blocks, kThreads, 0, stream>>>(
        feat, py, px, mask, out, cols, howo, points, h, w);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `gchw` = 1 writes
// [N, G, Cg, HoWo], 0 writes [N, G, HoWo, Cg].  Launches on `stream` and
// does not synchronise; returns the cudaError_t of the launch.
extern "C" int dcnv3_sample_grouped_f32(const void* feat, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int n, int howo,
                                        int groups, int points, int h, int w,
                                        int cg, int gchw, void* stream) {
  const auto* f = static_cast<const float*>(feat);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * groups * howo == 0) return cudaSuccess;
  switch (cg) {
#define DCNV3_GROUPED_CASE(CG)                                               \
  case CG:                                                                   \
    return launch<CG>(f, y, x, m, o, n, howo, groups, points, h, w, gchw, s);
    DCNV3_GROUPED_CASE(1)
    DCNV3_GROUPED_CASE(2)
    DCNV3_GROUPED_CASE(4)
    DCNV3_GROUPED_CASE(8)
    DCNV3_GROUPED_CASE(16)
    DCNV3_GROUPED_CASE(32)
#undef DCNV3_GROUPED_CASE
    default:
      return cudaErrorInvalidValue;
  }
}
