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
// outside [0, H) x [0, W), NaN coordinates dropped, and f32 accumulation in
// registers, point by point and tap by tap in the order of
// dcnv3_sample.cu (K1), through the same dcnv3::sample_point.  Floor-based
// taps hold at exact integer coordinates too.
//
// Layouts: feat [N, G, H, W*Cg] (c fastest), so a group's map is one
// contiguous run of H*W*Cg floats; py/px/mask [N, G, P, HoWo], so
// neighbouring threads read neighbouring o and the coordinate loads
// coalesce; out [N, G, Cg, HoWo] ("gchw", where a warp's store of channel c
// coalesces) or [N, G, HoWo, Cg] ("ghwc", 16-byte stores when Cg % 4 == 0).
//
// Bound: memory.  Per call it must read 3 * N*G*P*HoWo*4 bytes of
// coordinates and mask, the feature map once (N*G*H*W*Cg*4 bytes) and
// write N*G*Cg*HoWo*4 bytes: the bytes of dcnv3_sample.cu, 7.75 MB (2.3 us
// at 3.35 TB/s) at the flagship serve shape (N=1, 32x44, G=32, Cg=8, P=9)
// and 33.8 MB (10.1 us) at the train shape (N=6, 32x32).  The arithmetic
// (about 4 taps * Cg * 2 flops a point) is far below the f32 rate.  What
// costs time is the gather: 36 taps of Cg channels an output column, a
// lone 32-byte sector each in device memory.
//
// Design (the host's ops/dcnv3_grouped.py:grouped_tile_plan picks the
// tile from the shapes):
//   - block (band, g, n) owns one (image, group) and a band of its output
//     pixels, one column a thread.  It stages the group's map (or, for a
//     map too large, the rows around its band, with halos; or nothing) in
//     shared memory with 16-byte cp.async, pixel-major, the pixel stride
//     padded to an odd number of 16-byte quads (dcnv3::tile_stride), so
//     that 8 lanes reading neighbouring pixels hit 8 bank quads.  Every tap
//     of a point whose two rows are staged is read from there, a point's
//     four taps issued together; taps of other rows read device memory;
//   - the bands are sized from the shapes: enough that one column a thread
//     fills a block of at most 512 threads, and, with fewer (image, group)
//     pairs than SMs (serve: 32), enough blocks that every SM works;
//   - a thread loads its column's P coordinates and masks into registers
//     before it waits for the map (kPoints at a time, unrolled, so the
//     loads are in flight together and behind the staging copy), and
//     samples from registers; no shared coordinate buffer, since the
//     layout already coalesces them;
//   - stores: channel planes for gchw, 16-byte vectors for ghwc.
// Measured at the flagship shapes on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit (PERF.md §6): with a whole map staged, 1, 2, 3, 4, 6, 8, 12
// and 16 bands took 0.0203, 0.0130, 0.0106, 0.0094, 0.0120, 0.0118,
// 0.0142 and 0.0193 ms at serve (the plan takes 4), and 0.0318, 0.0286,
// 0.0325, 0.0295, 0.0338, 0.0381, 0.0485 and 0.0562 ms at train (the plan
// takes 2; a band count that leaves some threads two columns costs a
// second pass).  The first version, a thread a column reading device
// memory, took 0.0118 and 0.0348 ms, and K1 0.0115 and 0.0320 on the same
// data; this one 0.0093 and 0.0285 (0.0139 and 0.0364 with a cold L2,
// K1 0.0158 and 0.0449).  What keeps it from its byte bound (a quarter at
// serve, a third at train) is the shared-memory reads of a warp's random
// taps, which conflict on banks, and at serve the latency of one block of
// 352 columns an SM.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dcnv3_tile.cuh"

namespace {

using namespace dcnv3;

// Threads a block at most (ops/dcnv3_grouped.py:_grouped_threads): 512,
// 256 at Cg = 32, whose accumulator and taps need more registers.
template <int CG>
constexpr int kThreads = CG >= 32 ? 256 : 512;

// Points whose coordinates a thread loads together: the flagship's 3x3.
constexpr int kPoints = 9;

template <int CG, bool GCHW>
__global__ void __launch_bounds__(kThreads<CG>)
dcnv3_sample_grouped_kernel(const float* __restrict__ feat,
                            const float* __restrict__ py,
                            const float* __restrict__ px,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int howo, int groups,
                            int points, int h, int w, int bands, int rows,
                            int halo) {
  constexpr int V = CG >= 4 ? 4 : CG;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const Tile t = block_tile(howo, h, 1, bands, rows, halo);
  const size_t ng = static_cast<size_t>(t.n) * groups + t.g0;
  const float* __restrict__ map = feat + ng * h * w * CG;
  const size_t coord = ng * points * howo;
  const int stride = tile_stride(1, CG);

  // stage rows [y_lo, y_hi) of the group's map: V floats a copy, into the
  // padded pixel stride
  {
    constexpr int per_pix = CG / V;
    const float* src = map + static_cast<size_t>(t.y_lo) * w * CG;
    const int vecs = (t.y_hi - t.y_lo) * w * per_pix;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x)
      __pipeline_memcpy_async(s + i / per_pix * stride + i % per_pix * V,
                              src + static_cast<size_t>(i) * V,
                              V * sizeof(float));
    __pipeline_commit();
  }

  float y[kPoints], x[kPoints], m[kPoints];
  auto load = [&](int o, int p0) {
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      if (p0 + k < points) {
        const size_t i = coord + static_cast<size_t>(p0 + k) * howo + o;
        y[k] = py[i];
        x[k] = px[i];
        m[k] = mask[i];
      }
    }
  };
  // the first column's coordinates fly while the map arrives
  int o = t.o_lo + threadIdx.x;
  if (o < t.o_hi) load(o, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (; o < t.o_hi; o += blockDim.x) {
    float acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0.f;
    for (int p0 = 0; p0 < points; p0 += kPoints) {
      if (p0) load(o, p0);
#pragma unroll
      for (int k = 0; k < kPoints; ++k)
        if (p0 + k < points)
          sample_point<CG>(acc, s, stride, t.y_lo, t.y_hi, map, CG, h, w,
                           y[k], x[k], m[k]);
    }
    if constexpr (GCHW) {
      float* __restrict__ dst = out + ng * CG * howo + o;
#pragma unroll
      for (int c = 0; c < CG; ++c) dst[static_cast<size_t>(c) * howo] = acc[c];
    } else {
      float* __restrict__ dst = out + (ng * howo + o) * CG;
#pragma unroll
      for (int c = 0; c < CG; c += V) {
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = acc[c + k];
        store_vec<V>(dst + c, v);
      }
    }
    if (o + static_cast<int>(blockDim.x) < t.o_hi) load(o + blockDim.x, 0);
  }
}

template <int CG>
cudaError_t launch(const float* feat, const float* py, const float* px,
                   const float* mask, float* out, int n, int howo, int groups,
                   int points, int h, int w, int bands, int rows, int halo,
                   int gchw, int device, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(tile_stride(1, CG)) * rows * w * sizeof(float);
  const int ob = (howo + bands - 1) / bands;
  const int threads = min(kThreads<CG>, (ob + 31) / 32 * 32);
  const dim3 grid(bands, groups, n);
  int sms = 0;
  cudaError_t err;
  if (gchw) {
    constexpr auto* kernel = &dcnv3_sample_grouped_kernel<CG, true>;
    err = device_facts<kernel>(device, &sms);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(feat, py, px, mask, out, howo,
                                            groups, points, h, w, bands,
                                            rows, halo);
  } else {
    constexpr auto* kernel = &dcnv3_sample_grouped_kernel<CG, false>;
    err = device_facts<kernel>(device, &sms);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(feat, py, px, mask, out, howo,
                                            groups, points, h, w, bands,
                                            rows, halo);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  `gchw` = 1 writes
// [N, G, Cg, HoWo], 0 writes [N, G, HoWo, Cg].  (bands, rows, halo) is the
// tile plan of ops/dcnv3_grouped.py:grouped_tile_plan.  Launches on
// `stream` of CUDA device `device`, the current one, and does not
// synchronise; returns the cudaError_t of the launch.
extern "C" int dcnv3_sample_grouped_f32(const void* feat, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int n, int howo,
                                        int groups, int points, int h, int w,
                                        int cg, int bands, int rows,
                                        int halo, int gchw, int device,
                                        void* stream) {
  const auto* f = static_cast<const float*>(feat);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * groups * howo == 0) return cudaSuccess;
  if (bands < 1 || rows < 0 || halo < 0) return cudaErrorInvalidValue;
  switch (cg) {
#define DCNV3_GROUPED_CASE(CG)                                               \
  case CG:                                                                   \
    return launch<CG>(f, y, x, m, o, n, howo, groups, points, h, w, bands,   \
                      rows, halo, gchw, device, s);
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
