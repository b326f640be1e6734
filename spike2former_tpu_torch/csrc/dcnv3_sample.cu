// DCNv3 deformable bilinear sampling, forward, for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel dcnv3_sample_pallas_t5 (wrapper at :440, body
// _sampling_kernel_t5 at :362) in spike2former_tpu/ops/pallas/dcnv3_kernel.py.
// It computes the function, not the TPU algorithm: the one-hot selector
// matmuls and the pltpu.repeat channel expansion exist only because scalar
// gathers serialize on a TPU.
//
//   out[n, o, g*Cg + c] = sum_p m * bilinear(value[n, :, :, g*Cg + c]; py, px)
//
// with floor-based taps (y0 = floor(py), y0 + 1; likewise x), zero padding
// outside [0, H) x [0, W), NaN coordinates dropped, and f32 accumulation in
// registers, p by p and tap by tap in the order of the grouped forward
// (dcnv3_sample_grouped.cu), so the two give the same values.  Floor-based
// taps are kept even when a coordinate is an exact integer: zero offsets put
// every tap there, and the backward kernel relies on the same convention.
//
// Layouts: value [N, H, W, G*Cg] channels-last; py/px/mask [N, HoWo, G, P];
// out [N, HoWo, G*Cg].
//
// Element types: value and out are both f32 (dcnv3_sample_f32) or both
// bf16 (dcnv3_sample_bf16, the bf16 model's form of the same TPU kernel,
// which takes bf16 features and f32 coordinates and mask as the JAX package
// hands them).  Coordinates, mask, bilinear weights and the accumulation are
// f32 in both; the bf16 form converts the value tile to f32 while staging
// it (dcnv3_tile.cuh) and rounds once, to bf16, at the store of out.  It
// does not copy the TPU kernel's rounding of its selector rows to bf16.
// Its bound halves only the feature terms: 0.72 MB in and 0.72 MB out of
// 6.31 MB at the serve shape (1.88 us at 3.35 TB/s), 3.15 + 3.15 of
// 27.5 MB at the train shape (8.21 us); the f32 coordinates dominate.
//
// Bound: memory.  Per call it must read the value map once
// (N*H*W*G*Cg*4 bytes), 3 * N*HoWo*G*P*4 bytes of coordinates and mask, and
// write N*HoWo*G*Cg*4 bytes: 33.8 MB at the flagship train shape (N=6,
// 32x32, G=32, Cg=8, P=9), 10.1 us at 3.35 TB/s; 7.75 MB (2.3 us) at the
// serve shape (N=1, 32x44).  The arithmetic (about 4 taps * Cg * 2 flops a
// point) is far below the f32 rate.  What costs time is the gather: each
// output pixel reads 36 taps of Cg channels, in this layout a lone 32-byte
// sector each, the next pixel's 1 KB away, so a warp's taps miss L1; and a
// thread per (o, g) reads its 9 coordinates at a 1152-byte stride.
//
// Design (the host's tile_plan in ops/dcnv3.py picks the tile):
//   - a block stages its groups' whole map (or, for a map too large, the
//     rows around a band of output pixels) in shared memory with cp.async,
//     pixel-major as in device memory, the pixel stride padded to an odd
//     number of 16-byte quads so that 8 lanes reading 8 neighbouring pixels
//     hit 8 different bank quads.  Every tap of a point whose two rows are
//     staged is read from there, four taps' loads issued together; a column
//     or row off the map reads its clamped neighbour with weight 0.  Taps of
//     rows outside a band's staged rows read device memory;
//   - each warp takes 32 items (output pixel, group) at a time and copies
//     their coordinates into a buffer with cp.async, consecutive lanes on
//     consecutive floats of each item's P-float run (lane i then reads its
//     own P floats at an odd stride: no bank conflicts); a block's first
//     chunk arrives with its tile, in one wait;
//   - with as many (image, group) pairs as SMs or more (train: 192), one
//     wave of resident blocks walks the items in order, two groups a
//     block, and stages a pair's maps once when its range enters it; with
//     fewer (serve: 32), one block an SM takes a band of one group's
//     output pixels (4 bands at serve), each staging the whole map;
//   - outputs go out as 16-byte stores (Cg % 4 == 0).
// The plans were chosen by measurement at the flagship shapes, on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit (PERF.md §6, the design steps): at
// serve one group a block in 4 bands took 0.01165 ms against 0.01451 for
// resident blocks; at train two groups a block in resident blocks took
// 0.03262 ms against 0.03471 for one group.  What keeps K1 from its byte
// bound is the shared-memory data path: a warp's random taps conflict on
// banks.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dcnv3_tile.cuh"

namespace {

using namespace dcnv3;

// Threads a block (ops/dcnv3.py:_warps): 512, and 256 at Cg = 32, whose
// accumulator and taps need more than the 128 registers a thread that
// 512 threads leave.  One block an SM (__launch_bounds__(.., 1)): the
// tile and the coordinate buffers fill the shared memory at the flagship
// shapes anyway, so the compiler may use those registers.
template <int CG>
constexpr int kThreads = CG >= 32 ? 256 : 512;

// Copy value rows [y_lo, y_hi) of groups [g0, g0 + gb) of image n into
// shared memory, pixel-major (s[pixel*pix_stride + gl*CG + c]), as f32:
// with cp.async for f32 (the copies fly without registers; the caller
// commits and waits), by converting loads for bf16.
template <int CG, typename T>
__device__ __forceinline__ void stage(float* s, const T* __restrict__ value,
                                      const Tile& t, int gb, int h, int w,
                                      int c_all, int pix_stride) {
  constexpr int V = CG >= 4 ? 4 : CG;
  const int per_pix = gb * CG / V;  // vectors of a pixel's staged groups
  const int items = (t.y_hi - t.y_lo) * w * per_pix;
  const T* src = value + (static_cast<size_t>(t.n) * h + t.y_lo) * w *
                             c_all + t.g0 * CG;
  for (int i = threadIdx.x; i < items; i += kThreads<CG>)
    stage_vec<V>(
        s + i / per_pix * pix_stride + i % per_pix * V,
        src + static_cast<size_t>(i / per_pix) * c_all + i % per_pix * V);
}

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads<CG>, 1)
dcnv3_sample_kernel(const T* __restrict__ value,
                    const float* __restrict__ py,
                    const float* __restrict__ px,
                    const float* __restrict__ mask,
                    T* __restrict__ out, int n_img, int howo, int groups,
                    int points, int h, int w, int gb, int bands, int rows,
                    int halo) {
  constexpr int V = CG >= 4 ? 4 : CG;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c_all = groups * CG;
  const int pix_stride = tile_stride(gb, CG);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* buf = smem + rows * w * pix_stride + warp * 3 * 32 * points;
  // A unit is one image and gb groups: howo*gb items (o, gl), gl fastest.
  // bands == 0 (whole maps staged): a 1-D grid of resident blocks, each
  // walking an equal range of the units' items in order and staging a
  // unit's maps when its range enters it.  Otherwise block (band, chunk,
  // image) takes one band of one unit, with the map rows around it (all
  // of them when rows >= h).
  const int per_unit = howo * gb;
  const int chunks = groups / gb;
  int lo, hi;
  Tile t;
  if (bands == 0) {
    const int total = n_img * chunks * per_unit;
    const int per = (total + gridDim.x - 1) / gridDim.x;
    lo = blockIdx.x * per;
    hi = min(total, lo + per);
    t.y_lo = 0;
    t.y_hi = h;
  } else {
    t = block_tile(howo, h, gb, bands, rows, halo);
    const int unit = t.n * chunks + t.g0 / gb;
    lo = unit * per_unit + t.o_lo * gb;
    hi = unit * per_unit + t.o_hi * gb;
  }
  t.o_lo = 0;

  int staged = -1;  // the unit whose maps are in shared memory
  for (int i = lo; i < hi;) {
    const int unit = i / per_unit;
    const int a = i - unit * per_unit;
    const int b = min(hi - unit * per_unit, per_unit);
    i += b - a;
    t.n = unit / chunks;
    t.g0 = unit % chunks * gb;
    const T* __restrict__ img =
        value + static_cast<size_t>(t.n) * h * w * c_all;
    // each warp takes 32 items at a time
    for (int j0 = a + warp * 32, k = 0; j0 < b || (k == 0 && unit != staged);
         j0 += kThreads<CG>, ++k) {
      const int count = max(0, min(32, b - j0));
      if (k == 0 && unit != staged) {
        // the unit's maps and each warp's first 32 items in one wait
        __syncthreads();  // every warp is done with the last unit's maps
        stage<CG>(smem, value, t, gb, h, w, c_all, pix_stride);
        if (count)
          fetch_coords(buf, py, px, mask, t, j0, count, gb, groups, points,
                       howo, lane);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        staged = unit;
      } else {
        __syncwarp();
        fetch_coords(buf, py, px, mask, t, j0, count, gb, groups, points,
                     howo, lane);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncwarp();
      }
      if (lane >= count) continue;
      const int j = j0 + lane;
      const int gl = j % gb;
      const int g = t.g0 + gl;
      const size_t row =
          (static_cast<size_t>(t.n) * howo + j / gb) * groups + g;
      const float* s = smem + gl * CG;
      const T* __restrict__ feat = img + g * CG;
      const float* mine = buf + lane * points;

      float acc[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] = 0.f;

      for (int p = 0; p < points; ++p)
        sample_point<CG>(acc, s, pix_stride, t.y_lo, t.y_hi, feat, c_all, h,
                         w, mine[p], mine[32 * points + p],
                         mine[64 * points + p]);

      T* __restrict__ dst = out + row * CG;
#pragma unroll
      for (int c = 0; c < CG; c += V) {
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = acc[c + k];
        store_vec<V>(dst + c, v);  // bf16: the one rounding
      }
    }
  }
}

template <typename T, int CG>
cudaError_t launch(const T* value, const float* py, const float* px,
                   const float* mask, T* out, int n, int howo, int groups,
                   int points, int h, int w, int gb, int bands, int rows,
                   int halo, int device, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(tile_stride(gb, CG)) * rows * w +
                       kThreads<CG> / 32 * 3 * 32 * points) * sizeof(float);
  int sms = 0, per_sm = 0;
  const cudaError_t err = device_facts<&dcnv3_sample_kernel<T, CG>>(
      device, &sms, bands == 0 ? &per_sm : nullptr, kThreads<CG>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bands, groups / gb, n);
  if (bands == 0)  // one wave of resident blocks, no more than 32-item chunks
    grid = dim3(min((n * howo * groups + 31) / 32, max(1, per_sm) * sms));
  dcnv3_sample_kernel<T, CG><<<grid, kThreads<CG>, smem, stream>>>(
      value, py, px, mask, out, n, howo, groups, points, h, w, gb, bands,
      rows, halo);
  return cudaGetLastError();
}

template <typename T>
int entry(const void* value, const void* py, const void* px, const void* mask,
          void* out, int n, int howo, int groups, int points, int h, int w,
          int cg, int gb, int bands, int rows, int halo, int device,
          void* stream) {
  const auto* v = static_cast<const T*>(value);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * howo * groups == 0) return cudaSuccess;
  if (gb < 1 || groups % gb || bands < 0 || rows < 0 || halo < 0 ||
      (bands == 0 && rows < h))
    return cudaErrorInvalidValue;
  switch (cg) {
#define DCNV3_CASE(CG)                                                      \
  case CG:                                                                  \
    return launch<T, CG>(v, y, x, m, o, n, howo, groups, points, h, w, gb,  \
                         bands, rows, halo, device, s);
    DCNV3_CASE(1)
    DCNV3_CASE(2)
    DCNV3_CASE(4)
    DCNV3_CASE(8)
    DCNV3_CASE(16)
    DCNV3_CASE(32)
#undef DCNV3_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes: value and out f32 or bf16,
// py/px/mask f32.  Launch on `stream` of CUDA device `device`, the current
// one, and do not synchronise; return the cudaError_t of the launch.
// (gb, bands, rows, halo) is the tile plan of ops/dcnv3.py:tile_plan.
extern "C" int dcnv3_sample_f32(const void* value, const void* py,
                                const void* px, const void* mask, void* out,
                                int n, int howo, int groups, int points,
                                int h, int w, int cg, int gb, int bands,
                                int rows, int halo, int device,
                                void* stream) {
  return entry<float>(value, py, px, mask, out, n, howo, groups, points, h,
                      w, cg, gb, bands, rows, halo, device, stream);
}

extern "C" int dcnv3_sample_bf16(const void* value, const void* py,
                                 const void* px, const void* mask, void* out,
                                 int n, int howo, int groups, int points,
                                 int h, int w, int cg, int gb, int bands,
                                 int rows, int halo, int device,
                                 void* stream) {
  return entry<__nv_bfloat16>(value, py, px, mask, out, n, howo, groups,
                              points, h, w, cg, gb, bands, rows, halo,
                              device, stream);
}
