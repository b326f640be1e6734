// DCNv3 deformable bilinear sampling, backward, for Hopper (sm_90a): K2.
//
// Replaces the TPU kernel dcnv3_sample_pallas_t5_bwd (wrapper at :773, body
// _sampling_kernel_t5_bwd at :639) in
// spike2former_tpu/ops/pallas/dcnv3_kernel.py.  It computes the gradient of
// the forward in dcnv3_sample.cu, not the TPU algorithm: the Pallas kernel
// builds one-hot row/column selectors and runs three batched matmuls plus a
// pltpu.repeat channel expansion because scalar gathers serialize on a TPU.
// For each (n, o, g) row and each of the P points, for each of the four
// floor-based taps inside the map, with s = <F_tap, dout[n, o, g]>:
//
//   dvalue[n, tap, g*Cg + c] += m * wy * wx * dout[c]
//   dmask += wy * wx * s
//   dpy   += m * (dwy/dpy) * wx * s,   dwy/dpy = -1 (row y0), +1 (row y0+1)
//   dpx   += m * wy * (dwx/dpx) * s,   likewise
//
// Taps off the map give 0 to every term, NaN coordinates are dropped.  The
// coordinate gradient stays floor-based at exact integer coordinates
// (F[y0+1] - F[y0]): zero offsets at init put every coordinate there, and
// the TPU kernel keeps the same convention (compare-based s0/s1 taps).
//
// Layouts as the forward: value and dvalue [N, H, W, G*Cg] channels-last;
// py/px/mask and dpy/dpx/dmask [N, HoWo, G, P]; dout [N, HoWo, G*Cg].
//
// Element types: value, dout and dvalue are f32 (dcnv3_sample_bwd_f32) or
// bf16 (dcnv3_sample_bwd_bf16); py/px/mask and their gradients are f32 in
// both, every sum is f32.  The bf16 form reads bf16 value and dout
// (converted to f32 while staging and loading), accumulates dvalue in an
// f32 buffer (`dacc`, which the wrapper allocates: there are no bf16
// atomics in the scatter, and bands overlap) and writes it to bf16 once, in
// a second pass over the map (dcnv3_tile.cuh:cast_bf16_kernel) on the same
// stream.  It does
// not copy the TPU kernel's rounding of its intermediates to bf16.  Its
// bound halves only the feature terms: 42.5 MB of coordinates and their
// gradients and 3 x 3.15 MB of value, dout and dvalue, 51.9 MB at the train
// shape, 15.5 us at 3.35 TB/s; the f32 buffer's write and read are traffic
// above the bound.
//
// Bound: memory.  Per call it must read the value map, 3 * N*HoWo*G*P*4
// bytes of coordinates and mask and the upstream gradient, and write dvalue
// and 3 * N*HoWo*G*P*4 bytes of coordinate and mask gradients: 61.3 MB at
// the flagship train shape (N=6, 32x32, G=32, Cg=8, P=9), 18.3 us at
// 3.35 TB/s.  The arithmetic (about 4 taps * 4 * Cg flops per point) is far
// below the f32 rate.  What costs time is the scatter into dvalue: 36 taps
// of Cg channels per row, 6*1024*32*9*4*8 = 56.6 M additions at that
// shape, which the first version issued as scalar atomics to device memory
// (0.645 ms on an NVIDIA H100, 35x the bound).
//
// Design (the host's tile_plan in ops/dcnv3.py picks the tile):
//   - a block takes one group of one image and a band of HoWo / 256 output
//     pixels, one item (output pixel, group) a thread.  It stages the
//     group's whole map (or, for a map too large, the rows around its band)
//     in shared memory with cp.async, pixel-major, and keeps beside it a
//     zeroed accumulator of kShared of the Cg channels, in channel planes
//     so that a warp's adds at neighbouring pixels hit neighbouring banks;
//   - for a tap whose rows are staged, <F, dout> is read from shared memory
//     (a point's four taps together, a column or row off the map clamped
//     with weight 0), channels [0, kShared) of m * wy * wx * dout are added
//     into the accumulator and the others straight into dvalue with one
//     16-byte vector atomic per 4 channels (red.global.add.v4.f32; float2 or
//     scalar for Cg 2 and 1); a tap outside the staged rows reads and adds
//     in device memory.  Nothing is added for a weight of 0 (three of the
//     four taps at an exact integer coordinate);
//   - at the end the block adds its accumulator into dvalue with vector
//     atomics (bands overlap, so the wrapper zero-fills dvalue), or, when
//     one block owns a group's whole map (one band: maps of 256 pixels or
//     fewer), stores it and needs no zero-fill;
//   - each warp copies its 32 items' coordinates into a shared buffer with
//     cp.async, consecutive lanes on consecutive floats of each item's P
//     floats, and writes dpy/dpx/dmask back the same way.
// Why the split: sm_90 has no shared-memory f32 add.  atomicAdd compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN), and a warp's random taps
// conflict on banks and collide on words.  Measured at the train shape on
// an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §6, the design
// steps), one group a block in four bands: all 8 channels in shared memory
// 0.245 ms, none (every add a vector atomic into L2) 0.183 ms, 4 of 8
// 0.156 ms, as both units then work at once.  One group a block: in eight
// bands two groups (a block's coordinate reads then waste half as many
// sector bytes) took 0.174 ms with no channel shared and 0.323 with 4,
// one group 0.186 and 0.200.  The atomics sum dvalue in an order that
// varies from run to run (f32 rounding only).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "dcnv3_tile.cuh"

namespace {

using namespace dcnv3;

// Threads a block (ops/dcnv3.py:_warps): 256, and 128 at Cg = 32, whose
// upstream gradient, taps and adds need more than the 128 registers a
// thread the compiler allows 256 threads
template <int CG>
constexpr int kThreads = CG >= 32 ? 128 : 256;

template <typename T, int CG>
__device__ __forceinline__ void sample_bwd(const T* __restrict__ value,
                        const float* __restrict__ py,
                        const float* __restrict__ px,
                        const float* __restrict__ mask,
                        const T* __restrict__ dout,
                        float* __restrict__ dvalue,
                        float* __restrict__ dpy,
                        float* __restrict__ dpx,
                        float* __restrict__ dmask, int howo, int groups,
                        int points, int h, int w, int gb, int bands, int rows,
                        int halo) {
  constexpr int V = CG >= 4 ? 4 : CG;
  constexpr int shared = kShared<CG>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Tile t = block_tile(howo, h, gb, bands, rows, halo);
  if (t.o_lo >= t.o_hi) return;
  const bool whole = bands == 1 && rows >= h;
  const int c_all = groups * CG;
  const int pix_stride = gb * CG;
  const int plane = rows * w;
  const int per_pix = gb * CG / V;  // vectors of a pixel's staged groups
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float* s_val = smem;                          // [pixel][pix_stride]
  float* s_acc = smem + plane * pix_stride;     // [gl*shared + c][pixel]
  float* buf = s_acc + gb * shared * plane + warp * 3 * 32 * points;
  const size_t img = static_cast<size_t>(t.n) * h * w * c_all;
  const size_t tile_off = img + static_cast<size_t>(t.y_lo) * w * c_all +
                          t.g0 * CG;
  const int staged = (t.y_hi - t.y_lo) * w * per_pix;  // vectors
  const int items = (t.o_hi - t.o_lo) * gb;

  // stage the value rows (cp.async, pixel-major as in device memory) and
  // the warp's first 32 items' coordinates in one wait; zero the
  // accumulator; a block that owns the whole map also zeroes the channels
  // it adds in device memory (no other block touches them)
  for (int i = threadIdx.x; i < staged; i += kThreads<CG>) {
    const int pix = i / per_pix;
    const int c0 = i % per_pix * V;  // gl*CG + channel
    stage_vec<V>(s_val + pix * pix_stride + c0,
                 value + tile_off + static_cast<size_t>(pix) * c_all + c0);
    const int gl = c0 / CG, c = c0 % CG;
    if (c < shared) {
#pragma unroll
      for (int k = 0; k < V; ++k)
        s_acc[(gl * shared + c + k) * plane + pix] = 0.f;
    } else if (whole) {
      const float zero[V] = {};
      store_vec<V>(dvalue + tile_off + static_cast<size_t>(pix) * c_all + c0,
                   zero);
    }
  }
  if (warp * 32 < items)
    fetch_coords(buf, py, px, mask, t, warp * 32,
                 min(32, items - warp * 32), gb, groups, points, howo, lane);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // each warp takes 32 items at a time: (o, gl), gl fastest
  for (int j0 = warp * 32; j0 < items; j0 += kThreads<CG>) {
    const int count = min(32, items - j0);
    if (j0 != warp * 32) {
      __syncwarp();
      fetch_coords(buf, py, px, mask, t, j0, count, gb, groups, points,
                   howo, lane);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
    }
    if (lane < count) {
      const int j = j0 + lane;
      const int gl = j % gb;
      const int g = t.g0 + gl;
      const size_t row =
          (static_cast<size_t>(t.n) * howo + t.o_lo + j / gb) * groups + g;
      const float* s = s_val + gl * CG;
      float* acc = s_acc + gl * shared * plane;
      const T* __restrict__ feat = value + img + g * CG;
      float* __restrict__ dfeat = dvalue + img + g * CG;
      float* mine = buf + lane * points;

      float d[CG];
#pragma unroll
      for (int c = 0; c < CG; c += V) {
        float v[V];
        load_vec<V>(v, dout + row * CG + c);
#pragma unroll
        for (int k = 0; k < V; ++k) d[c + k] = v[k];
      }

      for (int p = 0; p < points; ++p) {
        const float m = mine[64 * points + p];
        float gy = 0.f, gx = 0.f, gm = 0.f;
        sample_point_bwd<CG>(gy, gx, gm, s, pix_stride, acc, plane, t.y_lo,
                             t.y_hi, feat, dfeat, c_all, h, w, d, mine[p],
                             mine[32 * points + p], m);
        // the gradients take the slots of the coordinates just read
        mine[p] = m * gy;
        mine[32 * points + p] = m * gx;
        mine[64 * points + p] = gm;
      }
    }
    // the gradients go back by the walk that fetched the coordinates
    __syncwarp();
    const int stride = 32 * points;
    for_each_coord(t, j0, count, gb, groups, points, howo, lane,
                   [&](int e, size_t idx) {
                     dpy[idx] = buf[e];
                     dpx[idx] = buf[stride + e];
                     dmask[idx] = buf[2 * stride + e];
                   });
  }
  __syncthreads();

  // flush the accumulator's channels: a plain store when the block owns
  // the whole map, else vector atomics into the zeroed dvalue (all-zero
  // vectors, halo pixels no tap reached, are skipped)
  const int acc_vecs = (t.y_hi - t.y_lo) * w * gb * shared / V;
  for (int i = threadIdx.x; i < acc_vecs; i += kThreads<CG>) {
    const int per = gb * shared / V;
    const int pix = i / per;
    const int gl = i % per * V / shared;
    const int c = i % per * V % shared;
    float v[V];
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = s_acc[(gl * shared + c + k) * plane + pix];
      any |= v[k] != 0.f;
    }
    float* dst = dvalue + tile_off + static_cast<size_t>(pix) * c_all +
                 gl * CG + c;
    if (whole)
      store_vec<V>(dst, v);
    else if (any)
      add_vec<V>(dst, v);
  }
}

// The kernels.  Under the compiler's default register budget for 256
// threads Cg 2-16 build without spills (80 registers at Cg = 8, which
// leaves room for three blocks an SM at the train shape); Cg = 1 spills
// there and not when asked for two blocks an SM, and Cg = 32 keeps d, a
// tap and its adds (about 130 floats) live and may use 255 registers a
// thread (one block an SM).
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads<CG>)
dcnv3_sample_bwd_kernel(const T* __restrict__ value,
                        const float* __restrict__ py,
                        const float* __restrict__ px,
                        const float* __restrict__ mask,
                        const T* __restrict__ dout,
                        float* __restrict__ dvalue, float* __restrict__ dpy,
                        float* __restrict__ dpx, float* __restrict__ dmask,
                        int howo, int groups, int points, int h, int w,
                        int gb, int bands, int rows, int halo) {
  sample_bwd<T, CG>(value, py, px, mask, dout, dvalue, dpy, dpx, dmask,
                    howo, groups, points, h, w, gb, bands, rows, halo);
}

template <typename T, int CG, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads<CG>, MIN_BLOCKS)
dcnv3_sample_bwd_kernel_bounded(const T* __restrict__ value,
                                const float* __restrict__ py,
                                const float* __restrict__ px,
                                const float* __restrict__ mask,
                                const T* __restrict__ dout,
                                float* __restrict__ dvalue,
                                float* __restrict__ dpy,
                                float* __restrict__ dpx,
                                float* __restrict__ dmask, int howo,
                                int groups, int points, int h, int w, int gb,
                                int bands, int rows, int halo) {
  sample_bwd<T, CG>(value, py, px, mask, dout, dvalue, dpy, dpx, dmask,
                    howo, groups, points, h, w, gb, bands, rows, halo);
}

template <typename T, int CG>
cudaError_t launch(const T* value, const float* py, const float* px,
                   const float* mask, const T* dout, float* dvalue,
                   float* dpy, float* dpx, float* dmask, int n, int howo,
                   int groups, int points, int h, int w, int gb, int bands,
                   int rows, int halo, int device, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(gb) * (CG + kShared<CG>) * rows * w +
       kThreads<CG> / 32 * 3 * 32 * points) * sizeof(float);
  constexpr auto* kernel = [] {
    if constexpr (CG >= 32)
      return &dcnv3_sample_bwd_kernel_bounded<T, CG, 1>;
    else if constexpr (CG == 1)
      return &dcnv3_sample_bwd_kernel_bounded<T, CG, 2>;
    else
      return &dcnv3_sample_bwd_kernel<T, CG>;
  }();
  int sms = 0;
  const cudaError_t err = device_facts<kernel>(device, &sms);
  if (err != cudaSuccess) return err;
  const dim3 grid(bands, groups / gb, n);
  kernel<<<grid, kThreads<CG>, smem, stream>>>(
      value, py, px, mask, dout, dvalue, dpy, dpx, dmask, howo, groups,
      points, h, w, gb, bands, rows, halo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t entry(const void* value, const void* py, const void* px,
                  const void* mask, const void* dout, float* dv, void* dpy,
                  void* dpx, void* dmask, int n, int howo, int groups,
                  int points, int h, int w, int cg, int gb, int bands,
                  int rows, int halo, int device, cudaStream_t s) {
  const auto* v = static_cast<const T*>(value);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  const auto* d = static_cast<const T*>(dout);
  auto* dy = static_cast<float*>(dpy);
  auto* dx = static_cast<float*>(dpx);
  auto* dm = static_cast<float*>(dmask);
  if (gb < 1 || groups % gb || bands < 1 || rows < 0 || halo < 0)
    return cudaErrorInvalidValue;
  switch (cg) {
#define DCNV3_BWD_CASE(CG)                                                  \
  case CG:                                                                  \
    return launch<T, CG>(v, y, x, m, d, dv, dy, dx, dm, n, howo, groups,    \
                         points, h, w, gb, bands, rows, halo, device, s);
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

}  // namespace

// Plain C entry points, loaded with ctypes.  Launch on `stream` of CUDA
// device `device`, the current one, and do not synchronise; return the
// cudaError_t of the launch.  (gb, bands, rows, halo) is the tile plan of
// ops/dcnv3.py:tile_plan.  The f32 form adds into `dvalue`, which must hold
// zeros unless the plan is one band of every row (the whole map).
extern "C" int dcnv3_sample_bwd_f32(const void* value, const void* py,
                                    const void* px, const void* mask,
                                    const void* dout, void* dvalue,
                                    void* dpy, void* dpx, void* dmask, int n,
                                    int howo, int groups, int points, int h,
                                    int w, int cg, int gb, int bands,
                                    int rows, int halo, int device,
                                    void* stream) {
  if (n * howo * groups == 0) return cudaSuccess;
  return entry<float>(value, py, px, mask, dout, static_cast<float*>(dvalue),
                      dpy, dpx, dmask, n, howo, groups, points, h, w, cg, gb,
                      bands, rows, halo, device,
                      static_cast<cudaStream_t>(stream));
}

// The bf16 form: value, dout and dvalue bf16; `dacc` an f32 [N, H, W, G*Cg]
// buffer that the kernel accumulates into, under the same zero-fill rule as
// the f32 form's dvalue, and that a second launch rounds into dvalue.
extern "C" int dcnv3_sample_bwd_bf16(const void* value, const void* py,
                                     const void* px, const void* mask,
                                     const void* dout, void* dacc,
                                     void* dvalue, void* dpy, void* dpx,
                                     void* dmask, int n, int howo,
                                     int groups, int points, int h, int w,
                                     int cg, int gb, int bands, int rows,
                                     int halo, int device, void* stream) {
  if (n * howo * groups == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<float*>(dacc);
  cudaError_t err = entry<__nv_bfloat16>(
      value, py, px, mask, dout, acc, dpy, dpx, dmask, n, howo, groups,
      points, h, w, cg, gb, bands, rows, halo, device, s);
  if (err != cudaSuccess) return err;
  const size_t elems = static_cast<size_t>(n) * h * w * groups * cg;
  return launch_cast_bf16(acc, static_cast<__nv_bfloat16*>(dvalue), elems,
                          device, s);
}
