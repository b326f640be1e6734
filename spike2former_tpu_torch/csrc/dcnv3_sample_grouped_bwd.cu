// DCNv3 deformable bilinear sampling in the grouped layout, backward, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dcnv3_sample_pallas_t_bwd (body
// _sampling_kernel_t_bwd) in spike2former_tpu/ops/pallas/dcnv3_kernel.py,
// the backward of the forward in dcnv3_sample_grouped.cu.  It computes the
// gradient, not the TPU algorithm: the Pallas kernel builds one-hot
// selectors, runs five matmuls per point and carries dfeat from one output
// tile to the next in its sequential grid.  For each (n, g, o) column and
// each of the P points, for each of the four floor-based taps inside the
// map, with s = <F_tap, dout[n, g, :, o]>:
//
//   dfeat[n, g, tap, c] += m * wy * wx * dout[c]
//   dmask += wy * wx * s
//   dpy   += m * (dwy/dpy) * wx * s,   dwy/dpy = -1 (row y0), +1 (row y0+1)
//   dpx   += m * wy * (dwx/dpx) * s,   likewise
//
// Taps off the map give 0 to every term, NaN coordinates are dropped.  The
// coordinate gradient stays floor-based at exact integer coordinates
// (F[y0+1] - F[y0]), as the TPU kernel's compare-based s0/s1, t0/t1
// selectors keep it.  The point's arithmetic is dcnv3::sample_point_bwd,
// K2's (dcnv3_sample_bwd.cu).
//
// Layouts: feat and dfeat [N, G, H, W*Cg] (c fastest), so a group's map is
// one contiguous run of H*W*Cg floats; py/px/mask and dpy/dpx/dmask
// [N, G, P, HoWo]; dout [N, G, Cg, HoWo].  Neighbouring threads read and
// write neighbouring o of every [.., HoWo] tensor, so those accesses
// coalesce with no staging.
//
// Bound: memory.  Per call it must read the feature map, 3 * N*G*P*HoWo*4
// bytes of coordinates and mask and the upstream gradient, and write dfeat
// and 3 * N*G*P*HoWo*4 bytes of coordinate and mask gradients: the bytes of
// dcnv3_sample_bwd.cu, 61.3 MB (18.3 us at 3.35 TB/s) at the flagship train
// shape (N=6, 32x32, G=32, Cg=8, P=9).  What costs time is the scatter into
// dfeat: 6*32*1024*9*4*8 = 56.6 M additions at that shape, which the first
// version issued as scalar atomics to device memory (0.600 ms on an NVIDIA
// H100, 33x the bound), as K2's first version did.
//
// Design, K2's in this layout (the host's
// ops/dcnv3_grouped.py:grouped_tile_plan picks the tile from the shapes):
//   - block (band, g, n) owns one (image, group) and a band of HoWo / 256
//     output pixels, one column a thread.  It stages the group's map (or,
//     for a map too large, the rows around its band, with halos; or
//     nothing) in shared memory with 16-byte cp.async, pixel-major as in
//     device memory, and keeps beside it a zeroed accumulator of the first
//     kShared (4) of the Cg channels, in channel planes so that a warp's
//     adds at neighbouring pixels hit neighbouring banks;
//   - for a tap whose rows are staged, <F, dout> is read from shared memory
//     (a point's four taps together), channels [0, kShared) of
//     m * wy * wx * dout are added into the accumulator and the others
//     straight into dfeat with one 16-byte vector atomic per 4 channels
//     (red.global.add.v4.f32; .v2 or scalar for Cg 2 and 1); a tap outside
//     the staged rows reads and adds in device memory.  Nothing is added
//     for a weight of 0 (three of the four taps at an exact integer
//     coordinate);
//   - at the end the block adds its accumulator into dfeat with vector
//     atomics (bands overlap, so the wrapper zero-fills dfeat), or, when
//     one block owns the group's whole map (one band), stores it, and
//     zeroes the other channels itself before any tap adds into them: the
//     wrapper then skips the zero-fill;
//   - a thread loads its column's upstream gradient and its P coordinates
//     and masks into registers before it waits for the map (kPoints at a
//     time, unrolled, so the loads are in flight together), and writes
//     dpy, dpx and dmask straight back, coalesced.
// Measured at the flagship shapes on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit (PERF.md §6): bands of 256 columns (6 at serve, 4 at train)
// took 0.0517 and 0.1461 ms; at train one band took 0.184 ms, and 3, 6 or
// 12 bands, which leave some threads two columns, 0.20-0.23 ms.  The
// first version took 0.600 ms at train, K2 0.155 on the same data, this
// one 0.146 (0.95x K2).  What is left is K2's: the compare-and-swap loop
// of the shared adds and the L2 vector atomics, at 12% of the byte
// bound.  The atomics sum dfeat in an order that varies from run to run
// (f32 rounding only).
//
// Element types: feat, dout and dfeat are f32 (dcnv3_sample_grouped_bwd_f32)
// or bf16 (dcnv3_sample_grouped_bwd_bf16, K7's bf16 form); py/px/mask and
// their gradients are f32 in both.  The bf16 form stages feat as f32,
// loads dout as f32, adds dfeat into an f32 buffer (`dacc`, under the f32
// form's zero-fill rule; there are no bf16 atomics) and rounds it into
// dfeat once, in a second pass on the same stream
// (dcnv3_tile.cuh:cast_bf16_kernel), as the TPU kernel sums dfeat in f32
// and casts it once (dcnv3_kernel.py:1019).  Its one other rounding is
// the TPU kernel's row weight, cast to bf16 before the product that feeds
// the column gradient (:913): dpx sums sx * bf16(m * wy) * <F, dout>
// (dcnv3_tile.cuh:sample_point_bwd's ROUND_ROWS); dpy and dmask use the
// f32 weights, as the TPU kernel's do.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "dcnv3_tile.cuh"

namespace {

using namespace dcnv3;

// Threads a block at most (ops/dcnv3_grouped.py:_grouped_threads): 256,
// 128 at Cg = 32, whose upstream gradient, taps and adds need more
// registers.
template <int CG>
constexpr int kThreads = CG >= 32 ? 128 : 256;

// Points whose coordinates a thread loads together: the flagship's 3x3.
constexpr int kPoints = 9;

template <typename T, int CG>
__global__ void __launch_bounds__(kThreads<CG>)
dcnv3_sample_grouped_bwd_kernel(const T* __restrict__ feat,
                                const float* __restrict__ py,
                                const float* __restrict__ px,
                                const float* __restrict__ mask,
                                const T* __restrict__ dout,
                                float* __restrict__ dfeat,
                                float* __restrict__ dpy,
                                float* __restrict__ dpx,
                                float* __restrict__ dmask, int howo,
                                int groups, int points, int h, int w,
                                int bands, int rows, int halo) {
  constexpr int V = CG >= 4 ? 4 : CG;
  constexpr int shared = kShared<CG>;
  constexpr int per_pix = CG / V;  // vectors a pixel
  constexpr bool kBf16 = !std::is_same_v<T, float>;
  extern __shared__ float4 smem4[];
  float* s_val = reinterpret_cast<float*>(smem4);  // [pixel][CG]
  const Tile t = block_tile(howo, h, 1, bands, rows, halo);
  const bool whole = bands == 1 && rows >= h;
  const int plane = rows * w;
  float* s_acc = s_val + plane * CG;  // [c][pixel], c < shared
  const size_t ng = static_cast<size_t>(t.n) * groups + t.g0;
  const T* __restrict__ map = feat + ng * h * w * CG;
  float* __restrict__ dmap = dfeat + ng * h * w * CG;
  const size_t tile_off = static_cast<size_t>(t.y_lo) * w * CG;
  const size_t coord = ng * points * howo;
  const T* __restrict__ dsrc = dout + ng * CG * howo;

  // stage the map rows (pixel-major as in device memory, as f32) and zero
  // the accumulator; a block that owns the whole map also zeroes the channels
  // it adds in device memory (no other block touches them)
  const int staged = (t.y_hi - t.y_lo) * w * per_pix;  // vectors
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const int pix = i / per_pix;
    const int c = i % per_pix * V;
    stage_vec<V>(s_val + static_cast<size_t>(i) * V,
                 map + tile_off + static_cast<size_t>(i) * V);
    if (c < shared) {
#pragma unroll
      for (int k = 0; k < V; ++k) s_acc[(c + k) * plane + pix] = 0.f;
    } else if (whole) {
      const float zero[V] = {};
      store_vec<V>(dmap + tile_off + static_cast<size_t>(i) * V, zero);
    }
  }
  __pipeline_commit();

  float y[kPoints], x[kPoints], m[kPoints], d[CG];
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
    if (p0 == 0) {
#pragma unroll
      for (int c = 0; c < CG; ++c)
        d[c] = to_f32(dsrc[static_cast<size_t>(c) * howo + o]);
    }
  };
  // the first column's upstream gradient and coordinates fly while the map
  // arrives
  int o = t.o_lo + threadIdx.x;
  if (o < t.o_hi) load(o, 0);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (; o < t.o_hi; o += blockDim.x) {
    for (int p0 = 0; p0 < points; p0 += kPoints) {
      if (p0) load(o, p0);
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        if (p0 + k >= points) continue;
        float gy = 0.f, gx = 0.f, gm = 0.f;
        sample_point_bwd<CG, kBf16>(gy, gx, gm, s_val, CG, s_acc, plane,
                                    t.y_lo, t.y_hi, map, dmap, CG, h, w, d,
                                    y[k], x[k], m[k]);
        const size_t i = coord + static_cast<size_t>(p0 + k) * howo + o;
        dpy[i] = m[k] * gy;
        dpx[i] = kBf16 ? gx : m[k] * gx;
        dmask[i] = gm;
      }
    }
    if (o + static_cast<int>(blockDim.x) < t.o_hi) load(o + blockDim.x, 0);
  }
  __syncthreads();

  // flush the accumulator's channels: a plain store when the block owns
  // the whole map, else vector atomics into the zeroed dfeat (all-zero
  // vectors, halo pixels no tap reached, are skipped)
  constexpr int acc_per_pix = shared / V;
  const int acc_vecs = (t.y_hi - t.y_lo) * w * acc_per_pix;
  for (int i = threadIdx.x; i < acc_vecs; i += blockDim.x) {
    const int pix = i / acc_per_pix;
    const int c = i % acc_per_pix * V;
    float v[V];
    bool any = false;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = s_acc[(c + k) * plane + pix];
      any |= v[k] != 0.f;
    }
    float* dst = dmap + tile_off + static_cast<size_t>(pix) * CG + c;
    if (whole)
      store_vec<V>(dst, v);
    else if (any)
      add_vec<V>(dst, v);
  }
}

template <typename T, int CG>
cudaError_t launch(const T* feat, const float* py, const float* px,
                   const float* mask, const T* dout, float* dfeat,
                   float* dpy, float* dpx, float* dmask, int n, int howo,
                   int groups, int points, int h, int w, int bands, int rows,
                   int halo, int device, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(CG + kShared<CG>) * rows * w *
                      sizeof(float);
  const int ob = (howo + bands - 1) / bands;
  const int threads = min(kThreads<CG>, (ob + 31) / 32 * 32);
  constexpr auto* kernel = &dcnv3_sample_grouped_bwd_kernel<T, CG>;
  int sms = 0;
  const cudaError_t err = device_facts<kernel>(device, &sms);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bands, groups, n), threads, smem, stream>>>(
      feat, py, px, mask, dout, dfeat, dpy, dpx, dmask, howo, groups, points,
      h, w, bands, rows, halo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t entry(const void* feat, const void* py, const void* px,
                  const void* mask, const void* dout, float* dfeat,
                  void* dpy, void* dpx, void* dmask, int n, int howo,
                  int groups, int points, int h, int w, int cg, int bands,
                  int rows, int halo, int device, cudaStream_t s) {
  const auto* f = static_cast<const T*>(feat);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  const auto* d = static_cast<const T*>(dout);
  auto* dy = static_cast<float*>(dpy);
  auto* dx = static_cast<float*>(dpx);
  auto* dm = static_cast<float*>(dmask);
  if (bands < 1 || rows < 0 || halo < 0) return cudaErrorInvalidValue;
  switch (cg) {
#define DCNV3_GROUPED_BWD_CASE(CG)                                           \
  case CG:                                                                   \
    return launch<T, CG>(f, y, x, m, d, dfeat, dy, dx, dm, n, howo, groups,  \
                         points, h, w, bands, rows, halo, device, s);
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

}  // namespace

// Plain C entry points, loaded with ctypes.  (bands, rows, halo) is the
// tile plan of ops/dcnv3_grouped.py:grouped_tile_plan.  Launch on `stream`
// of CUDA device `device`, the current one, and do not synchronise; return
// the cudaError_t of the launch.  The f32 form adds into `dfeat`, which
// must hold zeros unless the plan is one band of every row (the whole map).
extern "C" int dcnv3_sample_grouped_bwd_f32(
    const void* feat, const void* py, const void* px, const void* mask,
    const void* dout, void* dfeat, void* dpy, void* dpx, void* dmask, int n,
    int howo, int groups, int points, int h, int w, int cg, int bands,
    int rows, int halo, int device, void* stream) {
  if (n * groups * howo == 0) return cudaSuccess;
  return entry<float>(feat, py, px, mask, dout, static_cast<float*>(dfeat),
                      dpy, dpx, dmask, n, howo, groups, points, h, w, cg,
                      bands, rows, halo, device,
                      static_cast<cudaStream_t>(stream));
}

// The bf16 form: feat, dout and dfeat bf16; `dacc` an f32 [N, G, H, W*Cg]
// buffer that the kernel adds into, under the f32 form's zero-fill rule
// for its dfeat, and that a second launch rounds into dfeat.
extern "C" int dcnv3_sample_grouped_bwd_bf16(
    const void* feat, const void* py, const void* px, const void* mask,
    const void* dout, void* dacc, void* dfeat, void* dpy, void* dpx,
    void* dmask, int n, int howo, int groups, int points, int h, int w,
    int cg, int bands, int rows, int halo, int device, void* stream) {
  if (n * groups * howo == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto* acc = static_cast<float*>(dacc);
  const cudaError_t err = entry<__nv_bfloat16>(
      feat, py, px, mask, dout, acc, dpy, dpx, dmask, n, howo, groups,
      points, h, w, cg, bands, rows, halo, device, s);
  if (err != cudaSuccess) return err;
  return launch_cast_bf16(acc, static_cast<__nv_bfloat16*>(dfeat),
                          static_cast<size_t>(n) * groups * h * w * cg,
                          device, s);
}
