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
//
// Element types: feat and out are both f32 (dcnv3_sample_grouped_f32) or
// both bf16 (dcnv3_sample_grouped_bf16, the TPU kernels' bf16 forms, which
// take bf16 features and f32 coordinates and mask).  The bf16 forms round
// where the TPU kernels round, since each rounding there changes the
// function:
//   - the row weight m * (1 - fy), m * fy, taken in f32, to bf16 (the row
//     selector cast to feat.dtype before its matmul, dcnv3_kernel.py:53,
//     :101, :283, :537);
//   - with `round_cols` (K3, K6), the column weight 1 - fx, fx to bf16 (the
//     column selector cast to expand_ref's dtype, :109, :546); K4 and K5
//     keep it f32;
//   - the per-column sum T[v, c] = sum over the points reaching map column
//     v, in point order, of (F[y0, v, c] r0 + F[y0+1, v, c] r1) * cw, to
//     bf16 (t_acc cast before the channel select, :66, :115, :297, :554),
//     then the sum over v in f32 and one rounding to bf16 at the store.
// Products and sums are taken with __fmul_rn / __fadd_rn, as XLA takes
// them, unfused.  Only the f32 sum over v runs in another order than the
// TPU kernel's channel-select matmul, so the result is within one bf16 ulp
// of it.
//
// What bounds the bf16 forms is not the bytes either but the work of
// finding, for one output column, which map columns its 2P taps reach and
// in which point order, since each column's sum is rounded on its own.
// Walking the points and, for each tap column, rescanning the other points
// (the first form) costs 150-250 coordinate loads a column at P = 9,
// starts them only after the map has arrived, and serialises a lane's taps
// behind data-dependent branches: 6x the f32 form's time (PERF.md §6).
// The design:
//   - the map is staged as bf16, as it lies in device memory, by 16-byte
//     cp.async (the pixel stride padded to an odd number of 16-byte quads
//     from Cg = 16, tile_stride_bf16): half the f32 tile's bytes, a tap of
//     8 channels one 16-byte shared load, and the copy in flight while the
//     thread loads its column's P coordinates and masks (kPoints, unrolled)
//     into registers;
//   - each point's terms are taken once: its floor row y0, its two row
//     weights rounded to bf16 (one word) and fx go to a point table in
//     shared memory, [field][point][thread] with the thread fastest, so a
//     warp reading 32 different points hits 32 banks; each of its two tap
//     slots (q, dx) on the map gets the key v << 5 | 2q + dx (v its map
//     column), and a slot off the map, or of a point with a NaN
//     coordinate, the key kNoSlot, which sorts last;
//   - the 2P keys are sorted in registers by a fixed network (Batcher's
//     odd-even merge sort for 32 keys, pruned to 18: 90 compare-exchanges),
//     which puts each map column's slots together in point order;
//   - one walk over the sorted slots reads each slot's two taps once (4P
//     tap reads a column, as the f32 form) and its terms from the table,
//     adds its contribution into the column sum, and at the last slot of a
//     column rounds that sum to bf16 and adds it into the output column;
//   - blocks of 256 threads, two an SM at Cg = 8 (__launch_bounds__: no
//     spill; at three an SM, 80 registers a thread, it spills the index
//     of a later column's coordinates), and, with fewer (image, group)
//     pairs than SMs, bands for two blocks an SM (the host's plan;
//     profile_grouped.py sweeps the band counts).  At the flagship's
//     shapes a thread has one column.
// Measured at the flagship shapes on an NVIDIA H100 80GB HBM3 at a 700 W
// power limit (chip_smoke.py (grouped bf16), PERF.md §6): 0.0115-0.0118 ms
// at serve and 0.0343-0.0350 ms at train, 1.24-1.29x the f32 form on the
// same data and a sixth and a quarter of the byte bound (the first form:
// 0.0553-0.0564 and 0.1435-0.1457 ms).
// A layout with more than kPoints points (or a map wider than 2^26, whose
// column would not fit a key) takes the first form's walk, rereading the
// coordinates for each tap column: correct for any P.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "dcnv3_tile.cuh"

namespace {

using namespace dcnv3;
using bf16 = __nv_bfloat16;

// Threads a block at most (ops/dcnv3_grouped.py:_grouped_threads).  The
// f32 form: 512, 256 at Cg = 32, whose accumulator and taps need more
// registers.  The bf16 forms: 256, so that kMinBlocks blocks share an SM.
template <typename T, int CG>
constexpr int kThreads =
    std::is_same_v<T, float> ? (CG >= 32 ? 256 : 512) : 256;

// Blocks of the bf16 forms an SM holds (__launch_bounds__): three up to
// Cg = 4 (at most 80 registers a thread), two at Cg = 8 and 16, one at
// Cg = 32; at three blocks an SM, Cg = 8 would spill.
template <int CG>
constexpr int kMinBlocks = CG >= 32 ? 1 : CG >= 8 ? 2 : 3;

// Points whose coordinates a thread loads together: the flagship's 3x3.
constexpr int kPoints = 9;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Column o of the output from its f32 sum: a channel plane each for gchw,
// vectors for ghwc; bf16 rounds here, the sum's one rounding.
template <int CG, bool GCHW, typename T>
__device__ __forceinline__ void store_column(T* __restrict__ out, size_t ng,
                                             int howo, int o,
                                             const float (&acc)[CG]) {
  constexpr int V = CG >= 4 ? 4 : CG;
  if constexpr (GCHW) {
    T* __restrict__ dst = out + ng * CG * howo + o;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      if constexpr (std::is_same_v<T, float>)
        dst[static_cast<size_t>(c) * howo] = acc[c];
      else
        dst[static_cast<size_t>(c) * howo] = __float2bfloat16_rn(acc[c]);
    }
  } else {
    T* __restrict__ dst = out + (ng * howo + o) * CG;
#pragma unroll
    for (int c = 0; c < CG; c += V) {
      float v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = acc[c + k];
      store_vec<V>(dst + c, v);
    }
  }
}

// The f32 form: the group's map staged as f32, each point's four taps
// summed from registers (dcnv3::sample_point, K1's arithmetic).
template <int CG, bool GCHW>
__global__ void __launch_bounds__(kThreads<float, CG>)
dcnv3_sample_grouped_f32_kernel(const float* __restrict__ feat,
                                const float* __restrict__ py,
                                const float* __restrict__ px,
                                const float* __restrict__ mask,
                                float* __restrict__ out, int howo,
                                int groups, int points, int h, int w,
                                int bands, int rows, int halo) {
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
      stage_vec<V>(s + i / per_pix * stride + i % per_pix * V,
                   src + static_cast<size_t>(i) * V);
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
    if (o + static_cast<int>(blockDim.x) < t.o_hi) load(o + blockDim.x, 0);
    store_column<CG, GCHW>(out, ng, howo, o, acc);
  }
}

// Elements between neighbouring pixels of the bf16 forms' staged tile,
// which keeps the map's bf16: from Cg = 16 (32 bytes) the stride is padded
// to an odd number of 16-byte quads, as tile_stride pads the f32 tile; at
// Cg = 8 a pixel is one quad already (ops/dcnv3_grouped.py:
// _grouped_pixel_bytes mirrors it).
__host__ __device__ constexpr int tile_stride_bf16(int cg) {
  return cg % 16 ? cg : cg + 8;
}

// The bf16 forms' point table: kFields words for each of a thread's
// kPoints points, at [field][point][thread] (ops/dcnv3_grouped.py:
// POINT_TABLE_BYTES mirrors its size).
constexpr int kFields = 3;
constexpr int kRow = 0;         // y0, the floor row, an int
constexpr int kRowWeights = 1;  // bf16(m (1 - fy)) low, bf16(m fy) high
constexpr int kFx = 2;          // fx, f32

// Tap slots a column sorts (two a point), the key of a slot that reaches
// no map column, and the widest map whose column fits a key.
constexpr int kSlots = 2 * kPoints;
constexpr unsigned kNoSlot = 0xffffffffu;
constexpr int kMaxSortedW = 1 << 26;

// v[0:V] = src[0:V] bf16 converted to f32, one load of 2V bytes (V = 8:
// 16 bytes), from shared or device memory.
template <int V>
__device__ __forceinline__ void load_bf16(float (&v)[V], const bf16* src) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(words[k] << 16);
      v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
    }
  } else {
    load_vec<V>(v, src);
  }
}

// Stage V bf16 elements: cp.async of 2V bytes (the caller commits and
// waits), or a plain copy of one element (2 bytes, below cp.async's 4).
template <int V>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src) {
  if constexpr (V >= 2)
    __pipeline_memcpy_async(dst, src, V * sizeof(bf16));
  else
    *dst = *src;
}

// g += r * F[yy, xx, :] over the CG channels: from the staged tile when row
// yy is staged, else from device memory.
template <int CG>
__device__ __forceinline__ void add_tap(float (&g)[CG], const bf16* s,
                                        int stride, int y_lo, int y_hi,
                                        const bf16* __restrict__ map, int w,
                                        int yy, int xx, float r) {
  constexpr int V = CG >= 8 ? 8 : CG;
  const bool staged = yy >= y_lo && yy < y_hi;
  const bf16* src = s + ((yy - y_lo) * w + xx) * stride;
  const bf16* gsrc = map + (static_cast<size_t>(yy) * w + xx) * CG;
#pragma unroll
  for (int c = 0; c < CG; c += V) {
    float v[V];
    if (staged)
      load_bf16<V>(v, src + c);
    else
      load_bf16<V>(v, gsrc + c);
#pragma unroll
    for (int k = 0; k < V; ++k) g[c + k] = __fadd_rn(g[c + k],
                                                     __fmul_rn(v[k], r));
  }
}

// The bf16 forms' sum for output column o for any P (the first form, kept
// for more than kPoints points): acc += bf16(T[v, :]) for every map column
// v its points reach.  For each point p and tap column v that no earlier
// point reached, it sums the contributions of points p..P-1 at v in point
// order, rereading their coordinates.  A point with a NaN coordinate is
// dropped, as the f32 form drops it.
template <int CG, bool ROUND_COLS>
__device__ __forceinline__ void sample_column_rounded(
    float (&acc)[CG], const bf16* s, int stride, int y_lo, int y_hi,
    const bf16* __restrict__ map, int h, int w, const float* __restrict__ py,
    const float* __restrict__ px, const float* __restrict__ mask,
    size_t coord, int howo, int points, int o) {
  for (int p = 0; p < points; ++p) {
    const float x0p = floorf(__ldg(px + coord + static_cast<size_t>(p) * howo
                                   + o));
    if (!(x0p >= -1.f && x0p <= w - 1.f)) continue;  // off the map, or NaN
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float v = x0p + dx;
      if (v < 0.f || v > w - 1.f) continue;
      bool first = true;
      for (int q = 0; q < p && first; ++q) {
        const float d = v - floorf(__ldg(px + coord +
                                         static_cast<size_t>(q) * howo + o));
        first = !(d == 0.f || d == 1.f);
      }
      if (!first) continue;
      const int xx = static_cast<int>(v);
      float t[CG];
#pragma unroll
      for (int c = 0; c < CG; ++c) t[c] = 0.f;
      for (int q = p; q < points; ++q) {
        const size_t i = coord + static_cast<size_t>(q) * howo + o;
        const float x = __ldg(px + i);
        const float x0 = floorf(x);
        const float d = v - x0;
        if (!(d == 0.f || d == 1.f)) continue;
        const float y = __ldg(py + i);
        const float y0f = floorf(y);
        if (!(y0f >= -1.f && y0f <= h - 1.f)) continue;  // G = 0, or NaN
        const float m = __ldg(mask + i);
        const float fx = __fsub_rn(x, x0);
        float cw = d == 0.f ? __fsub_rn(1.f, fx) : fx;
        if constexpr (ROUND_COLS) cw = round_bf16(cw);
        const float fy = __fsub_rn(y, y0f);
        const int y0 = static_cast<int>(y0f);
        float g[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) g[c] = 0.f;
        if (y0 >= 0)
          add_tap<CG>(g, s, stride, y_lo, y_hi, map, w, y0, xx,
                      round_bf16(__fmul_rn(__fsub_rn(1.f, fy), m)));
        if (y0 + 1 < h)
          add_tap<CG>(g, s, stride, y_lo, y_hi, map, w, y0 + 1, xx,
                      round_bf16(__fmul_rn(fy, m)));
#pragma unroll
        for (int c = 0; c < CG; ++c) t[c] = __fadd_rn(t[c],
                                                      __fmul_rn(g[c], cw));
      }
#pragma unroll
      for (int c = 0; c < CG; ++c) acc[c] += round_bf16(t[c]);
    }
  }
}

// Compare-exchange of keys A < B, dropped when B is past the N sorted
// ones (those hold kNoSlot, the largest key, which no comparator moves).
template <int N, int A, int B, int M>
__device__ __forceinline__ void exchange(unsigned (&k)[M]) {
  if constexpr (B < N) {
    const unsigned a = k[A], b = k[B];
    k[A] = min(a, b);
    k[B] = max(a, b);
  }
}

// Batcher's odd-even merge of keys [LO, HI] at distance R: the comparators
// (i, i + R) for i = I, I + 2R, ... below HI - R, after the two halves.
template <int N, int I, int HI, int R, int M>
__device__ __forceinline__ void merge_pairs(unsigned (&k)[M]) {
  if constexpr (I < HI - R) {
    exchange<N, I, I + R>(k);
    merge_pairs<N, I + 2 * R, HI, R>(k);
  }
}

template <int N, int LO, int HI, int R, int M>
__device__ __forceinline__ void odd_even_merge(unsigned (&k)[M]) {
  if constexpr (2 * R < HI - LO) {
    odd_even_merge<N, LO, HI, 2 * R>(k);
    odd_even_merge<N, LO + R, HI, 2 * R>(k);
    merge_pairs<N, LO + R, HI, R>(k);
  } else {
    exchange<N, LO, LO + R>(k);
  }
}

template <int N, int LO, int HI, int M>
__device__ __forceinline__ void odd_even_sort(unsigned (&k)[M]) {
  if constexpr (HI > LO) {
    odd_even_sort<N, LO, LO + (HI - LO) / 2>(k);
    odd_even_sort<N, LO + (HI - LO) / 2 + 1, HI>(k);
    odd_even_merge<N, LO, HI, 1>(k);
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Sort k[0:N] ascending with Batcher's network for the next power of two,
// its comparators past N dropped: every index is a constant, so the keys
// stay in registers.
template <int N, int M>
__device__ __forceinline__ void sort_keys(unsigned (&k)[M]) {
  odd_even_sort<N, 0, pow2_at_least(N) - 1>(k);
}

// One output column's point table and slot keys from its coordinates: a
// point q with a tap on the map (a NaN coordinate has none) writes its
// terms to the table `tbl` (this thread's words, kThreads apart) and each
// of its two tap columns v inside the map gets the key v << 5 | 2q + dx;
// every other slot, and key[kSlots], kNoSlot.
template <int CG>
__device__ __forceinline__ void point_slots(unsigned (&key)[kSlots + 1],
                                            uint32_t* tbl,
                                            const float (&y)[kPoints],
                                            const float (&x)[kPoints],
                                            const float (&m)[kPoints],
                                            int points, int h, int w) {
  constexpr int T = kThreads<bf16, CG>;
  key[kSlots] = kNoSlot;
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    key[2 * q] = key[2 * q + 1] = kNoSlot;
    const float y0f = floorf(y[q]);
    const float x0f = floorf(x[q]);
    if (!(q < points && y0f >= -1.f && y0f <= h - 1.f && x0f >= -1.f &&
          x0f <= w - 1.f))
      continue;
    const int x0 = static_cast<int>(x0f);
    const float fy = __fsub_rn(y[q], y0f);
    const uint32_t r0 = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn(__fsub_rn(1.f, fy), m[q])));
    const uint32_t r1 = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn(fy, m[q])));
    tbl[(kRow * kPoints + q) * T] = static_cast<uint32_t>(
        static_cast<int>(y0f));
    tbl[(kRowWeights * kPoints + q) * T] = r0 | r1 << 16;
    tbl[(kFx * kPoints + q) * T] = __float_as_uint(__fsub_rn(x[q], x0f));
    if (x0 >= 0) key[2 * q] = static_cast<unsigned>(x0) << 5 | 2 * q;
    if (x0 + 1 < w)
      key[2 * q + 1] = static_cast<unsigned>(x0 + 1) << 5 | (2 * q + 1);
  }
}

// The bf16 forms' sum for one output column of at most kPoints points from
// its slot keys and point table (see the note at the top): sort the keys,
// then walk the slots in column order, each slot's two taps read once, and
// round each column's sum at its last slot.
template <int CG, bool ROUND_COLS>
__device__ __forceinline__ void sample_column_sorted(
    float (&acc)[CG], unsigned (&key)[kSlots + 1], const uint32_t* tbl,
    const bf16* s, int stride, int y_lo, int y_hi,
    const bf16* __restrict__ map, int h, int w) {
  constexpr int T = kThreads<bf16, CG>;
  sort_keys<kSlots>(key);
  float t[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) t[c] = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (key[i] == kNoSlot) break;
    const int v = static_cast<int>(key[i] >> 5);
    const int q = static_cast<int>(key[i] >> 1 & 15);
    const int y0 = static_cast<int>(tbl[(kRow * kPoints + q) * T]);
    const uint32_t r = tbl[(kRowWeights * kPoints + q) * T];
    const float fx = __uint_as_float(tbl[(kFx * kPoints + q) * T]);
    float cw = key[i] & 1 ? fx : __fsub_rn(1.f, fx);
    if constexpr (ROUND_COLS) cw = round_bf16(cw);
    float g[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) g[c] = 0.f;
    if (y0 >= 0)
      add_tap<CG>(g, s, stride, y_lo, y_hi, map, w, y0, v,
                  __uint_as_float(r << 16));
    if (y0 + 1 < h)
      add_tap<CG>(g, s, stride, y_lo, y_hi, map, w, y0 + 1, v,
                  __uint_as_float(r & 0xffff0000u));
#pragma unroll
    for (int c = 0; c < CG; ++c) t[c] = __fadd_rn(t[c], __fmul_rn(g[c], cw));
    if (key[i + 1] >> 5 != key[i] >> 5) {  // the column's last slot
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        acc[c] += round_bf16(t[c]);
        t[c] = 0.f;
      }
    }
  }
}

// The bf16 forms (see the note at the top).
template <int CG, bool GCHW, bool ROUND_COLS>
__global__ void __launch_bounds__(kThreads<bf16, CG>, kMinBlocks<CG>)
dcnv3_sample_grouped_bf16_kernel(const bf16* __restrict__ feat,
                                 const float* __restrict__ py,
                                 const float* __restrict__ px,
                                 const float* __restrict__ mask,
                                 bf16* __restrict__ out, int howo,
                                 int groups, int points, int h, int w,
                                 int bands, int rows, int halo) {
  constexpr int V = CG >= 8 ? 8 : CG;
  extern __shared__ float4 smem4[];
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem4) + threadIdx.x;
  bf16* s = reinterpret_cast<bf16*>(reinterpret_cast<uint32_t*>(smem4) +
                                    kFields * kPoints * kThreads<bf16, CG>);
  const Tile t = block_tile(howo, h, 1, bands, rows, halo);
  const size_t ng = static_cast<size_t>(t.n) * groups + t.g0;
  const bf16* __restrict__ map = feat + ng * h * w * CG;
  const size_t coord = ng * points * howo;
  const int stride = tile_stride_bf16(CG);

  // stage rows [y_lo, y_hi) of the group's map as bf16: V elements a copy,
  // into the padded pixel stride
  {
    constexpr int per_pix = CG / V;
    const bf16* src = map + static_cast<size_t>(t.y_lo) * w * CG;
    const int vecs = (t.y_hi - t.y_lo) * w * per_pix;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x)
      stage_bf16<V>(s + i / per_pix * stride + i % per_pix * V,
                    src + static_cast<size_t>(i) * V);
    __pipeline_commit();
  }

  const bool sorted = points <= kPoints && w <= kMaxSortedW;
  float y[kPoints], x[kPoints], m[kPoints];
  auto load = [&](int o) {
#pragma unroll
    for (int k = 0; k < kPoints; ++k) {
      if (k < points) {
        const size_t i = coord + static_cast<size_t>(k) * howo + o;
        y[k] = py[i];
        x[k] = px[i];
        m[k] = mask[i];
      }
    }
  };
  // the first column's coordinates fly while the map arrives; a later
  // column's (none at the flagship's shapes) load when it starts
  const int first = t.o_lo + threadIdx.x;
  if (sorted && first < t.o_hi) load(first);
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int o = first; o < t.o_hi; o += blockDim.x) {
    float acc[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[c] = 0.f;
    if (sorted) {
      if (o != first) load(o);
      unsigned key[kSlots + 1];
      point_slots<CG>(key, tbl, y, x, m, points, h, w);
      sample_column_sorted<CG, ROUND_COLS>(acc, key, tbl, s, stride, t.y_lo,
                                           t.y_hi, map, h, w);
    } else {
      sample_column_rounded<CG, ROUND_COLS>(acc, s, stride, t.y_lo, t.y_hi,
                                            map, h, w, py, px, mask, coord,
                                            howo, points, o);
    }
    store_column<CG, GCHW>(out, ng, howo, o, acc);
  }
}

// Dynamic shared memory of a block staging `rows` rows of width w: the f32
// tile, or the bf16 tile after the point table.
template <typename T, int CG>
size_t smem_bytes(int rows, int w) {
  const size_t pixels = static_cast<size_t>(rows) * w;
  if constexpr (std::is_same_v<T, float>)
    return tile_stride(1, CG) * pixels * sizeof(float);
  else
    return kFields * kPoints * kThreads<T, CG> * sizeof(uint32_t) +
           tile_stride_bf16(CG) * pixels * sizeof(bf16);
}

template <typename T, int CG, bool GCHW, bool ROUND_COLS>
cudaError_t launch_one(const T* feat, const float* py, const float* px,
                       const float* mask, T* out, int n, int howo,
                       int groups, int points, int h, int w, int bands,
                       int rows, int halo, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, CG>(rows, w);
  const int ob = (howo + bands - 1) / bands;
  const int threads = min(kThreads<T, CG>, (ob + 31) / 32 * 32);
  constexpr auto* kernel = [] {
    if constexpr (std::is_same_v<T, float>)
      return &dcnv3_sample_grouped_f32_kernel<CG, GCHW>;
    else
      return &dcnv3_sample_grouped_bf16_kernel<CG, GCHW, ROUND_COLS>;
  }();
  int sms = 0;
  const cudaError_t err = device_facts<kernel>(device, &sms);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bands, groups, n), threads, smem, stream>>>(
      feat, py, px, mask, out, howo, groups, points, h, w, bands, rows,
      halo);
  return cudaGetLastError();
}

template <typename T, int CG>
cudaError_t launch(const T* feat, const float* py, const float* px,
                   const float* mask, T* out, int n, int howo, int groups,
                   int points, int h, int w, int bands, int rows, int halo,
                   int gchw, int round_cols, int device,
                   cudaStream_t stream) {
#define DCNV3_GROUPED_LAUNCH(GCHW, ROUND)                                   \
  return launch_one<T, CG, GCHW, ROUND>(feat, py, px, mask, out, n, howo,  \
                                        groups, points, h, w, bands, rows, \
                                        halo, device, stream)
  if constexpr (std::is_same_v<T, float>) {
    if (gchw) DCNV3_GROUPED_LAUNCH(true, false);
    DCNV3_GROUPED_LAUNCH(false, false);
  } else {
    if (gchw && round_cols) DCNV3_GROUPED_LAUNCH(true, true);
    if (gchw) DCNV3_GROUPED_LAUNCH(true, false);
    if (round_cols) DCNV3_GROUPED_LAUNCH(false, true);
    DCNV3_GROUPED_LAUNCH(false, false);
  }
#undef DCNV3_GROUPED_LAUNCH
}

template <typename T>
int entry(const void* feat, const void* py, const void* px, const void* mask,
          void* out, int n, int howo, int groups, int points, int h, int w,
          int cg, int bands, int rows, int halo, int gchw, int round_cols,
          int device, void* stream) {
  const auto* f = static_cast<const T*>(feat);
  const auto* y = static_cast<const float*>(py);
  const auto* x = static_cast<const float*>(px);
  const auto* m = static_cast<const float*>(mask);
  auto* o = static_cast<T*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n * groups * howo == 0) return cudaSuccess;
  if (bands < 1 || rows < 0 || halo < 0) return cudaErrorInvalidValue;
  switch (cg) {
#define DCNV3_GROUPED_CASE(CG)                                               \
  case CG:                                                                   \
    return launch<T, CG>(f, y, x, m, o, n, howo, groups, points, h, w,      \
                         bands, rows, halo, gchw, round_cols, device, s);
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

}  // namespace

// Plain C entry points, loaded with ctypes.  `gchw` = 1 writes
// [N, G, Cg, HoWo], 0 writes [N, G, HoWo, Cg].  (bands, rows, halo) is the
// tile plan of ops/dcnv3_grouped.py:grouped_tile_plan.  Launch on `stream`
// of CUDA device `device`, the current one, and do not synchronise; return
// the cudaError_t of the launch.
extern "C" int dcnv3_sample_grouped_f32(const void* feat, const void* py,
                                        const void* px, const void* mask,
                                        void* out, int n, int howo,
                                        int groups, int points, int h, int w,
                                        int cg, int bands, int rows,
                                        int halo, int gchw, int device,
                                        void* stream) {
  return entry<float>(feat, py, px, mask, out, n, howo, groups, points, h, w,
                      cg, bands, rows, halo, gchw, 0, device, stream);
}

// The bf16 form: feat and out bf16.  `round_cols` = 1 rounds the column
// weights to bf16 as K3 and K6 do, 0 keeps them f32 as K4 and K5 do.
extern "C" int dcnv3_sample_grouped_bf16(const void* feat, const void* py,
                                         const void* px, const void* mask,
                                         void* out, int n, int howo,
                                         int groups, int points, int h,
                                         int w, int cg, int bands, int rows,
                                         int halo, int gchw, int round_cols,
                                         int device, void* stream) {
  return entry<__nv_bfloat16>(feat, py, px, mask, out, n, howo, groups,
                              points, h, w, cg, bands, rows, halo, gchw,
                              round_cols, device, stream);
}
