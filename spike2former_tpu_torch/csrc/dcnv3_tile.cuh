// What the DCNv3 samplers share: K1 (dcnv3_sample.cu) and K2
// (dcnv3_sample_bwd.cu) in the channels-last layout, and their grouped-layout
// counterparts (dcnv3_sample_grouped.cu, dcnv3_sample_grouped_bwd.cu).  The
// part of the map and of the output pixels a block owns (the host's
// ops/dcnv3.py:tile_plan, grouped_tile_plan and _band_rows choose and size
// it), the padded pixel stride of a staged tile, vector loads and atomics,
// one point's bilinear sample and its backward against a staged tile, the
// walk that copies a warp's coordinates, and what a launch needs to know of
// the device, kept per device.
//
// The feature element type T is float or __nv_bfloat16 (K1 and K2 take
// both; the grouped pair float only).  A staged tile is f32 whatever T: a
// bf16 feature is converted to f32 while it is staged (stage_vec), so the
// shared-memory layout, its bank arithmetic and the host's plan sizes
// (4 bytes a staged channel) are the same for both types, and a tap read
// from shared memory costs no conversion.  Taps of rows outside the staged
// tile read T from device memory and convert.  Coordinates, mask, bilinear
// weights and every sum are f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace dcnv3 {

// The block's share: image n, groups [g0, g0 + gb), output pixels
// [o_lo, o_hi), staged map rows [y_lo, y_hi).
struct Tile {
  int n, g0, o_lo, o_hi, y_lo, y_hi;
};

// Block (band, group chunk, image) of a plan of `bands` bands of output
// pixels, `rows` staged rows and `halo` rows above a band (halo + 1 below,
// the floor tap's next row): the whole map when rows >= h.
__device__ __forceinline__ Tile block_tile(int howo, int h, int gb,
                                           int bands, int rows, int halo) {
  Tile t;
  const int ob = (howo + bands - 1) / bands;
  t.n = blockIdx.z;
  t.g0 = blockIdx.y * gb;
  t.o_lo = blockIdx.x * ob;
  t.o_hi = min(howo, t.o_lo + ob);
  if (rows >= h) {
    t.y_lo = 0;
    t.y_hi = h;
    return t;
  }
  // nominal map row of output pixel o (o / w when HoWo = H*W)
  const int r_lo = static_cast<int>(static_cast<long long>(t.o_lo) * h / howo);
  const int r_hi =
      static_cast<int>(static_cast<long long>(max(t.o_hi - 1, t.o_lo)) * h /
                       howo);
  t.y_lo = max(0, r_lo - halo);
  t.y_hi = max(t.y_lo, min(min(h, r_hi + halo + 2), t.y_lo + rows));
  return t;
}

// v[0:V] = src[0:V], one vector load (V = 4: 16 bytes).
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V], const float* src) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = *src;
  }
}

// v[0:V] = src[0:V] converted to f32, one vector load of 2*V bytes (8
// bytes at V = 4, aligned for any Cg since a vector starts at a multiple of
// V elements).
template <int V>
__device__ __forceinline__ void load_vec(float (&v)[V],
                                         const __nv_bfloat16* src) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __bfloat162float(*src);
  }
}

// dst[0:V] += v, one vector atomic (sm_90: red.global.add.v4.f32 / .v2).
template <int V>
__device__ __forceinline__ void add_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(dst, v[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    *dst = v[0];
  }
}

// dst[0:V] = v rounded to bf16 (round to nearest even), one store of 2*V
// bytes.
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float (&v)[V]) {
  if constexpr (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&a);
    u.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(dst) = u;
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *dst = __float2bfloat16_rn(v[0]);
  }
}

// Stage src[0:V] into shared memory at dst as f32: an f32 vector by
// cp.async (the caller commits and waits), a bf16 one by a load, the
// conversion and a shared store (cp.async cannot convert).
template <int V>
__device__ __forceinline__ void stage_vec(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, V * sizeof(float));
}

template <int V>
__device__ __forceinline__ void stage_vec(float* dst,
                                          const __nv_bfloat16* src) {
  float v[V];
  load_vec<V>(v, src);
  store_vec<V>(dst, v);
}

// Floats between neighbouring pixels of a forward kernel's staged tile of
// `groups` groups of `cg` channels, padded to an odd number of 16-byte
// quads so that 8 lanes reading 16 bytes of 8 neighbouring pixels hit 8
// different bank quads (at 32 bytes a pixel they would pair up on 4)
// (ops/dcnv3.py:_pixel_floats mirrors it).
__host__ __device__ __forceinline__ int tile_stride(int groups, int cg) {
  return groups * cg % 8 ? groups * cg : groups * cg + 4;
}

// acc += m * bilinear(map; y, x) over the CG channels of one group: the
// four floor-based taps (y0 = floor(y), y0 + 1; likewise x), zero outside
// [0, h) x [0, w), NaN coordinates dropped.  Map rows [y_lo, y_hi) are
// staged at `s` (row y_lo first, `stride` floats a pixel); a tap of
// another row reads `feat` in device memory (`gstride` elements a pixel,
// float or bf16).
// A tap off the map reads its clamped neighbour with weight 0.  The
// additions go tap by tap in one order in every kernel, so the forwards
// agree.
template <int CG, typename T>
__device__ __forceinline__ void sample_point(
    float (&acc)[CG], const float* s, int stride, int y_lo, int y_hi,
    const T* __restrict__ feat, int gstride, int h, int w, float y,
    float x, float m) {
  constexpr int V = CG >= 4 ? 4 : CG;
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  // every tap off the map (this also drops NaN coordinates)
  if (!(y0f >= -1.f && y0f <= h - 1.f && x0f >= -1.f && x0f <= w - 1.f))
    return;
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const float fy = y - y0f;
  const float fx = x - x0f;
  const float wy0 = 1.f - fy, wx0 = 1.f - fx;
  const bool vx0 = x0 >= 0, vx1 = x0 + 1 < w;
  const float w00 = y0 >= 0 && vx0 ? m * wy0 * wx0 : 0.f;
  const float w01 = y0 >= 0 && vx1 ? m * wy0 * fx : 0.f;
  const float w10 = y0 + 1 < h && vx0 ? m * fy * wx0 : 0.f;
  const float w11 = y0 + 1 < h && vx1 ? m * fy * fx : 0.f;
  const int ya = max(y0, 0), yb = min(y0 + 1, h - 1);
  const int xa = max(x0, 0), xb = min(x0 + 1, w - 1);
  if (ya >= y_lo && yb < y_hi) {
    // both rows staged: four taps from shared memory, loads issued
    // together
    const float* r0 = s + (ya - y_lo) * w * stride;
    const float* r1 = s + (yb - y_lo) * w * stride;
#pragma unroll
    for (int c = 0; c < CG; c += V) {
      float v00[V], v01[V], v10[V], v11[V];
      load_vec<V>(v00, r0 + xa * stride + c);
      load_vec<V>(v01, r0 + xb * stride + c);
      load_vec<V>(v10, r1 + xa * stride + c);
      load_vec<V>(v11, r1 + xb * stride + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[c + k] += w00 * v00[k];
        acc[c + k] += w01 * v01[k];
        acc[c + k] += w10 * v10[k];
        acc[c + k] += w11 * v11[k];
      }
    }
    return;
  }
  // a row outside the staged rows: tap by tap, from device memory where
  // the row is not staged
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = dy ? yb : ya;
    const bool in_tile = yy >= y_lo && yy < y_hi;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float wt = dy ? (dx ? w11 : w10) : (dx ? w01 : w00);
      if (wt == 0.f) continue;
      const int xx = dx ? xb : xa;
      const float* src = s + ((yy - y_lo) * w + xx) * stride;
      const T* gsrc = feat + (static_cast<size_t>(yy) * w + xx) * gstride;
#pragma unroll
      for (int c = 0; c < CG; c += V) {
        float v[V];
        if (in_tile)
          load_vec<V>(v, src + c);
        else
          load_vec<V>(v, gsrc + c);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[c + k] += wt * v[k];
      }
    }
  }
}

// Channels of a staged tap that a backward kernel adds in its shared
// accumulator, the first kShared of each group's Cg (ops/dcnv3.py:
// SHARED_CHANNELS mirrors it); the others go to device memory as vector
// atomics.  sm_90 has no shared-memory f32 add: atomicAdd there is a
// compare-and-swap loop, and a warp's random taps conflict on banks and
// collide on words, so sharing the adds between the two units is fastest
// (dcnv3_sample_bwd.cu's note has the measurements).
template <int CG>
constexpr int kShared = CG < 4 ? CG : 4;

// dfeat[tap] += wt * d: channels [0, kShared) into the shared accumulator
// (pixel i of the tile, channel planes of `plane` floats), the others, or
// all when the tap is not staged (staged false), straight into device
// memory (`dst`, the tap's channels of the group) with vector atomics.
template <int CG>
__device__ __forceinline__ void scatter(float* acc, int i, int plane,
                                        bool staged, float* dst,
                                        const float (&d)[CG], float wt) {
  constexpr int V = CG >= 4 ? 4 : CG;
#pragma unroll
  for (int c = 0; c < CG; c += V) {
    float add[V];
#pragma unroll
    for (int k = 0; k < V; ++k) add[k] = wt * d[c + k];
    if (staged && c < kShared<CG>) {
#pragma unroll
      for (int k = 0; k < V; ++k) atomicAdd(acc + (c + k) * plane + i, add[k]);
    } else {
      add_vec<V>(dst + c, add);
    }
  }
}

// <F, d> for the CG channels at `src` (shared or device memory; f32 or
// bf16 F, f32 sum).
template <int CG, typename T>
__device__ __forceinline__ float dot(const T* src, const float (&d)[CG]) {
  constexpr int V = CG >= 4 ? 4 : CG;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CG; c += V) {
    float f[V];
    load_vec<V>(f, src + c);
#pragma unroll
    for (int k = 0; k < V; ++k) sum += f[k] * d[c + k];
  }
  return sum;
}

// The backward of sample_point for one point with upstream gradient d.
// For each of the four floor-based taps inside the map, with
// s = <F_tap, d>: dfeat[tap] += m * wy * wx * d (scatter into `acc` and
// `dfeat`, nothing for a weight of 0), gm += wy * wx * s,
// gy += (dwy/dy) * wx * s and gx += wy * (dwx/dx) * s (the caller scales
// gy and gx by m), dwy/dy = -1 on row y0 and +1 on row y0 + 1, likewise x:
// floor-based also at exact integer coordinates.  Taps off the map give 0
// to every term, NaN coordinates are dropped.  The staged tile and the
// device-memory map as in sample_point (`feat` f32 or bf16; `dfeat`, the
// gradient's device-memory accumulator, is f32 in both cases); `acc`
// holds the staged pixels' shared channels in planes of `plane` floats.
template <int CG, typename T>
__device__ __forceinline__ void sample_point_bwd(
    float& gy, float& gx, float& gm, const float* s, int stride, float* acc,
    int plane, int y_lo, int y_hi, const T* __restrict__ feat,
    float* __restrict__ dfeat, int gstride, int h, int w,
    const float (&d)[CG], float y, float x, float m) {
  constexpr int V = CG >= 4 ? 4 : CG;
  const float y0f = floorf(y);
  const float x0f = floorf(x);
  // some tap inside the map (this also drops NaN coordinates)
  if (!(y0f >= -1.f && y0f <= h - 1.f && x0f >= -1.f && x0f <= w - 1.f))
    return;
  const int y0 = static_cast<int>(y0f);
  const int x0 = static_cast<int>(x0f);
  const float fy = y - y0f;
  const float fx = x - x0f;
  const float wy0 = 1.f - fy, wx0 = 1.f - fx;
  // tap (dy, dx): <F, d> and the shared tile's pixel, or -1; a tap off
  // the map reads its clamped neighbour and counts 0
  const int ya = max(y0, 0), yb = min(y0 + 1, h - 1);
  const int xa = max(x0, 0), xb = min(x0 + 1, w - 1);
  float sv[2][2];
  int ti[2][2];
  if (ya >= y_lo && yb < y_hi) {
    // both rows staged: the four dot products from shared memory, loads
    // issued together
    ti[0][0] = (ya - y_lo) * w + xa;
    ti[0][1] = (ya - y_lo) * w + xb;
    ti[1][0] = (yb - y_lo) * w + xa;
    ti[1][1] = (yb - y_lo) * w + xb;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
#pragma unroll
    for (int c = 0; c < CG; c += V) {  // a quad of each tap at once
      float v00[V], v01[V], v10[V], v11[V];
      load_vec<V>(v00, s + ti[0][0] * stride + c);
      load_vec<V>(v01, s + ti[0][1] * stride + c);
      load_vec<V>(v10, s + ti[1][0] * stride + c);
      load_vec<V>(v11, s + ti[1][1] * stride + c);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s00 += v00[k] * d[c + k];
        s01 += v01[k] * d[c + k];
        s10 += v10[k] * d[c + k];
        s11 += v11[k] * d[c + k];
      }
    }
    sv[0][0] = s00;
    sv[0][1] = s01;
    sv[1][0] = s10;
    sv[1][1] = s11;
  } else {
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yy = dy ? yb : ya;
      const bool in_tile = yy >= y_lo && yy < y_hi;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xx = dx ? xb : xa;
        ti[dy][dx] = in_tile ? (yy - y_lo) * w + xx : -1;
        sv[dy][dx] =
            in_tile ? dot<CG>(s + ti[dy][dx] * stride, d)
                    : dot<CG>(feat + (static_cast<size_t>(yy) * w + xx) *
                                         gstride, d);
      }
    }
  }
  const bool in_y[2] = {y0 >= 0, y0 + 1 < h};
  const bool in_x[2] = {x0 >= 0, x0 + 1 < w};
  const float wy[2] = {wy0, fy}, wx[2] = {wx0, fx};
  const float sy[2] = {-1.f, 1.f};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      if (!(in_y[dy] && in_x[dx])) continue;
      const float v = sv[dy][dx];
      gm += wy[dy] * wx[dx] * v;
      gy += sy[dy] * wx[dx] * v;
      gx += sy[dx] * wy[dy] * v;
      const float wt = m * wy[dy] * wx[dx];
      if (wt != 0.f)
        scatter<CG>(acc, ti[dy][dx], plane, ti[dy][dx] >= 0,
                    dfeat + (static_cast<size_t>(y0 + dy) * w + x0 + dx) *
                                gstride, d, wt);
    }
}

// The coordinates and mask of a warp's `count` items j0 + i (output pixel
// o_lo + (j0 + i) / gb, group g0 + (j0 + i) % gb) against its buffer
// buf[k*32*P + i*P + p] for py, px, mask (k = 0, 1, 2): calls f(e, idx) for
// each buffer slot e < count*P and the index idx of its float in a
// [N, HoWo, G, P] array.  Consecutive lanes take consecutive floats of each
// item's gb*P-float run, where a thread per item would step 4*G*P bytes;
// lane i then reads its own P floats at a stride of P words (odd for
// P = 9: no bank conflicts).
template <typename F>
__device__ __forceinline__ void for_each_coord(const Tile& t, int j0,
                                               int count, int gb, int groups,
                                               int points, int howo, int lane,
                                               F&& f) {
  const int total = count * points;
  int j = lane / points, p = lane % points;  // slot e = j*P + p
  for (int e = lane; e < total; e += 32) {
    const int jj = j0 + j;
    f(e, ((static_cast<size_t>(t.n) * howo + t.o_lo + jj / gb) * groups +
          t.g0 + jj % gb) * points + p);
    j += 32 / points;
    p += 32 % points;
    if (p >= points) {
      p -= points;
      ++j;
    }
  }
}

// cp.async of those items' py, px and mask into the warp's buffer; the
// caller commits and waits.
__device__ __forceinline__ void fetch_coords(
    float* buf, const float* __restrict__ py, const float* __restrict__ px,
    const float* __restrict__ mask, const Tile& t, int j0, int count,
    int gb, int groups, int points, int howo, int lane) {
  const int stride = 32 * points;
  for_each_coord(t, j0, count, gb, groups, points, howo, lane,
                 [&](int e, size_t idx) {
                   __pipeline_memcpy_async(buf + e, py + idx, sizeof(float));
                   __pipeline_memcpy_async(buf + stride + e, px + idx,
                                           sizeof(float));
                   __pipeline_memcpy_async(buf + 2 * stride + e, mask + idx,
                                           sizeof(float));
                 });
}

constexpr int kMaxDevices = 64;

// What a launch of `Kernel` needs to know of device `device` (the current
// one), worked out at the kernel's first launch there and kept: the
// kernel's dynamic shared-memory limit is raised to the device's opt-in
// most (an attribute of a kernel on one device, so set once per device),
// and `*sms` is the device's SM count.  With `per_sm`, also how many
// blocks of `threads` threads and `smem` bytes fit an SM, kept for the
// last `smem` asked.  Returns the first CUDA error.
template <auto Kernel>
cudaError_t device_facts(int device, int* sms, int* per_sm = nullptr,
                         int threads = 0, size_t smem = 0) {
  struct Facts {
    int sms = 0;        // 0: not worked out yet
    size_t smem = 0;
    int per_sm = 0;     // 0: not worked out for `smem`
  };
  static Facts facts[kMaxDevices];
  static std::mutex mu;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> lock(mu);
  Facts& f = facts[device];
  if (!f.sms) {
    int optin = 0, count = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    f.sms = count;
  }
  *sms = f.sms;
  if (per_sm) {
    if (!f.per_sm || f.smem != smem) {
      const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &f.per_sm, Kernel, threads, smem);
      if (err != cudaSuccess) {
        f.per_sm = 0;
        return err;
      }
      f.smem = smem;
    }
    *per_sm = f.per_sm;
  }
  return cudaSuccess;
}

}  // namespace dcnv3
