// What the DCNv3 samplers dcnv3_sample.cu (K1) and dcnv3_sample_bwd.cu (K2)
// share: the part of the map and of the output pixels a block owns (the
// host's ops/dcnv3.py:tile_plan and _band_rows choose and size it), vector
// loads, the walk that copies a warp's coordinates, and what a launch
// needs to know of the device, kept per device.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

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
