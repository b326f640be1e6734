// JAX's threefry2x32 random draws (jax.random.bits / uniform / bernoulli
// under jax_threefry_partitionable = True), bit for bit, for the port's
// dropout masks, loss points and initial variables.
//
// Replaces no TPU kernel: the JAX package draws with jax.random, which XLA
// lowers to the same hash.  torch has no threefry (torch.rand is Philox, a
// different stream) and the plain tensor version
// (spike2former_tpu_torch/utils/jax_random.py:bits_reference) takes about
// 140 elementwise int64 passes over the draw; this kernel takes one.
//
// One thread per output element of the block [start, stop) of one axis of
// a draw of shape (pre, n, post): its flat index i in the WHOLE draw is
// (p * n + start + a) * post + q, its counter pair (i >> 32, i & 0xffffffff),
// its 32 bits the xor of the two threefry2x32 output words.  Modes:
//   0  the bits (uint32, written as int32),
//   1  float32 uniforms: fma(f, span, lo) then max(lo, .), f in [0, 1) from
//      the high 23 bits (random.py:_uniform; XLA's CPU contracts the scale
//      and shift into one FMA, and so does __fmaf_rn),
//   2  a keep mask (bool): f < p.
// Bound: writing the output once (4 bytes a uniform, 1 a mask); the hash
// is ~90 integer operations an element, which the card's integer rate
// covers at well under the write time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__global__ void threefry_kernel(void* __restrict__ out, uint32_t k0,
                                uint32_t k1, int64_t n, int64_t post,
                                int64_t start, int64_t len, int64_t total,
                                int mode, float a, float b) {
  const int64_t block_rows = len * post;
  // the whole draw: an element's flat index is its place in the output
  // (no 64-bit divisions)
  const bool whole = start == 0 && len == n;
  for (int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       j < total; j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    uint64_t i = static_cast<uint64_t>(j);
    if (!whole) {
      const int64_t p = j / block_rows;
      const int64_t r = j - p * block_rows;
      const int64_t ax = r / post;
      const int64_t q = r - ax * post;
      i = static_cast<uint64_t>((p * n + start + ax) * post + q);
    }
    uint32_t x0 = static_cast<uint32_t>(i >> 32);
    uint32_t x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if (mode == 0) {
      static_cast<uint32_t*>(out)[j] = bits;
      continue;
    }
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    if (mode == 1) {
      static_cast<float*>(out)[j] = fmaxf(b, __fmaf_rn(f, a, b));
    } else {
      static_cast<bool*>(out)[j] = f < a;
    }
  }
}

}  // namespace

extern "C" int threefry_draw(void* out, uint32_t k0, uint32_t k1,
                             long long pre, long long n, long long post,
                             long long start, long long stop, int mode,
                             float a, float b, void* stream) {
  const int64_t len = stop - start;
  const int64_t total = static_cast<int64_t>(pre) * len * post;
  if (total <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  threefry_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      out, k0, k1, n, post, start, len, total, mode, a, b);
  return static_cast<int>(cudaGetLastError());
}
