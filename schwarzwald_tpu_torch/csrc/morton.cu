// Morton interleave of 21-bit grid coordinates into 63-bit keys, on an
// NVIDIA Hopper card (built for sm_90a).
//
// Replaces the TPU kernel schwarzwald_tpu/ops/device.py
// `morton_interleave_pallas` (:217, body `interleave21` :201 with
// `expand_bits_by_3_u32` :187). Semantics: bit i of z, y and x goes to key
// bit 3i, 3i+1 and 3i+2 (calculate_morton_index, OctreeAlgorithms.h:64-87);
// only the low 21 bits of each coordinate are read.
//
// The TPU kernel held the whole input in VMEM as (n/128, 128) tiles, needed
// n to be a multiple of 1024, and wrote the key as a (hi, lo) pair of
// uint32 words because the TPU has no 64-bit integers. Here the key is one
// 64-bit word, n is arbitrary, and the grid-stride loop masks the ragged
// tail itself.
//
// What bounds it on this card: memory. Each point reads 12 bytes and
// writes 8 (200 MB at 10M points); the bit spread is ~15 integer ops per
// coordinate. Design: one thread per point in a grid-stride loop, so
// neighbouring threads load neighbouring 4-byte words (coalesced) and store
// neighbouring 8-byte words; the spread is the 64-bit magic-number form
// (21 bits to 63 in one pass, no hi/lo split); a few blocks per SM keep
// enough loads in flight to cover the latency of device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ uint64_t spread3(uint32_t v) {
  uint64_t x = v & 0x1FFFFFu;
  x = (x | (x << 32)) & 0x001F00000000FFFFull;
  x = (x | (x << 16)) & 0x001F0000FF0000FFull;
  x = (x | (x << 8)) & 0x100F00F00F00F00Full;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ull;
  x = (x | (x << 2)) & 0x1249249249249249ull;
  return x;
}

__global__ void __launch_bounds__(THREADS)
interleave_kernel(const uint32_t* __restrict__ x,
                  const uint32_t* __restrict__ y,
                  const uint32_t* __restrict__ z, int64_t n,
                  uint64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = spread3(__ldg(z + i)) | (spread3(__ldg(y + i)) << 1) |
             (spread3(__ldg(x + i)) << 2);
  }
}

}  // namespace

extern "C" {

// Keys of n points: out[i] = interleave(x[i], y[i], z[i]). x, y, z are
// (n,) 32-bit coordinates, out is (n,) 64-bit, all on the current device.
// Launches on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched; n == 0 launches
// nothing).
int morton_interleave(const void* x, const void* y, const void* z,
                      int64_t n, void* out, void* stream) {
  if (n <= 0) return 0;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t needed = (n + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  interleave_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), n, static_cast<uint64_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
