// Greedy Poisson-disk (MIN_DISTANCE) accept mask of one Morton-sorted
// range, on an NVIDIA Hopper card (built for sm_90a).
//
// Replaces the TPU kernel schwarzwald_tpu/ops/poisson_pallas.py (`_kernel`
// :135, driven by `_run` :220). Semantics (the reference's
// PoissonDiskSampling::sample_points, Sampling.h:444-465): walk the range in
// order and accept point i iff it is analyzed and no earlier ACCEPTED point
// lies at d2 < spacing^2, with d2 = (dx*dx + dy*dy) + dz*dz.
//
// Design. The range is cut into blocks of BLOCK consecutive points. The host
// (ops/poisson_cuda.py) lists, for every block bi, the earlier blocks bj < bi
// whose AABB meets bi's AABB inflated by the spacing (CSR: pair_ptr,
// pair_bj). ONE thread block (CTA) walks the point blocks in ascending order,
// so every bj it reads is final -- this is what the TPU's in-order grid gave
// for free. For each bi:
//   1. cross step: for each listed bj, every point of bi that is still
//      undecided is rejected if any ACCEPTED point of bj is close;
//   2. intra step: each thread builds its row of the strict-lower close
//      matrix of bi as a bitmask in shared memory, then synchronous
//      relaxation rounds run until no point is undecided: an undecided
//      point with an accepted close earlier point rejects; one with no
//      accepted and no undecided close earlier point accepts. Each round
//      reads the previous round's bits (double buffers), so the earliest
//      undecided point always decides and the fixpoint is the sequential
//      greedy result.
// Points that are not analyzed (MIN_DISTANCE_FAST's strided mask, and the
// pad rows of the last block) are neither accepted nor blocking.
//
// Precision: T = double (the engine's mode, bit-equal to the native host
// kernel, whose squared spacing is the float32 product widened to double)
// or T = float (bit-equal to the float32 greedy oracle). Every subtraction,
// product and sum is an explicit round-to-nearest intrinsic, and the build
// passes -fmad=false, so no FMA contraction changes the rounding.
//
// What bounds it on this card: a single CTA per range runs on one of the
// 132 SMs, and the blocks of a range run one after another, so a range's
// time is latency-bound (blocks x (pairs + relaxation rounds)), not bound by
// bytes or FLOPs. Later work: schedule independent blocks concurrently
// (wavefronts of the pair-list dependency levels, or a persistent kernel
// with per-block ready flags), and batch many ranges into one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 512;            // points per block == threads per CTA
constexpr int WORDS = BLOCK / 32;     // 32-bit words per bitmask row

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T dist2(T xi, T yi, T zi, T xj, T yj, T zj) {
  const T dx = sub_rn(xi, xj);
  const T dy = sub_rn(yi, yj);
  const T dz = sub_rn(zi, zj);
  return add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz));
}

template <typename T>
constexpr size_t shared_bytes() {
  return sizeof(uint32_t) * BLOCK * WORDS   // close rows
         + sizeof(T) * 6 * BLOCK            // block bi planes, bj list
         + sizeof(uint32_t) * 4 * WORDS     // acc/und double buffers
         + sizeof(int32_t) * WORDS;         // accepted count per warp
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
poisson_range_kernel(const T* __restrict__ planes,      // (3, n): x, y, z
                     const uint8_t* __restrict__ analyze,  // (n) or null
                     int64_t n, T sq,
                     const int32_t* __restrict__ pair_ptr,  // (n_blocks + 1)
                     const int32_t* __restrict__ pair_bj,   // cross pairs
                     int32_t n_blocks,
                     uint8_t* __restrict__ out) {          // (n) accept 0/1
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* close = reinterpret_cast<uint32_t*>(smem);           // [BLOCK][WORDS]
  T* xi_s = reinterpret_cast<T*>(close + BLOCK * WORDS);
  T* yi_s = xi_s + BLOCK;
  T* zi_s = yi_s + BLOCK;
  T* xj_s = zi_s + BLOCK;
  T* yj_s = xj_s + BLOCK;
  T* zj_s = yj_s + BLOCK;
  uint32_t* acc_bits = reinterpret_cast<uint32_t*>(zj_s + BLOCK);  // [2][WORDS]
  uint32_t* und_bits = acc_bits + 2 * WORDS;                       // [2][WORDS]
  int32_t* warp_cnt = reinterpret_cast<int32_t*>(und_bits + 2 * WORDS);

  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const T* px = planes;
  const T* py = planes + n;
  const T* pz = planes + 2 * n;

  for (int bi = 0; bi < n_blocks; ++bi) {
    const int64_t base = static_cast<int64_t>(bi) * BLOCK;
    const int64_t gi = base + i;
    const bool valid = gi < n;
    T xi = T(0), yi = T(0), zi = T(0);
    if (valid) {
      xi = px[gi];
      yi = py[gi];
      zi = pz[gi];
    }
    bool und = valid && (analyze == nullptr || analyze[gi] != 0);

    // 1. cross pairs: earlier blocks, whose accept flags are final. Only
    //    the ACCEPTED points of block bj can reject, so they are compacted
    //    into shared memory first (order within the list is irrelevant).
    if (__syncthreads_or(und)) {
      for (int p = pair_ptr[bi]; p < pair_ptr[bi + 1]; ++p) {
        // bj < bi, so block bj is full (only the last block is partial)
        const int64_t gj = static_cast<int64_t>(pair_bj[p]) * BLOCK + i;
        const bool a = out[gj] != 0;
        const uint32_t m = __ballot_sync(0xffffffffu, a);
        if (lane == 0) warp_cnt[warp] = __popc(m);
        __syncthreads();
        int offset = 0, total = 0;
        for (int w = 0; w < WORDS; ++w) {
          offset += (w < warp) ? warp_cnt[w] : 0;
          total += warp_cnt[w];
        }
        if (a) {
          const int slot = offset + __popc(m & ((1u << lane) - 1u));
          xj_s[slot] = px[gj];
          yj_s[slot] = py[gj];
          zj_s[slot] = pz[gj];
        }
        __syncthreads();
        if (und) {
          for (int j = 0; j < total; ++j) {
            if (dist2(xi, yi, zi, xj_s[j], yj_s[j], zj_s[j]) < sq) {
              und = false;
              break;
            }
          }
        }
        // before the next pair overwrites the list; stop early once no
        // point of block bi is left undecided
        if (!__syncthreads_or(und)) break;
      }
    }

    // 2. intra step: strict-lower close rows, then relaxation rounds
    xi_s[i] = xi;
    yi_s[i] = yi;
    zi_s[i] = zi;
    const uint32_t und_word0 = __ballot_sync(0xffffffffu, und);
    if (lane == 0) {
      acc_bits[warp] = 0u;
      und_bits[warp] = und_word0;
    }
    const int any_und = __syncthreads_or(und);
    if (any_und) {
      uint32_t* row = close + i * WORDS;
      for (int w = 0; w <= warp; ++w) {
        uint32_t bits = 0u;
        const int jmax = (w == warp) ? lane : 32;  // j < i only
        for (int b = 0; b < jmax; ++b) {
          const int j = w * 32 + b;
          if (dist2(xi, yi, zi, xi_s[j], yi_s[j], zi_s[j]) < sq)
            bits |= 1u << b;
        }
        row[w] = bits;
      }
      __syncthreads();

      bool acc = false;
      int cur = 0;
      while (true) {
        const uint32_t* acc_cur = acc_bits + cur * WORDS;
        const uint32_t* und_cur = und_bits + cur * WORDS;
        if (und) {
          uint32_t acc_hit = 0u, und_hit = 0u;
          for (int w = 0; w <= warp; ++w) {
            acc_hit |= row[w] & acc_cur[w];
            und_hit |= row[w] & und_cur[w];
          }
          if (acc_hit) {
            und = false;          // rejected
          } else if (!und_hit) {
            und = false;          // accepted
            acc = true;
          }
        }
        const uint32_t acc_word = __ballot_sync(0xffffffffu, acc);
        const uint32_t und_word = __ballot_sync(0xffffffffu, und);
        const int nxt = cur ^ 1;
        if (lane == 0) {
          acc_bits[nxt * WORDS + warp] = acc_word;
          und_bits[nxt * WORDS + warp] = und_word;
        }
        cur = nxt;
        if (!__syncthreads_or(und)) break;
      }
      if (valid) out[gi] = acc ? 1 : 0;
    } else if (valid) {
      out[gi] = 0;
    }
    __syncthreads();  // block bi is final before any later block reads it
  }
}

template <typename T>
cudaError_t launch(const T* planes, const uint8_t* analyze, int64_t n, T sq,
                   const int32_t* pair_ptr, const int32_t* pair_bj,
                   int32_t n_blocks, uint8_t* out, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      poisson_range_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  poisson_range_kernel<T><<<1, BLOCK, smem, stream>>>(
      planes, analyze, n, sq, pair_ptr, pair_bj, n_blocks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int poisson_block_size() { return BLOCK; }

// Returns cudaGetLastError() after the launch (0 = launched). The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
int poisson_accept_mask_f64(const double* planes, const uint8_t* analyze,
                            int64_t n, double sq, const int32_t* pair_ptr,
                            const int32_t* pair_bj, int32_t n_blocks,
                            uint8_t* out, void* stream) {
  return static_cast<int>(launch<double>(
      planes, analyze, n, sq, pair_ptr, pair_bj, n_blocks, out,
      static_cast<cudaStream_t>(stream)));
}

int poisson_accept_mask_f32(const float* planes, const uint8_t* analyze,
                            int64_t n, float sq, const int32_t* pair_ptr,
                            const int32_t* pair_bj, int32_t n_blocks,
                            uint8_t* out, void* stream) {
  return static_cast<int>(launch<float>(
      planes, analyze, n, sq, pair_ptr, pair_bj, n_blocks, out,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
