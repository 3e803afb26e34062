// Greedy Poisson-disk (MIN_DISTANCE) accept mask of one Morton-sorted
// range, on an NVIDIA Hopper card (built for sm_90a).
//
// Replaces the TPU kernel schwarzwald_tpu/ops/poisson_pallas.py (`_kernel`
// :135, driven by `_run` :220). Semantics (the reference's
// PoissonDiskSampling::sample_points, Sampling.h:444-465): walk the range in
// order and accept point i iff it is analyzed and no earlier ACCEPTED point
// lies at d2 < spacing^2, with d2 = (dx*dx + dy*dy) + dz*dz.
//
// Precision: T = double (the engine's mode, bit-equal to the native host
// kernel, whose squared spacing is the float32 product widened to double)
// or T = float (bit-equal to the float32 greedy oracle). Every subtraction,
// product and sum is an explicit round-to-nearest intrinsic and the build
// passes -fmad=false, so no FMA contraction changes the rounding. The
// tensor cores are not used: |p|^2 + |q|^2 - 2 p.q, or DMMA's fused
// multiply-add, rounds differently from the reference.
//
// Bounds (uniform 262,144 points in a 64-unit cube at spacing 2: 512 blocks
// of 512 points, 23.67 cross pairs per block, 4.24e6 close pairs):
//   * bytes: 3 coordinates in and one mask byte out per point, 25 B in f64,
//     6.55 MB, 0.002 ms at 3.35 TB/s;
//   * operations: the exact d2 of every close pair, 8 f64 operations each,
//     34 MFLOP, 0.001 ms at 34 TFLOP/s (f64 outside the tensor cores). The
//     AABB-pair formulation would test every pair of points in adjacent
//     blocks, 3.24e9 tests, 26 GFLOP, 0.76 ms; phase A's chunk cull skips
//     most of them, so that count is not a floor.
// The bound is the byte floor, and the kernel's time is far from it: what
// holds it is phase B's chain of waits, below, not arithmetic.
//
// Design. The range is cut into blocks of BLOCK consecutive points. The
// prep kernels below (prep_blocks_kernel, prep_pairs_kernel) build on the
// card the CSR list of cross pairs: for every block bi the earlier blocks
// bj < bi whose AABB meets bi's AABB inflated by the spacing. The work
// splits in two:
//
//   Phase A, the close pairs (close_kernel): nothing here depends on a
//   decision, so it runs on every SM, one CTA per block bi. The CTA stages
//   the planes of each listed bj, then of bi itself (the intra pair, j < i),
//   in shared memory with cp.async, double-buffered over the pairs of bi.
//   Each warp bounds one 32-point chunk of the staged block, and a thread
//   tests its point only against the chunks within reach of it on every
//   axis (the reach is the pair prune's inflated spacing, so the cull is
//   never tighter than the close test), evaluating the exact d2 there. The
//   output is, for each point, the list of its earlier close points, as a
//   CSR of point indices: a counting pass, an exclusive scan (torch.cumsum),
//   a filling pass that repeats the counting pass's arithmetic. A CSR rather
//   than per-pair close bitmasks, because the main path's ranges are sparse
//   (a few close points per point): the lists hold 4 bytes per close pair
//   where a bitmask holds 32 KB per block pair. A point that is not
//   analyzed (its x is NaN in the staged planes, so every d2 with it is NaN
//   and never < sq) is neither a source nor a target.
//
//   Phase B, the decisions (decide_kernel): one CTA decides one block. It
//   takes its block from an atomicAdd ticket, not from blockIdx, so blocks
//   are handed out in ascending order, and a CTA only ever waits on blocks
//   that CTAs already running have taken: no deadlock, whatever order the
//   hardware starts CTAs in. Before any wait, each thread puts its close
//   points of the same block into a bitmask row. It then reads the state
//   bytes (1 rejected, 2 accepted, 0 not yet) of its close points in
//   earlier blocks (phase A's lists give that set, not the AABB list) and
//   rejects its point on an accepted one; while one is unset, one thread of
//   the CTA waits with acquire loads on the ready flag of the latest such
//   block, so a waiting CTA polls with one thread. Then the block's points
//   are decided warp after warp: warp w waits on named barrier w for warp
//   w - 1, rejects on an accepted close point of an earlier warp, and
//   settles its own 32 points with ballots (reject on an accepted close
//   earlier point, accept when none is undecided; the earliest undecided
//   lane always decides, so the result is the sequential greedy one). The
//   CTA writes its mask and state bytes and publishes its ready flag with
//   a release store.
//
//   Memory: the wrapper allocates every buffer with torch.empty (the range
//   path: once per sending thread, in a workspace reused from range to
//   range, ops/poisson_cuda.py `_Workspace`). The close
//   lists are held under a budget of entries (ops/poisson_cuda.py
//   CLOSE_BUDGET). Past it, phases A and B run window by window over the
//   blocks: the decisions of one window are final before the next window's
//   phase A starts, and that phase A resolves a close point in an earlier
//   window on the spot (an accepted one rejects the point, any other is
//   dropped), so a window stores only the close pairs inside itself.
//
// What this does about the single-CTA kernel it replaces: (1) phase A fills
// every SM instead of one; (2) the distance tests left the ordered walk:
// phase B's critical path is a wait, a read of a few mask bytes and the
// relaxation rounds of one block; (3) each engine worker thread launches on
// a stream of its own (ops/poisson_cuda.py), so the ranges of one finalize
// level overlap; (4) the AABBs and the pair CSR are built on the card, by
// two launches of the prep (below) and not by a chain of torch ops.
//
// The bound of phase B is the longest dependency chain: block b waits on
// block b' only when a point of b' is close to a point of b, and the chain
// of such waits runs one CTA after another. In a sparse range Morton-adjacent
// blocks still touch, so the chain is about as long as the block count (512
// of 512 blocks at the timing case, 10,684 of 10,723 at the main path's
// root) and phase B stays a walk, now of short steps (a few microseconds
// each: the flag's visibility, the state bytes' round trip, the block's
// decisions and its stores). Scan-line data, with points closer than the
// spacing all along Morton order, makes such chains at any density: that is
// the risk this design keeps.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda/atomic>

namespace {

constexpr int BLOCK = 512;            // points per block == threads per CTA
constexpr int WORDS = BLOCK / 32;     // 32-bit words per bitmask row
constexpr int CHUNK = 32;             // points per culled chunk (a warp's)
constexpr int CHUNKS = BLOCK / CHUNK;
constexpr int BATCH = 8;              // list entries whose loads overlap

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
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(dst), "l"(gmem), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING));
}

// Phase A. One CTA per block bi of [b0, b0 + gridDim.x); thread i owns point
// gi = bi * BLOCK + i. Its work items are the listed bj of bi (ascending),
// then bi itself (j < i). Close points j < w0 (earlier windows, whose mask
// is final) are not listed: FILL resolves them against `out` instead.
//   FILL = false: counts[li] = number of listed close points (li = gi -
//                 b0 * BLOCK, every thread of the grid writes its slot);
//   FILL = true:  idx[offsets[li] ...] = the listed close points, in item
//                 order then j order; blocked[li] = 1 for a point that is
//                 not analyzed, padding, or rejected by an earlier window.
template <typename T, bool FILL>
__global__ void __launch_bounds__(BLOCK)
close_kernel(const T* __restrict__ planes,   // (3, n); x NaN = not analyzed
             int64_t n, T sq, double reach,
             const int32_t* __restrict__ pair_ptr,
             const int32_t* __restrict__ pair_bj,
             int32_t b0, int64_t w0,
             const uint8_t* __restrict__ out,      // FILL: final for j < w0
             const int64_t* __restrict__ gate,     // !FILL: nonzero = skip
             int32_t* __restrict__ counts,         // !FILL
             const int64_t* __restrict__ offsets,  // FILL
             int32_t* __restrict__ idx,            // FILL
             uint8_t* __restrict__ blocked) {      // FILL
  __shared__ __align__(16) T stage[2][3][BLOCK];
  __shared__ double box[2][3][CHUNKS];  // min / max per axis per chunk

  // the range path's pair gate (prep_pairs_kernel's head[0]): a range past
  // it goes to the host kernel, and its counting pass does nothing
  if (!FILL && gate != nullptr && *gate != 0) return;
  const int i = threadIdx.x;
  const int32_t bi = b0 + static_cast<int32_t>(blockIdx.x);
  const int64_t gi = static_cast<int64_t>(bi) * BLOCK + i;
  const int64_t li = gi - static_cast<int64_t>(b0) * BLOCK;
  const T* px = planes;
  const T* py = planes + n;
  const T* pz = planes + 2 * n;
  const bool valid = gi < n;
  T xi = T(0), yi = T(0), zi = T(0);
  if (valid) {
    xi = px[gi];
    yi = py[gi];
    zi = pz[gi];
  }
  const bool analyzed = valid && xi == xi;

  // the counting pass skips the pairs in earlier windows (nothing is listed
  // there); pair_bj is ascending within a row, so they come first
  const int32_t bw0 = static_cast<int32_t>(w0 / BLOCK);
  int32_t p_begin = pair_ptr[bi];
  const int32_t p_end = pair_ptr[bi + 1];
  if (!FILL) {
    while (p_begin < p_end && pair_bj[p_begin] < bw0) ++p_begin;
  }
  const int32_t items = p_end - p_begin + 1;  // the last item is bi itself

  auto item_block = [&](int32_t k) -> int32_t {
    return k < items - 1 ? pair_bj[p_begin + k] : bi;
  };
  auto stage_item = [&](int32_t k, int buf) {
    const int64_t gj = static_cast<int64_t>(item_block(k)) * BLOCK + i;
    if (gj < n) {
      cp_async(&stage[buf][0][i], px + gj);
      cp_async(&stage[buf][1][i], py + gj);
      cp_async(&stage[buf][2][i], pz + gj);
    } else {
      // padding of the last block: NaN is never close
      stage[buf][0][i] = stage[buf][1][i] = stage[buf][2][i] = quiet_nan<T>();
    }
    cp_async_commit();
  };

  // the cull: the point's reach per axis, in double, as the pair prune
  const double rx0 = static_cast<double>(xi) - reach;
  const double rx1 = static_cast<double>(xi) + reach;
  const double ry0 = static_cast<double>(yi) - reach;
  const double ry1 = static_cast<double>(yi) + reach;
  const double rz0 = static_cast<double>(zi) - reach;
  const double rz1 = static_cast<double>(zi) + reach;
  const int lane = i & 31;
  const int warp = i >> 5;

  int32_t cnt = 0;
  int64_t pos = FILL ? offsets[li] : 0;
  bool rej = false;
  stage_item(0, 0);
  for (int32_t k = 0; k < items; ++k) {
    const int buf = k & 1;
    if (k + 1 < items) {
      stage_item(k + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sx = stage[buf][0];
    const T* sy = stage[buf][1];
    const T* sz = stage[buf][2];
    {
      // warp w bounds chunk w of the staged block (fmin / fmax skip the
      // NaN of points that are not analyzed; an all-NaN chunk stays NaN
      // and is never near)
      T v[3] = {sx[i], sy[i], sz[i]};
      T lo[3] = {v[0], v[1], v[2]};
      T hi[3] = {v[0], v[1], v[2]};
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fmin(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
          hi[a] = fmax(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          box[0][a][warp] = static_cast<double>(lo[a]);
          box[1][a][warp] = static_cast<double>(hi[a]);
        }
      }
    }
    __syncthreads();
    const int32_t bj = item_block(k);
    const int jmax = k == items - 1 ? i : BLOCK;  // intra: j < i only
    const int64_t base_j = static_cast<int64_t>(bj) * BLOCK;
    const bool early = FILL && bj < bw0;  // an earlier window: final mask
    if (analyzed && !(early && rej)) {
      for (int c = 0; c < CHUNKS && c * CHUNK < jmax; ++c) {
        if (!(rx0 <= box[1][0][c] && rx1 >= box[0][0][c] &&
              ry0 <= box[1][1][c] && ry1 >= box[0][1][c] &&
              rz0 <= box[1][2][c] && rz1 >= box[0][2][c])) {
          continue;  // no point of the chunk within reach
        }
        const int j1 = min((c + 1) * CHUNK, jmax);
        if (early) {
          for (int j = c * CHUNK; j < j1; ++j) {
            if (dist2(xi, yi, zi, sx[j], sy[j], sz[j]) < sq &&
                out[base_j + j] != 0) {
              rej = true;
              break;
            }
          }
          if (rej) break;
        } else {
#pragma unroll 8
          for (int j = c * CHUNK; j < j1; ++j) {
            if (dist2(xi, yi, zi, sx[j], sy[j], sz[j]) < sq) {
              if (FILL) {
                idx[pos++] = static_cast<int32_t>(base_j + j);
              } else {
                ++cnt;
              }
            }
          }
        }
      }
    }
    __syncthreads();  // before the next issue overwrites this buffer
  }
  if (FILL) {
    blocked[li] = (!analyzed || rej) ? 1 : 0;
  } else {
    counts[li] = cnt;
  }
}

// Phase B. One CTA per block of [b0, b0 + gridDim.x), in ticket order.
// offsets / idx / blocked are indexed by li = gi - b0 * BLOCK; every listed
// close point lies in [b0 * BLOCK, gi).
__global__ void __launch_bounds__(BLOCK)
decide_kernel(int64_t n, int32_t b0,
              const int64_t* __restrict__ offsets,
              const int32_t* __restrict__ idx,
              const uint8_t* __restrict__ blocked,
              int32_t* ticket, int32_t* flags, uint8_t* state,
              uint8_t* out) {
  __shared__ int32_t s_block;
  __shared__ int32_t s_pending[2];  // latest pending block, per wait round
  // strict-lower rows of the block, word w of thread i at close[w][i] (so a
  // warp reading one word touches 32 banks)
  __shared__ uint32_t close[WORDS][BLOCK];
  __shared__ uint32_t acc_bits[WORDS];  // accepted points, per warp

  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  if (i == 0) {
    s_block = b0 + atomicAdd(ticket, 1);
    s_pending[0] = -1;
  }
  __syncthreads();
  const int32_t b = s_block;
  const int64_t base = static_cast<int64_t>(b) * BLOCK;
  const int64_t gi = base + i;
  const int64_t li = gi - static_cast<int64_t>(b0) * BLOCK;
  const bool valid = gi < n;
  bool und = valid && blocked[li] == 0;
  // a list holds the close points of earlier blocks first, ascending, then
  // those of this block
  const int64_t e_begin = und ? offsets[li] : 0;
  const int64_t e_end = und ? offsets[li + 1] : 0;
  int64_t e_cross = e_begin;  // the first entry of this block
  for (int64_t hi = e_end; e_cross < hi;) {
    const int64_t mid = e_cross + (hi - e_cross) / 2;
    if (idx[mid] < base) {
      e_cross = mid + 1;
    } else {
      hi = mid;
    }
  }

  // 1. the close points of this block, as a strict-lower bitmask row: it
  //    needs no other block, so it is built before any wait
  for (int w = 0; w < WORDS; ++w) close[w][i] = 0u;
  if (und) {
    for (int64_t e = e_cross; e < e_end; ++e) {
      const int l = static_cast<int>(idx[e] - base);
      close[l >> 5][i] |= 1u << (l & 31);
    }
  }

  // 2. reject on an accepted close point of an earlier block. A deciding
  //    CTA writes every point's state byte (1 rejected, 2 accepted) before
  //    it publishes its block's ready flag with a release store, and a
  //    state byte, once seen set, is final: it is the one location a reader
  //    needs, so the threads read states with relaxed loads and take no
  //    fence of their own (on this card a fence per thread cost more than
  //    it saved). Each thread reads the states of its unread entries, all
  //    loads of a batch in flight together; while one is unset, one thread
  //    of the CTA waits with acquire loads on the ready flag of the latest
  //    such block, and all read again. A waiting CTA polls with one thread,
  //    not 512, and a rejected point waits no more.
  const volatile uint8_t* vstate = state;
  int64_t e_read = e_begin;  // the entries before e_read are set
  bool settled = e_cross == e_begin;
  for (int round = 0;; round ^= 1) {
    int32_t pending = -1;  // the latest block with an unset entry
    if (!settled) {
      int64_t e_unset = e_cross;
      bool hit = false;
      for (int64_t e0 = e_read; e0 < e_cross; e0 += BATCH) {
        int32_t j[BATCH];
        uint32_t st[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) j[k] = e0 + k < e_cross ? idx[e0 + k] : -1;
#pragma unroll
        for (int k = 0; k < BATCH; ++k) st[k] = j[k] >= 0 ? vstate[j[k]] : 1u;
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          if (st[k] == 0u) {
            pending = max(pending, j[k] / BLOCK);
            e_unset = min(e_unset, e0 + k);
          }
          hit |= st[k] == 2u;
        }
      }
      e_read = e_unset;
      if (hit) {
        und = false;
        pending = -1;
      }
      settled = pending < 0;
    }
    if (i == 0) s_pending[round ^ 1] = -1;  // the next round's slot
    if (pending >= 0) atomicMax(&s_pending[round], pending);
    __syncthreads();
    const int32_t wait_for = s_pending[round];
    if (wait_for < 0) break;
    if (i == 0) {
      cuda::atomic_ref<int32_t, cuda::thread_scope_device> flag(
          flags[wait_for]);
      while (flag.load(cuda::memory_order_acquire) == 0) __nanosleep(100);
    }
    __syncthreads();
  }

  // 3. the block's decisions, warp after warp: warp w waits on named
  //    barrier w for warp w - 1, so every accepted bit of the earlier warps
  //    is final; it rejects on one of them, then settles its own 32 points
  //    with ballots (the earliest undecided lane always decides: reject on
  //    an accepted close earlier point, accept when none is undecided) and
  //    hands on to warp w + 1. The row lives in registers.
  uint32_t earlier = 0u;  // close points of earlier warps that accepted
  uint32_t own = close[warp][i];
  if (warp > 0) {
    asm volatile("bar.sync %0, %1;" :: "r"(warp), "r"(64) : "memory");
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      if (w < warp) earlier |= close[w][i] & acc_bits[w];
    }
  }
  if (earlier) und = false;
  bool acc = false;
  uint32_t acc_w = 0u;
  uint32_t und_w = __ballot_sync(0xffffffffu, und);
  while (und_w) {
    if (und) {
      if (own & acc_w) {
        und = false;          // rejected
      } else if (!(own & und_w)) {
        und = false;          // accepted
        acc = true;
      }
    }
    acc_w = __ballot_sync(0xffffffffu, acc);
    und_w = __ballot_sync(0xffffffffu, und);
  }
  if (lane == 0) acc_bits[warp] = acc_w;
  if (warp + 1 < WORDS) {
    asm volatile("bar.arrive %0, %1;" :: "r"(warp + 1), "r"(64) : "memory");
  }
  if (valid) {
    out[gi] = acc ? 1 : 0;
    reinterpret_cast<volatile uint8_t*>(state)[gi] = acc ? 2 : 1;
  }
  // the barrier orders every thread's bytes before thread 0's release store
  // (cumulative at device scope)
  __syncthreads();
  if (i == 0) {
    cuda::atomic_ref<int32_t, cuda::thread_scope_device> flag(flags[b]);
    flag.store(1, cuda::memory_order_release);
  }
}

template <typename T, bool FILL>
cudaError_t launch_close(const T* planes, int64_t n, T sq, double reach,
                         const int32_t* pair_ptr, const int32_t* pair_bj,
                         int32_t b0, int32_t b1, int64_t w0,
                         const uint8_t* out, const int64_t* gate,
                         int32_t* counts, const int64_t* offsets,
                         int32_t* idx, uint8_t* blocked,
                         cudaStream_t stream) {
  if (b1 <= b0) return cudaSuccess;
  close_kernel<T, FILL><<<b1 - b0, BLOCK, 0, stream>>>(
      planes, n, sq, reach, pair_ptr, pair_bj, b0, w0, out, gate, counts,
      offsets, idx, blocked);
  return cudaGetLastError();
}

// -- the prep of one range -------------------------------------------------
//
// Port-only: the JAX package preps a range on the host in numpy
// (schwarzwald_tpu/ops/poisson_pallas.py:62 `_prep`); there is no Pallas
// kernel to replace. Its plain version is ops/poisson_cuda.py
// `prep_torch` (pair_csr_torch and _masked), and its output equals that
// version element for element: the (3, n) planes in the mode's type with x
// = NaN at the points that are not analyzed; the per-block AABBs of the
// unmasked planes, widened to double; the cross-pair CSR with the same
// pairs in the same order (bj < bi, ascending bj within a row; lo = min - s
// and hi = max + s rounded in double, the same <= and >= tests); n_cross
// and the gate flag (n_cross + nb > MAX_PAIRS_PER_BLOCK * nb).
//
// Two launches. prep_blocks_kernel, one CTA per block: the planes, the
// block's AABB, and the zeroing of what the range's kernels expect zeroed
// (phase B's state bytes, ready flags and tickets; the pair scan's status
// words and ticket). prep_pairs_kernel, one CTA per row bi taken from a
// ticket: it tests every bj < bi (a range of nb blocks costs nb^2 / 2 box
// tests, 57M at the 5.49M-point root, all in L2), counts the row, gets the
// row's start by a single-pass scan with decoupled look-back (each row
// publishes its count at once, then its inclusive prefix; a row sums the
// counts back to the first inclusive prefix it meets; rows are taken in
// ascending ticket order, so every row it waits on is held by a running
// CTA that publishes without waiting: no deadlock), then tests the row
// again and writes its pairs in order. pair_bj holds `cap` entries, the
// gate's capacity: no entry is written at or past it, and a row whose end
// passes it writes none (the gate has tripped). The last row writes
// head[0] (the gate flag) and head[1] (n_cross).
//
// Bound: 24 bytes in per point (positions, f64), 3 coordinates out and
// 4 bytes per pair; the box tests are a few thousand per block. The
// kernels' time is launch-sized at the main path's ranges (8-200 blocks).

constexpr int PAIR_THREADS = 256;
constexpr int PAIR_WARPS = PAIR_THREADS / 32;
constexpr unsigned long long SCAN_AGGREGATE = 1ull << 62;
constexpr unsigned long long SCAN_PREFIX = 2ull << 62;
constexpr unsigned long long SCAN_VALUE = (1ull << 62) - 1;

// min / max that keep a NaN, as torch.amin / amax do
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b || b < a ? b : a);
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b || b > a ? b : a);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
prep_blocks_kernel(const double* __restrict__ pos,      // (n, 3)
                   const uint8_t* __restrict__ analyze,  // (n,) or null
                   int64_t n, int32_t nb,
                   T* __restrict__ planes,               // (3, n)
                   double* __restrict__ box,             // (6, nb)
                   unsigned long long* __restrict__ scan,
                   int32_t* __restrict__ pair_ticket,
                   uint8_t* __restrict__ state,
                   int32_t* __restrict__ flags,
                   int32_t* __restrict__ tickets) {
  __shared__ double part[2][3][BLOCK / 32];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const int32_t b = blockIdx.x;
  const int64_t gi = static_cast<int64_t>(b) * BLOCK + i;
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  double lo[3] = {inf, inf, inf};
  double hi[3] = {-inf, -inf, -inf};
  if (gi < n) {
    T v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = static_cast<T>(pos[gi * 3 + a]);
      lo[a] = hi[a] = static_cast<double>(v[a]);
    }
    planes[gi] = (analyze != nullptr && analyze[gi] == 0) ? quiet_nan<T>()
                                                          : v[0];
    planes[n + gi] = v[1];
    planes[2 * n + gi] = v[2];
    state[gi] = 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = nan_min(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = nan_max(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      part[0][a][warp] = lo[a];
      part[1][a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (i < 3) {
    double m = part[0][i][0];
    double x = part[1][i][0];
    for (int w = 1; w < BLOCK / 32; ++w) {
      m = nan_min(m, part[0][i][w]);
      x = nan_max(x, part[1][i][w]);
    }
    box[i * nb + b] = m;
    box[(3 + i) * nb + b] = x;
  }
  if (i == 0) {
    flags[b] = 0;
    tickets[b] = 0;
    scan[b] = 0ull;
    if (b == 0) *pair_ticket = 0;
  }
}

__global__ void __launch_bounds__(PAIR_THREADS)
prep_pairs_kernel(const double* __restrict__ box, int32_t nb, double s,
                  int64_t cap, int32_t* __restrict__ pair_ptr,
                  int32_t* __restrict__ pair_bj, unsigned long long* scan,
                  int32_t* pair_ticket, int64_t* __restrict__ head) {
  __shared__ int32_t s_row;
  __shared__ long long s_sum[PAIR_WARPS];
  __shared__ long long s_start;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_row = atomicAdd(pair_ticket, 1);
  __syncthreads();
  const int32_t r = s_row;
  double lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __dsub_rn(box[a * nb + r], s);
    hi[a] = __dadd_rn(box[(3 + a) * nb + r], s);
  }
  auto meets = [&](int32_t j) -> bool {
    bool m = j < r;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      m = m && lo[a] <= box[(3 + a) * nb + j] && hi[a] >= box[a * nb + j];
    }
    return m;
  };

  // the row's count
  long long cnt = 0;
  for (int32_t j0 = 0; j0 < r; j0 += PAIR_THREADS) cnt += meets(j0 + t);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) s_sum[warp] = cnt;
  __syncthreads();
  if (t == 0) {
    long long c = 0;
    for (int w = 0; w < PAIR_WARPS; ++w) c += s_sum[w];
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> mine(
        scan[r]);
    long long start = 0;
    if (r > 0) {
      mine.store(SCAN_AGGREGATE | static_cast<unsigned long long>(c),
                 cuda::memory_order_relaxed);
      for (int32_t j = r - 1;;) {
        cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> st(
            scan[j]);
        const unsigned long long v = st.load(cuda::memory_order_relaxed);
        if (v == 0ull) {
          __nanosleep(32);
          continue;
        }
        start += static_cast<long long>(v & SCAN_VALUE);
        if ((v & ~SCAN_VALUE) == SCAN_PREFIX || j == 0) break;
        --j;
      }
    }
    const long long end = start + c;
    mine.store(SCAN_PREFIX | static_cast<unsigned long long>(end),
               cuda::memory_order_relaxed);
    pair_ptr[r + 1] = static_cast<int32_t>(min(end, 2147483647LL));
    if (r == 0) pair_ptr[0] = 0;
    if (r == nb - 1) {
      head[0] = end > cap ? 1 : 0;
      head[1] = end;
    }
    s_start = end > cap ? -1 : start;  // -1: past the gate, write nothing
  }
  __syncthreads();

  // the row's pairs, in ascending bj
  long long base = s_start;
  if (base < 0) return;
  for (int32_t j0 = 0; j0 < r; j0 += PAIR_THREADS) {
    const bool m = meets(j0 + t);
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_sum[warp] = __popc(bal);
    __syncthreads();
    long long at = base;
    long long chunk = 0;
    for (int w = 0; w < PAIR_WARPS; ++w) {
      at += w < warp ? s_sum[w] : 0;
      chunk += s_sum[w];
    }
    if (m) pair_bj[at + __popc(bal & ((1u << lane) - 1u))] = j0 + t;
    base += chunk;
    __syncthreads();  // before the next chunk overwrites s_sum
  }
}

template <typename T>
cudaError_t launch_prep_blocks(const double* pos, const uint8_t* analyze,
                               int64_t n, T* planes, double* box,
                               unsigned long long* scan,
                               int32_t* pair_ticket, uint8_t* state,
                               int32_t* flags, int32_t* tickets,
                               cudaStream_t stream) {
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  if (nb <= 0) return cudaSuccess;
  prep_blocks_kernel<T><<<static_cast<unsigned>(nb), BLOCK, 0, stream>>>(
      pos, analyze, n, static_cast<int32_t>(nb), planes, box, scan,
      pair_ticket, state, flags, tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int poisson_block_size() { return BLOCK; }

// Each entry point launches one kernel on `stream`, asynchronously, and
// returns cudaGetLastError() after the launch (0 = launched). Nothing is
// allocated or synchronised here. `reach` is the cull's per-axis reach,
// never tighter than the close test (ops/poisson_cuda.py). `gate` (may be
// null) is the prep's head: the counting pass does nothing when head[0] is
// set.

int poisson_close_count_f64(const double* planes, int64_t n, double sq,
                            double reach, const int32_t* pair_ptr,
                            const int32_t* pair_bj, int32_t b0, int32_t b1,
                            int64_t w0, const int64_t* gate, int32_t* counts,
                            void* stream) {
  return static_cast<int>(launch_close<double, false>(
      planes, n, sq, reach, pair_ptr, pair_bj, b0, b1, w0, nullptr, gate,
      counts, nullptr, nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
}

int poisson_close_count_f32(const float* planes, int64_t n, float sq,
                            double reach, const int32_t* pair_ptr,
                            const int32_t* pair_bj, int32_t b0, int32_t b1,
                            int64_t w0, const int64_t* gate, int32_t* counts,
                            void* stream) {
  return static_cast<int>(launch_close<float, false>(
      planes, n, sq, reach, pair_ptr, pair_bj, b0, b1, w0, nullptr, gate,
      counts, nullptr, nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
}

int poisson_close_fill_f64(const double* planes, int64_t n, double sq,
                           double reach, const int32_t* pair_ptr,
                           const int32_t* pair_bj, int32_t b0, int32_t b1,
                           int64_t w0, const uint8_t* out,
                           const int64_t* offsets, int32_t* idx,
                           uint8_t* blocked, void* stream) {
  return static_cast<int>(launch_close<double, true>(
      planes, n, sq, reach, pair_ptr, pair_bj, b0, b1, w0, out, nullptr,
      nullptr, offsets, idx, blocked, static_cast<cudaStream_t>(stream)));
}

int poisson_close_fill_f32(const float* planes, int64_t n, float sq,
                           double reach, const int32_t* pair_ptr,
                           const int32_t* pair_bj, int32_t b0, int32_t b1,
                           int64_t w0, const uint8_t* out,
                           const int64_t* offsets, int32_t* idx,
                           uint8_t* blocked, void* stream) {
  return static_cast<int>(launch_close<float, true>(
      planes, n, sq, reach, pair_ptr, pair_bj, b0, b1, w0, out, nullptr,
      nullptr, offsets, idx, blocked, static_cast<cudaStream_t>(stream)));
}

int poisson_decide(int64_t n, int32_t b0, int32_t b1, const int64_t* offsets,
                   const int32_t* idx, const uint8_t* blocked,
                   int32_t* ticket, int32_t* flags, uint8_t* state,
                   uint8_t* out, void* stream) {
  if (b1 <= b0) return 0;
  decide_kernel<<<b1 - b0, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      n, b0, offsets, idx, blocked, ticket, flags, state, out);
  return static_cast<int>(cudaGetLastError());
}

// The prep of one range of n points (nb = ceil(n / BLOCK) blocks): first
// poisson_prep_blocks_*, then poisson_prep_pairs on the same stream.
// `scan` holds nb status words and `tickets` nb entries; `cap` is pair_bj's
// capacity, MAX_PAIRS_PER_BLOCK * nb - nb.

int poisson_prep_blocks_f64(const double* pos, const uint8_t* analyze,
                            int64_t n, double* planes, double* box,
                            unsigned long long* scan, int32_t* pair_ticket,
                            uint8_t* state, int32_t* flags, int32_t* tickets,
                            void* stream) {
  return static_cast<int>(launch_prep_blocks<double>(
      pos, analyze, n, planes, box, scan, pair_ticket, state, flags, tickets,
      static_cast<cudaStream_t>(stream)));
}

int poisson_prep_blocks_f32(const double* pos, const uint8_t* analyze,
                            int64_t n, float* planes, double* box,
                            unsigned long long* scan, int32_t* pair_ticket,
                            uint8_t* state, int32_t* flags, int32_t* tickets,
                            void* stream) {
  return static_cast<int>(launch_prep_blocks<float>(
      pos, analyze, n, planes, box, scan, pair_ticket, state, flags, tickets,
      static_cast<cudaStream_t>(stream)));
}

int poisson_prep_pairs(const double* box, int32_t nb, double s, int64_t cap,
                       int32_t* pair_ptr, int32_t* pair_bj,
                       unsigned long long* scan, int32_t* pair_ticket,
                       int64_t* head, void* stream) {
  if (nb <= 0) return 0;
  prep_pairs_kernel<<<nb, PAIR_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      box, nb, s, cap, pair_ptr, pair_bj, scan, pair_ticket, head);
  return static_cast<int>(cudaGetLastError());
}

// An asynchronous copy of `bytes` on `stream`: kind 1 host to device, 2
// device to host (cudaMemcpyKind). Returns the CUDA error (0 = queued).
int poisson_copy(void* dst, const void* src, int64_t bytes, int kind,
                 void* stream) {
  if (bytes <= 0) return 0;
  return static_cast<int>(cudaMemcpyAsync(
      dst, src, static_cast<size_t>(bytes), static_cast<cudaMemcpyKind>(kind),
      static_cast<cudaStream_t>(stream)));
}

// A stream of the caller's own on the current device, outside PyTorch's
// pool (32 streams per device, shared once more threads ask): one per
// sending thread however many threads send ranges. Non-blocking, so it
// never waits on the legacy default stream. Returns the CUDA error (0 =
// made); the handle goes to *stream.
int poisson_stream_create(void** stream) {
  cudaStream_t s = nullptr;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = s;
  return static_cast<int>(err);
}

}  // extern "C"
