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
// one or two launches of the prep (below), not by a chain of torch ops.
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
// unmasked planes, widened to double, NaN kept as torch.amin / amax keep
// it; the cross-pair CSR with the same pairs in the same order (bj < bi,
// ascending bj within a row; lo = min - s and hi = max + s rounded in
// double, the same <= and >= tests); n_cross and the gate flag (n_cross +
// nb > MAX_PAIRS_PER_BLOCK * nb). It also zeroes what the range's kernels
// expect zeroed: phase B's state bytes, ready flags and tickets.
//
// Bound: 24 bytes in per point (positions, f64), 3 coordinates out and 4
// bytes per pair: 0.0038 ms at `uniform_262144` (512 blocks), 0.079 ms at
// the 10M main path's 5.49M-point root. What held the first design (a
// launch for the blocks, then one CTA per row testing every earlier block
// twice, its start by a look-back that one thread walked a row at a time)
// was the second launch at the main path's ranges (8-512 blocks, most of
// them 33-200, where the data moves in about a microsecond) and, at the
// root, nb^2 box tests and a look-back chain over 10,723 rows. This design:
//
//   * A range of at most PREP_ONE_LAUNCH = BLOCK blocks (every range of
//     md_10M's node recursion, 459 of md_30M's 537) is one launch,
//     prep_one_kernel: each CTA takes its block by ticket, writes its
//     planes, box and zeroes, publishes the box, then builds its row of
//     the pair CSR at once: thread j waits for box j (an earlier ticket, so
//     a running CTA that publishes without waiting) and tests it, and the
//     row's start comes from a look-back whose warp reads 32 rows' status
//     words at a time. Flags and status words carry the launch's epoch, so
//     no launch clears them. Tried and measured (PERF.md §6): the
//     last CTA to finish building the whole CSR alone (lost to the two
//     launches above 100 blocks), and this kernel looping over larger
//     ranges (lost above 512 blocks).
//   * A larger range (the finalize's upper levels, the root) keeps two
//     launches, both with the same epoch-tagged look-back. The first,
//     prep_blocks_kernel, does the blocks. Below the wrapper's
//     PREP_GROUPED_FROM = 3,200 blocks the second is prep_rows_kernel, the
//     first design's CTA a row testing every earlier block, now without
//     its look-back chain and its zeroing pass: faster than it at every
//     size measured (768-8,192 blocks, PERF.md section 6). From there the
//     first launch also writes a union box per GROUP consecutive blocks
//     (by the group's last CTA, by a ticket); blocks are in Morton order,
//     so a group is spatially compact. The second, prep_pairs_kernel,
//     gives one CTA of 8 warps a tile of TILE = 8 rows by ticket, a warp
//     a row; a row tests the group boxes first and the member blocks only
//     of a group whose box meets, in ascending order, keeps its pairs in
//     shared memory for the fill, and the look-back runs over tiles. Its
//     chain of dependent loads a row lost to the CTA a row below about
//     3,100 blocks; 32-row tiles (1,024-thread CTAs, 32 of them at 1,024
//     blocks) were slower still there.
// pair_bj holds `cap` entries, the gate's capacity: no entry is written at
// or past it, and a row whose end passes it writes none (the gate has
// tripped). head[0] is the gate flag, head[1] n_cross.

constexpr int PREP_ONE_LAUNCH = 512;  // blocks a range takes in one launch
static_assert(PREP_ONE_LAUNCH <= BLOCK, "one thread a block of a row");
constexpr int GROUP = 32;             // blocks per group box (a warp's lanes)
constexpr int TILE = 8;               // rows per CTA of prep_pairs_kernel
constexpr int PAIR_THREADS = 32 * TILE;  // a warp a row
constexpr int ROW_KEEP = 256;         // a row's pairs kept from its count
constexpr int ROWS_THREADS = 256;     // threads of prep_rows_kernel's CTA
// A status word of the look-back: its state in bits 62-63, the launch's
// epoch in bits 46-61, a count or prefix in bits 0-45 (a range of at most
// PREP_MAX_BLOCKS blocks has fewer pairs than 2^46).
constexpr unsigned long long SCAN_AGGREGATE = 1ull << 62;
constexpr unsigned long long SCAN_PREFIX = 2ull << 62;
constexpr unsigned long long SCAN_STATE = 3ull << 62;
constexpr int SCAN_TAG_SHIFT = 46;
constexpr unsigned long long SCAN_VALUE = (1ull << SCAN_TAG_SHIFT) - 1;
constexpr unsigned long long SCAN_TAG = ~(SCAN_STATE | SCAN_VALUE);
constexpr int PREP_EPOCHS = 1 << 16;  // epochs 1 .. PREP_EPOCHS - 1
constexpr int64_t PREP_MAX_BLOCKS = 1 << 23;

// min / max that keep a NaN, as torch.amin / amax do
__device__ __forceinline__ double nan_min(double a, double b) {
  return a != a ? a : (b != b || b < a ? b : a);
}
__device__ __forceinline__ double nan_max(double a, double b) {
  return a != a ? a : (b != b || b > a ? b : a);
}

// Block b of a range: its planes (x = NaN where not analyzed), its box
// (min x, y, z then max x, y, z, nb apart; also into row[6]) and the
// zeroes of phase B's state bytes, ready flag and ticket. Every thread of
// the CTA calls it; the box is fenced before it returns.
template <typename T>
__device__ void block_work(const double* __restrict__ pos,
                           const uint8_t* __restrict__ analyze, int64_t n,
                           int32_t nb, int32_t b, T* __restrict__ planes,
                           double* box, uint8_t* __restrict__ state,
                           int32_t* __restrict__ flags,
                           int32_t* __restrict__ tickets, double* row) {
  __shared__ double part[2][3][BLOCK / 32];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
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
    row[i] = m;
    row[3 + i] = x;
    __threadfence();  // the box before it is published
  }
  if (i == 0) {
    flags[b] = 0;
    tickets[b] = 0;
  }
  __syncthreads();
}

// The start of a row's pairs by a single-pass scan with decoupled
// look-back, warp 0 of the row's CTA: it publishes the row's count at once,
// then reads the status words of up to 32 earlier rows at a time, sums the
// counts back to the nearest inclusive prefix, and publishes its own. Rows
// (or tiles of rows) are taken in ascending ticket order, so every row it
// waits on is held by a running CTA that publishes without waiting: no
// deadlock. A word counts once it holds the launch's `tag` (its epoch <<
// SCAN_TAG_SHIFT): words of earlier launches are read as unpublished, so
// no launch clears them. Returns the row's start (exclusive prefix) in
// every lane.
__device__ long long look_back(unsigned long long* scan, int32_t r,
                               long long count, unsigned long long tag,
                               int lane) {
  using ref = cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>;
  long long start = 0;
  if (r > 0) {
    if (lane == 0) {
      ref(scan[r]).store(SCAN_AGGREGATE | tag |
                             static_cast<unsigned long long>(count),
                         cuda::memory_order_relaxed);
    }
    for (int32_t top = r - 1;;) {
      const int32_t j = top - lane;
      // before row 0: a prefix of 0
      unsigned long long v =
          j >= 0 ? ref(scan[j]).load(cuda::memory_order_relaxed)
                 : SCAN_PREFIX | tag;
      if ((v & SCAN_TAG) != tag) v = 0ull;  // another launch's word
      const unsigned prefix =
          __ballot_sync(0xffffffffu, (v & SCAN_STATE) == SCAN_PREFIX);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      const unsigned upto = (2u << stop) - 1u;  // lanes 0 .. stop
      if (__ballot_sync(0xffffffffu, (v & SCAN_STATE) == 0ull) & upto) {
        __nanosleep(32);
        continue;  // a row not yet published: read the window again
      }
      long long sum =
          lane <= stop ? static_cast<long long>(v & SCAN_VALUE) : 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      start += sum;
      if (prefix) break;
      top -= 32;
    }
  }
  if (lane == 0) {
    ref(scan[r]).store(SCAN_PREFIX | tag |
                           static_cast<unsigned long long>(start + count),
                       cuda::memory_order_relaxed);
  }
  return start;
}

// The CTA's place in a launch, by ticket, in thread 0: the CTA that takes
// the last of `last + 1` tickets sets the counter back to 0 for the
// workspace's next range (every CTA has taken its ticket by then).
__device__ __forceinline__ int32_t take_ticket(int32_t* ticket,
                                               int32_t last) {
  const int32_t t = atomicAdd(ticket, 1);
  if (t == last) *ticket = 0;
  return t;
}

// A range of at most PREP_ONE_LAUNCH blocks in one launch: each CTA takes
// block b by ticket, does its block, publishes its box (ready[b] = epoch),
// then builds row b of the pair CSR: thread j < b waits for box j and
// tests it, and the row's count, start (look_back over `scan`) and pairs
// follow, in ascending j. Row nb - 1 writes the gate. `epoch` differs from
// every value ready and scan hold from earlier launches (the wrapper's
// count of the workspace's launches, on buffers zeroed where it allocates
// them), so nothing is cleared.
template <typename T>
__global__ void __launch_bounds__(BLOCK, 4)  // 32 registers: 4 CTAs a SM
prep_one_kernel(const double* __restrict__ pos,
                const uint8_t* __restrict__ analyze, int64_t n, int32_t nb,
                T* __restrict__ planes, double* box,
                int32_t* ticket,             // 1, zero on entry
                int32_t* ready,              // nb
                unsigned long long* scan,    // nb
                int32_t epoch,               // 1 .. PREP_EPOCHS - 1
                uint8_t* __restrict__ state, int32_t* __restrict__ flags,
                int32_t* __restrict__ tickets, double s, int64_t cap,
                int32_t* __restrict__ pair_ptr,
                int32_t* __restrict__ pair_bj, int64_t* __restrict__ head) {
  using ref = cuda::atomic_ref<int32_t, cuda::thread_scope_device>;
  __shared__ int32_t s_b;
  __shared__ double s_row[6];
  __shared__ int32_t s_warp[BLOCK / 32];
  __shared__ long long s_start;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  if (i == 0) s_b = take_ticket(ticket, nb - 1);
  __syncthreads();
  const int32_t b = s_b;
  block_work<T>(pos, analyze, n, nb, b, planes, box, state, flags, tickets,
                s_row);
  if (i == 0) ref(ready[b]).store(epoch, cuda::memory_order_release);

  // row b: thread j < b tests block j's box against b's inflated one
  // (PREP_ONE_LAUNCH <= BLOCK: one thread a block)
  bool m = false;
  if (i < b) {
    ref flag(ready[i]);
    while (flag.load(cuda::memory_order_acquire) != epoch) __nanosleep(64);
    m = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      m = m && __dsub_rn(s_row[a], s) <= __ldcg(&box[(3 + a) * nb + i]) &&
          __dadd_rn(s_row[3 + a], s) >= __ldcg(&box[a * nb + i]);
    }
  }
  const unsigned bal = __ballot_sync(0xffffffffu, m);
  if (lane == 0) s_warp[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    long long c = lane < BLOCK / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    const long long start = look_back(
        scan, b, c, static_cast<unsigned long long>(epoch) << SCAN_TAG_SHIFT,
        lane);
    if (lane == 0) {
      const long long end = start + c;
      pair_ptr[b + 1] = static_cast<int32_t>(min(end, 2147483647LL));
      if (b == 0) pair_ptr[0] = 0;
      if (b == nb - 1) {
        head[0] = end > cap ? 1 : 0;
        head[1] = end;
      }
      s_start = end > cap ? -1 : start;  // -1: past the gate, write nothing
    }
  }
  __syncthreads();
  if (s_start >= 0 && m) {  // the row's pairs, in ascending j
    long long at = s_start + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) at += s_warp[w];
    pair_bj[at] = i;
  }
}

// Row r's pairs, one warp: every j < r whose box meets r's box inflated by
// s, in ascending j. It tests 32 group boxes at a time, then the members of
// each group whose box meets. Each pair goes to out[at + its place] where
// that place is below `room`; returns the row's count.
__device__ int row_pairs(int32_t r, const double* __restrict__ box, int nb,
                         const double* __restrict__ gbox, int ng, double s,
                         int32_t* out, long long at, long long room,
                         int lane) {
  double lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = __dsub_rn(box[a * nb + r], s);
    hi[a] = __dadd_rn(box[(3 + a) * nb + r], s);
  }
  int cnt = 0;
  const int32_t last_group = r / GROUP;
  for (int32_t g0 = 0; g0 <= last_group; g0 += 32) {
    const int32_t g = g0 + lane;
    bool gm = g <= last_group;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      gm = gm && lo[a] <= gbox[(3 + a) * ng + g] && hi[a] >= gbox[a * ng + g];
    }
    unsigned groups = __ballot_sync(0xffffffffu, gm);
    while (groups) {
      const int32_t j = (g0 + __ffs(groups) - 1) * GROUP + lane;
      groups &= groups - 1;
      bool m = j < r;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        m = m && lo[a] <= box[(3 + a) * nb + j] && hi[a] >= box[a * nb + j];
      }
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      const int place = cnt + __popc(bal & ((1u << lane) - 1u));
      if (m && place < room) out[at + place] = j;
      cnt += __popc(bal);
    }
  }
  return cnt;
}

// The first launch of a larger range: one CTA a block (block_work), and,
// when gbox is not null, each group's last CTA (by the group's ticket)
// writes the group's union box.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
prep_blocks_kernel(const double* __restrict__ pos,
                   const uint8_t* __restrict__ analyze, int64_t n,
                   int32_t nb, T* __restrict__ planes, double* box,
                   double* __restrict__ gbox,
                   int32_t* gcount,  // ng, zero on entry
                   uint8_t* __restrict__ state, int32_t* __restrict__ flags,
                   int32_t* __restrict__ tickets) {
  __shared__ double s_row[6];
  __shared__ int s_last;
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int32_t b = blockIdx.x;
  block_work<T>(pos, analyze, n, nb, b, planes, box, state, flags, tickets,
                s_row);
  if (gbox == nullptr) return;
  const int32_t g = b / GROUP;
  if (i == 0) {
    const int32_t last = min(GROUP, nb - g * GROUP) - 1;
    s_last = take_ticket(&gcount[g], last) == last;
  }
  __syncthreads();
  if (!s_last || i >= 32) return;
  // the group's last CTA, one warp: lane l holds member g * GROUP + l
  __threadfence();
  const double inf = __longlong_as_double(0x7ff0000000000000LL);
  const int32_t ng = (nb + GROUP - 1) / GROUP;
  const int32_t j = g * GROUP + lane;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const bool is_max = a >= 3;
    double v = j < nb ? __ldcg(&box[a * nb + j]) : (is_max ? -inf : inf);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const double o = __shfl_xor_sync(0xffffffffu, v, off);
      v = is_max ? fmax(v, o) : fmin(v, o);  // a NaN is left out
    }
    if (lane == 0) gbox[a * ng + g] = v;
  }
}

// The pair CSR of a range of more than PREP_ONE_LAUNCH and fewer than
// the wrapper's PREP_GROUPED_FROM blocks, after prep_blocks_kernel
// without group boxes: one CTA a row, rows taken in ascending ticket
// order; it tests every earlier block (a few chunks of ROWS_THREADS at
// these sizes), counts the row, gets its start by look_back over rows,
// then tests the row again and writes its pairs. The last row writes the
// gate.
__global__ void __launch_bounds__(ROWS_THREADS)
prep_rows_kernel(const double* __restrict__ box, int32_t nb, double s,
                 int64_t cap, int32_t* __restrict__ pair_ptr,
                 int32_t* __restrict__ pair_bj,
                 unsigned long long* scan,  // nb
                 int32_t* ticket,           // 1, zero on entry
                 int32_t epoch,             // 1 .. PREP_EPOCHS - 1
                 int64_t* __restrict__ head) {
  constexpr int WARPS = ROWS_THREADS / 32;
  __shared__ int32_t s_r;
  __shared__ int32_t s_sum[WARPS];
  __shared__ long long s_start;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_r = take_ticket(ticket, nb - 1);
  __syncthreads();
  const int32_t r = s_r;
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
  int cnt = 0;
  for (int32_t j0 = 0; j0 < r; j0 += ROWS_THREADS) cnt += meets(j0 + t);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0) s_sum[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    long long c = 0;
    for (int w = 0; w < WARPS; ++w) c += s_sum[w];
    const long long start = look_back(
        scan, r, c, static_cast<unsigned long long>(epoch) << SCAN_TAG_SHIFT,
        lane);
    if (lane == 0) {
      const long long end = start + c;
      pair_ptr[r + 1] = static_cast<int32_t>(min(end, 2147483647LL));
      if (r == 0) pair_ptr[0] = 0;
      if (r == nb - 1) {
        head[0] = end > cap ? 1 : 0;
        head[1] = end;
      }
      s_start = end > cap ? -1 : start;  // -1: past the gate, write nothing
    }
  }
  __syncthreads();

  // the row's pairs, in ascending j
  long long base = s_start;
  if (base < 0) return;
  for (int32_t j0 = 0; j0 < r; j0 += ROWS_THREADS) {
    const bool m = meets(j0 + t);
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_sum[warp] = __popc(bal);
    __syncthreads();
    long long at = base;
    long long chunk = 0;
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? s_sum[w] : 0;
      chunk += s_sum[w];
    }
    if (m) pair_bj[at + __popc(bal & ((1u << lane) - 1u))] = j0 + t;
    base += chunk;
    __syncthreads();  // before the next chunk overwrites s_sum
  }
}

// The pair CSR of a range of at least PREP_GROUPED_FROM blocks, after
// prep_blocks_kernel: one CTA a tile of TILE rows, a warp a row, tiles
// taken in ascending ticket order. Each warp counts its row and keeps up
// to ROW_KEEP of its pairs in shared memory; warp 0 scans the tile and
// gets the tile's start by look_back over tiles; then each warp writes
// its pairs, from shared memory, or by testing its row again when it had
// more. The last tile writes the gate.
__global__ void __launch_bounds__(PAIR_THREADS)
prep_pairs_kernel(const double* __restrict__ box,
                  const double* __restrict__ gbox, int32_t nb, double s,
                  int64_t cap, int32_t* __restrict__ pair_ptr,
                  int32_t* __restrict__ pair_bj,
                  unsigned long long* scan,  // ceil(nb / TILE)
                  int32_t* ticket,           // 1, zero on entry
                  int32_t epoch,             // 1 .. PREP_EPOCHS - 1
                  int64_t* __restrict__ head) {
  __shared__ int32_t s_tile;
  __shared__ int32_t s_cnt[TILE];
  __shared__ long long s_at[TILE];
  __shared__ int32_t s_keep[TILE][ROW_KEEP];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int32_t ng = (nb + GROUP - 1) / GROUP;
  if (t == 0) s_tile = take_ticket(ticket, (nb - 1) / TILE);
  __syncthreads();
  const int32_t tile = s_tile;
  const int32_t r0 = tile * TILE;
  const int rows = min(TILE, nb - r0);
  if (warp < rows) {
    const int c = row_pairs(r0 + warp, box, nb, gbox, ng, s, s_keep[warp],
                            0, ROW_KEEP, lane);
    if (lane == 0) s_cnt[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const long long c = lane < rows ? s_cnt[lane] : 0;
    long long incl = c;
#pragma unroll
    for (int off = 1; off < TILE; off <<= 1) {
      const long long o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const long long total = __shfl_sync(0xffffffffu, incl, TILE - 1);
    const long long start = look_back(
        scan, tile, total,
        static_cast<unsigned long long>(epoch) << SCAN_TAG_SHIFT, lane);
    if (lane == 0) {
      if (tile == 0) pair_ptr[0] = 0;
      if (r0 + rows == nb) {
        head[0] = start + total > cap ? 1 : 0;
        head[1] = start + total;
      }
    }
    if (lane < rows) {
      const long long end = start + incl;
      pair_ptr[r0 + lane + 1] = static_cast<int32_t>(min(end, 2147483647LL));
      s_at[lane] = end > cap ? -1 : end - c;  // -1: past the gate
    }
  }
  __syncthreads();
  if (warp < rows && s_at[warp] >= 0) {
    const int c = s_cnt[warp];
    if (c <= ROW_KEEP) {
      for (int k = lane; k < c; k += 32) {
        pair_bj[s_at[warp] + k] = s_keep[warp][k];
      }
    } else {
      row_pairs(r0 + warp, box, nb, gbox, ng, s, pair_bj, s_at[warp], c,
                lane);
    }
  }
}

template <typename T>
int prep_one(const double* pos, const uint8_t* analyze, int64_t n,
             T* planes, double* box, int32_t* ready,
             unsigned long long* status, int32_t epoch, uint8_t* state,
             int32_t* flags, int32_t* tickets, double s, int64_t cap,
             int32_t* pair_ptr, int32_t* pair_bj, int64_t* head,
             void* stream) {
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  if (nb <= 0) return 0;
  if (nb > PREP_ONE_LAUNCH || epoch <= 0 || epoch >= PREP_EPOCHS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prep_one_kernel<T><<<static_cast<unsigned>(nb), BLOCK, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos, analyze, n, static_cast<int32_t>(nb), planes, box, ready,
      ready + 1, status, epoch, state, flags, tickets, s, cap, pair_ptr,
      pair_bj, head);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prep_blocks(const double* pos, const uint8_t* analyze, int64_t n,
                T* planes, double* box, double* gbox, int32_t* gcount,
                uint8_t* state, int32_t* flags, int32_t* tickets,
                void* stream) {
  const int64_t nb = (n + BLOCK - 1) / BLOCK;
  if (nb <= 0) return 0;
  if (nb > PREP_MAX_BLOCKS) return static_cast<int>(cudaErrorInvalidValue);
  prep_blocks_kernel<T><<<static_cast<unsigned>(nb), BLOCK, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      pos, analyze, n, static_cast<int32_t>(nb), planes, box, gbox, gcount,
      state, flags, tickets);
  return static_cast<int>(cudaGetLastError());
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

// The prep of one range of n points (nb = ceil(n / BLOCK) blocks): when
// nb <= poisson_prep_one_launch(), poisson_prep_one_*; otherwise
// poisson_prep_blocks_*, then poisson_prep_rows (gbox and gcount null) or,
// from the wrapper's PREP_GROUPED_FROM blocks, poisson_prep_pairs, on the
// same stream. box
// holds 6 nb doubles. Both take ready (1 + nb int32: the ticket, 0 on
// entry and when the launch ends, then the one launch's ready flags),
// status (nb look-back words) and `epoch`, 1 .. poisson_prep_epochs() -
// 1, which no flag or word holds from an earlier launch (buffers zeroed
// when made; a count of the launches on them, started again over zeroed
// buffers when it wraps). The two also take gbox (6 ng doubles, any
// content) and gcount (ng int32, ng = ceil(nb / poisson_prep_group()), 0
// on entry and when the launch ends). `cap` is pair_bj's capacity,
// MAX_PAIRS_PER_BLOCK * nb - nb.

int poisson_prep_one_launch() { return PREP_ONE_LAUNCH; }
int poisson_prep_group() { return GROUP; }
int poisson_prep_epochs() { return PREP_EPOCHS; }

int poisson_prep_one_f64(const double* pos, const uint8_t* analyze,
                         int64_t n, double* planes, double* box,
                         int32_t* ready, unsigned long long* status,
                         int32_t epoch, uint8_t* state, int32_t* flags,
                         int32_t* tickets,
                         double s, int64_t cap, int32_t* pair_ptr,
                         int32_t* pair_bj, int64_t* head, void* stream) {
  return prep_one<double>(pos, analyze, n, planes, box, ready, status,
                          epoch, state, flags, tickets, s, cap, pair_ptr,
                          pair_bj, head, stream);
}

int poisson_prep_one_f32(const double* pos, const uint8_t* analyze,
                         int64_t n, float* planes, double* box,
                         int32_t* ready, unsigned long long* status,
                         int32_t epoch, uint8_t* state, int32_t* flags,
                         int32_t* tickets,
                         double s, int64_t cap, int32_t* pair_ptr,
                         int32_t* pair_bj, int64_t* head, void* stream) {
  return prep_one<float>(pos, analyze, n, planes, box, ready, status, epoch,
                         state, flags, tickets, s, cap, pair_ptr, pair_bj,
                         head, stream);
}

int poisson_prep_blocks_f64(const double* pos, const uint8_t* analyze,
                            int64_t n, double* planes, double* box,
                            double* gbox, int32_t* gcount, uint8_t* state,
                            int32_t* flags, int32_t* tickets, void* stream) {
  return prep_blocks<double>(pos, analyze, n, planes, box, gbox, gcount,
                             state, flags, tickets, stream);
}

int poisson_prep_blocks_f32(const double* pos, const uint8_t* analyze,
                            int64_t n, float* planes, double* box,
                            double* gbox, int32_t* gcount, uint8_t* state,
                            int32_t* flags, int32_t* tickets, void* stream) {
  return prep_blocks<float>(pos, analyze, n, planes, box, gbox, gcount,
                            state, flags, tickets, stream);
}

int poisson_prep_pairs(const double* box, const double* gbox, int32_t nb,
                       double s, int64_t cap, int32_t* pair_ptr,
                       int32_t* pair_bj, int32_t* ready,
                       unsigned long long* status, int32_t epoch,
                       int64_t* head, void* stream) {
  if (nb <= 0) return 0;
  if (nb > PREP_MAX_BLOCKS || epoch <= 0 || epoch >= PREP_EPOCHS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prep_pairs_kernel<<<(nb + TILE - 1) / TILE, PAIR_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      box, gbox, nb, s, cap, pair_ptr, pair_bj, status, ready, epoch, head);
  return static_cast<int>(cudaGetLastError());
}

int poisson_prep_rows(const double* box, int32_t nb, double s, int64_t cap,
                      int32_t* pair_ptr, int32_t* pair_bj, int32_t* ready,
                      unsigned long long* status, int32_t epoch,
                      int64_t* head, void* stream) {
  if (nb <= 0) return 0;
  if (nb > PREP_MAX_BLOCKS || epoch <= 0 || epoch >= PREP_EPOCHS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prep_rows_kernel<<<nb, ROWS_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      box, nb, s, cap, pair_ptr, pair_bj, status, ready, epoch, head);
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
