// The grid samplers' level-synchronous octree sweep (X2) on an NVIDIA
// Hopper card (built for sm_90a): per point of a Morton-sorted fresh range,
// the octree level of the node that keeps it, under RANDOM_GRID,
// GRID_CENTER or JITTERED.
//
// Replaces the XLA program schwarzwald_tpu/ops/device_tiling.py
// `octree_select_grid` (:246), which has no Pallas kernel; the port ran it
// as ~55 torch ops a level (ops/device_tiling.py `octree_select_grid_torch`,
// its plain version here). Semantics, level by level over a static plan
// (ops/device_tiling.py `level_plan`, made on the host from the candidate
// levels and the JITTERED configs alone):
//   * a node cell is the key's top node_level + 1 octant digits (one cell
//     when that is <= 0); in_node is its count of still-remaining points;
//   * in_node <= max_points: every remaining point of the node is taken;
//   * otherwise the pick of its pick cell: the first remaining point
//     (RANDOM_GRID, and the cand == -1 root case over the node cell), the
//     remaining point nearest the cell's centre (GRID_CENTER) or nearest the
//     permutation-table target (JITTERED); ties go to the lowest index;
//   * a selected point gets node_level + 2; a terminal level takes every
//     remaining point. Levels the plan does not hold (re-rooting depths)
//     leave their points at 0 for the host.
// f64 geometry in the plain version's order: the node bounds by iterative
// halving, half = (max - min) / 2, min = min + bit * half, max = min + half;
// distances ((dx*dx + dy*dy) + dz*dz); the build passes -fmad=false so no
// multiply and add fuse. Each distance equals the host engine's bit for bit.
//
// Bound: memory. The function reads each 8-byte key once (and 24 bytes of
// positions for the distance samplers) and writes one level byte: 9 or 33
// bytes a point, 36 / 133 MB at 4M points, 0.011 / 0.040 ms at 3.35 TB/s.
// The distances are ~100-300 f64 operations a point per level, below the
// byte time at 34 TFLOP/s. The plain version rereads the keys and several
// n-sized temporaries about ten times a level through generic scans.
//
// Design. Nothing comes back to the host: the whole plan is enqueued on the
// caller's stream in one call (init, then two launches a level for
// RANDOM_GRID and three for the distance samplers), and a level with no
// remaining point left returns at once (a flag per level on the card).
//   * Cell heads without scans: the keys are sorted, so point i heads its
//     cell iff its cell prefix differs from point i-1's. In a warp (32
//     consecutive points) a lane's head is the nearest head lane at or left
//     of it (a ballot); only when lane 0 heads nothing does it binary-search
//     the sorted keys for its cell's start, once per warp.
//   * Per-cell results by atomics into scratch indexed by the head: the
//     remaining count (atomicAdd), the first remaining index (atomicMin),
//     the least distance (atomicMin over the bits of a non-negative double,
//     which order as uint64), then in a second launch the least index among
//     the points at that distance. A warp first reduces each run of lanes
//     of one cell with shuffles, so a cell takes one atomic per warp. Min
//     and sum do not depend on order, so the result is deterministic.
//   * Scratch in two sets, level k using set k & 1: the decide launch of
//     level k resets set (k + 1) & 1 at the heads of level k + 1 (the only
//     entries that level touches), while nothing of level k reads it; the
//     init launch resets set 0 at the heads of the first level. So scratch
//     needs no clearing pass and may start as any bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NONE = 0xffffffffu;
constexpr uint64_t FAR = 0xffffffffffffffffull;
constexpr int MAX_PERM = 64;

enum Pick : int { FIRST = 0, CENTER = 1, JITTER = 2 };

// One level of the plan (ops/device_tiling.py `level_plan`, packed by
// `_pack_plan` as LEVEL_INTS int32 values).
struct Level {
  int node_level;   // selected points get node_level + 2
  int terminal;     // 1: every remaining point takes the level
  int node_groups;  // octant digits of the node cell (<= 0: one cell)
  int pick_groups;  // octant digits of the pick cell (<= 0: one cell)
  int pick;         // FIRST, CENTER or JITTER
  int depth;        // CENTER: the cell's depth; JITTER: the node's
  int levels;       // JITTER: digits of the jitter grid below the node
  int actual;       // JITTER: grid cells per axis
  int plen;         // JITTER: permutation length
  uint8_t perm[3][MAX_PERM];
};
constexpr int LEVEL_INTS = 9 + 3 * MAX_PERM;

struct Bounds {
  double min[3];
  double max[3];
};

// One scratch set: per cell head, the remaining count, the picked index
// and (distance samplers) the least distance's bits.
struct Set {
  uint32_t* count;
  uint32_t* index;
  uint64_t* dist;
};

__device__ __forceinline__ int shift_of(int groups) {
  return 63 - 3 * groups;
}

__device__ __forceinline__ bool heads(const uint64_t* key, int64_t i,
                                      int groups) {
  if (i == 0) return true;
  if (groups <= 0) return false;
  const int s = shift_of(groups);
  return (key[i] >> s) != (key[i - 1] >> s);
}

// The first index j <= i whose key has the cell prefix of key[i].
__device__ uint32_t cell_start(const uint64_t* key, int64_t i, int s) {
  const uint64_t c = key[i] >> s;
  int64_t lo = 0, hi = i;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if ((key[mid] >> s) < c) lo = mid + 1; else hi = mid;
  }
  return static_cast<uint32_t>(lo);
}

// Every lane of the warp calls this with its own i (i0 + lane, valid or
// not) and key k: the head of its cell of `groups` digits (NONE past n).
__device__ uint32_t warp_head(const uint64_t* key, int64_t i, int64_t n,
                              uint64_t k, int groups, int lane) {
  const bool valid = i < n;
  if (groups <= 0) return valid ? 0u : NONE;
  const int s = shift_of(groups);
  uint64_t prev = __shfl_up_sync(FULL, k, 1);
  if (lane == 0 && valid && i > 0) prev = key[i - 1];
  const bool head = valid && (i == 0 || (prev >> s) != (k >> s));
  const unsigned ballot = __ballot_sync(FULL, head);
  uint32_t base = 0;
  if (lane == 0 && valid && !head) base = cell_start(key, i, s);
  base = __shfl_sync(FULL, base, 0);
  if (!valid) return NONE;
  const unsigned upto = ballot & (FULL >> (31 - lane));
  if (upto == 0) return base;
  return static_cast<uint32_t>(i - lane + (31 - __clz(upto)));
}

// Runs of lanes with the same head are contiguous (sorted keys): after the
// loop the first lane of each run holds the run's sum / min.
template <typename T, bool MIN>
__device__ T run_reduce(T v, uint32_t head, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T other = __shfl_down_sync(FULL, v, off);
    const uint32_t other_head = __shfl_down_sync(FULL, head, off);
    if (lane + off < 32 && other_head == head) {
      v = MIN ? (other < v ? other : v) : v + other;
    }
  }
  return v;
}

__device__ __forceinline__ bool run_leader(uint32_t head, int lane) {
  const uint32_t left = __shfl_up_sync(FULL, head, 1);
  return head != NONE && (lane == 0 || left != head);
}

// Bit of axis a (0 x, 1 y, 2 z) at octant-descent level t.
__device__ __forceinline__ double axis_bit(uint64_t k, int t, int a) {
  return static_cast<double>((k >> (3 * (20 - t) + 2 - a)) & 1ull);
}

// The depth-`depth` node's bounds of key k, by the host's halving.
__device__ __forceinline__ void node_bounds(uint64_t k, int depth,
                                            const Bounds& b, double* mn,
                                            double* mx) {
  for (int a = 0; a < 3; ++a) {
    mn[a] = b.min[a];
    mx[a] = b.max[a];
  }
  for (int t = 0; t < depth; ++t) {
    for (int a = 0; a < 3; ++a) {
      const double half = (mx[a] - mn[a]) / 2.0;
      mn[a] = mn[a] + axis_bit(k, t, a) * half;
      mx[a] = mn[a] + half;
    }
  }
}

__device__ __forceinline__ double sq_dist(const double* p, double tx,
                                          double ty, double tz) {
  const double dx = p[0] - tx;
  const double dy = p[1] - ty;
  const double dz = p[2] - tz;
  return (dx * dx + dy * dy) + dz * dz;
}

// The squared distance of point i (key k) to its pick target, as bits.
__device__ uint64_t dist_bits(const double* pos, int64_t i, uint64_t k,
                              const Level& L, const Bounds& b) {
  double mn[3], mx[3], t[3];
  node_bounds(k, L.depth, b, mn, mx);
  if (L.pick == CENTER) {
    for (int a = 0; a < 3; ++a) t[a] = mn[a] + (mx[a] - mn[a]) / 2.0;
  } else {
    const double grid = (mx[0] - mn[0]) / static_cast<double>(L.actual);
    const double cell = grid / static_cast<double>(L.actual);
    int64_t g[3] = {0, 0, 0};
    for (int j = 0; j < L.levels; ++j) {
      const int tl = L.node_level + 1 + j;
      const int sh = L.levels - 1 - j;
      for (int a = 0; a < 3; ++a) {
        g[a] |= static_cast<int64_t>((k >> (3 * (20 - tl) + 2 - a)) & 1ull)
                << sh;
      }
    }
    const double p[3] = {
        static_cast<double>(L.perm[0][(g[1] + g[2]) % L.plen] - 1),
        static_cast<double>(L.perm[1][(g[0] + g[2]) % L.plen] - 1),
        static_cast<double>(L.perm[2][(g[0] + g[1]) % L.plen] - 1)};
    for (int a = 0; a < 3; ++a) {
      t[a] = mn[a] + (static_cast<double>(g[a]) * grid + p[a] * cell);
    }
  }
  return static_cast<uint64_t>(
      __double_as_longlong(sq_dist(pos + 3 * i, t[0], t[1], t[2])));
}

// Reset set `s` at the heads of level L (the entries L's atomics touch).
__device__ __forceinline__ void reset_heads(const uint64_t* key, int64_t i,
                                            const Level& L, Set s) {
  if (heads(key, i, L.node_groups)) s.count[i] = 0;
  if (heads(key, i, L.pick_groups)) {
    s.index[i] = NONE;
    if (s.dist != nullptr) s.dist[i] = FAR;
  }
}

__global__ void __launch_bounds__(THREADS)
init_kernel(const uint64_t* __restrict__ key, int64_t n,
            int8_t* __restrict__ out, int32_t* __restrict__ alive,
            int n_levels, int has_first, Level first, Set set0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i == 0) {
    for (int k = 0; k <= n_levels; ++k) alive[k] = (k == 0);
  }
  if (i >= n) return;
  out[i] = 0;
  if (has_first) reset_heads(key, i, first, set0);
}

// Level k, first pass: per node cell the remaining count; per pick cell
// the first remaining index (FIRST) or the least distance (CENTER,
// JITTER).
__global__ void __launch_bounds__(THREADS)
count_kernel(const uint64_t* __restrict__ key, const double* __restrict__ pos,
             int64_t n, const int8_t* __restrict__ out,
             const int32_t* __restrict__ alive, int k, Level L, Bounds b,
             Set s) {
  if (!alive[k]) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  const bool rem = valid && out[i] == 0;
  if (!__ballot_sync(FULL, rem)) return;
  const uint64_t ki = valid ? key[i] : 0;
  const uint32_t hn = warp_head(key, i, n, ki, L.node_groups, lane);
  const uint32_t count = run_reduce<uint32_t, false>(rem ? 1u : 0u, hn, lane);
  if (run_leader(hn, lane) && count) atomicAdd(s.count + hn, count);
  const uint32_t hp = L.pick_groups == L.node_groups
                          ? hn
                          : warp_head(key, i, n, ki, L.pick_groups, lane);
  const bool lead = run_leader(hp, lane);
  if (L.pick == FIRST) {
    const uint32_t first = run_reduce<uint32_t, true>(
        rem ? static_cast<uint32_t>(i) : NONE, hp, lane);
    if (lead && first != NONE) atomicMin(s.index + hp, first);
  } else {
    const uint64_t d = run_reduce<uint64_t, true>(
        rem ? dist_bits(pos, i, ki, L, b) : FAR, hp, lane);
    if (lead && d != FAR) {
      atomicMin(reinterpret_cast<unsigned long long*>(s.dist + hp),
                static_cast<unsigned long long>(d));
    }
  }
}

// Level k, second pass of the distance samplers: per pick cell the least
// index among the remaining points at the least distance.
__global__ void __launch_bounds__(THREADS)
nearest_kernel(const uint64_t* __restrict__ key,
               const double* __restrict__ pos, int64_t n,
               const int8_t* __restrict__ out,
               const int32_t* __restrict__ alive, int k, Level L, Bounds b,
               Set s) {
  if (!alive[k]) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  const bool rem = valid && out[i] == 0;
  if (!__ballot_sync(FULL, rem)) return;
  const uint64_t ki = valid ? key[i] : 0;
  const uint32_t hp = warp_head(key, i, n, ki, L.pick_groups, lane);
  const bool at_min = rem && dist_bits(pos, i, ki, L, b) == s.dist[hp];
  const uint32_t first = run_reduce<uint32_t, true>(
      at_min ? static_cast<uint32_t>(i) : NONE, hp, lane);
  if (run_leader(hp, lane) && first != NONE) atomicMin(s.index + hp, first);
}

// Level k, the decisions: a remaining point is selected when its node is
// at most max_points or it is its pick cell's pick (every remaining point
// on a terminal level). Then set (k + 1) & 1 is reset for level k + 1.
__global__ void __launch_bounds__(THREADS)
decide_kernel(const uint64_t* __restrict__ key, int64_t n,
              int8_t* __restrict__ out, int32_t* __restrict__ alive, int k,
              Level L, int64_t max_points, Set s, int has_next, Level next,
              Set next_set) {
  if (!alive[k]) return;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool valid = i < n;
  if (valid && has_next) reset_heads(key, i, next, next_set);
  const bool rem = valid && out[i] == 0;
  const int8_t level = static_cast<int8_t>(L.node_level + 2);
  if (L.terminal) {
    if (rem) out[i] = level;
    return;
  }
  if (!__ballot_sync(FULL, rem)) return;
  const uint64_t ki = valid ? key[i] : 0;
  const uint32_t hn = warp_head(key, i, n, ki, L.node_groups, lane);
  const uint32_t hp = L.pick_groups == L.node_groups
                          ? hn
                          : warp_head(key, i, n, ki, L.pick_groups, lane);
  if (!rem) return;
  if (static_cast<int64_t>(s.count[hn]) <= max_points ||
      s.index[hp] == static_cast<uint32_t>(i)) {
    out[i] = level;
  } else {
    alive[k + 1] = 1;
  }
}

Level unpack(const int32_t* v) {
  Level L;
  L.node_level = v[0];
  L.terminal = v[1];
  L.node_groups = v[2];
  L.pick_groups = v[3];
  L.pick = v[4];
  L.depth = v[5];
  L.levels = v[6];
  L.actual = v[7];
  L.plen = v[8];
  for (int a = 0; a < 3; ++a) {
    for (int j = 0; j < MAX_PERM; ++j) {
      L.perm[a][j] = static_cast<uint8_t>(v[9 + a * MAX_PERM + j]);
    }
  }
  return L;
}

}  // namespace

extern "C" {

int x2_level_ints() { return LEVEL_INTS; }

// The whole sweep of n points on `stream`, asynchronously: `plan` (host
// memory) holds n_levels levels of LEVEL_INTS int32 each; key (n,) sorted
// 63-bit keys; pos (n, 3) doubles, or null when no level picks by
// distance; out (n,) int8 levels; alive n_levels + 1 int32; count and
// index 2n uint32 each, dist 2n uint64 or null, all of any content;
// bounds the root's min then max. Writes the number of kernels launched
// to *launches and returns cudaGetLastError() after the last launch, or
// the first non-zero one (0 = every launch went out). n == 0 launches
// nothing.
int x2_sweep(const void* key, const void* pos, int64_t n, void* out,
             void* alive, void* count, void* index, void* dist,
             const int32_t* plan, int n_levels, const double* bounds,
             int64_t max_points, void* stream, int* launches) {
  *launches = 0;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t* k = static_cast<const uint64_t*>(key);
  const double* p = static_cast<const double*>(pos);
  int8_t* o = static_cast<int8_t*>(out);
  int32_t* a = static_cast<int32_t*>(alive);
  Set sets[2];
  for (int j = 0; j < 2; ++j) {
    sets[j].count = static_cast<uint32_t*>(count) + j * n;
    sets[j].index = static_cast<uint32_t*>(index) + j * n;
    sets[j].dist = dist == nullptr ? nullptr
                                   : static_cast<uint64_t*>(dist) + j * n;
  }
  Bounds b;
  for (int j = 0; j < 3; ++j) {
    b.min[j] = bounds[j];
    b.max[j] = bounds[3 + j];
  }
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  Level first = n_levels > 0 ? unpack(plan) : Level{};
  init_kernel<<<blocks, THREADS, 0, st>>>(
      k, n, o, a, n_levels, n_levels > 0 && !first.terminal, first, sets[0]);
  ++*launches;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int lv = 0; lv < n_levels; ++lv) {
    const Level L = unpack(plan + lv * LEVEL_INTS);
    const Set s = sets[lv & 1];
    if (!L.terminal) {
      count_kernel<<<blocks, THREADS, 0, st>>>(k, p, n, o, a, lv, L, b, s);
      ++*launches;
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      if (L.pick != FIRST) {
        nearest_kernel<<<blocks, THREADS, 0, st>>>(k, p, n, o, a, lv, L, b,
                                                   s);
        ++*launches;
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
    }
    const bool has_next = lv + 1 < n_levels;
    const Level next = has_next ? unpack(plan + (lv + 1) * LEVEL_INTS)
                                : Level{};
    decide_kernel<<<blocks, THREADS, 0, st>>>(
        k, n, o, a, lv, L, max_points, s, has_next && !next.terminal, next,
        sets[(lv + 1) & 1]);
    ++*launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return 0;
}

}  // extern "C"
