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
// byte time at 34 TFLOP/s. The first design (an init launch, then two
// or three launches a level over all n points) paid a full pass over every
// key at each launch, about 33 us at 4M points, and a binary search of the
// sorted keys in most warps, 25-37 times a sweep.
//
// Design: one cooperative launch a sweep (cudaLaunchCooperativeKernel), its
// grid the CTAs that fit on the card at once; grid.sync() stands where the
// launch boundaries stood between a level's phases. The level plan comes in
// a device buffer of the launch (any depth; nothing module-wide), so sweeps
// may be enqueued on any stream or card while earlier ones run.
//   * Each CTA owns a fixed contiguous tile of points, in warp chunks of 32.
//     It reads its keys from device memory once and keeps on chip (shared
//     memory; a global region per CTA when the tile is too large for it)
//     what the levels need: per point the octant digits its key shares with
//     the key before (d, one byte: point i heads a cell of G digits iff
//     d[i] < G), per chunk the least d and the mask of still-remaining
//     points, and the list of chunks that still hold a remaining point, so
//     a later level touches only those. RANDOM_GRID reads no key after the
//     first pass; the distance samplers read the keys and positions of the
//     remaining points only, and keep each one's distance (pdist) for the
//     level's second phase. Each level byte is written once: at the level
//     that selects the point, or 0 at the end.
//   * Cell heads are the cells' first points, as before: within a chunk
//     a ballot of d < G; before it, per level a prefix max over the tile's
//     chunks of their last head (from the chunk minima, a few hundred
//     chunks a CTA); before the tile, per G one binary search of the keys
//     at the start.
//   * Per-cell results by atomics into scratch indexed by the head: the
//     remaining count (atomicAdd), the first remaining index (atomicMin),
//     the least distance (atomicMin over the bits of a non-negative double,
//     which order as uint64), then in a second phase the least index among
//     the points at that distance. A run of lanes of one cell in a chunk
//     takes one atomic (its count and first index from the ballot of
//     remaining lanes, its least distance by shuffles). Min and sum do not
//     depend on order, so the result is deterministic.
//   * Scratch in two sets, level k using set k & 1: the decide phase of
//     level k resets set (k + 1) & 1 at the heads of the cells that still
//     hold a remaining point (the only entries level k + 1 touches), while
//     nothing of level k reads it; the start resets set 0 for the first
//     level. So scratch needs no clearing pass and may start as any bytes.
//     Scratch written by other CTAs during the launch is read past L1.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NONE = 0xffffffffu;
constexpr uint64_t FAR = 0xffffffffffffffffull;
constexpr int MAX_PERM = 64;
constexpr int DIGITS = 22;  // cell sizes G = 0 .. 21 octant digits
constexpr int LEVEL_INTS = 9 + 3 * MAX_PERM;

enum Pick : int { FIRST = 0, CENTER = 1, JITTER = 2 };

// One level of the plan (ops/device_tiling.py `level_plan`, packed by
// `_pack_plan` as LEVEL_INTS int32 values: these nine, then the three
// permutation rows of MAX_PERM).
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
  const int32_t* perm;  // the level's three permutation rows
};

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

struct Args {
  const uint64_t* key;   // (n,) sorted, < 2^63
  const double* pos;     // (n, 3) or null
  int64_t n;
  int8_t* out;           // (n,)
  int32_t* alive;        // n_levels + 1
  Set sets[2];
  uint64_t* pdist;       // (n,): each remaining point's distance, or null
  const int32_t* plan;   // n_levels x LEVEL_INTS, on the card
  int n_levels;
  Bounds bounds;
  int64_t max_points;
  uint8_t* work;         // per-CTA regions in device memory, or null
  int32_t tile;          // points per CTA, a multiple of 32
  int32_t region;        // bytes of one CTA's region
};

// Bytes of one CTA's state for a tile of `tile` points (c = tile / 32
// chunks): the remaining masks, two chunk lists, four head arrays, the
// chunk minima, then d per point.
__host__ __device__ inline int64_t region_bytes(int64_t tile) {
  const int64_t c = tile / 32;
  return ((4 * c + 8 * c + 16 * c + c + tile) + 15) / 16 * 16;
}

// Octant digits that two keys share from the top (21 when equal): a cell
// of G digits holds both iff the result is >= G.
__device__ __forceinline__ int shared_digits(uint64_t a, uint64_t b) {
  const uint64_t x = a ^ b;
  return x == 0 ? 21 : (__clzll(static_cast<long long>(x)) - 1) / 3;
}

// Bit of axis a (0 x, 1 y, 2 z) at octant-descent level t.
__device__ __forceinline__ double axis_bit(uint64_t k, int t, int a) {
  return static_cast<double>((k >> (3 * (20 - t) + 2 - a)) & 1ull);
}

// The depth-`depth` node's bounds of key k, by the host's halving.
__device__ __forceinline__ void node_bounds(uint64_t k, int depth,
                                            const Bounds& b, double* mn,
                                            double* mx) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mn[a] = b.min[a];
    mx[a] = b.max[a];
  }
  for (int t = 0; t < depth; ++t) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const double half = (mx[a] - mn[a]) / 2.0;
      mn[a] = mn[a] + axis_bit(k, t, a) * half;
      mx[a] = mn[a] + half;
    }
  }
}

__device__ __forceinline__ double sq_dist(const double* p, double tx,
                                          double ty, double tz) {
  const double dx = __ldg(p) - tx;
  const double dy = __ldg(p + 1) - ty;
  const double dz = __ldg(p + 2) - tz;
  return (dx * dx + dy * dy) + dz * dz;
}

// The squared distance of point i (key k) to its pick target, as bits.
__device__ uint64_t dist_bits(const double* pos, int64_t i, uint64_t k,
                              const Level& L, const Bounds& b) {
  double mn[3], mx[3], t[3];
  node_bounds(k, L.depth, b, mn, mx);
  if (L.pick == CENTER) {
#pragma unroll
    for (int a = 0; a < 3; ++a) t[a] = mn[a] + (mx[a] - mn[a]) / 2.0;
  } else {
    const double grid = (mx[0] - mn[0]) / static_cast<double>(L.actual);
    const double cell = grid / static_cast<double>(L.actual);
    int64_t g[3] = {0, 0, 0};
    for (int j = 0; j < L.levels; ++j) {
      const int tl = L.node_level + 1 + j;
      const int sh = L.levels - 1 - j;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        g[a] |= static_cast<int64_t>((k >> (3 * (20 - tl) + 2 - a)) & 1ull)
                << sh;
      }
    }
    const double p[3] = {
        static_cast<double>(__ldg(L.perm + (g[1] + g[2]) % L.plen) - 1),
        static_cast<double>(
            __ldg(L.perm + MAX_PERM + (g[0] + g[2]) % L.plen) - 1),
        static_cast<double>(
            __ldg(L.perm + 2 * MAX_PERM + (g[0] + g[1]) % L.plen) - 1)};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t[a] = mn[a] + (static_cast<double>(g[a]) * grid + p[a] * cell);
    }
  }
  return static_cast<uint64_t>(
      __double_as_longlong(sq_dist(pos + 3 * i, t[0], t[1], t[2])));
}

__device__ Level load_level(const int32_t* plan, int lv) {
  const int32_t* v = plan + static_cast<int64_t>(lv) * LEVEL_INTS;
  Level L;
  L.node_level = __ldg(v);
  L.terminal = __ldg(v + 1);
  L.node_groups = __ldg(v + 2);
  L.pick_groups = __ldg(v + 3);
  L.pick = __ldg(v + 4);
  L.depth = __ldg(v + 5);
  L.levels = __ldg(v + 6);
  L.actual = __ldg(v + 7);
  L.plen = __ldg(v + 8);
  L.perm = v + 9;
  return L;
}

// A CTA's state (see region_bytes), in shared memory or its global region.
struct Tile {
  int64_t t0, t1;      // its points [t0, t1)
  int chunks;
  uint32_t* rmask;     // per chunk: lanes still remaining
  int32_t* live[2];    // chunk lists (local chunk ids, any order)
  int32_t* heads[4];   // per chunk: the head of its last point, per G
  int8_t* m;           // per chunk: the least d
  int8_t* d;           // per point
};

// The CTA's G-digit heads at the end of every chunk: the last point at or
// before the chunk's end with d < G (`pre`: the last one before the tile),
// into h. Warps find each chunk's last head, then a prefix max runs over
// the chunks.
__device__ void head_scan(const Tile& T, int G, int32_t pre, int32_t* h,
                          int32_t* s_part) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int c = warp; c < T.chunks; c += WARPS) {
    int32_t v = -1;
    if (T.m[c] < G) {
      const unsigned b = __ballot_sync(FULL, T.d[c * 32 + lane] < G);
      v = static_cast<int32_t>(T.t0) + c * 32 + (31 - __clz(b));
    }
    if (lane == 0) h[c] = v;
  }
  __syncthreads();
  // each thread a contiguous segment of chunks: its max, a scan of the
  // segments' maxima, then the running max over the segment
  const int per = (T.chunks + THREADS - 1) / THREADS;
  const int c0 = tid * per;
  const int c1 = min(T.chunks, c0 + per);
  int32_t mx = -1;
  for (int c = c0; c < c1; ++c) mx = max(mx, h[c]);
  int32_t incl = mx;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = max(incl, o);
  }
  if (lane == 31) s_part[warp] = incl;
  __syncthreads();
  int32_t run = pre;
  for (int w = 0; w < warp; ++w) run = max(run, s_part[w]);
  const int32_t before = __shfl_up_sync(FULL, incl, 1);
  if (lane > 0) run = max(run, before);
  for (int c = c0; c < c1; ++c) {
    run = max(run, h[c]);
    h[c] = run;
  }
  __syncthreads();
}

// One chunk's lanes, as every phase sees them.
struct Lanes {
  int64_t i;       // the lane's point
  unsigned rmask;  // the chunk's lanes still remaining
  bool rem;        // this lane's
  int dv;          // its d
  uint32_t base;   // the chunk's first point
};

__device__ __forceinline__ Lanes chunk_lanes(const Tile& T, int c,
                                             int lane) {
  Lanes l;
  l.base = static_cast<uint32_t>(T.t0) + c * 32;
  l.i = static_cast<int64_t>(l.base) + lane;
  l.rmask = T.rmask[c];
  l.rem = (l.rmask >> lane) & 1u;
  l.dv = T.d[c * 32 + lane];
  return l;
}

// A chunk's cells of G digits: this lane's cell head (its cell's first
// point, global index) and, for the lane that starts a run of one cell in
// the chunk (lane 0 always), the run's lanes (0 for the others).
struct Runs {
  uint32_t head;
  unsigned run;
};

__device__ __forceinline__ Runs runs_of(const Lanes& l, int G,
                                        const int32_t* h, int c, int32_t pre,
                                        int lane) {
  const unsigned heads = __ballot_sync(FULL, l.dv < G);
  const unsigned upto = heads & (FULL >> (31 - lane));
  Runs r;
  r.head = upto ? l.base + static_cast<uint32_t>(31 - __clz(upto))
                : static_cast<uint32_t>(c > 0 ? h[c - 1] : pre);
  const unsigned lead = heads | 1u;
  r.run = 0;
  if ((lead >> lane) & 1u) {
    const unsigned after = lead & ~(FULL >> (31 - lane));
    r.run = (FULL << lane) & (after ? (after & (0u - after)) - 1u : FULL);
  }
  return r;
}

// Runs of lanes with the same head are contiguous (sorted keys): after the
// loop the first lane of each run holds the run's minimum.
__device__ uint64_t run_min(uint64_t v, uint32_t head, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint64_t other = __shfl_down_sync(FULL, v, off);
    const uint32_t other_head = __shfl_down_sync(FULL, head, off);
    if (lane + off < 32 && other_head == head && other < v) v = other;
  }
  return v;
}

template <bool DIST>
__global__ void __launch_bounds__(THREADS, 2) sweep_kernel(Args A) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_pre[DIGITS];
  __shared__ int32_t s_part[WARPS];
  __shared__ int s_live_next;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  Tile T;
  T.t0 = static_cast<int64_t>(blockIdx.x) * A.tile;
  T.t1 = min(A.n, T.t0 + A.tile);
  T.chunks = T.t1 > T.t0 ? static_cast<int>((T.t1 - T.t0 + 31) / 32) : 0;
  {
    uint8_t* r = A.work != nullptr
                     ? A.work + static_cast<int64_t>(blockIdx.x) * A.region
                     : smem;
    const int c = A.tile / 32;
    T.rmask = reinterpret_cast<uint32_t*>(r);
    T.live[0] = reinterpret_cast<int32_t*>(r + 4 * c);
    T.live[1] = T.live[0] + c;
    for (int k = 0; k < 4; ++k) T.heads[k] = T.live[1] + c + k * c;
    T.m = reinterpret_cast<int8_t*>(T.heads[3] + c);
    T.d = T.m + c;
  }

  // -- start: d, the chunk minima and masks; the heads before the tile -----
  if (blockIdx.x == 0 && tid <= A.n_levels) A.alive[tid] = 0;
  if (warp == 0 && lane < DIGITS) {
    // lane G: the first point of the cell of G digits that holds the
    // tile's first point (a binary search of the sorted keys)
    const int s = 63 - 3 * lane;
    const uint64_t cell = __ldg(A.key + T.t0) >> s;
    int64_t lo = 0, hi = T.t0;
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo) / 2;
      if ((__ldg(A.key + mid) >> s) < cell) lo = mid + 1; else hi = mid;
    }
    s_pre[lane] = static_cast<int32_t>(lo);
  }
  // each lane's key and the key before the chunk, one chunk ahead
  auto keys_of = [&](int c, uint64_t* before) -> uint64_t {
    const int64_t i = T.t0 + c * 32 + lane;
    *before = lane == 0 && i > 0 && c < T.chunks ? __ldg(A.key + i - 1) : 0;
    return c < T.chunks && i < T.t1 ? __ldg(A.key + i) : 0;
  };
  uint64_t next_before = 0;
  uint64_t next = keys_of(warp, &next_before);
  for (int c = warp; c < T.chunks; c += WARPS) {
    const int64_t i = T.t0 + c * 32 + lane;
    const bool valid = i < T.t1;
    const uint64_t k = next;
    uint64_t prev = __shfl_up_sync(FULL, k, 1);
    if (lane == 0) prev = next_before;
    next = keys_of(c + WARPS, &next_before);
    const int dv = !valid ? 127 : i == 0 ? -1 : shared_digits(k, prev);
    T.d[c * 32 + lane] = static_cast<int8_t>(dv);
    const int mn = __reduce_min_sync(FULL, dv);
    const unsigned valid_mask = __ballot_sync(FULL, valid);
    if (lane == 0) {
      T.m[c] = static_cast<int8_t>(mn);
      T.rmask[c] = valid_mask;
      T.live[0][c] = c;
    }
  }
  __syncthreads();
  int n_live = T.chunks;
  int cur = 0;  // the live list and head pair of the current level

  // heads of the cells of level lv into head pair `slot`, and the reset of
  // set lv & 1 at the heads of the cells that hold a remaining point
  auto prepare = [&](int lv, int slot) {
    const Level L = load_level(A.plan, lv);
    if (L.terminal) return;
    const int gn = max(L.node_groups, 0);
    const int gp = max(L.pick_groups, 0);
    int32_t* hn = T.heads[2 * slot];
    int32_t* hp = gp == gn ? hn : T.heads[2 * slot + 1];
    head_scan(T, gn, s_pre[gn], hn, s_part);
    if (gp != gn) head_scan(T, gp, s_pre[gp], hp, s_part);
    const Set S = A.sets[lv & 1];
    const int32_t* live = T.live[cur];
    for (int x = warp; x < n_live; x += WARPS) {
      const int c = live[x];
      const Lanes l = chunk_lanes(T, c, lane);
      const Runs rn = runs_of(l, gn, hn, c, s_pre[gn], lane);
      const Runs rp = runs_of(l, gp, hp, c, s_pre[gp], lane);
      if (rn.run & l.rmask) S.count[rn.head] = 0;
      if (rp.run & l.rmask) {
        S.index[rp.head] = NONE;
        if (DIST) S.dist[rp.head] = FAR;
      }
    }
  };

  if (A.n_levels > 0) prepare(0, 0);
  grid.sync();

  int lv = 0;
  for (; lv < A.n_levels; ++lv) {
    if (lv > 0 && __ldcg(A.alive + lv) == 0) break;  // nothing remains
    const Level L = load_level(A.plan, lv);
    const Set S = A.sets[lv & 1];
    const int gn = max(L.node_groups, 0);
    const int gp = max(L.pick_groups, 0);
    const int32_t* hn = T.heads[2 * cur];
    const int32_t* hp = gp == gn ? hn : T.heads[2 * cur + 1];
    const int32_t* live = T.live[cur];
    if (!L.terminal) {
      // per node cell the remaining count; per pick cell the first
      // remaining index (FIRST) or the least distance (CENTER, JITTER),
      // one atomic per run of a cell in a chunk
      for (int x = warp; x < n_live; x += WARPS) {
        const int c = live[x];
        const Lanes l = chunk_lanes(T, c, lane);
        const Runs rn = runs_of(l, gn, hn, c, s_pre[gn], lane);
        const unsigned in_run = rn.run & l.rmask;
        if (in_run) atomicAdd(S.count + rn.head, __popc(in_run));
        const Runs rp = gp == gn ? rn : runs_of(l, gp, hp, c, s_pre[gp],
                                                lane);
        if (!DIST || L.pick == FIRST) {
          const unsigned first = rp.run & l.rmask;
          if (first) atomicMin(S.index + rp.head, l.base + __ffs(first) - 1);
        } else {
          uint64_t dd = FAR;
          if (l.rem) {
            dd = dist_bits(A.pos, l.i, __ldg(A.key + l.i), L, A.bounds);
            A.pdist[l.i] = dd;
          }
          dd = run_min(dd, rp.head, lane);
          if (rp.run && dd != FAR) {
            atomicMin(reinterpret_cast<unsigned long long*>(S.dist +
                                                            rp.head),
                      static_cast<unsigned long long>(dd));
          }
        }
      }
      grid.sync();
      if (DIST && L.pick != FIRST) {
        // per pick cell the least index among the remaining points at the
        // least distance
        for (int x = warp; x < n_live; x += WARPS) {
          const int c = live[x];
          const Lanes l = chunk_lanes(T, c, lane);
          const Runs rp = runs_of(l, gp, hp, c, s_pre[gp], lane);
          const bool at_min =
              l.rem && A.pdist[l.i] ==
                           __ldcg(reinterpret_cast<const unsigned long long*>(
                               S.dist + rp.head));
          const unsigned first = rp.run & __ballot_sync(FULL, at_min);
          if (first) atomicMin(S.index + rp.head, l.base + __ffs(first) - 1);
        }
        grid.sync();
      }
    }
    // the decisions: a remaining point is selected when its node holds at
    // most max_points or it is its pick cell's pick (every remaining point
    // on a terminal level); the chunks left with a remaining point make
    // the next level's list
    if (tid == 0) s_live_next = 0;
    __syncthreads();
    const int8_t level = static_cast<int8_t>(L.node_level + 2);
    int32_t* next_live = T.live[cur ^ 1];
    for (int x = warp; x < n_live; x += WARPS) {
      const int c = live[x];
      const Lanes l = chunk_lanes(T, c, lane);
      bool sel = l.rem;
      if (!L.terminal) {
        const Runs rn = runs_of(l, gn, hn, c, s_pre[gn], lane);
        const Runs rp = gp == gn ? rn : runs_of(l, gp, hp, c, s_pre[gp],
                                                lane);
        sel = l.rem &&
              (static_cast<int64_t>(__ldcg(S.count + rn.head)) <=
                   A.max_points ||
               __ldcg(S.index + rp.head) == static_cast<uint32_t>(l.i));
      }
      if (sel) A.out[l.i] = level;
      const unsigned left = __ballot_sync(FULL, l.rem && !sel);
      if (lane == 0) {
        T.rmask[c] = left;
        if (left) next_live[atomicAdd(&s_live_next, 1)] = c;
      }
    }
    __syncthreads();
    n_live = s_live_next;
    cur ^= 1;
    if (lv + 1 < A.n_levels) {
      prepare(lv + 1, cur);
      if (tid == 0 && n_live > 0) A.alive[lv + 1] = 1;
    }
    grid.sync();
  }

  // the points no level of the plan selected stay at 0 for the host
  const int32_t* live = T.live[cur];
  for (int x = warp; x < n_live; x += WARPS) {
    const Lanes l = chunk_lanes(T, live[x], lane);
    if (l.rem) A.out[l.i] = 0;
  }
}

template <bool DIST>
int config(int64_t n, int* grid, int* tile, int* smem, int64_t* work) {
  const auto kernel = sweep_kernel<DIST>;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dyn_max = optin - static_cast<int>(fa.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int64_t chunks = (n + 31) / 32;
  // the most CTAs a SM whose state still fits in shared memory
  for (int b = per_sm; b >= 1; --b) {
    const int64_t g = std::min<int64_t>(static_cast<int64_t>(b) * sms,
                                        chunks);
    const int64_t t = (chunks + g - 1) / g * 32;
    const int64_t bytes = region_bytes(t);
    if (bytes > dyn_max) continue;
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, THREADS, static_cast<size_t>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (static_cast<int64_t>(fit) * sms < (n + t - 1) / t) continue;
    *tile = static_cast<int>(t);
    *grid = static_cast<int>((n + t - 1) / t);
    *smem = static_cast<int>(bytes);
    return 0;
  }
  // the state in device memory: one region a CTA
  const int64_t g = std::min<int64_t>(static_cast<int64_t>(per_sm) * sms,
                                      chunks);
  const int64_t t = (chunks + g - 1) / g * 32;
  *tile = static_cast<int>(t);
  *grid = static_cast<int>((n + t - 1) / t);
  *work = static_cast<int64_t>(*grid) * region_bytes(t);
  return 0;
}


}  // namespace

extern "C" {

int x2_level_ints() { return LEVEL_INTS; }


// The launch of a sweep of n points on the current device (`distance`:
// some level picks by distance): *grid CTAs of THREADS threads (the
// CTAs that fit on the card at once, at most one per 32 points), *tile
// points each, *smem bytes of dynamic shared memory, and *work bytes of
// device memory for the CTAs' state when it does not fit on chip (0 when
// it does). Returns the CUDA error (0 = planned).
int x2_config(int64_t n, int distance, int* grid, int* tile, int* smem,
              int64_t* work) {
  *grid = *tile = *smem = 0;
  *work = 0;
  if (n <= 0) return 0;
  return distance ? config<true>(n, grid, tile, smem, work)
                  : config<false>(n, grid, tile, smem, work);
}

// The whole sweep of n points on `stream`, one cooperative launch, with
// x2_config's grid, tile, smem and work: `plan` (device memory) holds
// n_levels levels of LEVEL_INTS int32 each; key (n,) sorted 63-bit keys;
// pos (n, 3) doubles and pdist (n,) uint64 when `distance`, else null;
// out (n,) int8 levels; alive n_levels + 1 int32; count and index 2n
// uint32 each, dist 2n uint64 or null, all of any content; work `work`
// bytes or null; bounds (host) the root's min then max. Returns the CUDA
// error of the launch (0 = launched); a grid the card cannot hold at once
// is refused (cudaErrorCooperativeLaunchTooLarge), and nothing else is
// tried.
int x2_sweep(const void* key, const void* pos, int64_t n, void* out,
             void* alive, void* count, void* index, void* dist, void* pdist,
             const int32_t* plan, int n_levels, const double* bounds,
             int64_t max_points, void* work, int distance, int grid,
             int tile, int smem, void* stream) {
  if (n <= 0) return 0;
  Args a;
  a.key = static_cast<const uint64_t*>(key);
  a.pos = static_cast<const double*>(pos);
  a.n = n;
  a.out = static_cast<int8_t*>(out);
  a.alive = static_cast<int32_t*>(alive);
  for (int j = 0; j < 2; ++j) {
    a.sets[j].count = static_cast<uint32_t*>(count) + j * n;
    a.sets[j].index = static_cast<uint32_t*>(index) + j * n;
    a.sets[j].dist = dist == nullptr ? nullptr
                                     : static_cast<uint64_t*>(dist) + j * n;
  }
  a.pdist = static_cast<uint64_t*>(pdist);
  a.plan = plan;
  a.n_levels = n_levels;
  for (int j = 0; j < 3; ++j) {
    a.bounds.min[j] = bounds[j];
    a.bounds.max[j] = bounds[3 + j];
  }
  a.max_points = max_points;
  a.work = static_cast<uint8_t*>(work);
  a.tile = tile;
  a.region = static_cast<int32_t>(region_bytes(tile));
  void* params[] = {&a};
  const void* kernel =
      distance ? reinterpret_cast<const void*>(sweep_kernel<true>)
               : reinterpret_cast<const void*>(sweep_kernel<false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(THREADS), params, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
