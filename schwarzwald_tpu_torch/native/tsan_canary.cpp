// Known races and one known hand-off, built with -fsanitize=thread -fopenmp
// beside the native library: tsan_check.sh runs them before each stress run
// to show that ThreadSanitizer sees the races of both kinds the stress run
// looks for, and that the GOMP_parallel shim (tsan_gomp.c) hides no race
// and leaves no report at a region's fork or join.
#include <cstdint>

static int64_t shared_total;

extern "C" {

// A race between concurrent callers: every call adds to one static without
// a lock (mode A's kind: thread_local state, statics, shared scratch).
int64_t canary_callers(int64_t n) {
  for (int64_t i = 0; i < n; ++i) shared_total += i;
  return shared_total;
}

// A race inside one parallel region: every thread of a team of four adds
// to one local of the caller without a lock.
int64_t canary_team(int64_t n) {
  int64_t sum = 0;
#pragma omp parallel for schedule(static) num_threads(4)
  for (int64_t i = 0; i < n; ++i) sum += i;
  return sum;
}

// No race: the caller fills `buf`, a team of four rewrites disjoint parts
// of it, and the caller reads it after the region, ordered only by the
// region's fork and join.
int64_t canary_handoff(int64_t* buf, int64_t n) {
  for (int64_t i = 0; i < n; ++i) buf[i] = i;
#pragma omp parallel for schedule(static) num_threads(4)
  for (int64_t i = 0; i < n; ++i) buf[i] = 2 * buf[i];
  int64_t sum = 0;
  for (int64_t i = 0; i < n; ++i) sum += buf[i];
  return sum;
}

}  // extern "C"
