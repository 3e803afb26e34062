/* The fork and join of GCC's OpenMP parallel regions, told to
 * ThreadSanitizer.
 *
 * libgomp is not built with -fsanitize=thread, so ThreadSanitizer never
 * sees how a parallel region hands its data to the team's workers and back:
 * it reports each worker's accesses against its parent's, before the region
 * and after its closing barrier. This library, preloaded after libtsan.so,
 * stands in for GOMP_parallel (the only region entry point the native
 * library calls; its loops inside a region use GOMP_loop_*_start/next and
 * GOMP_loop_end_nowait, which need no edge). It adds the two edges OpenMP
 * guarantees and nothing else: the parent's release before the region, each
 * thread's acquire as it starts its share, each thread's release as it ends
 * its share, the parent's acquire once the region has ended. The edges hang
 * on one region record on the parent's stack, so two regions (of two
 * callers, or one after another) never order each other's threads.
 *
 *   gcc -O1 -shared -fPIC -o libtsan_gomp.so tsan_gomp.c -ldl
 *   LD_PRELOAD="$(gcc -print-file-name=libtsan.so) ./libtsan_gomp.so" ...
 */
#define _GNU_SOURCE
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>

void __tsan_acquire(void *addr);
void __tsan_release(void *addr);

typedef void (*region_fn)(void *);
typedef void (*gomp_parallel_fn)(region_fn, void *, unsigned, unsigned);

struct region {
  region_fn fn;
  void *data;
  char fork; /* the parent's writes before the region */
  char join; /* every thread's writes in the region */
};

static void share(void *arg) {
  struct region *r = arg;
  __tsan_acquire(&r->fork);
  r->fn(r->data);
  __tsan_release(&r->join);
}

void GOMP_parallel(region_fn fn, void *data, unsigned num_threads,
                   unsigned flags) {
  static gomp_parallel_fn cached;
  gomp_parallel_fn real = __atomic_load_n(&cached, __ATOMIC_ACQUIRE);
  if (real == NULL) {
    /* libgomp came with the native library, which ctypes loads with
       RTLD_LOCAL: out of RTLD_NEXT's reach, so ask it by name */
    void *gomp = dlopen("libgomp.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (gomp != NULL)
      real = (gomp_parallel_fn)dlvsym(gomp, "GOMP_parallel", "GOMP_4.0");
    if (real == NULL) {
      fprintf(stderr, "tsan_gomp: libgomp's GOMP_parallel not found\n");
      abort();
    }
    __atomic_store_n(&cached, real, __ATOMIC_RELEASE);
  }
  struct region r = {fn, data, 0, 0};
  __tsan_release(&r.fork);
  real(share, &r, num_threads, flags);
  __tsan_acquire(&r.join);
}
