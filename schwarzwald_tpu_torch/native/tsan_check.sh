#!/usr/bin/env bash
# ThreadSanitizer check of the port's native library (native/src): build it
# with -fsanitize=thread, drive it from many Python threads at once
# (tsan_stress.py), and judge each run by its exit code and its reports.
#
#   schwarzwald_tpu_torch/native/tsan_check.sh [A|B|AB]     (default AB)
#
# Mode A runs with OMP_NUM_THREADS=1: races between concurrent callers,
# which the engine's worker threads can hit. Mode B runs with the default
# OpenMP team. libgomp is not built with ThreadSanitizer, so both modes
# preload tsan_gomp.c's GOMP_parallel, which tells it of each parallel
# region's fork and join (without it, every region's workers are reported
# against their parent). In each mode a canary run (tsan_canary.cpp) must
# report its two known races and nothing else, and then the stress run must
# report nothing and exit 0. No suppression file. The script exits 0 when
# every run passed, 1 when one failed, and 77 when libtsan is missing.
set -uo pipefail
HERE="$(cd "$(dirname "$0")" && pwd)"
BUILD="$HERE/build_tsan"
MODES="${1:-AB}"
FLAGS="-O1 -g -std=c++17 -shared -fPIC -fopenmp -fsanitize=thread"
PY="${PYTHON:-python3}"

LIBTSAN="$(gcc -print-file-name=libtsan.so 2>/dev/null || true)"
if [ -z "$LIBTSAN" ] || [ ! -e "$LIBTSAN" ]; then
    echo "tsan_check: libtsan.so not found (gcc -print-file-name)"
    exit 77
fi

# build OUT from SOURCES with the compiler command CMD when a source is
# newer than OUT or the command differs from OUT's stamp
build() {
    local out="$1" cmd="$2"; shift 2
    local stale=0 src
    [ -e "$out" ] || stale=1
    for src in "$@"; do [ "$src" -nt "$out" ] && stale=1; done
    [ "$(cat "$out.flags" 2>/dev/null)" = "$cmd" ] || stale=1
    [ "$stale" = 1 ] || return 0
    local start; start=$(date +%s)
    # shellcheck disable=SC2086
    $cmd -o "$out.$$.tmp" "$@" || return 1
    mv "$out.$$.tmp" "$out"
    echo "$cmd" > "$out.flags"
    echo "tsan_check: built $(basename "$out") in $(( $(date +%s) - start )) s"
}

# under a lock: test workers may start together
mkdir -p "$BUILD"
(
    flock 9
    build "$BUILD/libschwarzwald_native_tsan.so" "g++ $FLAGS" \
        "$HERE/src/schwarzwald_native.cpp" "$HERE/src/laz.cpp" &&
    build "$BUILD/libtsan_canary.so" "g++ $FLAGS" "$HERE/tsan_canary.cpp" &&
    build "$BUILD/libtsan_gomp.so" "gcc -O1 -shared -fPIC" \
        "$HERE/tsan_gomp.c" -ldl
) 9> "$BUILD/.lock" || { echo "tsan_check: build failed"; exit 1; }

status=0
for mode in $(echo "$MODES" | grep -o .); do
    if [ "$mode" = A ]; then threads=1; else threads=default; fi
    for run in canary stress; do
        lib="$BUILD/libschwarzwald_native_tsan.so"
        [ "$run" = canary ] && lib="$BUILD/libtsan_canary.so"
        log="$BUILD/mode_$mode.$run.$$.log"
        start=$(date +%s)
        (
            if [ "$mode" = A ]; then export OMP_NUM_THREADS=1
            else unset OMP_NUM_THREADS; fi
            OMP_WAIT_POLICY=passive TSAN_OPTIONS="exitcode=66" \
                LD_PRELOAD="$LIBTSAN $BUILD/libtsan_gomp.so" \
                "$PY" "$HERE/tsan_stress.py" "$run" "$lib"
        ) > "$log" 2>&1
        rc=$?
        echo "tsan_check: mode $mode $run ran in $(( $(date +%s) - start ))" \
             "s (OpenMP threads: $threads; log $log)"
        "$PY" "$HERE/tsan_stress.py" verdict "$mode" "$run" "$rc" "$log" \
            || status=1
    done
done
exit $status
