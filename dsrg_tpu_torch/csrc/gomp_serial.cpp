// One-thread stand-ins for the libgomp entry points that g++ -fopenmp emits
// calls to (a `#pragma omp parallel for schedule(static)` loop).  Linked into
// the native engines' library where the compiler has no libgomp
// (dsrg_tpu_torch/native.py): the sources still compile with -fopenmp, so
// every loop is the OpenMP build's code and gives its bits, on one thread.
// Hidden, so that a libgomp loaded in the same process is never called.

#define DSRG_HIDDEN __attribute__((visibility("hidden")))

extern "C" {

DSRG_HIDDEN void GOMP_parallel(void (*fn)(void*), void* data, unsigned, unsigned) { fn(data); }
DSRG_HIDDEN int omp_get_num_threads() { return 1; }
DSRG_HIDDEN int omp_get_thread_num() { return 0; }

}
