// The one host-runtime function the PS service needs: CLOCK_MONOTONIC in
// nanoseconds, the base of paddle_tpu_torch.profiler._now_ns()
// (time.monotonic_ns()), so server spans and client spans share one clock.
#include <time.h>

extern "C" __attribute__((visibility("default"))) long long pt_prof_now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}
