// Monotonic clock module.
//
// Copied from native/clock.cc; it builds into the port's host library
// (ops/build.py).
//
// The role of the reference's only C NIF (c_src/riak_ensemble_clock.c,
// 184 LoC): clock readings immune to wall-clock jumps, backing the
// leader-lease safety check (riak_ensemble_lease.erl:76-88).  Like the
// reference we prefer CLOCK_BOOTTIME on Linux — CLOCK_MONOTONIC stops
// while the machine is suspended, which would silently extend leases
// across a suspend/resume (the hazard discussed at
// c_src/riak_ensemble_clock.c:50-57).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <ctime>

namespace {

int64_t read_clock(clockid_t id) {
  struct timespec ts;
  if (clock_gettime(id, &ts) != 0) {
    return -1;
  }
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL +
         static_cast<int64_t>(ts.tv_nsec);
}

}  // namespace

extern "C" {

// Nanoseconds from an arbitrary fixed origin; never jumps backward.
int64_t retpu_monotonic_time_ns() {
#ifdef CLOCK_BOOTTIME
  int64_t t = read_clock(CLOCK_BOOTTIME);
  if (t >= 0) {
    return t;
  }
#endif
  return read_clock(CLOCK_MONOTONIC);
}

// Milliseconds (the riak_ensemble_clock:monotonic_time_ms/0 analog).
int64_t retpu_monotonic_time_ms() {
  int64_t ns = retpu_monotonic_time_ns();
  return ns < 0 ? -1 : ns / 1000000LL;
}

// 1 when CLOCK_BOOTTIME is in use (introspection/tests).
int retpu_clock_is_boottime() {
#ifdef CLOCK_BOOTTIME
  return read_clock(CLOCK_BOOTTIME) >= 0 ? 1 : 0;
#else
  return 0;
#endif
}

}  // extern "C"
