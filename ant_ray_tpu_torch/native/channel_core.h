// channel_core.h — lock-free single-writer/N-reader mutable-object
// channel over a shared-memory mapping.  Pure C++ (no Python): included
// by the art_torch_native extension (store_core.cpp) AND by the
// ThreadSanitizer stress driver beside it (channel_stress.cpp), so the
// exact atomics that ship are the atomics under TSAN.  A copy of the JAX
// package's native/channel_core.h (ref hardening model: the reference's mutable
// plasma objects, src/ray/core_worker/experimental_mutable_object_manager.h:44,
// are exercised by dedicated multi-threaded stress tests).
//
// Protocol: the header holds (version, msg_len, readers_done, closed,
// num_readers).  The writer waits until readers_done >= num_readers,
// writes the payload, then publishes by resetting readers_done and
// bumping version (release order).  Readers wait for version > last,
// read, then increment readers_done.  Reader-death recovery: the
// control plane calls channel_remove_reader() for a reader it knows is
// dead, shrinking num_readers so the writer stops waiting for it.

#pragma once

#include <cstdint>
#include <ctime>

#include <sched.h>

namespace art_channel {

struct ChannelHeader {
  uint64_t magic;
  uint64_t capacity;
  uint64_t num_readers;
  uint64_t closed;
  uint64_t version;       // published generation; 0 = nothing written yet
  uint64_t msg_len;       // payload bytes of the current version
  uint64_t readers_done;  // readers that released the current version
};

constexpr uint64_t kChannelMagic = 0x415254434831ull;  // "ARTCH1"

inline uint64_t ch_load(uint64_t* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
inline void ch_store(uint64_t* p, uint64_t v) {
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
inline void ch_add(uint64_t* p, uint64_t v) {
  __atomic_fetch_add(p, v, __ATOMIC_ACQ_REL);
}

// Spin with escalating sleep until `pred` returns true, the channel
// closes, or the deadline passes.  Returns 0 ok, 1 closed, 2 timeout.
// Must run WITHOUT the GIL when called from the extension; pred touches
// only the mapping.
template <typename Pred>
int ch_wait(ChannelHeader* h, double timeout_s, Pred pred) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  double deadline = ts.tv_sec + ts.tv_nsec * 1e-9 + timeout_s;
  int spins = 0;
  while (true) {
    if (pred()) return 0;
    if (ch_load(&h->closed)) return 1;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    if (timeout_s >= 0 && ts.tv_sec + ts.tv_nsec * 1e-9 > deadline)
      return 2;
    if (spins < 1024) {  // ~fast path: just yield the core
      ++spins;
      sched_yield();
    } else {  // slow path: sleep 50us (latency floor for idle channels)
      struct timespec req = {0, 50 * 1000};
      nanosleep(&req, nullptr);
    }
  }
}

// Writer side: wait for every reader of the previous version.
inline int channel_writer_wait(ChannelHeader* h, double timeout_s) {
  return ch_wait(h, timeout_s, [&] {
    return ch_load(&h->readers_done) >= ch_load(&h->num_readers);
  });
}

// Publish `nbytes` (already written into the payload window).
inline void channel_publish(ChannelHeader* h, uint64_t nbytes) {
  h->msg_len = nbytes;
  ch_store(&h->readers_done, 0);
  ch_add(&h->version, 1);
}

// Reader side: wait for a version newer than `last`.
inline int channel_reader_wait(ChannelHeader* h, uint64_t last,
                               double timeout_s) {
  return ch_wait(h, timeout_s,
                 [&] { return ch_load(&h->version) > last; });
}

inline void channel_release(ChannelHeader* h) {
  ch_add(&h->readers_done, 1);
}

// Reader-death recovery: the control plane observed a reader die (actor
// death, worker crash); stop requiring its release forever.  A CAS
// loop (decrement only while > 0) keeps concurrent/duplicate death
// reports from underflowing the count — an underflow would wedge the
// writer forever.  If the dead reader had already released the current
// version, readers_done merely over-counts (write_commit resets it).
// Returns the remaining reader count.
inline uint64_t channel_remove_reader(ChannelHeader* h) {
  uint64_t cur = __atomic_load_n(&h->num_readers, __ATOMIC_ACQUIRE);
  while (cur > 0) {
    if (__atomic_compare_exchange_n(&h->num_readers, &cur, cur - 1,
                                    /*weak=*/false, __ATOMIC_ACQ_REL,
                                    __ATOMIC_ACQUIRE)) {
      return cur - 1;
    }
  }
  return 0;
}

}  // namespace art_channel
