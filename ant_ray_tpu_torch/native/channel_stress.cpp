// channel_stress — ThreadSanitizer stress driver for the mutable-object
// channel protocol (channel_core.h), the exact code the art_torch_native
// extension ships.  A copy of the JAX package's native/channel_stress.cpp.
//
// Build (plain):  g++ -O1 -std=c++17 -pthread channel_stress.cpp -o stress
// Build (TSAN):   g++ -O1 -std=c++17 -pthread -fsanitize=thread \
//                     channel_stress.cpp -o stress_tsan
// Run:            ./stress <iterations> <readers>
//
// One writer thread publishes `iterations` versions whose payload is
// filled with a stamp derived from the version; `readers` reader
// threads acquire every version and verify the stamp (a torn read or a
// misordered publish fails loudly).  Halfway through, one extra
// registered reader "dies" without releasing and the main thread runs
// the remove_reader recovery — the writer must not wedge.  Exit 0 on
// success; TSAN reports any data race in the protocol itself.
//
// Ref hardening model: multi-threaded stress of the reference's mutable
// plasma objects (src/ray/core_worker/experimental_mutable_object_manager.h:44).

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "channel_core.h"

using namespace art_channel;

namespace {

constexpr uint64_t kCapacity = 4096;

struct Shared {
  ChannelHeader header;
  uint8_t payload[kCapacity];
};

std::atomic<int> failures{0};

void fail(const char* what, uint64_t version) {
  std::fprintf(stderr, "FAIL: %s at version %llu\n", what,
               static_cast<unsigned long long>(version));
  failures.fetch_add(1);
}

void writer(Shared* s, uint64_t iterations) {
  for (uint64_t i = 1; i <= iterations; ++i) {
    if (channel_writer_wait(&s->header, 30.0) != 0) {
      fail("writer wait", i);
      return;
    }
    uint8_t stamp = static_cast<uint8_t>(i & 0xff);
    std::memset(s->payload, stamp, kCapacity);
    channel_publish(&s->header, kCapacity);
  }
  ch_store(&s->header.closed, 1);
}

void reader(Shared* s, int id) {
  (void)id;
  uint64_t last = 0;
  while (true) {
    int rc = channel_reader_wait(&s->header, last, 30.0);
    if (rc == 1) return;  // closed: done
    if (rc == 2) {
      fail("reader wait timeout", last);
      return;
    }
    uint64_t version = ch_load(&s->header.version);
    uint8_t expect = static_cast<uint8_t>(version & 0xff);
    // Verify the whole window: a publish that raced the memset (or a
    // writer overwriting before all releases) shows as a mixed stamp.
    for (uint64_t off = 0; off < kCapacity; off += 257) {
      if (s->payload[off] != expect) {
        fail("torn payload", version);
        break;
      }
    }
    last = version;
    channel_release(&s->header);
  }
}

}  // namespace

int main(int argc, char** argv) {
  uint64_t iterations = argc > 1 ? std::strtoull(argv[1], nullptr, 10)
                                 : 20000;
  int n_readers = argc > 2 ? std::atoi(argv[2]) : 3;

  Shared shared;
  std::memset(&shared, 0, sizeof(shared));
  shared.header.magic = kChannelMagic;
  shared.header.capacity = kCapacity;
  // One extra registered reader plays the crash victim below.
  shared.header.num_readers = static_cast<uint64_t>(n_readers) + 1;
  shared.header.readers_done = shared.header.num_readers;

  std::thread w(writer, &shared, iterations);
  std::vector<std::thread> rs;
  for (int i = 0; i < n_readers; ++i) rs.emplace_back(reader, &shared, i);

  // The "dead reader": never acquires/releases.  Without recovery the
  // writer wedges on version 2 (readers_done can never reach
  // num_readers).  Recovery = the control plane removing it.
  std::this_thread::sleep_for(std::chrono::milliseconds(10));
  channel_remove_reader(&shared.header);

  w.join();
  for (auto& r : rs) r.join();
  if (failures.load() != 0) {
    std::fprintf(stderr, "stress FAILED (%d failures)\n", failures.load());
    return 1;
  }
  std::printf("stress OK: %llu versions, %d readers\n",
              static_cast<unsigned long long>(iterations), n_readers);
  return 0;
}
