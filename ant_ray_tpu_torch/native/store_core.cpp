// art_torch_native — native core of the shared-memory object store.
//
// A copy of the JAX package's native/store_core.cpp under its own module
// and type names (art_torch_native.Arena, ...), so both extensions can be
// loaded into one process.
//
// Role of the reference's plasma allocator (ref: src/ray/object_manager/
// plasma/plasma_allocator.h + dlmalloc arenas), redesigned for the
// tmpfs-arena model: one mmap'd file per node holds all objects; the node
// daemon owns allocation (single-writer), workers/drivers map the same
// file and read/write zero-copy through granted [offset, size) windows.
//
// Allocator: boundary-tag first-fit free list with coalescing.  Block
// layout: [u64 header][payload][u64 footer], header/footer = size | free
// bit.  Single-threaded by design (the owning daemon serializes), so no
// locks live in the arena itself.
//
// Python API (module art_torch_native):
//   Arena(path, capacity, create)      — create/open an arena file
//   a.alloc(nbytes) -> offset          — raises MemoryError when full
//   a.free(offset)
//   a.view(offset, nbytes) -> memoryview (zero-copy, writable)
//   a.used, a.capacity, a.num_blocks
//   a.close()
//
//   Channel(path, capacity, num_readers, create) — mutable-object channel
//   (role of the reference's multi-reader/single-writer mutable plasma
//   objects, ref: src/ray/core_worker/experimental_mutable_object_manager.h:44,
//   redesigned lock-free: a version counter + readers-done counter in the
//   mmap header replace the writer/reader semaphore pair; waits are
//   GIL-released spin-with-backoff, bounded by a caller deadline).
//   c.write_begin(nbytes, timeout) -> writable memoryview (waits for all
//       readers of the previous version; MemoryError if nbytes > capacity,
//       TimeoutError on deadline)
//   c.write_commit(nbytes)         — publish: version += 1
//   c.read_acquire(last_version, timeout) -> (version, memoryview) | None
//   c.read_release()               — reader done with current version
//   c.close()                      — set closed flag (readers/writers see
//       ChannelClosed via ValueError) and unmap
//   c.version, c.num_readers, c.capacity

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include "channel_core.h"

namespace {

constexpr uint64_t kMagic = 0x41525453484d3031ull;  // "ARTSHM01"
constexpr uint64_t kFreeBit = 1ull << 63;
constexpr uint64_t kAlign = 64;  // cache-line aligned payloads

struct ArenaHeader {
  uint64_t magic;
  uint64_t capacity;   // usable bytes after the header
  uint64_t used;       // payload bytes currently allocated
  uint64_t num_blocks; // live allocations
};

inline uint64_t align_up(uint64_t v, uint64_t a) {
  return (v + a - 1) & ~(a - 1);
}

struct Arena {
  PyObject_HEAD
  int fd;
  uint8_t* base;       // mmap base
  uint64_t file_size;
  bool owner;          // created (vs opened) — owner runs the allocator

  ArenaHeader* header() { return reinterpret_cast<ArenaHeader*>(base); }
  uint8_t* heap() { return base + align_up(sizeof(ArenaHeader), kAlign); }
  uint64_t heap_size() { return header()->capacity; }

  uint64_t read_tag(uint64_t off) {
    uint64_t v;
    std::memcpy(&v, heap() + off, sizeof(v));
    return v;
  }
  void write_tag(uint64_t off, uint64_t v) {
    std::memcpy(heap() + off, &v, sizeof(v));
  }
  // Block: [header u64][payload][footer u64]; size counts the whole block.
  void set_block(uint64_t off, uint64_t size, bool free_flag) {
    uint64_t tag = size | (free_flag ? kFreeBit : 0);
    write_tag(off, tag);
    write_tag(off + size - sizeof(uint64_t), tag);
  }
  static uint64_t tag_size(uint64_t tag) { return tag & ~kFreeBit; }
  static bool tag_free(uint64_t tag) { return tag & kFreeBit; }
};

int arena_init_file(Arena* self, const char* path, uint64_t capacity,
                    bool create) {
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  self->fd = open(path, flags, 0600);
  if (self->fd < 0) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  uint64_t heap_off = align_up(sizeof(ArenaHeader), kAlign);
  if (create) {
    self->file_size = heap_off + capacity;
    if (ftruncate(self->fd, static_cast<off_t>(self->file_size)) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return -1;
    }
  } else {
    struct stat st;
    if (fstat(self->fd, &st) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return -1;
    }
    self->file_size = static_cast<uint64_t>(st.st_size);
  }
  self->base = static_cast<uint8_t*>(
      mmap(nullptr, self->file_size, PROT_READ | PROT_WRITE, MAP_SHARED,
           self->fd, 0));
  if (self->base == MAP_FAILED) {
    self->base = nullptr;
    PyErr_SetFromErrno(PyExc_OSError);
    return -1;
  }
  if (create) {
    ArenaHeader* h = self->header();
    h->magic = kMagic;
    h->capacity = capacity;
    h->used = 0;
    h->num_blocks = 0;
    // One giant free block spanning the heap.
    self->set_block(0, capacity, /*free=*/true);
  } else if (self->header()->magic != kMagic) {
    PyErr_SetString(PyExc_ValueError, "not an art arena file");
    return -1;
  }
  self->owner = create;
  return 0;
}

// ------------------------------------------------------------------ methods

PyObject* arena_alloc(Arena* self, PyObject* arg) {
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "arena is closed");
    return nullptr;
  }
  unsigned long long nbytes_in = PyLong_AsUnsignedLongLong(arg);
  if (PyErr_Occurred()) return nullptr;
  uint64_t cap = self->heap_size();
  // Reject before the align_up below can wrap: a request near
  // UINT64_MAX would otherwise alias to a tiny `need`, silently
  // handing out a block the caller will overrun.
  if (nbytes_in > cap) {
    PyErr_SetString(PyExc_MemoryError, "arena full");
    return nullptr;
  }
  // Payload + header/footer tags, aligned.
  uint64_t need = align_up(nbytes_in + 2 * sizeof(uint64_t), kAlign);
  uint64_t off = 0;
  while (off < cap) {
    uint64_t tag = self->read_tag(off);
    uint64_t size = Arena::tag_size(tag);
    if (size == 0 || size > cap - off) {
      PyErr_SetString(PyExc_RuntimeError, "arena corruption detected");
      return nullptr;
    }
    if (Arena::tag_free(tag) && size >= need) {
      uint64_t remainder = size - need;
      if (remainder >= kAlign * 2) {
        self->set_block(off, need, false);
        self->set_block(off + need, remainder, true);
      } else {
        need = size;  // absorb the sliver
        self->set_block(off, size, false);
      }
      self->header()->used += need;
      self->header()->num_blocks += 1;
      // Payload begins after the header tag.
      return PyLong_FromUnsignedLongLong(off + sizeof(uint64_t));
    }
    off += size;
  }
  PyErr_SetString(PyExc_MemoryError, "arena full");
  return nullptr;
}

PyObject* arena_free(Arena* self, PyObject* arg) {
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "arena is closed");
    return nullptr;
  }
  unsigned long long payload_off = PyLong_AsUnsignedLongLong(arg);
  if (PyErr_Occurred()) return nullptr;
  if (payload_off < sizeof(uint64_t)) {
    PyErr_SetString(PyExc_ValueError, "bad offset");
    return nullptr;
  }
  uint64_t off = payload_off - sizeof(uint64_t);
  uint64_t cap = self->heap_size();
  if (off >= cap) {
    PyErr_SetString(PyExc_ValueError, "offset out of range");
    return nullptr;
  }
  uint64_t tag = self->read_tag(off);
  if (Arena::tag_free(tag)) {
    PyErr_SetString(PyExc_ValueError, "double free");
    return nullptr;
  }
  uint64_t size = Arena::tag_size(tag);
  self->header()->used -= size;
  self->header()->num_blocks -= 1;

  // Coalesce with next block.
  uint64_t next = off + size;
  if (next < cap) {
    uint64_t ntag = self->read_tag(next);
    if (Arena::tag_free(ntag)) size += Arena::tag_size(ntag);
  }
  // Coalesce with previous block (via its footer).
  if (off >= kAlign) {
    uint64_t ptag = self->read_tag(off - sizeof(uint64_t));
    if (Arena::tag_free(ptag)) {
      uint64_t psize = Arena::tag_size(ptag);
      off -= psize;
      size += psize;
    }
  }
  self->set_block(off, size, true);
  Py_RETURN_NONE;
}

PyObject* arena_view(Arena* self, PyObject* args) {
  unsigned long long off, nbytes;
  if (!PyArg_ParseTuple(args, "KK", &off, &nbytes)) return nullptr;
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "arena is closed");
    return nullptr;
  }
  uint64_t heap_start = align_up(sizeof(ArenaHeader), kAlign);
  uint64_t heap_bytes = self->file_size - heap_start;
  // Overflow-safe bound: check each term, then the sum via subtraction.
  if (off > heap_bytes || nbytes > heap_bytes - off) {
    PyErr_SetString(PyExc_ValueError, "view out of range");
    return nullptr;
  }
  return PyMemoryView_FromMemory(
      reinterpret_cast<char*>(self->heap() + off),
      static_cast<Py_ssize_t>(nbytes), PyBUF_WRITE);
}

PyObject* arena_close(Arena* self, PyObject*) {
  if (self->base != nullptr) {
    munmap(self->base, self->file_size);
    self->base = nullptr;
  }
  if (self->fd >= 0) {
    close(self->fd);
    self->fd = -1;
  }
  Py_RETURN_NONE;
}

PyObject* arena_get_used(Arena* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(0);
  return PyLong_FromUnsignedLongLong(self->header()->used);
}

PyObject* arena_get_capacity(Arena* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(0);
  return PyLong_FromUnsignedLongLong(self->header()->capacity);
}

PyObject* arena_get_num_blocks(Arena* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(0);
  return PyLong_FromUnsignedLongLong(self->header()->num_blocks);
}

PyObject* arena_get_heap_start(Arena* self, void*) {
  // Absolute file offset where payload offsets are rooted; clients add
  // this instead of duplicating the header layout.
  return PyLong_FromUnsignedLongLong(
      align_up(sizeof(ArenaHeader), kAlign));
}

// ================================================================ channel

// Header layout (all u64, 64-byte aligned block):
//   magic, capacity, num_readers, closed, version, msg_len, readers_done
using art_channel::ChannelHeader;
using art_channel::kChannelMagic;
using art_channel::ch_load;
using art_channel::ch_store;
using art_channel::ch_add;

struct Channel {
  PyObject_HEAD
  int fd;
  uint8_t* base;
  uint64_t file_size;
  uint64_t pending_write;  // bytes granted by write_begin, 0 otherwise

  ChannelHeader* header() { return reinterpret_cast<ChannelHeader*>(base); }
  uint8_t* payload() { return base + align_up(sizeof(ChannelHeader), kAlign); }
};

int channel_tp_init(PyObject* self_obj, PyObject* args, PyObject* kwargs) {
  Channel* self = reinterpret_cast<Channel*>(self_obj);
  self->fd = -1;
  self->base = nullptr;
  self->pending_write = 0;
  const char* path;
  unsigned long long capacity = 0;
  unsigned long long num_readers = 1;
  int create = 0;
  static const char* kwlist[] = {"path", "capacity", "num_readers",
                                 "create", nullptr};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "s|KKp", const_cast<char**>(kwlist), &path,
          &capacity, &num_readers, &create)) {
    return -1;
  }
  uint64_t header_sz = align_up(sizeof(ChannelHeader), kAlign);
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  self->fd = open(path, flags, 0600);
  if (self->fd < 0) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return -1;
  }
  if (create) {
    self->file_size = header_sz + align_up(capacity, kAlign);
    if (ftruncate(self->fd, static_cast<off_t>(self->file_size)) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return -1;
    }
  } else {
    struct stat st;
    if (fstat(self->fd, &st) != 0) {
      PyErr_SetFromErrno(PyExc_OSError);
      return -1;
    }
    self->file_size = static_cast<uint64_t>(st.st_size);
  }
  self->base = static_cast<uint8_t*>(
      mmap(nullptr, self->file_size, PROT_READ | PROT_WRITE, MAP_SHARED,
           self->fd, 0));
  if (self->base == MAP_FAILED) {
    self->base = nullptr;
    PyErr_SetFromErrno(PyExc_OSError);
    return -1;
  }
  if (create) {
    ChannelHeader* h = self->header();
    h->magic = kChannelMagic;
    h->capacity = align_up(capacity, kAlign);
    h->num_readers = num_readers;
    h->closed = 0;
    h->version = 0;
    h->msg_len = 0;
    // First write needs no reader handshake.
    h->readers_done = num_readers;
  } else if (self->header()->magic != kChannelMagic) {
    PyErr_SetString(PyExc_ValueError, "not an art channel file");
    return -1;
  }
  return 0;
}

PyObject* channel_write_begin(Channel* self, PyObject* args) {
  unsigned long long nbytes;
  double timeout_s = -1.0;
  if (!PyArg_ParseTuple(args, "K|d", &nbytes, &timeout_s)) return nullptr;
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  ChannelHeader* h = self->header();
  if (nbytes > h->capacity) {
    PyErr_Format(PyExc_MemoryError,
                 "message of %llu bytes exceeds channel capacity %llu",
                 nbytes, static_cast<unsigned long long>(h->capacity));
    return nullptr;
  }
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = art_channel::channel_writer_wait(h, timeout_s);
  Py_END_ALLOW_THREADS
  if (rc == 1) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  if (rc == 2) {
    PyErr_SetString(PyExc_TimeoutError,
                    "timed out waiting for readers of previous version");
    return nullptr;
  }
  self->pending_write = nbytes;
  return PyMemoryView_FromMemory(
      reinterpret_cast<char*>(self->payload()),
      static_cast<Py_ssize_t>(nbytes), PyBUF_WRITE);
}

PyObject* channel_write_commit(Channel* self, PyObject* arg) {
  unsigned long long nbytes = PyLong_AsUnsignedLongLong(arg);
  if (PyErr_Occurred()) return nullptr;
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  ChannelHeader* h = self->header();
  if (nbytes > self->pending_write) {
    PyErr_SetString(PyExc_ValueError, "commit larger than write_begin");
    return nullptr;
  }
  self->pending_write = 0;
  art_channel::channel_publish(h, nbytes);
  Py_RETURN_NONE;
}

PyObject* channel_read_acquire(Channel* self, PyObject* args) {
  unsigned long long last_version;
  double timeout_s = -1.0;
  if (!PyArg_ParseTuple(args, "K|d", &last_version, &timeout_s))
    return nullptr;
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  ChannelHeader* h = self->header();
  int rc;
  Py_BEGIN_ALLOW_THREADS
  rc = art_channel::channel_reader_wait(h, last_version, timeout_s);
  Py_END_ALLOW_THREADS
  if (rc == 1) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  if (rc == 2) Py_RETURN_NONE;
  uint64_t version = ch_load(&h->version);
  PyObject* view = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(self->payload()),
      static_cast<Py_ssize_t>(h->msg_len), PyBUF_READ);
  if (view == nullptr) return nullptr;
  PyObject* out = Py_BuildValue("KN", version, view);
  return out;
}

PyObject* channel_read_release(Channel* self, PyObject*) {
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  art_channel::channel_release(self->header());
  Py_RETURN_NONE;
}

PyObject* channel_remove_reader(Channel* self, PyObject*) {
  if (self->base == nullptr) {
    PyErr_SetString(PyExc_ValueError, "channel is closed");
    return nullptr;
  }
  // Reader-death recovery (ref: mutable-object reader failure handling,
  // experimental_mutable_object_manager.h): the control plane observed
  // a reader die; the writer must stop waiting for its releases.
  return PyLong_FromUnsignedLongLong(
      art_channel::channel_remove_reader(self->header()));
}

PyObject* channel_close(Channel* self, PyObject*) {
  if (self->base != nullptr) {
    ch_store(&self->header()->closed, 1);
    munmap(self->base, self->file_size);
    self->base = nullptr;
  }
  if (self->fd >= 0) {
    close(self->fd);
    self->fd = -1;
  }
  Py_RETURN_NONE;
}

PyObject* channel_get_version(Channel* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(-1);
  return PyLong_FromUnsignedLongLong(ch_load(&self->header()->version));
}

PyObject* channel_get_capacity(Channel* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(0);
  return PyLong_FromUnsignedLongLong(self->header()->capacity);
}

PyObject* channel_get_num_readers(Channel* self, void*) {
  if (self->base == nullptr) return PyLong_FromLong(0);
  return PyLong_FromUnsignedLongLong(self->header()->num_readers);
}

void channel_dealloc(PyObject* self_obj) {
  Channel* self = reinterpret_cast<Channel*>(self_obj);
  if (self->base != nullptr) munmap(self->base, self->file_size);
  if (self->fd >= 0) close(self->fd);
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyMethodDef channel_methods[] = {
    {"write_begin", reinterpret_cast<PyCFunction>(channel_write_begin),
     METH_VARARGS, "write_begin(nbytes, timeout=-1) -> writable view"},
    {"write_commit", reinterpret_cast<PyCFunction>(channel_write_commit),
     METH_O, "write_commit(nbytes) — publish the new version"},
    {"read_acquire", reinterpret_cast<PyCFunction>(channel_read_acquire),
     METH_VARARGS,
     "read_acquire(last_version, timeout=-1) -> (version, view) | None"},
    {"read_release", reinterpret_cast<PyCFunction>(channel_read_release),
     METH_NOARGS, "read_release() — done with the current version"},
    {"remove_reader", reinterpret_cast<PyCFunction>(channel_remove_reader),
     METH_NOARGS,
     "remove_reader() -> remaining — a reader died; stop waiting for it"},
    {"close", reinterpret_cast<PyCFunction>(channel_close), METH_NOARGS,
     "set closed flag and unmap"},
    {nullptr, nullptr, 0, nullptr}};

PyGetSetDef channel_getset[] = {
    {"version", reinterpret_cast<getter>(channel_get_version), nullptr,
     nullptr, nullptr},
    {"capacity", reinterpret_cast<getter>(channel_get_capacity), nullptr,
     nullptr, nullptr},
    {"num_readers", reinterpret_cast<getter>(channel_get_num_readers),
     nullptr, nullptr, nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PyTypeObject ChannelType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

int arena_tp_init(PyObject* self_obj, PyObject* args, PyObject* kwargs) {
  Arena* self = reinterpret_cast<Arena*>(self_obj);
  self->fd = -1;
  self->base = nullptr;
  const char* path;
  unsigned long long capacity = 0;
  int create = 0;
  static const char* kwlist[] = {"path", "capacity", "create", nullptr};
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "s|Kp", const_cast<char**>(kwlist), &path,
          &capacity, &create)) {
    return -1;
  }
  if (create && capacity < kAlign * 4) {
    PyErr_SetString(PyExc_ValueError, "capacity too small");
    return -1;
  }
  return arena_init_file(self, path, align_up(capacity, kAlign),
                         create != 0);
}

void arena_dealloc(PyObject* self_obj) {
  Arena* self = reinterpret_cast<Arena*>(self_obj);
  if (self->base != nullptr) munmap(self->base, self->file_size);
  if (self->fd >= 0) close(self->fd);
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyMethodDef arena_methods[] = {
    {"alloc", reinterpret_cast<PyCFunction>(arena_alloc), METH_O,
     "alloc(nbytes) -> payload offset"},
    {"free", reinterpret_cast<PyCFunction>(arena_free), METH_O,
     "free(offset)"},
    {"view", reinterpret_cast<PyCFunction>(arena_view), METH_VARARGS,
     "view(offset, nbytes) -> writable memoryview"},
    {"close", reinterpret_cast<PyCFunction>(arena_close), METH_NOARGS,
     "unmap and close"},
    {nullptr, nullptr, 0, nullptr}};

PyGetSetDef arena_getset[] = {
    {"used", reinterpret_cast<getter>(arena_get_used), nullptr, nullptr,
     nullptr},
    {"capacity", reinterpret_cast<getter>(arena_get_capacity), nullptr,
     nullptr, nullptr},
    {"num_blocks", reinterpret_cast<getter>(arena_get_num_blocks), nullptr,
     nullptr, nullptr},
    {"heap_start", reinterpret_cast<getter>(arena_get_heap_start), nullptr,
     nullptr, nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PyTypeObject ArenaType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------------
// PinnedBuffer: read-only buffer-protocol exporter tying a shared-memory
// window to an arbitrary owner object.  A numpy array deserialized
// zero-copy over one of these keeps it as its base, which keeps the
// owner (the client-side arena pin) alive until the array is GC'd — so
// the store can never recycle the slot under a live reader.  C-level
// because pure-Python buffer exporting (PEP 688 __buffer__) only exists
// on CPython >= 3.12 and this must work everywhere the package claims.

struct PinnedBuffer {
  PyObject_HEAD
  Py_buffer view;    // retained view of the source buffer
  PyObject* owner;   // kept alive while any consumer references us
  int has_view;
};

int pinned_tp_init(PyObject* self_obj, PyObject* args, PyObject* kwargs) {
  PinnedBuffer* self = reinterpret_cast<PinnedBuffer*>(self_obj);
  PyObject* source;
  PyObject* owner;
  static const char* kwlist[] = {"source", "owner", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "OO",
                                   const_cast<char**>(kwlist), &source,
                                   &owner)) {
    return -1;
  }
  if (self->has_view) {
    // No re-init: consumers may hold exported buffers over the current
    // view; releasing it under them would dangle their data pointers.
    PyErr_SetString(PyExc_ValueError,
                    "PinnedBuffer cannot be re-initialized");
    return -1;
  }
  if (PyObject_GetBuffer(source, &self->view, PyBUF_SIMPLE) < 0) return -1;
  self->has_view = 1;
  Py_INCREF(owner);
  self->owner = owner;
  return 0;
}

int pinned_getbuffer(PyObject* self_obj, Py_buffer* out, int flags) {
  PinnedBuffer* self = reinterpret_cast<PinnedBuffer*>(self_obj);
  if (!self->has_view) {
    PyErr_SetString(PyExc_BufferError, "PinnedBuffer not initialized");
    return -1;
  }
  if ((flags & PyBUF_WRITABLE) == PyBUF_WRITABLE) {
    PyErr_SetString(PyExc_BufferError, "PinnedBuffer is read-only");
    return -1;
  }
  return PyBuffer_FillInfo(out, self_obj, self->view.buf, self->view.len,
                           /*readonly=*/1, flags);
}

Py_ssize_t pinned_length(PyObject* self_obj) {
  PinnedBuffer* self = reinterpret_cast<PinnedBuffer*>(self_obj);
  return self->has_view ? self->view.len : 0;
}

void pinned_dealloc(PyObject* self_obj) {
  PinnedBuffer* self = reinterpret_cast<PinnedBuffer*>(self_obj);
  if (self->has_view) PyBuffer_Release(&self->view);
  Py_XDECREF(self->owner);
  Py_TYPE(self_obj)->tp_free(self_obj);
}

PyObject* pinned_get_owner(PyObject* self_obj, void*) {
  PinnedBuffer* self = reinterpret_cast<PinnedBuffer*>(self_obj);
  PyObject* owner = self->owner ? self->owner : Py_None;
  Py_INCREF(owner);
  return owner;
}

PyBufferProcs pinned_as_buffer = {pinned_getbuffer, nullptr};

PySequenceMethods pinned_as_sequence = {
    pinned_length,  // sq_length — len() == byte length, like memoryview
};

PyGetSetDef pinned_getset[] = {
    {"owner", reinterpret_cast<getter>(pinned_get_owner), nullptr, nullptr,
     nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PyTypeObject PinnedBufferType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

PyModuleDef art_torch_native_module = {
    PyModuleDef_HEAD_INIT, "art_torch_native",
    "native shared-memory arena for the object store", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit_art_torch_native(void) {
  ArenaType.tp_name = "art_torch_native.Arena";
  ArenaType.tp_basicsize = sizeof(Arena);
  ArenaType.tp_flags = Py_TPFLAGS_DEFAULT;
  ArenaType.tp_new = PyType_GenericNew;
  ArenaType.tp_init = arena_tp_init;
  ArenaType.tp_dealloc = arena_dealloc;
  ArenaType.tp_methods = arena_methods;
  ArenaType.tp_getset = arena_getset;
  if (PyType_Ready(&ArenaType) < 0) return nullptr;
  ChannelType.tp_name = "art_torch_native.Channel";
  ChannelType.tp_basicsize = sizeof(Channel);
  ChannelType.tp_flags = Py_TPFLAGS_DEFAULT;
  ChannelType.tp_new = PyType_GenericNew;
  ChannelType.tp_init = channel_tp_init;
  ChannelType.tp_dealloc = channel_dealloc;
  ChannelType.tp_methods = channel_methods;
  ChannelType.tp_getset = channel_getset;
  if (PyType_Ready(&ChannelType) < 0) return nullptr;
  PinnedBufferType.tp_name = "art_torch_native.PinnedBuffer";
  PinnedBufferType.tp_basicsize = sizeof(PinnedBuffer);
  PinnedBufferType.tp_flags = Py_TPFLAGS_DEFAULT;
  PinnedBufferType.tp_new = PyType_GenericNew;
  PinnedBufferType.tp_init = pinned_tp_init;
  PinnedBufferType.tp_dealloc = pinned_dealloc;
  PinnedBufferType.tp_as_buffer = &pinned_as_buffer;
  PinnedBufferType.tp_as_sequence = &pinned_as_sequence;
  PinnedBufferType.tp_getset = pinned_getset;
  if (PyType_Ready(&PinnedBufferType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&art_torch_native_module);
  if (m == nullptr) return nullptr;
  Py_INCREF(&ArenaType);
  PyModule_AddObject(m, "Arena",
                     reinterpret_cast<PyObject*>(&ArenaType));
  Py_INCREF(&ChannelType);
  PyModule_AddObject(m, "Channel",
                     reinterpret_cast<PyObject*>(&ChannelType));
  Py_INCREF(&PinnedBufferType);
  PyModule_AddObject(m, "PinnedBuffer",
                     reinterpret_cast<PyObject*>(&PinnedBufferType));
  return m;
}
