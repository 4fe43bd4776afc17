// The shared-memory ring of the multiprocess DataLoader (built into
// libpaddle_tpu_torch_ps with ps_service.cc and pt_clock.cc by
// paddle_tpu_torch/_native/__init__.py). A copy of the ring section of the
// JAX package's native runtime, so the two packages' rings behave alike and
// each package's library, loaded RTLD_LOCAL, resolves its own pt_ring_*.
//
// Reference: memory/allocation/mmap_allocator.* and
// operators/reader/lod_tensor_blocking_queue.h, the multiprocess
// DataLoader transport.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#define PT_API extern "C" __attribute__((visibility("default")))

// Shared-memory ring buffer (multiprocess DataLoader transport)
//
// SPSC/MPSC circular byte buffer in POSIX shared memory with process-shared
// pthread mutex + condvars. Messages are 8-byte-length-prefixed and copied in
// up to two parts on wrap-around. One writer side per worker process; the
// parent reads. Capacity must exceed the largest single message.
// ---------------------------------------------------------------------------

namespace {
struct RingHeader {
  uint64_t magic;          // validity check
  int64_t capacity;        // data bytes
  int64_t head;            // read offset
  int64_t tail;            // write offset
  int64_t used;            // bytes in buffer
  int32_t closed;          // producer closed
  int32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t nonempty;
  pthread_cond_t nonfull;
};

constexpr uint64_t kRingMagic = 0x70745f72696e6701ULL;

struct Ring {
  RingHeader* hdr;
  char* data;
  size_t map_len;
  std::string name;
  bool owner;
};

char* ring_data(RingHeader* h) {
  return reinterpret_cast<char*>(h) + sizeof(RingHeader);
}

void abs_deadline(struct timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_MONOTONIC, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (long)(timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}
}  // namespace

PT_API void* pt_ring_create(const char* name, long long capacity) {
  shm_unlink(name);  // stale segment from a crashed prior run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t total = sizeof(RingHeader) + (size_t)capacity;
  if (ftruncate(fd, total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  RingHeader* h = (RingHeader*)mem;
  memset(h, 0, sizeof(RingHeader));
  h->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  // robust so a worker dying with the lock held doesn't hang the parent
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_condattr_setclock(&ca, CLOCK_MONOTONIC);
  pthread_cond_init(&h->nonempty, &ca);
  pthread_cond_init(&h->nonfull, &ca);

  h->magic = kRingMagic;
  Ring* r = new Ring{h, ring_data(h), total, name, true};
  return r;
}

PT_API void* pt_ring_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  RingHeader* h = (RingHeader*)mem;
  if (h->magic != kRingMagic) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  Ring* r = new Ring{h, ring_data(h), (size_t)st.st_size, name, false};
  return r;
}

namespace {
int lock_mu(RingHeader* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock (worker killed mid-write). Committed
    // messages (head..head+used) are intact, but tail may have advanced past
    // an uncommitted partial write — resync it and close the stream so the
    // consumer drains what is valid and the supervisor restarts the worker.
    h->tail = (h->head + h->used) % h->capacity;
    h->closed = 1;
    pthread_mutex_consistent(&h->mu);
    rc = 0;
  }
  return rc;
}
}  // namespace

// Blocking write with timeout. Returns 0 ok, -1 timeout, -2 closed/error,
// -3 message larger than capacity.
PT_API int pt_ring_write(void* ring, const void* src, long long len,
                         int timeout_ms) {
  Ring* r = (Ring*)ring;
  RingHeader* h = r->hdr;
  long long need = len + 8;
  if (need > h->capacity) return -3;
  if (lock_mu(h) != 0) return -2;
  struct timespec dl;
  abs_deadline(&dl, timeout_ms);
  while (h->capacity - h->used < need) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    int rc = pthread_cond_timedwait(&h->nonfull, &h->mu, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  // write 8-byte length, then payload, both possibly in two parts
  char lenbuf[8];
  memcpy(lenbuf, &len, 8);
  const char* parts[2] = {lenbuf, (const char*)src};
  long long plens[2] = {8, len};
  for (int p = 0; p < 2; ++p) {
    long long off = 0;
    while (off < plens[p]) {
      long long pos = h->tail % h->capacity;
      long long chunk = plens[p] - off;
      if (chunk > h->capacity - pos) chunk = h->capacity - pos;
      memcpy(r->data + pos, parts[p] + off, chunk);
      h->tail = (h->tail + chunk) % h->capacity;
      off += chunk;
    }
  }
  h->used += need;
  pthread_cond_signal(&h->nonempty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// Blocks until a message is available; returns its length, -1 on timeout,
// -2 if closed and drained.
PT_API long long pt_ring_next_len(void* ring, int timeout_ms) {
  Ring* r = (Ring*)ring;
  RingHeader* h = r->hdr;
  if (lock_mu(h) != 0) return -2;
  struct timespec dl;
  abs_deadline(&dl, timeout_ms);
  while (h->used < 8) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    int rc = pthread_cond_timedwait(&h->nonempty, &h->mu, &dl);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
  }
  long long len = 0;
  long long pos = h->head % h->capacity;
  char lenbuf[8];
  for (int i = 0; i < 8; ++i) lenbuf[i] = r->data[(pos + i) % h->capacity];
  memcpy(&len, lenbuf, 8);
  pthread_mutex_unlock(&h->mu);
  return len;
}

// Pops the next message into buf (must be >= its length). Returns bytes
// copied, or -2 on closed/error. Call after pt_ring_next_len.
PT_API long long pt_ring_read(void* ring, void* buf, long long buflen) {
  Ring* r = (Ring*)ring;
  RingHeader* h = r->hdr;
  if (lock_mu(h) != 0) return -2;
  if (h->used < 8) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  long long len = 0;
  char lenbuf[8];
  long long pos = h->head % h->capacity;
  for (int i = 0; i < 8; ++i) lenbuf[i] = r->data[(pos + i) % h->capacity];
  memcpy(&len, lenbuf, 8);
  if (len > buflen) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  h->head = (h->head + 8) % h->capacity;
  long long off = 0;
  while (off < len) {
    long long p = h->head % h->capacity;
    long long chunk = len - off;
    if (chunk > h->capacity - p) chunk = h->capacity - p;
    memcpy((char*)buf + off, r->data + p, chunk);
    h->head = (h->head + chunk) % h->capacity;
    off += chunk;
  }
  h->used -= len + 8;
  pthread_cond_broadcast(&h->nonfull);
  pthread_mutex_unlock(&h->mu);
  return len;
}

PT_API void pt_ring_close_producer(void* ring) {
  Ring* r = (Ring*)ring;
  RingHeader* h = r->hdr;
  if (lock_mu(h) != 0) return;
  h->closed = 1;
  pthread_cond_broadcast(&h->nonempty);
  pthread_cond_broadcast(&h->nonfull);
  pthread_mutex_unlock(&h->mu);
}

PT_API void pt_ring_free(void* ring, int unlink_shm) {
  Ring* r = (Ring*)ring;
  if (unlink_shm) shm_unlink(r->name.c_str());
  munmap(r->hdr, r->map_len);
  delete r;
}

PT_API long long pt_ring_used(void* ring) {
  Ring* r = (Ring*)ring;
  RingHeader* h = r->hdr;
  if (lock_mu(h) != 0) return -1;
  long long u = h->used;
  pthread_mutex_unlock(&h->mu);
  return u;
}
