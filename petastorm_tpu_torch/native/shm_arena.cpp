// Process-shared memory arena allocator: the data plane between the process
// pool's worker processes and the consumer.
//
// The port's copy of petastorm_tpu/native/shm_arena.cpp, unchanged in its
// logic.  The workers and the consumer share one host, so results move
// through a shared-memory arena: a worker copies (or decodes) column payloads
// in once, and the consumer wraps them as numpy arrays with no further copy.
//
// Layout: the Python side maps one POSIX shared-memory segment into every
// process (multiprocessing.shared_memory) and hands this library the base
// pointer.  The arena header holds a process-shared robust pthread mutex; the
// body is a first-fit free list with 64-byte aligned block headers, split on
// alloc and coalesced on free.  Frees may arrive out of allocation order
// (workers complete rowgroups out of order), which is why this is a free-list
// allocator and not a ring.
//
// C ABI (ctypes): psa_init / psa_alloc / psa_free / psa_free_bytes /
// psa_largest_free / psa_check.

#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr uint64_t kMagic = 0x70736130617265ULL;  // "psa0are"
constexpr uint64_t kAlign = 64;                   // cacheline; keeps numpy views aligned

struct ArenaHeader {
  uint64_t magic;
  uint64_t size;             // total mapped bytes, header included
  uint64_t first_block;      // offset of the first block header
  pthread_mutex_t mutex;
};

struct BlockHeader {
  uint64_t size;             // payload bytes (excluding this header)
  uint64_t next;             // offset of next block header, 0 = end
  uint32_t free_flag;        // 1 = free, 0 = allocated
  uint32_t pad;
  char align_pad[40];        // header = 64B, so payloads stay 64B-aligned
};
static_assert(sizeof(BlockHeader) == kAlign, "payload alignment broken");

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

inline ArenaHeader* header(void* mem) { return static_cast<ArenaHeader*>(mem); }

inline BlockHeader* block_at(void* mem, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(static_cast<char*>(mem) + off);
}

// Robust lock: if a worker died holding the mutex, recover its state and
// continue (the dead worker's allocation leaks until the arena is destroyed,
// which is the safe failure mode).
int lock(ArenaHeader* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

// Initialize an arena over `size` bytes of zeroed shared memory at `mem`.
// Called exactly once, by the consumer, before any worker attaches.
int psa_init(void* mem, uint64_t size) {
  if (size < sizeof(ArenaHeader) + sizeof(BlockHeader) + kAlign) return -1;
  ArenaHeader* h = header(mem);
  h->size = size;
  h->first_block = align_up(sizeof(ArenaHeader));

  pthread_mutexattr_t attr;
  if (pthread_mutexattr_init(&attr) != 0) return -2;
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  if (pthread_mutex_init(&h->mutex, &attr) != 0) {
    pthread_mutexattr_destroy(&attr);
    return -2;
  }
  pthread_mutexattr_destroy(&attr);

  BlockHeader* first = block_at(mem, h->first_block);
  first->size = size - h->first_block - sizeof(BlockHeader);
  first->next = 0;
  first->free_flag = 1;
  first->pad = 0;
  h->magic = kMagic;  // last: attaching processes spin on magic
  return 0;
}

// True once psa_init completed (workers poll this after mapping).
int psa_check(void* mem) { return header(mem)->magic == kMagic ? 1 : 0; }

// Allocate `size` payload bytes; returns the payload offset (64-byte aligned),
// or -1 when no block fits (caller retries / falls back), or -2 on corruption.
int64_t psa_alloc(void* mem, uint64_t size) {
  ArenaHeader* h = header(mem);
  if (h->magic != kMagic) return -2;
  uint64_t need = align_up(size ? size : 1);
  if (lock(h) != 0) return -2;

  int64_t result = -1;
  for (uint64_t off = h->first_block; off != 0;) {
    BlockHeader* b = block_at(mem, off);
    if (b->free_flag && b->size >= need) {
      uint64_t remainder = b->size - need;
      if (remainder > sizeof(BlockHeader) + kAlign) {
        // split: tail of this block becomes a new free block
        uint64_t new_off = off + sizeof(BlockHeader) + need;
        BlockHeader* nb = block_at(mem, new_off);
        nb->size = remainder - sizeof(BlockHeader);
        nb->next = b->next;
        nb->free_flag = 1;
        nb->pad = 0;
        b->size = need;
        b->next = new_off;
      }
      b->free_flag = 0;
      result = static_cast<int64_t>(off + sizeof(BlockHeader));
      break;
    }
    off = b->next;
  }
  pthread_mutex_unlock(&h->mutex);
  return result;
}

// Free the allocation whose *payload* starts at `payload_off`.
// Coalesces with free neighbours (prev found by list walk: block counts stay
// small because batches are large and short-lived).
int psa_free(void* mem, uint64_t payload_off) {
  ArenaHeader* h = header(mem);
  if (h->magic != kMagic) return -2;
  uint64_t off = payload_off - sizeof(BlockHeader);
  if (lock(h) != 0) return -2;

  BlockHeader* target = nullptr;
  BlockHeader* prev = nullptr;
  for (uint64_t cur = h->first_block; cur != 0;) {
    BlockHeader* b = block_at(mem, cur);
    if (cur == off) { target = b; break; }
    prev = b;
    cur = b->next;
  }
  if (target == nullptr || target->free_flag) {
    pthread_mutex_unlock(&h->mutex);
    return -1;  // not an allocated block (double free / bad offset)
  }
  target->free_flag = 1;
  // coalesce with next
  if (target->next != 0) {
    BlockHeader* nb = block_at(mem, target->next);
    if (nb->free_flag) {
      target->size += sizeof(BlockHeader) + nb->size;
      target->next = nb->next;
    }
  }
  // coalesce with prev
  if (prev != nullptr && prev->free_flag) {
    prev->size += sizeof(BlockHeader) + target->size;
    prev->next = target->next;
  }
  pthread_mutex_unlock(&h->mutex);
  return 0;
}

uint64_t psa_free_bytes(void* mem) {
  ArenaHeader* h = header(mem);
  if (h->magic != kMagic) return 0;
  if (lock(h) != 0) return 0;
  uint64_t total = 0;
  for (uint64_t off = h->first_block; off != 0;) {
    BlockHeader* b = block_at(mem, off);
    if (b->free_flag) total += b->size;
    off = b->next;
  }
  pthread_mutex_unlock(&h->mutex);
  return total;
}

uint64_t psa_largest_free(void* mem) {
  ArenaHeader* h = header(mem);
  if (h->magic != kMagic) return 0;
  if (lock(h) != 0) return 0;
  uint64_t largest = 0;
  for (uint64_t off = h->first_block; off != 0;) {
    BlockHeader* b = block_at(mem, off);
    if (b->free_flag && b->size > largest) largest = b->size;
    off = b->next;
  }
  pthread_mutex_unlock(&h->mutex);
  return largest;
}

}  // extern "C"
