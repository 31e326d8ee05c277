// Native plasma-equivalent object store core.
//
// Equivalent of the reference's plasma store internals (ref:
// src/ray/object_manager/plasma/store.h:55 ObjectLifecycleManager,
// eviction_policy.h LRUCache, object_store.h allocation). Deliberate
// design divergence: the reference maps ONE big arena and refcounts
// client attachments through IPC; here every object is its own
// shm_open()'d segment, so an evicted object's memory survives for any
// process still holding a zero-copy view (unlink semantics) without a
// cross-process refcount protocol. The C++ layer owns the hot metadata
// path: allocation accounting, LRU ordering, spill/evict decisions,
// segment lifecycle, and crc32c seal checksums (integrity check the
// pure-Python store never had).
//
// C ABI for ctypes (pybind11 is not in the image).
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <list>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>

namespace {

// software crc32c (Castagnoli), slice-by-1; ~1 GB/s — run at seal time
// on the already-written buffer, far from the memcpy hot path.
struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      t[i] = c;
    }
  }
};

uint32_t crc32c(const uint8_t* data, size_t n) {
  // magic-static: thread-safe one-time init (two Store instances sealing
  // concurrently raced the old lazy bool-guarded fill)
  static const Crc32cTable tbl;
  const uint32_t* table = tbl.t;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Entry {
  void* base = nullptr;   // mapped segment (nullptr when spilled)
  uint64_t size = 0;
  bool sealed = false;
  bool pinned = false;
  uint32_t crc = 0;
  bool has_crc = false;
  std::string spill_path;  // non-empty when spilled to disk
  std::list<std::string>::iterator lru_it;
};

struct Store {
  std::mutex mu;
  std::string prefix;
  std::string spill_dir;
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t min_spill = 1 << 20;
  uint64_t num_evictions = 0;
  uint64_t num_spills = 0;
  std::unordered_map<std::string, Entry> objects;
  std::list<std::string> lru;  // front = least recently used
};

std::string seg_name(Store* s, const std::string& oid) {
  return s->prefix + "_" + oid;
}

void* map_segment(const std::string& name, uint64_t size, bool create) {
  int flags = create ? (O_RDWR | O_CREAT | O_EXCL) : O_RDWR;
  int fd = shm_open(("/" + name).c_str(), flags, 0666);
  if (fd < 0 && create && errno == EEXIST) {
    shm_unlink(("/" + name).c_str());  // stale from a previous run
    fd = shm_open(("/" + name).c_str(), flags, 0666);
  }
  if (fd < 0) return nullptr;
  uint64_t sz = size ? size : 1;
  if (create && ftruncate(fd, (off_t)sz) != 0) {
    close(fd);
    shm_unlink(("/" + name).c_str());
    return nullptr;
  }
  void* p = mmap(nullptr, sz, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  return p == MAP_FAILED ? nullptr : p;
}

void unmap_unlink(Store* s, const std::string& oid, Entry& e,
                  bool unlink_file) {
  if (e.base) {
    munmap(e.base, e.size ? e.size : 1);
    e.base = nullptr;
    if (unlink_file) shm_unlink(("/" + seg_name(s, oid)).c_str());
  }
}

// returns false when nothing more can be freed
bool free_one(Store* s, uint64_t needed) {
  for (auto it = s->lru.begin(); it != s->lru.end(); ++it) {
    auto oit = s->objects.find(*it);
    if (oit == s->objects.end()) continue;
    Entry& e = oit->second;
    if (!e.sealed || e.pinned || e.base == nullptr) continue;
    std::string oid = *it;
    if (!s->spill_dir.empty() && e.size >= s->min_spill) {
      // spill: restorable later (ref: local_object_manager.h:110)
      std::string path = s->spill_dir + "/" + seg_name(s, oid);
      FILE* f = fopen(path.c_str(), "wb");
      if (f) {
        // a short write (disk full/quota) recorded as a successful spill
        // would silently lose the object at restore time — verify both
        // the write and the flush-on-close before unmapping memory
        size_t wrote = fwrite(e.base, 1, e.size, f);
        int closed = fclose(f);
        if (wrote == e.size && closed == 0) {
          e.spill_path = path;
          unmap_unlink(s, oid, e, true);
          s->used -= e.size;
          s->num_spills++;
          return true;
        }
        unlink(path.c_str());  // drop the partial file
      }
      // spill failed: fall through to plain eviction
    }
    s->used -= e.size;
    unmap_unlink(s, oid, e, true);
    s->lru.erase(e.lru_it);
    s->objects.erase(oit);
    s->num_evictions++;
    return true;
  }
  (void)needed;
  return false;
}

void touch(Store* s, const std::string& oid, Entry& e) {
  s->lru.erase(e.lru_it);
  s->lru.push_back(oid);
  e.lru_it = std::prev(s->lru.end());
}

}  // namespace

extern "C" {

void* rtpu_store_open(const char* prefix, uint64_t capacity,
                      const char* spill_dir, uint64_t min_spill) {
  Store* s = new Store();
  s->prefix = prefix;
  s->capacity = capacity;
  s->spill_dir = spill_dir ? spill_dir : "";
  if (min_spill) s->min_spill = min_spill;
  return s;
}

// 0 ok; -1 object larger than capacity; -2 store full (all pinned)
int rtpu_store_create(void* h, const char* oid_c, uint64_t size) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  std::string oid(oid_c);
  auto it = s->objects.find(oid);
  if (it != s->objects.end()) {  // idempotent re-create (lineage re-run)
    Entry& e = it->second;
    if (e.base) s->used -= e.size;
    unmap_unlink(s, oid, e, true);
    if (!e.spill_path.empty()) unlink(e.spill_path.c_str());
    s->lru.erase(e.lru_it);
    s->objects.erase(it);
  }
  if (size > s->capacity) return -1;
  while (s->used + size > s->capacity) {
    if (!free_one(s, size)) return -2;
  }
  void* base = map_segment(seg_name(s, oid), size, true);
  if (!base) return -2;
  Entry e;
  e.base = base;
  e.size = size;
  s->lru.push_back(oid);
  e.lru_it = std::prev(s->lru.end());
  s->objects.emplace(oid, e);
  s->used += size;
  return 0;
}

int rtpu_store_seal(void* h, const char* oid_c, int with_crc) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  if (it == s->objects.end()) return -1;
  Entry& e = it->second;
  e.sealed = true;
  if (with_crc && e.base) {
    e.crc = crc32c((const uint8_t*)e.base, e.size);
    e.has_crc = true;
  }
  touch(s, it->first, e);
  return 0;
}

// verify a sealed object against its seal-time checksum.
// 1 = ok, 0 = CORRUPTED, -1 = unknown/no crc/spilled
int rtpu_store_verify(void* h, const char* oid_c) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  if (it == s->objects.end()) return -1;
  Entry& e = it->second;
  if (!e.has_crc || !e.base) return -1;
  return crc32c((const uint8_t*)e.base, e.size) == e.crc ? 1 : 0;
}

int rtpu_store_pin(void* h, const char* oid_c, int pinned) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  if (it == s->objects.end()) return -1;
  it->second.pinned = pinned != 0;
  return 0;
}

int rtpu_store_contains(void* h, const char* oid_c) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  return (it != s->objects.end() && it->second.sealed) ? 1 : 0;
}

// get a writable/readable pointer to the (restored-if-spilled) segment.
// returns 0 and fills ptr/size; -1 unknown; -2 restore failed
int rtpu_store_get(void* h, const char* oid_c, void** ptr,
                   uint64_t* size, int* sealed) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  if (it == s->objects.end()) return -1;
  Entry& e = it->second;
  if (e.base == nullptr) {
    if (e.spill_path.empty()) return -1;
    while (s->used + e.size > s->capacity) {
      if (!free_one(s, e.size)) return -2;
    }
    void* base = map_segment(seg_name(s, it->first), e.size, true);
    if (!base) return -2;
    FILE* f = fopen(e.spill_path.c_str(), "rb");
    if (!f) {
      munmap(base, e.size ? e.size : 1);
      return -2;
    }
    size_t got = fread(base, 1, e.size, f);
    fclose(f);
    if (got != e.size) {
      munmap(base, e.size ? e.size : 1);
      return -2;
    }
    e.base = base;
    s->used += e.size;
  }
  touch(s, it->first, e);
  *ptr = e.base;
  *size = e.size;
  *sealed = e.sealed ? 1 : 0;
  return 0;
}

int rtpu_store_delete(void* h, const char* oid_c) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(oid_c);
  if (it == s->objects.end()) return 0;
  Entry& e = it->second;
  if (e.base) s->used -= e.size;
  unmap_unlink(s, it->first, e, true);
  if (!e.spill_path.empty()) unlink(e.spill_path.c_str());
  s->lru.erase(e.lru_it);
  s->objects.erase(it);
  return 0;
}

void rtpu_store_stats(void* h, uint64_t* used, uint64_t* capacity,
                      uint64_t* count, uint64_t* evictions,
                      uint64_t* spills) {
  Store* s = (Store*)h;
  std::lock_guard<std::mutex> g(s->mu);
  *used = s->used;
  *capacity = s->capacity;
  *count = s->objects.size();
  *evictions = s->num_evictions;
  *spills = s->num_spills;
}

void rtpu_store_destroy(void* h) {
  Store* s = (Store*)h;
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (auto& kv : s->objects) {
      unmap_unlink(s, kv.first, kv.second, true);
      if (!kv.second.spill_path.empty())
        unlink(kv.second.spill_path.c_str());
    }
    s->objects.clear();
    s->lru.clear();
    s->used = 0;
  }
  delete s;
}

}  // extern "C"
