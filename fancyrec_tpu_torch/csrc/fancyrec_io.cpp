// fancyrec_io: the host row gather for BigFile feature stores.
//
// The port's own copy of the JAX package's native/fancyrec_io.cpp (same C
// ABI for open, gather and close; same results). The hot host-side IO
// pattern of training and evaluation is "gather K scattered float32 rows
// from an (N x D) feature.bin into one contiguous batch buffer". This
// library memory-maps the file once and copies the rows on the caller's
// thread. Two changes from the JAX copy: no thread pool (the JAX copy
// spread every gather of 64 rows or more over threads; on the H100 host
// that was 30% slower than the numpy memmap on the recipe's frame gathers,
// and a serial copy ties the memmap there), and no madvise(WILLNEED)
// prefetch entry point, which no loader calls. No CUDA: it runs on the
// host beside the card, feeding the pinned batches; ctypes releases the
// interpreter lock for the call, so the loader's prefetch thread gathers
// while the main thread drives the card.
//
// C ABI (bound from Python with ctypes, fancyrec_tpu_torch/io/native.py):
//   frio_open(path, rows, dim)          -> handle (>=0) or -errno
//   frio_gather(handle, idx, n, out)    -> 0 or -1; out: n*dim float32
//   frio_close(handle)
//
// Built at first use with the host compiler (g++ -O3 -shared -fPIC
// -pthread) into build/host/ by fancyrec_tpu_torch.ops._build.load_host.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Store {
  // mu makes close safe against in-flight gathers: ctypes releases the
  // GIL around foreign calls, so a prefetch-thread gather can overlap a
  // main-thread close -- without the reader lock that is a
  // use-after-munmap. Gathers take mu shared; close takes it exclusive,
  // so it waits for running gathers to drain.
  std::shared_mutex mu;
  const float* base = nullptr;
  size_t bytes = 0;
  int64_t rows = 0;
  int64_t dim = 0;
  int fd = -1;
  // bumped every time the slot is (re)opened; the generation rides in
  // the handle's high bits so a stale handle whose slot was closed and
  // reused for a DIFFERENT file fails cleanly instead of silently
  // reading the new file's rows (handle-reuse ABA)
  uint32_t gen = 0;
  bool open = false;
};

std::mutex g_mu;
// unique_ptr: Store addresses must stay stable across vector growth
// (readers hold pointers outside g_mu) and shared_mutex is immovable
std::vector<std::unique_ptr<Store>> g_stores;

int64_t make_handle(int64_t slot, uint32_t gen) {
  return (static_cast<int64_t>(gen) << 31) | slot;
}

// -> (store, expected generation); callers must re-check open AND
// s->gen == gen under the store lock before touching the mapping
Store* store_for(int64_t handle, uint32_t* gen) {
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t slot = handle & 0x7fffffff;
  *gen = static_cast<uint32_t>(handle >> 31);
  if (handle < 0 || slot >= static_cast<int64_t>(g_stores.size()))
    return nullptr;
  return g_stores[slot].get();
}

}  // namespace

extern "C" {

int64_t frio_open(const char* path, int64_t rows, int64_t dim) {
  if (rows <= 0 || dim <= 0 ||
      static_cast<uint64_t>(rows) >
          SIZE_MAX / sizeof(float) / static_cast<uint64_t>(dim))
    return -EINVAL;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  size_t need = static_cast<size_t>(rows) * dim * sizeof(float);
  if (static_cast<size_t>(st.st_size) < need) {
    ::close(fd);
    return -EINVAL;
  }
  void* p = mmap(nullptr, need, PROT_READ, MAP_SHARED, fd, 0);
  if (p == MAP_FAILED) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  madvise(p, need, MADV_RANDOM);
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t slot = -1;
  for (size_t i = 0; i < g_stores.size(); ++i) {
    // reuse closed slots; taking the store's exclusive lock here is
    // cheap (no readers can hold a closed store's lock across calls)
    std::unique_lock<std::shared_mutex> su(g_stores[i]->mu,
                                           std::try_to_lock);
    if (su.owns_lock() && !g_stores[i]->open) {
      slot = static_cast<int64_t>(i);
      break;
    }
  }
  if (slot < 0) {
    g_stores.emplace_back(new Store());
    slot = static_cast<int64_t>(g_stores.size() - 1);
  }
  Store& s = *g_stores[slot];
  std::unique_lock<std::shared_mutex> su(s.mu);
  s.base = static_cast<const float*>(p);
  s.bytes = need;
  s.rows = rows;
  s.dim = dim;
  s.fd = fd;
  s.gen = (s.gen + 1) & 0x7fffffff;   // new identity for this slot
  s.open = true;
  return make_handle(slot, s.gen);
}

int frio_gather(int64_t handle, const int64_t* idx, int64_t n, float* out) {
  uint32_t gen;
  Store* sp = store_for(handle, &gen);
  if (!sp) return -1;
  // shared (reader) lock held for the whole copy: frio_close's exclusive
  // lock cannot munmap the mapping under our memcpys. The generation
  // check (under the lock) rejects a handle whose slot was closed and
  // reopened for a different file between store_for and here.
  std::shared_lock<std::shared_mutex> rl(sp->mu);
  const Store& s = *sp;
  if (!s.open || s.gen != gen) return -1;
  for (int64_t i = 0; i < n; ++i) {
    if (idx[i] < 0 || idx[i] >= s.rows) return -1;
  }
  size_t row_bytes = s.dim * sizeof(float);
  for (int64_t i = 0; i < n; ++i) {
    memcpy(out + i * s.dim, s.base + idx[i] * s.dim, row_bytes);
  }
  return 0;
}

int frio_close(int64_t handle) {
  uint32_t gen;
  Store* sp = store_for(handle, &gen);
  if (!sp) return -1;
  // exclusive lock: drains in-flight gathers before unmapping
  std::unique_lock<std::shared_mutex> wl(sp->mu);
  if (!sp->open || sp->gen != gen) return -1;
  munmap(const_cast<float*>(sp->base), sp->bytes);
  ::close(sp->fd);
  sp->open = false;
  return 0;
}

}  // extern "C"
