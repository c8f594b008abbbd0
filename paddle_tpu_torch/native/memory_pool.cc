// Buddy-allocator host memory pool with usage stats.
//
// Parity target: paddle/fluid/memory/detail/buddy_allocator.h:33 and
// memory/malloc.h (Alloc/Free/memory_usage) in the reference.  On TPU the
// device allocator belongs to XLA/PJRT (SURVEY §7.1), so this pool serves the
// host side: staging buffers for feeds, recordio chunks, and checkpoint IO —
// pinned-host-equivalent arenas that avoid per-batch malloc/free churn.

#include <cstdint>
#include <cstdlib>
#include <map>
#include <mutex>
#include <set>
#include <unordered_map>

namespace {

class BuddyPool {
 public:
  BuddyPool(size_t capacity, size_t min_block)
      : min_block_(round_pow2(min_block ? min_block : 256)) {
    capacity_ = round_pow2(capacity ? capacity : (64u << 20));
    arena_ = static_cast<uint8_t*>(std::malloc(capacity_));
    if (arena_) free_[capacity_].insert(0);
  }

  ~BuddyPool() { std::free(arena_); }

  bool ok() const { return arena_ != nullptr; }

  void* Alloc(size_t n) {
    std::lock_guard<std::mutex> lk(mu_);
    size_t want = round_pow2(n < min_block_ ? min_block_ : n);
    auto it = free_.lower_bound(want);
    while (it != free_.end() && it->second.empty()) ++it;
    if (it == free_.end()) return nullptr;  // pool exhausted
    size_t block = it->first;
    size_t off = *it->second.begin();
    it->second.erase(it->second.begin());
    while (block > want) {  // split down to the target size
      block >>= 1;
      free_[block].insert(off + block);  // right half goes free
    }
    allocated_[off] = block;
    used_ += block;
    if (used_ > peak_) peak_ = used_;
    return arena_ + off;
  }

  bool Free(void* p) {
    std::lock_guard<std::mutex> lk(mu_);
    size_t off = static_cast<uint8_t*>(p) - arena_;
    auto it = allocated_.find(off);
    if (it == allocated_.end()) return false;
    size_t block = it->second;
    allocated_.erase(it);
    used_ -= block;
    while (block < capacity_) {  // coalesce with buddy while possible
      size_t buddy = off ^ block;
      auto fit = free_.find(block);
      if (fit == free_.end()) break;
      auto bit = fit->second.find(buddy);
      if (bit == fit->second.end()) break;
      fit->second.erase(bit);
      off = off < buddy ? off : buddy;
      block <<= 1;
    }
    free_[block].insert(off);
    return true;
  }

  size_t used() {
    std::lock_guard<std::mutex> lk(mu_);
    return used_;
  }
  size_t peak() {
    std::lock_guard<std::mutex> lk(mu_);
    return peak_;
  }
  size_t capacity() const { return capacity_; }

 private:
  static size_t round_pow2(size_t n) {
    size_t p = 1;
    while (p < n) p <<= 1;
    return p;
  }

  size_t capacity_, min_block_;
  uint8_t* arena_ = nullptr;
  std::mutex mu_;
  std::map<size_t, std::set<size_t>> free_;       // block size -> offsets
  std::unordered_map<size_t, size_t> allocated_;  // offset -> block size
  size_t used_ = 0, peak_ = 0;
};

}  // namespace

extern "C" {

BuddyPool* mp_create(uint64_t capacity, uint64_t min_block) {
  auto* p = new BuddyPool(capacity, min_block);
  if (!p->ok()) {
    delete p;
    return nullptr;
  }
  return p;
}

void* mp_alloc(BuddyPool* p, uint64_t n) { return p->Alloc(n); }
int mp_free(BuddyPool* p, void* ptr) { return p->Free(ptr) ? 0 : -1; }
uint64_t mp_used(BuddyPool* p) { return p->used(); }
uint64_t mp_peak(BuddyPool* p) { return p->peak(); }
uint64_t mp_capacity(BuddyPool* p) { return p->capacity(); }
void mp_destroy(BuddyPool* p) { delete p; }

}  // extern "C"
