// Bounded blocking queue of byte blobs + threaded recordio file loader.
//
// Parity targets in the reference:
//   - operators/reader/blocking_queue.h:27 (bounded MPMC queue feeding the
//     double-buffer reader)
//   - reader decorator ops create_threaded_reader / open_files /
//     create_double_buffer_reader (operators/reader/*.cc): N reader threads
//     ahead of the compute stream.
// Here the consumer is the Python feed path (host->TPU transfer); the C++
// threads keep the queue full so record parsing and disk IO overlap compute.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
struct RioScanner;
RioScanner* rio_scanner_open(const char* path, int64_t chunk_begin,
                             int64_t chunk_end);
int64_t rio_scanner_next(RioScanner* s, const uint8_t** data);
void rio_scanner_close(RioScanner* s);
}

namespace {

struct Blob {
  std::vector<uint8_t> data;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t cap) : cap_(cap) {}

  bool Push(Blob&& b) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return false;
    q_.push_back(std::move(b));
    not_empty_.notify_one();
    return true;
  }

  // Returns nullptr when closed and drained.
  Blob* Pop() {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return nullptr;
    Blob* b = new Blob(std::move(q_.front()));
    q_.pop_front();
    not_full_.notify_one();
    return b;
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    not_empty_.notify_all();
    not_full_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lk(mu_);
    return q_.size();
  }

  bool Closed() {
    std::lock_guard<std::mutex> lk(mu_);
    return closed_;
  }

 private:
  size_t cap_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Blob> q_;
  bool closed_ = false;
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Queue C API
// ---------------------------------------------------------------------------
BlockingQueue* bq_create(uint64_t capacity) {
  return new BlockingQueue(capacity ? capacity : 1);
}

int bq_push(BlockingQueue* q, const uint8_t* data, uint64_t len) {
  Blob b;
  b.data.assign(data, data + len);
  return q->Push(std::move(b)) ? 0 : -1;
}

// Returns a heap blob (caller frees with blob_free) or nullptr when the
// queue is closed and empty.
Blob* bq_pop(BlockingQueue* q) { return q->Pop(); }

uint64_t bq_size(BlockingQueue* q) { return q->Size(); }

void bq_close(BlockingQueue* q) { q->Close(); }

void bq_destroy(BlockingQueue* q) {
  q->Close();
  delete q;
}

const uint8_t* blob_data(Blob* b) { return b->data.data(); }
uint64_t blob_len(Blob* b) { return b->data.size(); }
void blob_free(Blob* b) { delete b; }

// ---------------------------------------------------------------------------
// Threaded recordio loader: N threads scan a list of files into one queue.
// ---------------------------------------------------------------------------
struct FileLoader {
  BlockingQueue* queue;
  std::vector<std::string> paths;
  std::vector<std::thread> threads;
  std::mutex mu;
  size_t next_path = 0;
  std::string error;
  bool stop = false;
  int active = 0;
};

static void loader_thread(FileLoader* L) {
  for (;;) {
    std::string path;
    {
      std::lock_guard<std::mutex> lk(L->mu);
      if (L->stop || L->next_path >= L->paths.size()) break;
      path = L->paths[L->next_path++];
    }
    RioScanner* s = rio_scanner_open(path.c_str(), 0, -1);
    if (!s) {
      std::lock_guard<std::mutex> lk(L->mu);
      L->error = "cannot open " + path;
      break;
    }
    const uint8_t* data;
    int64_t len;
    while ((len = rio_scanner_next(s, &data)) >= 0) {
      Blob b;
      b.data.assign(data, data + len);
      if (!L->queue->Push(std::move(b))) break;  // queue closed
    }
    rio_scanner_close(s);
    if (len == -2) {
      std::lock_guard<std::mutex> lk(L->mu);
      L->error = "corrupt recordio file " + path;
      break;
    }
  }
  std::lock_guard<std::mutex> lk(L->mu);
  if (--L->active == 0) L->queue->Close();  // last producer out: EOF
}

// paths: '\n'-separated file list. Threads share the work queue of files.
FileLoader* loader_open(const char* paths, uint64_t num_threads,
                        uint64_t queue_capacity) {
  auto* L = new FileLoader();
  L->queue = new BlockingQueue(queue_capacity ? queue_capacity : 256);
  const char* p = paths;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t n = nl ? size_t(nl - p) : strlen(p);
    if (n) L->paths.emplace_back(p, n);
    p += n + (nl ? 1 : 0);
  }
  size_t nthreads = num_threads ? num_threads : 1;
  if (nthreads > L->paths.size() && !L->paths.empty())
    nthreads = L->paths.size();
  L->active = static_cast<int>(nthreads);
  for (size_t i = 0; i < nthreads; i++)
    L->threads.emplace_back(loader_thread, L);
  return L;
}

// Pops the next record; nullptr at end of data.
Blob* loader_next(FileLoader* L) { return L->queue->Pop(); }

const char* loader_error(FileLoader* L) {
  std::lock_guard<std::mutex> lk(L->mu);
  return L->error.empty() ? "" : L->error.c_str();
}

void loader_close(FileLoader* L) {
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->queue->Close();
  for (auto& t : L->threads) t.join();
  delete L->queue;
  delete L;
}

}  // extern "C"
