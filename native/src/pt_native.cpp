// Native host runtime for path_tracer_jax.
//
// Equivalents of the reference's C runtime components
// (SURVEY.md SS2): the pthread worker pool C5 (/root/reference/src/
// threadpool.c) and void* vector C6 (src/vector.c) become a C++17
// condition-variable thread pool with correct in-flight accounting (the
// reference's pool signals "exhausted" while tasks are still running,
// src/threadpool.c:24, and races on threads_running, src/threadpool.c:
// 18,62 — deliberately not replicated); the BMP writer C7 (src/bitmap.c)
// becomes a parallel row encoder producing byte-identical output.
//
// The *render* parallelism lives on the accelerator; this runtime covers
// the host side: image encoding, asynchronous frame output for animation
// sweeps (device renders frame n+1 while the host writes frame n), and
// generic task submission. Exposed as a plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Thread pool (C5/C6 replacement, race-free)
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n_threads) : stop_(false), in_flight_(0) {
    if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
    workers_.reserve(n_threads);
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    // notify_all, unlike the reference's single cond_signal on shutdown
    // for N workers (src/threadpool.c:63).
    available_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> task) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      queue_.push_back(std::move(task));
      ++in_flight_;
    }
    available_.notify_one();
  }

  // Blocks until queue empty AND all running tasks finished — the
  // correctness fix over threadpool_wait_for_tasks (src/threadpool.c:97).
  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    exhausted_.wait(lk, [this] { return in_flight_ == 0; });
  }

  int size() const { return static_cast<int>(workers_.size()); }

 private:
  void WorkerLoop() {
    for (;;) {
      std::function<void()> task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        available_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        task = std::move(queue_.front());
        queue_.pop_front();
      }
      task();
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--in_flight_ == 0) exhausted_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable available_;
  std::condition_variable exhausted_;
  std::deque<std::function<void()>> queue_;
  std::vector<std::thread> workers_;
  bool stop_;
  int in_flight_;
};

// ---------------------------------------------------------------------------
// BMP encoding (C7 replacement, byte-identical to src/bitmap.c)
// ---------------------------------------------------------------------------

inline void PutLE32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

inline void PutLE16(uint8_t* p, uint16_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
}

// Serializes (h, w, 3) RGB8 (row 0 = image top when y_inverted) into a
// 24-bit BMP: 54-byte header, BGR pixels, rows padded to 4 bytes, rows
// stored bottom-up (src/bitmap.c:5-78).
size_t EncodeBMP(const uint8_t* rgb, uint32_t w, uint32_t h, int y_inverted,
                 uint8_t* out, ThreadPool* pool) {
  const uint32_t row_padding = (4 - (w * 3) % 4) % 4;
  const uint32_t stride = 3 * w + row_padding;
  const uint32_t file_size = 14 + 40 + stride * h;

  uint8_t* hd = out;
  hd[0] = 'B';
  hd[1] = 'M';
  PutLE32(hd + 2, file_size);
  PutLE32(hd + 6, 0);
  PutLE32(hd + 10, 54);
  PutLE32(hd + 14, 40);
  PutLE32(hd + 18, w);
  PutLE32(hd + 22, h);
  PutLE16(hd + 26, 1);
  PutLE16(hd + 28, 24);
  PutLE32(hd + 30, 0);
  PutLE32(hd + 34, stride * h);
  PutLE32(hd + 38, 0);
  PutLE32(hd + 42, 0);
  PutLE32(hd + 46, 0);
  PutLE32(hd + 50, 0);

  uint8_t* body = out + 54;
  auto encode_row = [&](uint32_t out_row) {
    // BMP rows are bottom-up; y_inverted means rgb row 0 is the image top.
    const uint32_t src_row = y_inverted ? (h - 1 - out_row) : out_row;
    const uint8_t* src = rgb + static_cast<size_t>(src_row) * w * 3;
    uint8_t* dst = body + static_cast<size_t>(out_row) * stride;
    for (uint32_t x = 0; x < w; ++x) {
      dst[3 * x + 0] = src[3 * x + 2];
      dst[3 * x + 1] = src[3 * x + 1];
      dst[3 * x + 2] = src[3 * x + 0];
    }
    for (uint32_t p = 0; p < row_padding; ++p) dst[3 * w + p] = 0;
  };

  if (pool != nullptr && h >= 64) {
    const uint32_t n_chunks = pool->size() * 2;
    const uint32_t chunk = (h + n_chunks - 1) / n_chunks;
    for (uint32_t c = 0; c < n_chunks; ++c) {
      const uint32_t lo = c * chunk;
      const uint32_t hi = std::min(h, lo + chunk);
      if (lo >= hi) break;
      pool->Submit([=] {
        for (uint32_t r = lo; r < hi; ++r) encode_row(r);
      });
    }
    pool->Wait();
  } else {
    for (uint32_t r = 0; r < h; ++r) encode_row(r);
  }
  return file_size;
}

ThreadPool* g_pool = nullptr;
ThreadPool* Pool() {
  if (g_pool == nullptr) g_pool = new ThreadPool(0);
  return g_pool;
}

}  // namespace

extern "C" {

// --- thread pool C API ---

void* pt_pool_create(int n_threads) { return new ThreadPool(n_threads); }
void pt_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }
int pt_pool_size(void* pool) { return static_cast<ThreadPool*>(pool)->size(); }

typedef void (*pt_task_fn)(void* arg);

void pt_pool_submit(void* pool, pt_task_fn fn, void* arg) {
  static_cast<ThreadPool*>(pool)->Submit([fn, arg] { fn(arg); });
}

void pt_pool_wait(void* pool) { static_cast<ThreadPool*>(pool)->Wait(); }

// --- BMP C API ---

// Required output buffer size for pt_bmp_encode.
uint64_t pt_bmp_size(uint32_t w, uint32_t h) {
  const uint32_t row_padding = (4 - (w * 3) % 4) % 4;
  return 54 + static_cast<uint64_t>(3 * w + row_padding) * h;
}

// Encode to caller buffer; returns bytes written.
uint64_t pt_bmp_encode(const uint8_t* rgb, uint32_t w, uint32_t h,
                       int y_inverted, uint8_t* out) {
  return EncodeBMP(rgb, w, h, y_inverted, out, Pool());
}

// Encode + write to file; returns 0 on success.
int pt_bmp_write(const char* path, const uint8_t* rgb, uint32_t w, uint32_t h,
                 int y_inverted) {
  const uint64_t size = pt_bmp_size(w, h);
  std::vector<uint8_t> buf(size);
  EncodeBMP(rgb, w, h, y_inverted, buf.data(), Pool());
  FILE* f = fopen(path, "wb");
  if (f == nullptr) return -1;
  const size_t n = fwrite(buf.data(), 1, size, f);
  fclose(f);
  return n == size ? 0 : -2;
}

// --- async frame writer (animation pipeline) ---
// Copies the frame, encodes+writes on the pool, so the caller (the render
// loop) can immediately launch the next device render. The task encodes
// serially: a pool task must never fan out to and Wait() on its own pool
// (the waiting task counts as in-flight, which deadlocks Wait) —
// parallelism here comes from overlapping frames, not rows.

int pt_bmp_write_async(const char* path, const uint8_t* rgb, uint32_t w,
                       uint32_t h, int y_inverted) {
  std::string p(path);
  std::vector<uint8_t> copy(rgb, rgb + static_cast<size_t>(w) * h * 3);
  Pool()->Submit([p = std::move(p), copy = std::move(copy), w, h,
                  y_inverted]() {
    const uint64_t size = pt_bmp_size(w, h);
    std::vector<uint8_t> buf(size);
    EncodeBMP(copy.data(), w, h, y_inverted, buf.data(), /*pool=*/nullptr);
    FILE* f = fopen(p.c_str(), "wb");
    if (f == nullptr) return;
    fwrite(buf.data(), 1, size, f);
    fclose(f);
  });
  return 0;
}

void pt_drain() { Pool()->Wait(); }

}  // extern "C"
