// Native streaming IO for comms_tpu_torch: double-buffered file reader
// and async block writer.  This package's copy of the JAX package's
// comms_tpu/native/loader.cpp, with the same C ABI; the port builds and
// loads its own library and never the JAX package's.
//
// Role parity: the reference's IO layer is native (Rust) — blocking
// byte readers/writers on dedicated node threads (the reference's
// src/io/raw_iq.rs).  Here the hot path is: a C++ reader thread fills a
// ring of block buffers from disk while the Python thread enqueues
// device work, so host IO overlaps device compute without the GIL; the
// writer drains results to disk the same way.
//
// C ABI (used from Python via ctypes, see loader.py):
//   reader_open(path, block_bytes, n_buffers, loop) -> handle
//   reader_next(handle) -> const uint8_t*   (nullptr at EOF)
//   reader_release(handle, ptr)
//   reader_close(handle)
//   writer_open(path, block_bytes, n_buffers) -> handle
//   writer_submit(handle, data, nbytes)      (copies + queues)
//   writer_close(handle)                     (drains, closes)
//
// Build (loader.py does it at first use, into build/comms_tpu_torch/native/):
//   g++ -O3 -shared -fPIC -pthread loader.cpp -o libcomms_io-<hash>.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Buffer {
  std::vector<uint8_t> data;
  size_t filled = 0;
};

struct Reader {
  FILE* f = nullptr;
  size_t block_bytes = 0;
  bool loop = false;
  std::vector<Buffer> buffers;
  std::queue<int> ready;   // filled, waiting for consumer
  std::queue<int> free_q;  // available to fill
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::thread th;
  std::atomic<bool> stop{false};
  bool eof = false;
  int in_flight = -1;

  void run() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop || !free_q.empty(); });
        if (stop) return;
        idx = free_q.front();
        free_q.pop();
      }
      Buffer& b = buffers[idx];
      size_t got = fread(b.data.data(), 1, block_bytes, f);
      if (got < block_bytes && loop && !stop) {
        // Wrap: refill the remainder from the file start so steady
        // benchmarks never starve (explicit EOF policy; the
        // reference sleeps forever then panics, raw_iq.rs:56-70).
        while (got < block_bytes) {
          if (fseek(f, 0, SEEK_SET) != 0) break;
          size_t more = fread(b.data.data() + got, 1, block_bytes - got, f);
          if (more == 0) break;
          got += more;
        }
      }
      b.filled = got;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (got == 0) {
          eof = true;
        } else {
          ready.push(idx);
        }
      }
      cv_ready.notify_one();
      if (got < block_bytes) {  // final short block (or EOF)
        std::lock_guard<std::mutex> lk(mu);
        eof = true;
        cv_ready.notify_one();
        return;
      }
    }
  }
};

struct Writer {
  FILE* f = nullptr;
  std::queue<std::vector<uint8_t>> pending;
  std::mutex mu;
  std::condition_variable cv;
  std::thread th;
  std::atomic<bool> stop{false};
  size_t max_queue = 0;

  void run() {
    for (;;) {
      std::vector<uint8_t> blk;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !pending.empty(); });
        if (pending.empty()) {
          if (stop) return;
          continue;
        }
        blk = std::move(pending.front());
        pending.pop();
      }
      cv.notify_all();
      fwrite(blk.data(), 1, blk.size(), f);
    }
  }
};

}  // namespace

extern "C" {

void* reader_open(const char* path, uint64_t block_bytes,
                  uint32_t n_buffers, int loop) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  r->block_bytes = static_cast<size_t>(block_bytes);
  r->loop = loop != 0;
  r->buffers.resize(n_buffers ? n_buffers : 3);
  for (size_t i = 0; i < r->buffers.size(); ++i) {
    r->buffers[i].data.resize(r->block_bytes);
    r->free_q.push(static_cast<int>(i));
  }
  r->th = std::thread([r] { r->run(); });
  return r;
}

// Returns the next filled block (blocking), or nullptr at EOF.
// *out_bytes receives the filled length (may be < block_bytes on the
// final block).  The buffer stays valid until reader_release.
const uint8_t* reader_next(void* handle, uint64_t* out_bytes) {
  auto* r = static_cast<Reader*>(handle);
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_ready.wait(lk, [&] { return !r->ready.empty() || r->eof; });
  if (r->ready.empty()) {
    *out_bytes = 0;
    return nullptr;
  }
  int idx = r->ready.front();
  r->ready.pop();
  r->in_flight = idx;
  *out_bytes = r->buffers[idx].filled;
  return r->buffers[idx].data.data();
}

void reader_release(void* handle, const uint8_t* ptr) {
  auto* r = static_cast<Reader*>(handle);
  std::lock_guard<std::mutex> lk(r->mu);
  for (size_t i = 0; i < r->buffers.size(); ++i) {
    if (r->buffers[i].data.data() == ptr) {
      r->free_q.push(static_cast<int>(i));
      r->cv_free.notify_one();
      return;
    }
  }
}

void reader_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  r->stop = true;
  r->cv_free.notify_all();
  r->cv_ready.notify_all();
  if (r->th.joinable()) r->th.join();
  fclose(r->f);
  delete r;
}

void* writer_open(const char* path, uint64_t /*block_bytes*/,
                  uint32_t n_buffers) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->max_queue = n_buffers ? n_buffers : 4;
  w->th = std::thread([w] { w->run(); });
  return w;
}

void writer_submit(void* handle, const uint8_t* data, uint64_t nbytes) {
  auto* w = static_cast<Writer*>(handle);
  std::vector<uint8_t> blk(data, data + nbytes);
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv.wait(lk, [&] { return w->pending.size() < w->max_queue; });
  w->pending.push(std::move(blk));
  w->cv.notify_all();
}

void writer_close(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  {
    std::unique_lock<std::mutex> lk(w->mu);
    w->cv.wait(lk, [&] { return w->pending.empty(); });
    w->stop = true;
  }
  w->cv.notify_all();
  if (w->th.joinable()) w->th.join();
  fflush(w->f);
  fclose(w->f);
  delete w;
}

}  // extern "C"
