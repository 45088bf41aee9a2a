// Native layer-commit pipeline: tar content framing + dual SHA-256 +
// deterministic gzip, one pass, no Python on the per-byte path.
//
// The reference streams layer tars through two SHA-256 digesters and
// pgzip via goroutine fan-out (lib/builder/step/common.go:35-64,
// lib/stream/multi_writer.go:25). CPython's equivalent pays interpreter
// overhead per write; this sink takes pre-rendered tar header blocks
// from Python (byte-identical PAX headers via TarInfo.tobuf) but reads
// file content, pads entries, hashes the tar stream, compresses, hashes
// the gzip stream, and writes the blob file entirely in native code.
//
// The port's copy of makisu_tpu's native/layersink.cpp. One change: the
// tap receives the stream in pieces of up to kTapBatch bytes (the copy
// batches the headers, pads and 256 KiB reads it consumes), since each
// call into the tap takes the Python interpreter's lock. The blob bytes
// are the same as the reference's.
//
// Output bytes are identical to the Python pipeline for both backends:
//   zlib-<level>        : gzip header 1f 8b 08 00 0*4 <xfl> ff + one
//                         continuous deflate stream (memLevel 8) + crc32/
//                         isize trailer, as CPython
//                         gzip.GzipFile(mtime=0, filename="").
//   pgzip-<level>-<blk> : fixed header 1f 8b 08 00 0*4 00 ff + blockwise
//                         deflate segments (Z_SYNC_FLUSH, last Z_FINISH),
//                         as pgzip.cpp / tario.BlockGzipWriter.
//
// C ABI (ctypes):
//   lsk_new(out_fd, pgzip, level, block_size, nthreads) -> handle
//   lsk_write(h, data, n)            raw tar bytes (headers, inline data)
//   lsk_set_tap(h, fn, user)         uncompressed-stream callback
//   lsk_write_file(h, path, size)    file content + 512-byte padding
//   lsk_finish(h, tar_sha32, gz_sha32, &gz_size, &tar_size)
//   lsk_free(h)
// All int-returning calls: 0 = ok, negative = error.

#include <dlfcn.h>
#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include "deflate_common.h"
#include "sha256_common.h"

namespace {

using makisu_native::DeflateSlice;
using makisu_native::Digest256;
using makisu_native::GzipTrailer;

struct BlockJob {
  std::vector<uint8_t> in;
  std::vector<uint8_t> out;
  bool last = false;
  bool done = false;
  bool failed = false;
};

struct Sink {
  int fd = -1;
  bool pgzip = false;
  int level = 6;
  size_t block_size = 0;
  Digest256 tar_sha;  // uncompressed tar stream (diffID)
  Digest256 gz_sha;   // compressed blob (registry digest)
  // Optional tap: every uncompressed tar byte is also handed to this
  // callback (the GPU chunk session consumes the stream for CDC while
  // the native pipeline owns framing/hashing/compression). Invoked on
  // the lsk_write/lsk_write_file caller's thread.
  void (*tap)(const uint8_t*, size_t, void*) = nullptr;
  void* tap_user = nullptr;
  static constexpr size_t kTapBatch = 1 << 20;
  std::vector<uint8_t> tap_buf;  // bytes not yet handed to the tap
  uint64_t gz_size = 0;
  uint64_t tar_size = 0;
  uLong crc = 0;          // crc32 of the uncompressed stream (trailer)
  bool failed = false;
  bool zinit = false;

  // zlib backend: one continuous deflate stream.
  z_stream zs;
  std::vector<uint8_t> zbuf;

  // pgzip backend: blockwise jobs compressed by a pool, written in order.
  std::vector<uint8_t> pending;
  std::deque<BlockJob*> jobs;         // submission order (writeback)
  std::deque<BlockJob*> claim_queue;  // awaiting a worker
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;
  bool stopping = false;

  ~Sink() {
    if (!workers.empty()) {
      {
        std::lock_guard<std::mutex> lock(mu);
        stopping = true;
      }
      cv_work.notify_all();
      for (auto& t : workers) t.join();
    }
    for (auto* j : jobs) delete j;
    if (zinit) deflateEnd(&zs);
  }

  bool write_fd(const uint8_t* data, size_t n) {
    gz_sha.update(data, n);
    gz_size += n;
    size_t off = 0;
    while (off < n) {
      ssize_t w = ::write(fd, data + off, n - off);
      if (w < 0) {
        if (errno == EINTR) continue;
        return false;
      }
      off += static_cast<size_t>(w);
    }
    return true;
  }

  bool write_gzip_header() {
    if (pgzip) {
      if (!write_fd(makisu_native::kPgzipHeader, 10)) return false;
    } else {
      // CPython gzip.GzipFile header: XFL reflects the level.
      uint8_t xfl = level == 9 ? 2 : (level == 1 ? 4 : 0);
      const uint8_t header[10] = {0x1f, 0x8b, 0x08, 0, 0,
                                  0,    0,    0,    xfl, 0xff};
      if (!write_fd(header, 10)) return false;
    }
    if (!pgzip) {
      std::memset(&zs, 0, sizeof(zs));
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) {
        return false;
      }
      zinit = true;
      zbuf.resize(256 * 1024);
    }
    return true;
  }

  bool zlib_consume(const uint8_t* data, size_t n, bool finish) {
    zs.next_in = const_cast<Bytef*>(data);
    zs.avail_in = static_cast<uInt>(n);
    for (;;) {
      zs.next_out = zbuf.data();
      zs.avail_out = static_cast<uInt>(zbuf.size());
      int rc = deflate(&zs, finish ? Z_FINISH : Z_NO_FLUSH);
      if (rc == Z_STREAM_ERROR) return false;
      size_t got = zbuf.size() - zs.avail_out;
      if (got && !write_fd(zbuf.data(), got)) return false;
      if (finish) {
        if (rc == Z_STREAM_END) return true;
        continue;  // more output pending
      }
      if (zs.avail_in == 0) return true;
    }
  }

  void worker_loop() {
    for (;;) {
      BlockJob* job = nullptr;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_work.wait(lock,
                     [&] { return stopping || !claim_queue.empty(); });
        if (claim_queue.empty()) return;  // stopping
        job = claim_queue.front();
        claim_queue.pop_front();
      }
      bool ok = DeflateSlice(job->in.data(), job->in.size(), level,
                              job->last, job->out);
      {
        std::lock_guard<std::mutex> lock(mu);
        job->done = true;
        job->failed = !ok;
      }
      cv_done.notify_all();
    }
  }

  bool pgzip_submit(std::vector<uint8_t>&& data, bool last) {
    auto* job = new BlockJob();
    job->in = std::move(data);
    job->last = last;
    if (workers.empty()) {
      job->failed = !DeflateSlice(job->in.data(), job->in.size(), level,
                                   job->last, job->out);
      job->done = true;
      jobs.push_back(job);
    } else {
      {
        std::lock_guard<std::mutex> lock(mu);
        jobs.push_back(job);
        claim_queue.push_back(job);
      }
      cv_work.notify_one();
    }
    return drain(/*all=*/false);
  }

  // Write completed jobs in order; with all=true, wait for everything.
  // Without it, only pop already-done fronts, blocking solely when the
  // in-flight count exceeds the memory bound.
  bool drain(bool all) {
    size_t cap = workers.empty() ? 0 : workers.size() * 2 + 2;
    for (;;) {
      BlockJob* front = nullptr;
      {
        std::unique_lock<std::mutex> lock(mu);
        if (jobs.empty()) return true;
        if (!all && !jobs.front()->done && jobs.size() <= cap) return true;
        cv_done.wait(lock, [&] { return jobs.front()->done; });
        front = jobs.front();
        jobs.pop_front();
      }
      bool ok = !front->failed &&
                write_fd(front->out.data(), front->out.size());
      delete front;
      if (!ok) return false;
    }
  }

  void flush_tap() {
    if (!tap_buf.empty()) {
      tap(tap_buf.data(), tap_buf.size(), tap_user);
      tap_buf.clear();
    }
  }

  // Hand the stream to the tap in order, in pieces of up to kTapBatch
  // bytes (a single larger piece goes on as it is).
  void feed_tap(const uint8_t* data, size_t n) {
    if (tap_buf.size() + n > kTapBatch) flush_tap();
    if (n >= kTapBatch) {
      tap(data, n, tap_user);
    } else {
      tap_buf.insert(tap_buf.end(), data, data + n);
    }
  }

  // Every uncompressed tar byte flows through here exactly once.
  bool consume(const uint8_t* data, size_t n) {
    if (failed) return false;
    if (tap) feed_tap(data, n);
    tar_sha.update(data, n);
    tar_size += n;
    size_t off = 0;  // crc32 takes uInt lengths; chunk for safety
    while (off < n) {
      uInt step = static_cast<uInt>(
          (n - off) < (1u << 30) ? (n - off) : (1u << 30));
      crc = crc32(crc, data + off, step);
      off += step;
    }
    if (!pgzip) return zlib_consume(data, n, false);
    pending.insert(pending.end(), data, data + n);
    while (pending.size() >= block_size) {
      std::vector<uint8_t> blk(pending.begin(),
                               pending.begin() + block_size);
      pending.erase(pending.begin(), pending.begin() + block_size);
      if (!pgzip_submit(std::move(blk), false)) return false;
    }
    return true;
  }

  bool finish_stream() {
    if (tap) flush_tap();
    if (pgzip) {
      if (!pgzip_submit(std::move(pending), true)) return false;
      pending.clear();
      if (!drain(/*all=*/true)) return false;
    } else {
      if (!zlib_consume(nullptr, 0, true)) return false;
    }
    uint8_t trailer[8];
    GzipTrailer(static_cast<uint32_t>(crc), tar_size, trailer);
    return write_fd(trailer, 8);
  }
};

}  // namespace

extern "C" {

int lsk_abi_version() { return 1; }

void* lsk_new(int out_fd, int pgzip, int level, size_t block_size,
              int nthreads) {
  if (level < 0 || level > 9 || (pgzip && block_size == 0)) return nullptr;
  auto* s = new (std::nothrow) Sink();
  if (!s) return nullptr;
  s->fd = out_fd;
  s->pgzip = pgzip != 0;
  s->level = level;
  s->block_size = block_size;
  if (!s->write_gzip_header()) {
    delete s;
    return nullptr;
  }
  if (s->pgzip && nthreads > 1) {
    s->workers.reserve(nthreads);
    for (int i = 0; i < nthreads; ++i) {
      s->workers.emplace_back([s] { s->worker_loop(); });
    }
  }
  return s;
}

// Install an uncompressed-stream tap (NULL clears). Must be set before
// any write; the callback fires synchronously on the writer's thread, in
// pieces of up to kTapBatch bytes, the last one inside lsk_finish.
void lsk_set_tap(void* handle,
                 void (*fn)(const uint8_t*, size_t, void*),
                 void* user) {
  auto* s = static_cast<Sink*>(handle);
  s->tap = fn;
  s->tap_user = user;
}

int lsk_write(void* handle, const uint8_t* data, size_t n) {
  auto* s = static_cast<Sink*>(handle);
  if (!s->consume(data, n)) {
    s->failed = true;
    return -1;
  }
  return 0;
}

// Stream one regular file's content into the tar, then its 512 padding.
// `size` is the header's size field; a file that shrank since stat is an
// error (the tar framing would be corrupt).
int lsk_write_file(void* handle, const char* path, uint64_t size) {
  auto* s = static_cast<Sink*>(handle);
  int fd = ::open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -2;
  static thread_local std::vector<uint8_t> buf(256 * 1024);
  uint64_t remaining = size;
  while (remaining > 0) {
    size_t want = remaining < buf.size() ? remaining : buf.size();
    ssize_t got = ::read(fd, buf.data(), want);
    if (got < 0) {
      if (errno == EINTR) continue;
      ::close(fd);
      return -2;
    }
    if (got == 0) break;
    if (!s->consume(buf.data(), static_cast<size_t>(got))) {
      ::close(fd);
      s->failed = true;
      return -1;
    }
    remaining -= static_cast<uint64_t>(got);
  }
  ::close(fd);
  if (remaining > 0) return -3;
  size_t pad = (512 - (size % 512)) % 512;
  if (pad) {
    uint8_t zeros[512] = {0};
    if (!s->consume(zeros, pad)) {
      s->failed = true;
      return -1;
    }
  }
  return 0;
}

int lsk_finish(void* handle, uint8_t tar_sha[32], uint8_t gz_sha[32],
               uint64_t* gz_size, uint64_t* tar_size) {
  auto* s = static_cast<Sink*>(handle);
  if (s->failed || !s->finish_stream()) return -1;
  s->tar_sha.final(tar_sha);
  s->gz_sha.final(gz_sha);
  *gz_size = s->gz_size;
  *tar_size = s->tar_size;
  return 0;
}

void lsk_free(void* handle) { delete static_cast<Sink*>(handle); }

}  // extern "C"
