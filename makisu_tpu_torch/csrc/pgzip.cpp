// Parallel gzip's block codec: block-wise raw deflate, one compressor
// per block.
//
// The pgzip blob format (makisu_tpu_torch/tario.py BlockGzipWriter)
// compresses BLOCK-sized slices independently, each as a raw deflate
// stream ending in a sync flush (byte-aligned, no BFINAL), the last
// slice with Z_FINISH; their byte concatenation is one valid deflate
// stream inside a fixed gzip header (mtime 0) and a crc32/size trailer.
// The writer's lanes each hand one batch of whole blocks to
// ``pgz_blocks`` with the interpreter lock released. The port's copy of
// makisu_tpu's native/pgzip.cpp, with only the multi-block entry the
// port calls.
//
// C ABI (ctypes):
//   pgz_abi_version() -> 1
//   pgz_blocks(data, n, level, block_size, last, &out_n) -> buf
//   pgz_free(buf)

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "deflate_common.h"

extern "C" {

void pgz_free(uint8_t* buf) { ::operator delete(buf); }

// Multi-block entry: compress consecutive block_size-sliced segments
// of `data` SEQUENTIALLY in one call — the GIL is released for the
// whole batch, so a Python-side worker pool gets C-speed lanes without
// per-block ctypes/future overhead (the parallelism lives in the
// caller's lanes, each owning one batch). Framing follows the
// streaming convention of the pgzip writer and layersink.cpp (blob
// cache identity): a non-final batch must be an exact multiple of
// block_size (every slice sync-flushed); a final batch additionally
// emits the tail `n % block_size` bytes — possibly EMPTY — as the
// Z_FINISH slice. Output bytes are a pure function of (data, level,
// block_size, last): identical however the stream is batched or laned.
uint8_t* pgz_blocks(const uint8_t* data, size_t n, int level,
                    size_t block_size, int last, size_t* out_n) {
  if (block_size == 0 || level < 0 || level > 9 || out_n == nullptr) {
    return nullptr;
  }
  size_t nfull = n / block_size;
  if (!last && nfull * block_size != n) {
    return nullptr;  // non-final batches must be whole blocks
  }
  size_t nblocks = last ? nfull + 1 : nfull;
  if (nblocks == 0) {
    return nullptr;  // an empty non-final batch is a caller bug
  }
  std::vector<std::vector<uint8_t>> outs(nblocks);
  size_t total = 0;
  for (size_t i = 0; i < nblocks; ++i) {
    size_t off = i * block_size;
    size_t len = (i < nfull) ? block_size : n - off;
    bool fin = last != 0 && i + 1 == nblocks;
    if (!makisu_native::DeflateSlice(data + off, len, level, fin,
                                     outs[i])) {
      return nullptr;
    }
    total += outs[i].size();
  }
  uint8_t* out = static_cast<uint8_t*>(::operator new(total, std::nothrow));
  if (out == nullptr) return nullptr;
  size_t pos = 0;
  for (auto& seg : outs) {
    std::memcpy(out + pos, seg.data(), seg.size());
    pos += seg.size();
  }
  *out_n = pos;
  return out;
}

int pgz_abi_version() { return 1; }

}  // extern "C"
