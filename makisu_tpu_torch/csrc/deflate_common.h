// Shared deflate-slice compressor and gzip framing constants.
//
// Both pgzip.cpp and layersink.cpp emit the SAME bytes for the same
// (backend, level, block_size) — that equivalence is cache identity
// (layer digests recorded in cache entries). Keeping the slice
// compressor and framing in one header is what guarantees they cannot
// drift. The port's copy of makisu_tpu's native/deflate_common.h.

#ifndef MAKISU_NATIVE_DEFLATE_COMMON_H_
#define MAKISU_NATIVE_DEFLATE_COMMON_H_

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace makisu_native {

// Fixed gzip header for the pgzip (blockwise) backend: magic, deflate,
// no flags, mtime=0, XFL=0, OS=255.
inline const uint8_t kPgzipHeader[10] = {0x1f, 0x8b, 0x08, 0, 0,
                                         0,    0,    0,    0, 0xff};

// Compress one slice as raw deflate (windowBits -15, memLevel 8): a
// sync-flush-terminated segment, or Z_FINISH when `last`. Blockwise
// concatenation of such segments is one valid deflate stream.
inline bool DeflateSlice(const uint8_t* data, size_t n, int level,
                         bool last, std::vector<uint8_t>& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    return false;
  }
  out.resize(deflateBound(&zs, n) + 16);
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = deflate(&zs, last ? Z_FINISH : Z_SYNC_FLUSH);
  bool ok = last ? (rc == Z_STREAM_END) : (rc == Z_OK);
  out.resize(zs.total_out);
  deflateEnd(&zs);
  return ok;
}

// The 8-byte gzip trailer: crc32 then input size, both little-endian.
inline void GzipTrailer(uint32_t crc, uint64_t raw_size, uint8_t out[8]) {
  uint32_t isize = static_cast<uint32_t>(raw_size & 0xffffffffu);
  for (int i = 0; i < 4; ++i) out[i] = (crc >> (8 * i)) & 0xff;
  for (int i = 0; i < 4; ++i) out[4 + i] = (isize >> (8 * i)) & 0xff;
}

}  // namespace makisu_native

#endif  // MAKISU_NATIVE_DEFLATE_COMMON_H_
