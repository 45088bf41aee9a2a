// Span SHA-256 for Hopper (sm_90a).
//
// Replaces the TPU kernel makisu_tpu/ops/sha256_pallas.py _sha_kernel,
// which hashes lanes in lock-step as u32 vectors after an XLA pre-pass
// (padding, byteswap, transpose to block-major words).
//
// Input: one byte buffer of n bytes and S spans of it, (offset, length)
// each; offsets are int32 or int64, lengths int32. A span must lie inside
// the buffer and be no longer than max_len (the lane entry point passes
// cap - 9). A span that breaks either rule hashes as the empty message
// and sets *err to 1; the wrapper reads the flag where the caller has
// already synchronised (ops/sha256_cuda.py check_lengths).
// Output: [S, 8] digest words, big-endian word order (the word values of
// FIPS 180-4's H0..H7), in the order the spans were given.
//
// Design: one thread per span. SHA-256 is serial within a message, so
// the only parallelism is the number of spans in a launch; the chunk
// session launches once per pass over its device ring (about 32k chunks
// of the layer stream, so 256 blocks of 128 threads, 8 warps on each of
// the 132 SMs) instead of once per 512-lane bucket (4 blocks). The
// caller orders spans longest first, so the 32 lanes of a warp have
// nearly equal block counts (a warp runs as long as its longest lane)
// and the longest dependency chains start first.
//
// Chunks start at any byte, so a lane cannot use 16-byte vector loads.
// It loads the 4-byte-aligned words that cover each 64-byte block (17
// words; the 17th is needed only when the span is misaligned) and forms
// each big-endian message word with one PRMT, __byte_perm(lo, hi, sel),
// where sel = 0x0123 + 0x1111 * (offset & 3) is fixed per span. For an
// aligned span that is the byte swap itself, so alignment costs no ALU
// op. Word indices are static after unrolling, so nothing is indexed
// dynamically in registers (which would spill to local memory). The
// next block's 17 words are loaded while the current block compresses,
// so a load's latency hides behind ~1,400 instructions of the lane's own
// work. Loads of the tail blocks stop at the last word that holds a
// message byte, so a span that ends at the buffer's end reads nothing
// past the aligned word holding its last byte. The 8 state words and
// the 16-word message-schedule window live in registers (the 64 rounds
// are unrolled, so every window index is static). Padding happens
// inside the kernel, per 64-byte block: message bytes below the length,
// the 0x80 marker at the length, zeros after, and the 64-bit big-endian
// bit length in the last 8 bytes of the span's last block nb - 1,
// nb = (len + 9 + 63) / 64. There is no pre-pass.
//
// Bound on an H100, counted from compress() below in SASS instructions
// (SHF funnel shift, LOP3 three-input logic, IADD3 three-input add):
//   round:         Sigma1, Sigma0: 3 SHF + 1 LOP3 each; ch, maj: 1 LOP3
//                  each; t1 = h + Sigma1 + ch + K + w: 2 IADD3;
//                  e = d + t1, a = t1 + Sigma0 + maj: 1 IADD3 each
//                  -> 10 logic/shift + 4 adds
//   schedule step: sigma0, sigma1: 3 SHF + 1 LOP3 each;
//                  w + sigma0 + w' + sigma1: 2 IADD3 -> 8 + 2 adds
//   block:         64 rounds + 48 steps + 16 byte permutes (PRMT) + 8
//                  state adds -> 1,040 logic/shift/permute + 360 adds
// Shifts, LOP3 and PRMT issue only on the ALU pipe (64 lanes per SM per
// clock); an add may also issue on the FMA pipe as IMAD, so all 1,400
// share the issue limit of 128 lanes per SM per clock. The least time
// per live block is max(1040 / 64, 1400 / 128) = 16.25 SM clocks: the
// ALU pipe bounds it. The bytes (live blocks read once, 8 bytes of span
// metadata and 32 bytes of digest per span) take far less at 3.35 TB/s.
// A launch also has a floor no occupancy removes: one warp issues one
// instruction a clock, so the longest span takes at least its blocks x
// 1,400 clocks (about 0.72 ms for a 64 KiB span at 1,980 MHz).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
  uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t + 1) & 15];
      const uint32_t w2 = w[(t + 14) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + big_s1 + ch + kK[t] + wt;
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + big_s0 + maj;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// The 17 aligned words of block `blk` (word index 16 * blk + q from the
// span's first aligned word). A block that lies wholly inside the
// message loads its 16 words as they are and clamps the 17th to `last`,
// the last word holding a message byte (past it only when the span is
// aligned, and then the 17th word is not used). A tail block loads only
// words up to `last` (-1 for an empty span) and zeros the rest.
__device__ __forceinline__ void load_block(uint32_t w[17],
                                           const uint32_t* __restrict__ src,
                                           long long blk, long long nfull,
                                           long long last) {
  const long long base = blk * 16;
  if (blk < nfull) {
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = __ldg(src + base + q);
    w[16] = __ldg(src + min(base + 16, last));
  } else {
#pragma unroll
    for (int q = 0; q < 17; ++q)
      w[q] = base + q <= last ? __ldg(src + base + q) : 0u;
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
sha256_spans_kernel(const uint8_t* __restrict__ buf, long long n,
                    const Off* __restrict__ offsets,
                    const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ out, int spans, long long max_len,
                    unsigned* __restrict__ err) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= spans) return;
  long long off = offsets[i];
  long long len = lengths[i];
  if (off < 0 || len < 0 || len > max_len || off > n - len) {
    atomicOr(err, 1u);
    off = 0;
    len = 0;
  }
  const unsigned lead = static_cast<unsigned>(off & 3);
  const unsigned sel = 0x0123u + 0x1111u * lead;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(buf + off - lead);
  const long long last = len > 0 ? (lead + len - 1) >> 2 : -1;
  const long long nfull = len >> 6;
  const long long nb = (len + 9 + 63) >> 6;

  uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint32_t w[17];
  load_block(w, src, 0, nfull, last);
  for (long long blk = 0; blk < nb; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) m[q] = __byte_perm(w[q], w[q + 1], sel);
    if (blk + 1 < nb) load_block(w, src, blk + 1, nfull, last);
    if (blk >= nfull) {
      // The message ends in or before this block: keep its bytes, place
      // the marker, zero the rest.
      const long long start = blk * 64;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long rem = len - (start + 4 * j);
        if (rem < 4) {
          uint32_t x = rem <= 0 ? 0u : m[j] & (0xFFFFFFFFu << (32 - 8 * rem));
          if (rem >= 0) x |= 0x80u << (24 - 8 * rem);
          m[j] = x;
        }
      }
      if (blk == nb - 1) {
        const unsigned long long bits = static_cast<unsigned long long>(len)
                                        << 3;
        m[14] = static_cast<uint32_t>(bits >> 32);
        m[15] = static_cast<uint32_t>(bits);
      }
    }
    compress(s, m);
  }
  uint32_t* dst = out + static_cast<long long>(i) * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = s[k];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `buf` must be 4-byte aligned; `offsets` points to int64 values when
// offsets_64 is non-zero, else int32. `err` points to one device word
// that the kernel sets to 1 for a span outside the buffer or longer
// than max_len.
extern "C" int makisu_sha256_spans(const void* buf, long long n,
                                   const void* offsets, int offsets_64,
                                   const void* lengths, void* out, int spans,
                                   long long max_len, void* err,
                                   void* stream) {
  if (spans <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((spans + kThreads - 1) /
                                                kThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  uint32_t* o = static_cast<uint32_t*>(out);
  unsigned* e = static_cast<unsigned*>(err);
  if (offsets_64) {
    sha256_spans_kernel<long long><<<blocks, kThreads, 0, st>>>(
        b, n, static_cast<const long long*>(offsets), ln, o, spans, max_len,
        e);
  } else {
    sha256_spans_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        b, n, static_cast<const int32_t*>(offsets), ln, o, spans, max_len, e);
  }
  return static_cast<int>(cudaGetLastError());
}
