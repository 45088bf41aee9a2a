// Lane-parallel SHA-256 for Hopper (sm_90a).
//
// Replaces the TPU kernel makisu_tpu/ops/sha256_pallas.py _sha_kernel,
// which hashes lanes in lock-step as u32 vectors after an XLA pre-pass
// (padding, byteswap, transpose to block-major words).
//
// Input: L ragged messages in a [L, CAP] byte buffer (CAP % 64 == 0) and
// their lengths, each in [0, CAP - 9] so the padding fits in the lane. A
// lane whose length lies outside that range hashes as the empty message
// and sets *err to 1; the wrapper reads the flag where the caller has
// already synchronised (ops/sha256_cuda.py check_lengths).
// Output: [L, 8] digest words, big-endian word order (the word values of
// FIPS 180-4's H0..H7).
//
// Design: one thread per lane. The 8 state words and the 16-word
// message-schedule window live in registers (the 64 rounds are unrolled,
// so every window index is static). Padding happens inside the kernel,
// per 64-byte block: message bytes below the length, the 0x80 marker at
// the length, zeros after, and the 64-bit big-endian bit length in the
// last 8 bytes of the lane's last block nb - 1, nb = (len + 9 + 63) / 64.
// There is no pre-pass. Each lane loops over its own nb blocks only, as
// the reference's masked select keeps a lane's state after its last
// block. Blocks load as four 16-byte vector loads.
//
// Bound on an H100, counted from compress() below in SASS instructions
// (SHF funnel shift, LOP3 three-input logic, IADD3 three-input add):
//   round:         Sigma1, Sigma0: 3 SHF + 1 LOP3 each; ch, maj: 1 LOP3
//                  each; t1 = h + Sigma1 + ch + K + w: 2 IADD3;
//                  e = d + t1, a = t1 + Sigma0 + maj: 1 IADD3 each
//                  -> 10 logic/shift + 4 adds
//   schedule step: sigma0, sigma1: 3 SHF + 1 LOP3 each;
//                  w + sigma0 + w' + sigma1: 2 IADD3 -> 8 + 2 adds
//   block:         64 rounds + 48 steps + 16 byte swaps (PRMT) + 8 state
//                  adds -> 1,040 logic/shift/permute + 360 adds
// Shifts, LOP3 and PRMT issue only on the ALU pipe (64 lanes per SM per
// clock); an add may also issue on the FMA pipe as IMAD, so all 1,400
// share the issue limit of 128 lanes per SM per clock. The least time
// per live block is max(1040 / 64, 1400 / 128) = 16.25 SM clocks: the
// ALU pipe bounds it. The bytes (live blocks read once, 32 bytes per
// lane written) take far less at 3.35 TB/s.
// Known first target for a later change: at the production buckets 512
// lanes fill only 4 blocks of 128 threads on 132 SMs (128 lanes: one
// block), so the card runs a handful of long dependency chains and the
// kernel is latency-bound far above that bound.

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

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
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

__global__ void __launch_bounds__(kThreads)
sha256_lanes_kernel(const uint8_t* __restrict__ data,
                    const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ out, int lanes, long long cap,
                    unsigned* __restrict__ err) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  long long len = lengths[lane];
  if (len < 0 || len > cap - 9) {
    atomicOr(err, 1u);
    len = 0;
  }
  // len <= cap - 9 and cap % 64 == 0, so nb <= cap / 64.
  const long long nb = (len + 9 + 63) / 64;
  const uint4* src =
      reinterpret_cast<const uint4*>(data + static_cast<long long>(lane) * cap);

  uint32_t s[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  for (long long blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = src[blk * 4 + q];
      w[4 * q + 0] = bswap(v.x);
      w[4 * q + 1] = bswap(v.y);
      w[4 * q + 2] = bswap(v.z);
      w[4 * q + 3] = bswap(v.w);
    }
    const long long start = blk * 64;
    if (start + 64 > len) {
      // The message ends in or before this block: keep its bytes, place
      // the marker, zero the rest.
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long rem = len - (start + 4 * j);
        if (rem < 4) {
          uint32_t x = rem <= 0 ? 0u : w[j] & (0xFFFFFFFFu << (32 - 8 * rem));
          if (rem >= 0) x |= 0x80u << (24 - 8 * rem);
          w[j] = x;
        }
      }
      if (blk == nb - 1) {
        const unsigned long long bits = static_cast<unsigned long long>(len)
                                        << 3;
        w[14] = static_cast<uint32_t>(bits >> 32);
        w[15] = static_cast<uint32_t>(bits);
      }
    }
    compress(s, w);
  }
  uint32_t* dst = out + static_cast<long long>(lane) * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = s[i];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// `err` points to one device word that the kernel sets to 1 for a
// length outside [0, cap - 9].
extern "C" int makisu_sha256_lanes(const void* data, const void* lengths,
                                   void* out, int lanes, long long cap,
                                   void* err, void* stream) {
  if (lanes <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((lanes + kThreads - 1) /
                                                kThreads);
  sha256_lanes_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<uint32_t*>(out), lanes, cap, static_cast<unsigned*>(err));
  return static_cast<int>(cudaGetLastError());
}
