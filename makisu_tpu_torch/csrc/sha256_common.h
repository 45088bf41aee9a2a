// SHA-256 of the native layer sink: an OpenSSL EVP loader (resolved at
// runtime via dlopen — no link dependency, and every CPython host ships
// a libcrypto because hashlib links it) plus a scalar FIPS 180-4
// fallback. The port's copy of makisu_tpu's native/sha256_common.h
// without the chunker's batch entry (the port chunks on the card).

#ifndef MAKISU_NATIVE_SHA256_COMMON_H_
#define MAKISU_NATIVE_SHA256_COMMON_H_

#include <dlfcn.h>

#include <cstdint>
#include <cstring>

namespace makisu_native {

// --------------------------------------------------------- openssl (opt)
// The scalar SHA-256 below is ~10x slower than OpenSSL's SHA-NI path; on
// hosts with libcrypto we resolve the EVP API at runtime. No headers
// needed.
struct Evp {
  void* (*md_ctx_new)() = nullptr;
  void (*md_ctx_free)(void*) = nullptr;
  const void* (*sha256)() = nullptr;
  int (*init)(void*, const void*, void*) = nullptr;
  int (*update)(void*, const void*, size_t) = nullptr;
  int (*final)(void*, unsigned char*, unsigned int*) = nullptr;
  bool ok = false;

  Evp() {
    // RTLD_LOCAL: all symbols resolve via dlsym below; never inject a
    // possibly-second OpenSSL's symbols into the process namespace.
    void* lib = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_LOCAL);
    if (!lib) lib = dlopen("libcrypto.so", RTLD_NOW | RTLD_LOCAL);
    if (!lib) return;
    md_ctx_new =
        reinterpret_cast<void* (*)()>(dlsym(lib, "EVP_MD_CTX_new"));
    md_ctx_free =
        reinterpret_cast<void (*)(void*)>(dlsym(lib, "EVP_MD_CTX_free"));
    sha256 = reinterpret_cast<const void* (*)()>(dlsym(lib, "EVP_sha256"));
    init = reinterpret_cast<int (*)(void*, const void*, void*)>(
        dlsym(lib, "EVP_DigestInit_ex"));
    update = reinterpret_cast<int (*)(void*, const void*, size_t)>(
        dlsym(lib, "EVP_DigestUpdate"));
    final = reinterpret_cast<int (*)(void*, unsigned char*, unsigned int*)>(
        dlsym(lib, "EVP_DigestFinal_ex"));
    ok = md_ctx_new && md_ctx_free && sha256 && init && update && final;
  }
};

inline const Evp& evp() {
  static Evp instance;
  return instance;
}

// ---------------------------------------------------------------- sha256
// Straight FIPS 180-4; avoids an OpenSSL link dependency on hosts
// without libcrypto.
struct Sha256 {
  uint32_t h[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                   0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  uint8_t buf[64];
  size_t buflen = 0;
  uint64_t total = 0;

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
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
    uint32_t w[64];
    for (int i = 0; i < 16; ++i) {
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    }
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 =
          rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 =
          rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t n) {
    total += n;
    if (buflen) {
      size_t take = 64 - buflen < n ? 64 - buflen : n;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      n -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
    while (n >= 64) {
      block(data);
      data += 64;
      n -= 64;
    }
    if (n) {
      std::memcpy(buf, data, n);
      buflen = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    // Pad: 0x80, zeros to 56 mod 64, then the 64-bit big-endian length.
    uint8_t tail[64 + 8 + 1];
    size_t padlen = (buflen < 56 ? 56 - buflen : 120 - buflen);
    tail[0] = 0x80;
    std::memset(tail + 1, 0, padlen - 1);
    for (int i = 0; i < 8; ++i) {
      tail[padlen + i] = (bits >> (56 - 8 * i)) & 0xff;
    }
    update(tail, padlen + 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = (h[i] >> 24) & 0xff;
      out[4 * i + 1] = (h[i] >> 16) & 0xff;
      out[4 * i + 2] = (h[i] >> 8) & 0xff;
      out[4 * i + 3] = h[i] & 0xff;
    }
  }
};

// Digest front: OpenSSL EVP when available, scalar fallback otherwise.
struct Digest256 {
  void* ctx = nullptr;
  Sha256 fallback;

  Digest256() {
    if (evp().ok) {
      ctx = evp().md_ctx_new();
      if (ctx && evp().init(ctx, evp().sha256(), nullptr) != 1) {
        evp().md_ctx_free(ctx);
        ctx = nullptr;
      }
    }
  }
  ~Digest256() {
    if (ctx) evp().md_ctx_free(ctx);
  }
  void update(const uint8_t* data, size_t n) {
    if (ctx) {
      evp().update(ctx, data, n);
    } else {
      fallback.update(data, n);
    }
  }
  void final(uint8_t out[32]) {
    if (ctx) {
      unsigned int len = 32;
      evp().final(ctx, out, &len);
    } else {
      fallback.final(out);
    }
  }
};

}  // namespace makisu_native

#endif  // MAKISU_NATIVE_SHA256_COMMON_H_
