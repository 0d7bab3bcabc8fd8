// Batched Ed25519 challenge-scalar computation — native host component.
//
// The port's copy of dag_rider_tpu/native/challenge.cpp. The verify host
// path computes k = SHA-512(R || A || M) mod L per vertex (RFC 8032
// §5.1.7 step 2); this per-row work is the last Python loop in
// CUDAVerifier._prepare. This library does the whole batch in one C call:
// a self-contained FIPS 180-4 SHA-512 (spec constants, no OpenSSL
// dependency) and a byte-Horner mod-L reduction.
//
// Exposed via ctypes (dag_rider_tpu_torch/utils/native.py); built on demand
// with `g++ -O2 -shared -fPIC` into the repository's build/ directory.
// Pure-Python hashlib remains the fallback and the differential-testing
// oracle (tests/test_torch_native.py).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <vector>

#include <dlfcn.h>

namespace {

// OpenSSL's one-shot SHA512 (stable libcrypto ABI), resolved at runtime —
// the image ships libcrypto.so.3 but no dev headers/symlink. When absent
// the self-contained FIPS 180-4 implementation below is used instead;
// both produce identical digests (differentially tested against hashlib).
typedef unsigned char* (*sha512_fn)(const unsigned char*, size_t,
                                    unsigned char*);

sha512_fn resolve_openssl_sha512() {
  static sha512_fn cached = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    // RTLD_LOCAL: we only dlsym from our own handle; exporting OpenSSL
    // symbols globally could interpose on a different libcrypto already
    // loaded by Python's _ssl/cryptography modules.
    void* h = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libcrypto.so.1.1", RTLD_NOW | RTLD_LOCAL);
    if (h) cached = (sha512_fn)dlsym(h, "SHA512");
  }
  return cached;
}

// ----------------------------------------------------------------------
// SHA-512 (FIPS 180-4). Straightforward scalar implementation.
// ----------------------------------------------------------------------

const uint64_t K[80] = {
    0x428a2f98d728ae22ULL, 0x7137449123ef65cdULL, 0xb5c0fbcfec4d3b2fULL,
    0xe9b5dba58189dbbcULL, 0x3956c25bf348b538ULL, 0x59f111f1b605d019ULL,
    0x923f82a4af194f9bULL, 0xab1c5ed5da6d8118ULL, 0xd807aa98a3030242ULL,
    0x12835b0145706fbeULL, 0x243185be4ee4b28cULL, 0x550c7dc3d5ffb4e2ULL,
    0x72be5d74f27b896fULL, 0x80deb1fe3b1696b1ULL, 0x9bdc06a725c71235ULL,
    0xc19bf174cf692694ULL, 0xe49b69c19ef14ad2ULL, 0xefbe4786384f25e3ULL,
    0x0fc19dc68b8cd5b5ULL, 0x240ca1cc77ac9c65ULL, 0x2de92c6f592b0275ULL,
    0x4a7484aa6ea6e483ULL, 0x5cb0a9dcbd41fbd4ULL, 0x76f988da831153b5ULL,
    0x983e5152ee66dfabULL, 0xa831c66d2db43210ULL, 0xb00327c898fb213fULL,
    0xbf597fc7beef0ee4ULL, 0xc6e00bf33da88fc2ULL, 0xd5a79147930aa725ULL,
    0x06ca6351e003826fULL, 0x142929670a0e6e70ULL, 0x27b70a8546d22ffcULL,
    0x2e1b21385c26c926ULL, 0x4d2c6dfc5ac42aedULL, 0x53380d139d95b3dfULL,
    0x650a73548baf63deULL, 0x766a0abb3c77b2a8ULL, 0x81c2c92e47edaee6ULL,
    0x92722c851482353bULL, 0xa2bfe8a14cf10364ULL, 0xa81a664bbc423001ULL,
    0xc24b8b70d0f89791ULL, 0xc76c51a30654be30ULL, 0xd192e819d6ef5218ULL,
    0xd69906245565a910ULL, 0xf40e35855771202aULL, 0x106aa07032bbd1b8ULL,
    0x19a4c116b8d2d0c8ULL, 0x1e376c085141ab53ULL, 0x2748774cdf8eeb99ULL,
    0x34b0bcb5e19b48a8ULL, 0x391c0cb3c5c95a63ULL, 0x4ed8aa4ae3418acbULL,
    0x5b9cca4f7763e373ULL, 0x682e6ff3d6b2b8a3ULL, 0x748f82ee5defb2fcULL,
    0x78a5636f43172f60ULL, 0x84c87814a1f0ab72ULL, 0x8cc702081a6439ecULL,
    0x90befffa23631e28ULL, 0xa4506cebde82bde9ULL, 0xbef9a3f7b2c67915ULL,
    0xc67178f2e372532bULL, 0xca273eceea26619cULL, 0xd186b8c721c0c207ULL,
    0xeada7dd6cde0eb1eULL, 0xf57d4f7fee6ed178ULL, 0x06f067aa72176fbaULL,
    0x0a637dc5a2c898a6ULL, 0x113f9804bef90daeULL, 0x1b710b35131c471bULL,
    0x28db77f523047d84ULL, 0x32caab7b40c72493ULL, 0x3c9ebe0a15c9bebcULL,
    0x431d67c49c100d4cULL, 0x4cc5d4becb3e42b6ULL, 0x597f299cfc657e2aULL,
    0x5fcb6fab3ad6faecULL, 0x6c44198c4a475817ULL};

inline uint64_t rotr(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

struct Sha512 {
  uint64_t h[8];
  uint8_t buf[128];
  size_t buflen;
  uint64_t total;

  Sha512() { reset(); }

  void reset() {
    static const uint64_t init[8] = {
        0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
        0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
        0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};
    std::memcpy(h, init, sizeof(h));
    buflen = 0;
    total = 0;
  }

  void compress(const uint8_t* p) {
    uint64_t w[80];
    for (int i = 0; i < 16; i++) {
      w[i] = 0;
      for (int j = 0; j < 8; j++) w[i] = (w[i] << 8) | p[8 * i + j];
    }
    for (int i = 16; i < 80; i++) {
      uint64_t s0 = rotr(w[i - 15], 1) ^ rotr(w[i - 15], 8) ^ (w[i - 15] >> 7);
      uint64_t s1 = rotr(w[i - 2], 19) ^ rotr(w[i - 2], 61) ^ (w[i - 2] >> 6);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint64_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 80; i++) {
      uint64_t S1 = rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41);
      uint64_t ch = (e & f) ^ (~e & g);
      uint64_t t1 = hh + S1 + ch + K[i] + w[i];
      uint64_t S0 = rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39);
      uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint64_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t len) {
    total += len;
    if (buflen) {
      size_t take = 128 - buflen;
      if (take > len) take = len;
      std::memcpy(buf + buflen, p, take);
      buflen += take;
      p += take;
      len -= take;
      if (buflen == 128) {
        compress(buf);
        buflen = 0;
      }
    }
    while (len >= 128) {
      compress(p);
      p += 128;
      len -= 128;
    }
    if (len) {
      std::memcpy(buf, p, len);
      buflen = len;
    }
  }

  void final(uint8_t out[64]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 112) update(&zero, 1);
    uint8_t lenb[16] = {0};
    for (int i = 0; i < 8; i++) lenb[15 - i] = (uint8_t)(bits >> (8 * i));
    update(lenb, 16);
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++) out[8 * i + j] = (uint8_t)(h[i] >> (56 - 8 * j));
  }
};

// ----------------------------------------------------------------------
// Reduction mod L, L = 2^252 + c, c = 27742317777372353535851937790883648493
// (~2^124.7). Horner over the digest's 64-bit limbs; each step reduces
// t = acc * 2^64 + d (< 2^64 * L < 2^317) via the quotient estimate
// q = floor(t / 2^252) >= floor(t / L), exact to within 2 because
// c / 2^252 < 2^-127: after s = t - q*L, at most two add-backs of L.
// ----------------------------------------------------------------------

typedef unsigned __int128 u128;

// L in little-endian 64-bit limbs (4 limbs; bit 252 set in limb 3).
const uint64_t L_LIMBS[4] = {0x5812631a5cf5d3edULL, 0x14def9dea2f79cd6ULL,
                             0ULL, 0x1000000000000000ULL};

// acc: 5 limbs, invariant acc < L after each step (top limb scratch).
inline void reduce_step(uint64_t acc[5], uint64_t d) {
  // t = acc * 2^64 + d  (shift limbs up; acc < L keeps t < 2^64 * L)
  uint64_t t[5] = {d, acc[0], acc[1], acc[2], acc[3]};
  // q = t >> 252  (<= 2^65 - 1: needs 65 bits -> q_hi in {0, 1})
  uint64_t q_lo = (t[3] >> 60) | (t[4] << 4);
  uint64_t q_hi = t[4] >> 60;
  // t -= q * L   (q * L = q_lo * L + q_hi * (L << 64))
  u128 borrow = 0;
  u128 carry = 0;
  uint64_t prod[5];
  for (int i = 0; i < 4; i++) {
    u128 p = (u128)q_lo * L_LIMBS[i] + carry;
    prod[i] = (uint64_t)p;
    carry = p >> 64;
  }
  prod[4] = (uint64_t)carry;
  if (q_hi) {  // add L << 64 (q_hi is 0 or 1)
    u128 c2 = 0;
    for (int i = 1; i < 5; i++) {
      u128 s = (u128)prod[i] + L_LIMBS[i - 1] + c2;
      prod[i] = (uint64_t)s;
      c2 = s >> 64;
    }
  }
  for (int i = 0; i < 5; i++) {
    u128 diff = (u128)t[i] - prod[i] - borrow;
    t[i] = (uint64_t)diff;
    borrow = (diff >> 64) ? 1 : 0;  // two's-complement borrow out
  }
  // q may overshoot by <= 2: add L back while negative (borrow set)
  while (borrow) {
    u128 c2 = 0;
    for (int i = 0; i < 5; i++) {
      u128 s = (u128)t[i] + (i < 4 ? L_LIMBS[i] : 0) + c2;
      t[i] = (uint64_t)s;
      c2 = s >> 64;
    }
    borrow = c2 ? 0 : 1;  // still negative iff no carry out of bit 320
  }
  // one final conditional subtract: t may equal/exceed L but < 2L
  bool ge = t[4] != 0;
  if (!ge) {
    ge = true;
    for (int i = 3; i >= 0; i--) {
      if (t[i] != L_LIMBS[i]) {
        ge = t[i] > L_LIMBS[i];
        break;
      }
    }
  }
  if (ge) {
    u128 b2 = 0;
    for (int i = 0; i < 5; i++) {
      u128 diff = (u128)t[i] - (i < 4 ? L_LIMBS[i] : 0) - b2;
      t[i] = (uint64_t)diff;
      b2 = (diff >> 64) ? 1 : 0;
    }
  }
  for (int i = 0; i < 5; i++) acc[i] = t[i];
}

void reduce_digest_mod_l(const uint8_t digest_le[64], uint8_t out_le[32]) {
  uint64_t acc[5] = {0, 0, 0, 0, 0};
  for (int i = 7; i >= 0; i--) {
    uint64_t d = 0;
    for (int j = 7; j >= 0; j--) d = (d << 8) | digest_le[8 * i + j];
    reduce_step(acc, d);
  }
  for (int i = 0; i < 32; i++) out_le[i] = (uint8_t)(acc[i / 8] >> (8 * (i % 8)));
}

}  // namespace

extern "C" {

// rs/pks: [n][32]; msgs: concatenated message bytes with [n+1] offsets;
// out: [n][32] little-endian challenge scalars k = H(R||A||M) mod L.
void dagrider_challenge_batch(const uint8_t* rs, const uint8_t* pks,
                              const uint8_t* msgs, const uint64_t* msg_off,
                              uint64_t n, uint8_t* out) {
  sha512_fn ossl = resolve_openssl_sha512();
  uint8_t digest[64];
  if (ossl) {
    std::vector<uint8_t> buf;
    for (uint64_t i = 0; i < n; i++) {
      size_t mlen = msg_off[i + 1] - msg_off[i];
      buf.resize(64 + mlen);
      std::memcpy(buf.data(), rs + 32 * i, 32);
      std::memcpy(buf.data() + 32, pks + 32 * i, 32);
      std::memcpy(buf.data() + 64, msgs + msg_off[i], mlen);
      ossl(buf.data(), buf.size(), digest);
      reduce_digest_mod_l(digest, out + 32 * i);
    }
    return;
  }
  Sha512 sha;
  for (uint64_t i = 0; i < n; i++) {
    sha.reset();
    sha.update(rs + 32 * i, 32);
    sha.update(pks + 32 * i, 32);
    sha.update(msgs + msg_off[i], msg_off[i + 1] - msg_off[i]);
    sha.final(digest);
    reduce_digest_mod_l(digest, out + 32 * i);
  }
}

}  // extern "C"
