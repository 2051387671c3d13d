// AES-256-CBC (FIPS-197, SP 800-38A) for the ".hacklab" key wrapping
// (ieache/mp/keywrap.py).  Byte-oriented round functions over the
// standard S-box; no padding here — the caller pads to whole blocks as
// the reference framing does.

#include <array>
#include <cstdint>
#include <cstring>

namespace {

const uint8_t kSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

constexpr int kRounds = 14;           // AES-256
constexpr int kSchedule = 16 * (kRounds + 1);

inline uint8_t xtime(uint8_t x) {
  return static_cast<uint8_t>((x << 1) ^ ((x >> 7) * 0x1b));
}

inline uint8_t gmul(uint8_t a, uint8_t b) {
  uint8_t r = 0;
  while (b) {
    if (b & 1) r ^= a;
    a = xtime(a);
    b >>= 1;
  }
  return r;
}

// the inverse S-box and GF(2^8) products by the MixColumns constants
struct Tables {
  uint8_t inv[256];
  uint8_t m2[256], m3[256], m9[256], m11[256], m13[256], m14[256];
};

const Tables& tables() {
  static const Tables t = [] {
    Tables t{};
    for (int i = 0; i < 256; ++i) {
      const auto x = static_cast<uint8_t>(i);
      t.inv[kSbox[i]] = x;
      t.m2[i] = gmul(x, 2);
      t.m3[i] = gmul(x, 3);
      t.m9[i] = gmul(x, 9);
      t.m11[i] = gmul(x, 11);
      t.m13[i] = gmul(x, 13);
      t.m14[i] = gmul(x, 14);
    }
    return t;
  }();
  return t;
}

void expand_key(const uint8_t* key, uint8_t* w) {
  std::memcpy(w, key, 32);
  uint8_t rcon = 1;
  for (int i = 8; i < 4 * (kRounds + 1); ++i) {
    uint8_t t[4];
    std::memcpy(t, w + 4 * (i - 1), 4);
    if (i % 8 == 0) {
      const uint8_t t0 = t[0];
      t[0] = kSbox[t[1]] ^ rcon;
      t[1] = kSbox[t[2]];
      t[2] = kSbox[t[3]];
      t[3] = kSbox[t0];
      rcon = xtime(rcon);
    } else if (i % 8 == 4) {
      for (auto& b : t) b = kSbox[b];
    }
    for (int j = 0; j < 4; ++j) w[4 * i + j] = w[4 * (i - 8) + j] ^ t[j];
  }
}

void add_round_key(uint8_t* s, const uint8_t* rk) {
  for (int i = 0; i < 16; ++i) s[i] ^= rk[i];
}

// state is column-major: s[4*c + r]
void shift_rows(uint8_t* s, bool inverse) {
  uint8_t t[16];
  for (int c = 0; c < 4; ++c)
    for (int r = 0; r < 4; ++r) {
      const int src = inverse ? (c - r + 4) % 4 : (c + r) % 4;
      t[4 * c + r] = s[4 * src + r];
    }
  std::memcpy(s, t, 16);
}

void mix_columns(uint8_t* s, bool inverse) {
  const Tables& t = tables();
  for (int c = 0; c < 4; ++c) {
    uint8_t* col = s + 4 * c;
    const uint8_t a0 = col[0], a1 = col[1], a2 = col[2], a3 = col[3];
    if (!inverse) {
      col[0] = t.m2[a0] ^ t.m3[a1] ^ a2 ^ a3;
      col[1] = a0 ^ t.m2[a1] ^ t.m3[a2] ^ a3;
      col[2] = a0 ^ a1 ^ t.m2[a2] ^ t.m3[a3];
      col[3] = t.m3[a0] ^ a1 ^ a2 ^ t.m2[a3];
    } else {
      col[0] = t.m14[a0] ^ t.m11[a1] ^ t.m13[a2] ^ t.m9[a3];
      col[1] = t.m9[a0] ^ t.m14[a1] ^ t.m11[a2] ^ t.m13[a3];
      col[2] = t.m13[a0] ^ t.m9[a1] ^ t.m14[a2] ^ t.m11[a3];
      col[3] = t.m11[a0] ^ t.m13[a1] ^ t.m9[a2] ^ t.m14[a3];
    }
  }
}

void encrypt_block(const uint8_t* w, uint8_t* s) {
  add_round_key(s, w);
  for (int round = 1; round <= kRounds; ++round) {
    for (int i = 0; i < 16; ++i) s[i] = kSbox[s[i]];
    shift_rows(s, false);
    if (round != kRounds) mix_columns(s, false);
    add_round_key(s, w + 16 * round);
  }
}

void decrypt_block(const uint8_t* w, uint8_t* s) {
  const uint8_t* inv = tables().inv;
  add_round_key(s, w + 16 * kRounds);
  for (int round = kRounds - 1; round >= 0; --round) {
    shift_rows(s, true);
    for (int i = 0; i < 16; ++i) s[i] = inv[s[i]];
    add_round_key(s, w + 16 * round);
    if (round) mix_columns(s, true);
  }
}

}  // namespace

extern "C" {

// CBC over n bytes (a multiple of 16); in and out may alias.
// Returns 0, or -1 when n is not a whole number of blocks.
int aes256_cbc_encrypt(const uint8_t* key, const uint8_t* iv,
                       const uint8_t* in, uint8_t* out, int64_t n) {
  if (n % 16) return -1;
  uint8_t w[kSchedule];
  expand_key(key, w);
  uint8_t chain[16];
  std::memcpy(chain, iv, 16);
  for (int64_t off = 0; off < n; off += 16) {
    for (int i = 0; i < 16; ++i) chain[i] ^= in[off + i];
    encrypt_block(w, chain);
    std::memcpy(out + off, chain, 16);
  }
  return 0;
}

int aes256_cbc_decrypt(const uint8_t* key, const uint8_t* iv,
                       const uint8_t* in, uint8_t* out, int64_t n) {
  if (n % 16) return -1;
  uint8_t w[kSchedule];
  expand_key(key, w);
  uint8_t chain[16], block[16];
  std::memcpy(chain, iv, 16);
  for (int64_t off = 0; off < n; off += 16) {
    std::memcpy(block, in + off, 16);
    uint8_t s[16];
    std::memcpy(s, block, 16);
    decrypt_block(w, s);
    for (int i = 0; i < 16; ++i) out[off + i] = s[i] ^ chain[i];
    std::memcpy(chain, block, 16);
  }
  return 0;
}

}  // extern "C"
