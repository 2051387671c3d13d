// ieache native oracle — exact C++ twin of the JAX TFHE core.
//
// Role: the "reference TFHE implementation" for bit-exactness testing
// (the external tfhe-lib the reference links, `compile_c.py:65`, is not
// available; this oracle *defines* the framework's ground truth).  It
// re-implements, with plain int32/uint32 modular arithmetic and
// schoolbook negacyclic products:
//   * the Threefry-2x32-20 stream spec of ieache/utils/prng.py
//   * keyset generation        (ieache/lwe/keygen.py)
//   * bit encryption/decryption (ieache/lwe/encrypt.py)
//   * the full gate bootstrap  (ieache/boot/bootstrap.py:
//     mod-switch -> blind rotation (CMux external products) ->
//     sample extract -> linear keyswitch)
// Every output must match the JAX path bit-for-bit — enforced by
// tests/test_oracle_parity.py.  Exposed via a C ABI for ctypes.
//
// Build: make -C ieache/native  (g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ----------------------------------------------------------------- PRNG

struct Key {
  uint32_t k0, k1;
};

static const uint32_t kParity = 0x1BD11BDA;
static const uint32_t kGolden = 0x9E3779B9;
static const int kRotA[4] = {13, 15, 26, 6};
static const int kRotB[4] = {17, 29, 16, 24};

static inline uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                     uint32_t* y0, uint32_t* y1) {
  uint32_t ks0 = k0, ks1 = k1, ks2 = k0 ^ k1 ^ kParity;
  x0 += ks0;
  x1 += ks1;
  auto four = [&](const int* rot) {
    for (int i = 0; i < 4; i++) {
      x0 += x1;
      x1 = rotl(x1, rot[i]);
      x1 ^= x0;
    }
  };
  four(kRotA);
  x0 += ks1; x1 += ks2 + 1u;
  four(kRotB);
  x0 += ks2; x1 += ks0 + 2u;
  four(kRotA);
  x0 += ks0; x1 += ks1 + 3u;
  four(kRotB);
  x0 += ks1; x1 += ks2 + 4u;
  four(kRotA);
  x0 += ks2; x1 += ks0 + 5u;
  *y0 = x0;
  *y1 = x1;
}

static Key key_from_seed_words(const uint32_t* words, int n) {
  Key k{0, 0};
  for (int i = 0; i < n; i++) {
    uint32_t y0, y1;
    threefry(k.k0, k.k1, words[i], (uint32_t)i, &y0, &y1);
    k = Key{y0, y1};
  }
  return k;
}

static Key derive(Key k, uint32_t i) {
  uint32_t y0, y1;
  threefry(k.k0, k.k1, i, kGolden, &y0, &y1);
  return Key{y0, y1};
}

static void random_bits(Key k, uint32_t* out, int64_t n) {
  int64_t nblocks = (n + 1) / 2;
  for (int64_t j = 0; j < nblocks; j++) {
    uint32_t y0, y1;
    threefry(k.k0, k.k1, (uint32_t)j, 0u, &y0, &y1);
    if (2 * j < n) out[2 * j] = y0;
    if (2 * j + 1 < n) out[2 * j + 1] = y1;
  }
}

static inline int popcount32(uint32_t v) { return __builtin_popcount(v); }

// centered binomial: scale * (popcount(noise_bits bits) - noise_bits/2)
static void binomial_noise(Key k, int32_t* out, int64_t n, int32_t scale,
                           int noise_bits) {
  if (scale == 0) {
    std::memset(out, 0, n * sizeof(int32_t));
    return;
  }
  int words_per = noise_bits / 32;
  std::vector<uint32_t> w(n * words_per);
  random_bits(k, w.data(), n * words_per);
  for (int64_t i = 0; i < n; i++) {
    int64_t pop = 0;
    for (int j = 0; j < words_per; j++) pop += popcount32(w[i * words_per + j]);
    out[i] = (int32_t)((pop - noise_bits / 2) * (int64_t)scale);
  }
}

// --------------------------------------------------------------- params

struct Params {
  int32_t n, N, k, bg_bit, l, ks_basebit, ks_t;
  int32_t lwe_scale, tlwe_scale, noise_bits;
  int rows() const { return (k + 1) * l; }
  int kN() const { return k * N; }
  int log2_2N() const {
    int v = 2 * N, r = 0;
    while (v > 1) { v >>= 1; r++; }
    return r;
  }
};

// ------------------------------------------------- exact polynomial ops

// negacyclic product r = a * b mod (X^N + 1), exact mod 2^32
static void negacyclic_mul(const int32_t* a, const int32_t* b, int32_t* r,
                           int N) {
  std::vector<uint32_t> acc(N, 0);
  for (int i = 0; i < N; i++) {
    uint32_t ai = (uint32_t)a[i];
    if (!ai) continue;
    for (int j = 0; j < N; j++) {
      uint32_t prod = ai * (uint32_t)b[j];
      int idx = i + j;
      if (idx < N)
        acc[idx] += prod;
      else
        acc[idx - N] -= prod;
    }
  }
  for (int i = 0; i < N; i++) r[i] = (int32_t)acc[i];
}

// X^t * p for t in [0, 2N)
static void rotate_poly(const int32_t* p, int32_t t, int32_t* out, int N) {
  for (int j = 0; j < N; j++) {
    int32_t s = j - t;
    int32_t idx = ((s % (2 * N)) + 2 * N) % (2 * N);
    out[j] = idx < N ? p[idx] : (int32_t)(-(uint32_t)p[idx - N]);
  }
}

// balanced gadget decomposition (offset trick), digits[levels]
static inline void gadget_decompose1(uint32_t x, int base_bit, int levels,
                                     uint32_t offset, int32_t* digits) {
  int half = 1 << (base_bit - 1);
  uint32_t mask = (1u << base_bit) - 1;
  uint32_t v = x + offset;
  for (int j = 0; j < levels; j++) {
    int shift = 32 - (j + 1) * base_bit;
    digits[j] = (int32_t)((v >> shift) & mask) - half;
  }
}

static uint32_t gadget_offset(int base_bit, int levels) {
  uint32_t off = 0;
  for (int j = 0; j < levels; j++)
    off += (uint32_t)(1u << (base_bit - 1)) << (32 - (j + 1) * base_bit);
  // round-to-nearest of the dropped low bits (mirrors
  // ops/decompose.py::_offset — zero-mean residual; the truncation
  // bias couples with the secret key inside each blind-rotation step)
  if (levels * base_bit < 32) off += 1u << (32 - levels * base_bit - 1);
  return off;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- PRNG

void tf_threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                 uint32_t* out) {
  threefry(k0, k1, x0, x1, &out[0], &out[1]);
}

void tf_random_bits(uint32_t k0, uint32_t k1, uint32_t* out, int64_t n) {
  random_bits(Key{k0, k1}, out, n);
}

// -------------------------------------------------------------- keygen

// Outputs (caller-allocated):
//   lwe_s   int32[n]
//   trlwe_k int32[k*N]
//   bk      int32[n * rows * (k+1) * N]
//   ks      int32[kN * ks_t * (n+1)]
void tf_keygen(const int32_t* pr, const uint32_t* seed_words,
               int n_seed_words, int32_t* lwe_s, int32_t* trlwe_k,
               int32_t* bk, int32_t* ks) {
  Params p;
  std::memcpy(&p, pr, sizeof(Params));
  Key master = key_from_seed_words(seed_words, n_seed_words);

  // lwe key bits (stream 0), trlwe key bits (stream 1)
  {
    std::vector<uint32_t> w(p.n);
    random_bits(derive(master, 0), w.data(), p.n);
    for (int i = 0; i < p.n; i++) lwe_s[i] = (int32_t)(w[i] & 1u);
  }
  {
    std::vector<uint32_t> w(p.kN());
    random_bits(derive(master, 1), w.data(), p.kN());
    for (int i = 0; i < p.kN(); i++) trlwe_k[i] = (int32_t)(w[i] & 1u);
  }

  const int rows = p.rows(), kp1 = p.k + 1, N = p.N;
  // gadget constants h_j = 2^(32-(j+1)*bg_bit)
  std::vector<uint32_t> h(p.l);
  for (int j = 0; j < p.l; j++) h[j] = 1u << (32 - (j + 1) * p.bg_bit);

  // bootstrapping key
  Key bk_root = derive(master, 2);
  std::vector<uint32_t> mask_w(N);
  std::vector<int32_t> noise(N), prod(N);
  for (int i = 0; i < p.n; i++) {
    Key ki = derive(bk_root, i);
    for (int prow = 0; prow < rows; prow++) {
      Key kr = derive(ki, prow);
      int32_t* row = bk + (((int64_t)i * rows + prow) * kp1) * N;
      // masks u < k
      for (int u = 0; u < p.k; u++) {
        random_bits(derive(kr, u), mask_w.data(), N);
        for (int j = 0; j < N; j++) row[u * N + j] = (int32_t)mask_w[j];
      }
      // noise + b = sum a_u * K_u + e
      binomial_noise(derive(kr, p.k), noise.data(), N, p.tlwe_scale,
                     p.noise_bits);
      int32_t* b = row + p.k * N;
      for (int j = 0; j < N; j++) b[j] = noise[j];
      for (int u = 0; u < p.k; u++) {
        negacyclic_mul(row + u * N, trlwe_k + u * N, prod.data(), N);
        for (int j = 0; j < N; j++)
          b[j] = (int32_t)((uint32_t)b[j] + (uint32_t)prod[j]);
      }
      // message: s_i * h_j on component u of row p = u*l + j
      int u = prow / p.l, j = prow % p.l;
      row[u * N + 0] = (int32_t)((uint32_t)row[u * N + 0] +
                                 (uint32_t)lwe_s[i] * h[j]);
    }
  }

  // keyswitch key (linear variant)
  Key ks_root = derive(master, 3);
  std::vector<uint32_t> hks(p.ks_t);
  for (int j = 0; j < p.ks_t; j++)
    hks[j] = 1u << (32 - (j + 1) * p.ks_basebit);
  std::vector<uint32_t> a_w(p.n);
  int64_t nrows_ks = (int64_t)p.kN() * p.ks_t;
  for (int64_t r = 0; r < nrows_ks; r++) {
    Key kr = derive(ks_root, (uint32_t)r);
    int32_t* row = ks + r * (p.n + 1);
    random_bits(derive(kr, 0), a_w.data(), p.n);
    for (int i = 0; i < p.n; i++) row[i] = (int32_t)a_w[i];
    int32_t e;
    binomial_noise(derive(kr, 1), &e, 1, p.lwe_scale, p.noise_bits);
    int64_t i = r / p.ks_t, j = r % p.ks_t;
    uint32_t msg = (uint32_t)trlwe_k[i] * hks[j];
    uint32_t b = msg + (uint32_t)e;
    for (int t = 0; t < p.n; t++)
      b += (uint32_t)row[t] * (uint32_t)lwe_s[t];
    row[p.n] = (int32_t)b;
  }
}

// ------------------------------------------------------------- encrypt

void tf_encrypt(const int32_t* pr, const int32_t* lwe_s,
                const int32_t* bits, int64_t nbits, uint32_t sk0,
                uint32_t sk1, int32_t* out /* nbits x (n+1) */) {
  Params p;
  std::memcpy(&p, pr, sizeof(Params));
  const uint32_t mu = 1u << 29;
  std::vector<uint32_t> a_w(p.n);
  for (int64_t r = 0; r < nbits; r++) {
    Key kr = derive(Key{sk0, sk1}, (uint32_t)r);
    int32_t* row = out + r * (p.n + 1);
    random_bits(derive(kr, 0), a_w.data(), p.n);
    for (int i = 0; i < p.n; i++) row[i] = (int32_t)a_w[i];
    int32_t e;
    binomial_noise(derive(kr, 1), &e, 1, p.lwe_scale, p.noise_bits);
    uint32_t b = (bits[r] ? mu : (uint32_t)(-(int32_t)mu)) + (uint32_t)e;
    for (int i = 0; i < p.n; i++)
      b += (uint32_t)row[i] * (uint32_t)lwe_s[i];
    row[p.n] = (int32_t)b;
  }
}

void tf_decrypt(const int32_t* pr, const int32_t* lwe_s,
                const int32_t* lwe, int64_t nrows, int32_t* bits) {
  Params p;
  std::memcpy(&p, pr, sizeof(Params));
  for (int64_t r = 0; r < nrows; r++) {
    const int32_t* row = lwe + r * (p.n + 1);
    uint32_t phase = (uint32_t)row[p.n];
    for (int i = 0; i < p.n; i++)
      phase -= (uint32_t)row[i] * (uint32_t)lwe_s[i];
    bits[r] = ((int32_t)phase > 0) ? 1 : 0;
  }
}

// ----------------------------------------------------------- bootstrap

// One full gate bootstrap per input row (mu fixed); matches
// ieache.boot.bootstrap.bootstrap bit-for-bit.
void tf_bootstrap(const int32_t* pr, const int32_t* bk,
                  const int32_t* ks, const int32_t* lwe_in,
                  int64_t nrows, int32_t mu, int32_t* lwe_out) {
  Params p;
  std::memcpy(&p, pr, sizeof(Params));
  const int N = p.N, kp1 = p.k + 1, rows = p.rows();
  const int shift = 32 - p.log2_2N();
  const uint32_t round = 1u << (shift - 1);
  const uint32_t mask2N = (uint32_t)(2 * N - 1);
  const uint32_t goff = gadget_offset(p.bg_bit, p.l);
  const uint32_t ksoff = gadget_offset(p.ks_basebit, p.ks_t);

  std::vector<int32_t> acc(kp1 * N), rot(N), diff(N), prod(N);
  std::vector<int32_t> digits((size_t)rows * N);
  std::vector<int32_t> ext(p.kN() + 1);

  for (int64_t r = 0; r < nrows; r++) {
    const int32_t* in = lwe_in + r * (p.n + 1);
    // mod switch
    std::vector<int32_t> bara(p.n);
    for (int i = 0; i < p.n; i++)
      bara[i] = (int32_t)((((uint32_t)in[i] + round) >> shift) & mask2N);
    int32_t barb =
        (int32_t)((((uint32_t)in[p.n] + round) >> shift) & mask2N);

    // acc0: a parts zero, b part = X^(2N-barb) * (mu,...,mu)
    std::fill(acc.begin(), acc.end(), 0);
    int32_t t = (2 * N - barb) & (2 * N - 1);
    for (int j = 0; j < N; j++) {
      int32_t pos = ((j - t) % (2 * N) + 2 * N) % (2 * N);
      acc[p.k * N + j] = pos < N ? mu : (int32_t)(-(uint32_t)mu);
    }

    // blind rotation
    for (int i = 0; i < p.n; i++) {
      // digits of (X^bara_i * acc - acc), row p = u*l + j
      for (int u = 0; u < kp1; u++) {
        rotate_poly(&acc[u * N], bara[i], rot.data(), N);
        for (int j = 0; j < N; j++)
          diff[j] = (int32_t)((uint32_t)rot[j] - (uint32_t)acc[u * N + j]);
        for (int j = 0; j < N; j++) {
          int32_t d[16];
          gadget_decompose1((uint32_t)diff[j], p.bg_bit, p.l, goff, d);
          for (int lev = 0; lev < p.l; lev++)
            digits[((size_t)(u * p.l + lev)) * N + j] = d[lev];
        }
      }
      // acc += sum_p digits_p * BKrow_p   (external product)
      const int32_t* bki = bk + ((int64_t)i * rows) * kp1 * N;
      for (int prow = 0; prow < rows; prow++) {
        const int32_t* dp = &digits[(size_t)prow * N];
        for (int o = 0; o < kp1; o++) {
          negacyclic_mul(dp, bki + (prow * kp1 + o) * N, prod.data(), N);
          for (int j = 0; j < N; j++)
            acc[o * N + j] =
                (int32_t)((uint32_t)acc[o * N + j] + (uint32_t)prod[j]);
        }
      }
    }

    // sample extract at coefficient 0
    for (int u = 0; u < p.k; u++) {
      ext[u * N + 0] = acc[u * N + 0];
      for (int m = 1; m < N; m++)
        ext[u * N + m] = (int32_t)(-(uint32_t)acc[u * N + N - m]);
    }
    ext[p.kN()] = acc[p.k * N + 0];

    // linear keyswitch: out = unit_b - sum digits * KS
    int32_t* out = lwe_out + r * (p.n + 1);
    std::vector<uint32_t> acc_ks(p.n + 1, 0);
    for (int i = 0; i < p.kN(); i++) {
      int32_t d[16];
      gadget_decompose1((uint32_t)ext[i], p.ks_basebit, p.ks_t, ksoff, d);
      for (int j = 0; j < p.ks_t; j++) {
        if (!d[j]) continue;
        const int32_t* row = ks + ((int64_t)i * p.ks_t + j) * (p.n + 1);
        for (int tcol = 0; tcol <= p.n; tcol++)
          acc_ks[tcol] += (uint32_t)d[j] * (uint32_t)row[tcol];
      }
    }
    for (int tcol = 0; tcol <= p.n; tcol++)
      out[tcol] = (int32_t)(-acc_ks[tcol]);
    out[p.n] = (int32_t)((uint32_t)out[p.n] + (uint32_t)ext[p.kN()]);
  }
}

}  // extern "C"
