// Batch MurmurHash3_x86_32 for the VW featurizer of mmlspark_tpu_torch.
//
// A copy of mm_murmur3_32 and mm_murmur3_batch from the JAX package's
// native data plane (native/mmlspark_native.cpp), kept verbatim so that the
// port's hashes are the reference's bit for bit (vw/murmur.py holds the
// scalar Python version they must equal).  kernels/_build.py compiles it
// with binning.cpp into the host library; utils/native_loader.py binds it
// with ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16; h *= 0x85ebca6b;
  h ^= h >> 13; h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

uint32_t mm_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  const int64_t nblocks = len / 4;
  uint32_t h1 = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;

  const uint32_t* blocks = reinterpret_cast<const uint32_t*>(data);
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k1;
    std::memcpy(&k1, blocks + i, sizeof(k1));
    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2;
    h1 ^= k1; h1 = rotl32(h1, 13); h1 = h1 * 5 + 0xe6546b64;
  }

  const uint8_t* tail = data + nblocks * 4;
  uint32_t k1 = 0;
  switch (len & 3) {
    case 3: k1 ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k1 ^= static_cast<uint32_t>(tail[1]) << 8;  [[fallthrough]];
    case 1: k1 ^= tail[0];
            k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }
  h1 ^= static_cast<uint32_t>(len);
  return fmix32(h1);
}

// Hash n byte strings packed into `data` with prefix-sum `offsets` (n+1).
void mm_murmur3_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                      uint32_t seed, uint32_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = mm_murmur3_32(data + offsets[i], offsets[i + 1] - offsets[i], seed);
  }
}

}  // extern "C"
