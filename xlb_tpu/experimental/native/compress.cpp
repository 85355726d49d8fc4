// Byte-plane shuffle + zstd codec for out-of-core host slabs.
//
// Counterpart of the reference's nvComp compressed tiles
// (xlb/experimental/ooc/tiles/compressed_tile.py:68-248): there, tiles
// live LZ4-compressed in GPU/host memory and decompress on access.  Here
// the OOC domain is host-RAM-resident (ooc.py), so the codec is a host
// C++ path: transpose the f32/bf16 slab into byte planes (smooth flow
// fields make the exponent/high-mantissa planes near-constant, which
// zstd then collapses) and zstd the result.
//
// Build: g++ -O3 -shared -fPIC compress.cpp -lzstd (see __init__.py).

#include <zstd.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

void shuffle(const uint8_t* src, uint8_t* dst, int64_t n, int itemsize) {
  for (int b = 0; b < itemsize; ++b) {
    uint8_t* d = dst + static_cast<int64_t>(b) * n;
    const uint8_t* s = src + b;
    for (int64_t i = 0; i < n; ++i) d[i] = s[i * itemsize];
  }
}

void unshuffle(const uint8_t* src, uint8_t* dst, int64_t n, int itemsize) {
  for (int b = 0; b < itemsize; ++b) {
    const uint8_t* s = src + static_cast<int64_t>(b) * n;
    uint8_t* d = dst + b;
    for (int64_t i = 0; i < n; ++i) d[i * itemsize] = s[i];
  }
}

}  // namespace

extern "C" {

int64_t sc_bound(int64_t nbytes) {
  return static_cast<int64_t>(ZSTD_compressBound(static_cast<size_t>(nbytes)));
}

// src: n_elems items of itemsize bytes; returns compressed size or -1.
int64_t sc_compress(const uint8_t* src, int64_t n_elems, int32_t itemsize,
                    uint8_t* dst, int64_t dst_cap, int32_t level) {
  const int64_t nbytes = n_elems * itemsize;
  std::vector<uint8_t> tmp(static_cast<size_t>(nbytes));
  shuffle(src, tmp.data(), n_elems, itemsize);
  const size_t r = ZSTD_compress(dst, static_cast<size_t>(dst_cap), tmp.data(),
                                 static_cast<size_t>(nbytes), level);
  if (ZSTD_isError(r)) return -1;
  return static_cast<int64_t>(r);
}

// dst must hold n_elems*itemsize bytes; returns decompressed size or -1.
int64_t sc_decompress(const uint8_t* src, int64_t src_size, uint8_t* dst,
                      int64_t n_elems, int32_t itemsize) {
  const int64_t nbytes = n_elems * itemsize;
  std::vector<uint8_t> tmp(static_cast<size_t>(nbytes));
  const size_t r = ZSTD_decompress(tmp.data(), static_cast<size_t>(nbytes),
                                   src, static_cast<size_t>(src_size));
  if (ZSTD_isError(r) || static_cast<int64_t>(r) != nbytes) return -1;
  unshuffle(tmp.data(), dst, n_elems, itemsize);
  return nbytes;
}

}  // extern "C"
