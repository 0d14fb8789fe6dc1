// dpq_snappy.hpp — dependency-free Snappy raw-format codec (RFC draft
// "Snappy compressed format description", rev 2011; the format Parquet uses
// for page payloads when ColumnMetaData.codec == SNAPPY).
//
// The reference parser REJECTS compressed files ("Only uncompressed parquet
// files are supported", reference: src/reader/column_reader.cpp:13-15); this
// codec is an engine extension beyond the reference surface, oracle-tested
// against pyarrow's snappy in tests/test_snappy.py.
//
// Decompressor: strict bounds checks on every tag (untrusted file input —
// exercised under ASAN/UBSAN by the DPQ_SANITIZE lane).
// Compressor: greedy 4-byte hash matcher over 64 KiB blocks (the snappy
// block size); emits only spec tags (literal / copy-2-byte-offset), so any
// conforming decoder reads it.  Ratio is within a few percent of reference
// snappy on text.

#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "dpq_common.hpp"

namespace dpq {

// preamble: uncompressed length as LEB128 varint
inline uint64_t snappy_uncompressed_length(const uint8_t* src, size_t n,
                                           size_t* preamble) {
  uint64_t len = 0;
  int shift = 0;
  size_t i = 0;
  for (;; i++) {
    if (i >= n || shift > 28) throw Error("snappy: bad length preamble");
    uint8_t b = src[i];
    len |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *preamble = i + 1;
  return len;
}

// Decompress `src[0..n)` (raw snappy, with preamble) into `dst[0..dst_len)`.
// dst_len must equal the preamble length (callers size dst from the page
// header's uncompressed_size and cross-check).
inline void snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                              size_t dst_len) {
  size_t pre = 0;
  uint64_t want = snappy_uncompressed_length(src, n, &pre);
  if (want != dst_len) throw Error("snappy: length mismatch with page header");
  size_t ip = pre, op = 0;
  while (ip < n) {
    const uint8_t tag = src[ip++];
    if ((tag & 3) == 0) {  // literal
      size_t len = tag >> 2;
      if (len >= 60) {
        const size_t nb = len - 59;  // 1..4 length bytes
        if (ip + nb > n) throw Error("snappy: truncated literal length");
        len = 0;
        for (size_t k = 0; k < nb; k++) len |= size_t(src[ip + k]) << (8 * k);
        ip += nb;
      }
      len += 1;
      if (ip + len > n || op + len > dst_len)
        throw Error("snappy: literal overruns buffer");
      std::memcpy(dst + op, src + ip, len);
      ip += len;
      op += len;
      continue;
    }
    size_t len, off;
    if ((tag & 3) == 1) {  // copy, 11-bit offset
      if (ip >= n) throw Error("snappy: truncated copy-1");
      len = ((tag >> 2) & 7) + 4;
      off = (size_t(tag & 0xe0) << 3) | src[ip++];
    } else if ((tag & 3) == 2) {  // copy, 16-bit offset
      if (ip + 2 > n) throw Error("snappy: truncated copy-2");
      len = (tag >> 2) + 1;
      off = size_t(src[ip]) | (size_t(src[ip + 1]) << 8);
      ip += 2;
    } else {  // copy, 32-bit offset
      if (ip + 4 > n) throw Error("snappy: truncated copy-4");
      len = (tag >> 2) + 1;
      off = size_t(src[ip]) | (size_t(src[ip + 1]) << 8) |
            (size_t(src[ip + 2]) << 16) | (size_t(src[ip + 3]) << 24);
      ip += 4;
    }
    if (off == 0 || off > op || op + len > dst_len)
      throw Error("snappy: copy out of range");
    // copies may overlap their output (off < len): byte loop required
    const uint8_t* from = dst + op - off;
    if (off >= len) {
      std::memcpy(dst + op, from, len);
    } else {
      for (size_t k = 0; k < len; k++) dst[op + k] = from[k];
    }
    op += len;
  }
  if (op != dst_len) throw Error("snappy: short output");
}

namespace detail {

inline void snappy_emit_literal(std::vector<uint8_t>& out, const uint8_t* p,
                                size_t len) {
  while (len > 0) {
    size_t take = len;  // literal length fits 4 extension bytes; no cap needed
    if (take <= 60) {
      out.push_back(uint8_t((take - 1) << 2));
    } else {
      size_t v = take - 1;
      int nb = v < (1u << 8) ? 1 : v < (1u << 16) ? 2 : v < (1u << 24) ? 3 : 4;
      out.push_back(uint8_t((59 + nb) << 2));
      for (int k = 0; k < nb; k++) out.push_back(uint8_t(v >> (8 * k)));
    }
    out.insert(out.end(), p, p + take);
    p += take;
    len -= take;
  }
}

inline void snappy_emit_copy(std::vector<uint8_t>& out, size_t off, size_t len) {
  // tag 2 (16-bit offset) for everything: valid for off <= 65535, len 1..64
  // (copies shorter than 4 are legal with this tag, so no tail fixup)
  while (len > 0) {
    const size_t take = len > 64 ? 64 : len;
    out.push_back(uint8_t(((take - 1) << 2) | 2));
    out.push_back(uint8_t(off & 0xff));
    out.push_back(uint8_t(off >> 8));
    len -= take;
  }
}

}  // namespace detail

// Compress `src[0..n)` to raw snappy (with preamble).  Greedy hash matcher
// per 64 KiB block; offsets never cross a block boundary (so they fit the
// 16-bit copy tag).
inline std::vector<uint8_t> snappy_compress(const uint8_t* src, size_t n) {
  std::vector<uint8_t> out;
  out.reserve(n / 2 + 16);
  {  // preamble
    uint64_t v = n;
    do {
      uint8_t b = v & 0x7f;
      v >>= 7;
      out.push_back(v ? uint8_t(b | 0x80) : b);
    } while (v);
  }
  constexpr size_t kBlock = 65536;
  constexpr size_t kHashBits = 14;
  std::vector<int32_t> ht(size_t(1) << kHashBits);
  auto hash4 = [](const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return (v * 0x1e35a7bdu) >> (32 - kHashBits);
  };
  for (size_t base = 0; base < n; base += kBlock) {
    const size_t end = base + kBlock < n ? base + kBlock : n;
    std::fill(ht.begin(), ht.end(), -1);
    size_t i = base, lit_start = base;
    while (i + 4 <= end) {
      const uint32_t h = hash4(src + i);
      const int32_t cand = ht[h];
      ht[h] = int32_t(i - base);
      if (cand >= 0) {
        const size_t c = base + size_t(cand);
        if (std::memcmp(src + c, src + i, 4) == 0) {
          size_t len = 4;
          while (i + len < end && src[c + len] == src[i + len]) len++;
          detail::snappy_emit_literal(out, src + lit_start, i - lit_start);
          detail::snappy_emit_copy(out, i - c, len);
          i += len;
          lit_start = i;
          continue;
        }
      }
      i++;
    }
    detail::snappy_emit_literal(out, src + lit_start, end - lit_start);
  }
  return out;
}

}  // namespace dpq
