// dpq_delta.hpp — the Parquet V2 value encodings the reference never
// implements (its reader is PLAIN/dictionary-only): DELTA_BINARY_PACKED,
// DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY and BYTE_STREAM_SPLIT, decoded
// host-side into the engine's canonical PLAIN layouts so every downstream
// path (device planes, payload matrices, string tables, cold scan) stays
// unchanged.  Oracle: pyarrow-written files (tests/test_v2_encodings.py).
//
// All readers are strict-bounds (untrusted file input; ASAN/UBSAN lane).
// Arithmetic on deltas uses uint64 (wrap-defined) and truncates to the
// target width, matching the format's two's-complement semantics.

#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

#include "dpq_common.hpp"

namespace dpq {

// DELTA_BINARY_PACKED: header (block_size, miniblocks/block, total_count,
// first_value), then blocks of [min_delta, bitwidths[], miniblocks...].
// Returns exactly `want` values (uint64 two's-complement).
inline std::vector<uint64_t> delta_binary_values(Cursor& cur, int64_t want) {
  const uint64_t block_size = cur.uleb();
  const uint64_t miniblocks = cur.uleb();
  const uint64_t total = cur.uleb();
  const uint64_t first = uint64_t(cur.zigzag());
  if (block_size == 0 || miniblocks == 0 || block_size % miniblocks != 0)
    throw Error("delta: bad block geometry");
  const uint64_t mb_values = block_size / miniblocks;
  if (mb_values % 8 != 0 || mb_values > (1u << 20))
    throw Error("delta: bad miniblock size");

  std::vector<uint64_t> out;
  out.reserve(size_t(want));
  if (want > 0) out.push_back(first);
  uint64_t have = 1;
  uint64_t v = first;
  // the stream carries `total` values; callers may want fewer (never more)
  const uint64_t need = uint64_t(want) < total ? uint64_t(want) : total;
  while (have < need) {
    const uint64_t min_delta = uint64_t(cur.zigzag());
    const uint8_t* bws = cur.bytes(size_t(miniblocks));
    for (uint64_t m = 0; m < miniblocks && have < need; m++) {
      const int bw = bws[m];
      if (bw > 64) throw Error("delta: bit width > 64");
      const size_t sec = size_t(mb_values) * size_t(bw) / 8;
      const uint8_t* d = cur.bytes(sec);
      const uint64_t mask = bw == 64 ? ~uint64_t(0)
                                     : ((uint64_t(1) << bw) - 1);
      uint64_t bit = 0;
      for (uint64_t i = 0; i < mb_values && have < need; i++) {
        // word extraction (a per-BIT loop here measured ~30 ns/value):
        // unaligned 8-byte window + one spill byte covers any bw <= 64
        uint64_t delta = 0;
        if (bw) {
          const size_t b0 = size_t(bit >> 3);
          const int sh = int(bit & 7);
          uint64_t wd = 0;
          const size_t nb = sec - b0 < 8 ? sec - b0 : 8;
          std::memcpy(&wd, d + b0, nb);
          wd >>= sh;
          if (sh && b0 + 8 < sec)
            wd |= uint64_t(d[b0 + 8]) << (64 - sh);
          delta = wd & mask;
          bit += uint64_t(bw);
        }
        v += min_delta + delta;
        out.push_back(v);
        have++;
      }
    }
  }
  if (out.size() != size_t(want)) throw Error("delta: short value stream");
  return out;
}

// Append one PLAIN-prefixed BYTE_ARRAY value (u32 length + bytes).
inline void put_prefixed(std::vector<uint8_t>& out, const uint8_t* p,
                         uint32_t len) {
  const size_t at = out.size();
  out.resize(at + 4 + len);
  std::memcpy(out.data() + at, &len, 4);
  if (len) std::memcpy(out.data() + at + 4, p, len);
}

// DELTA_LENGTH_BYTE_ARRAY -> the PLAIN u32-prefixed layout.
inline std::vector<uint8_t> delta_length_ba_to_plain(Cursor& cur, int64_t nn) {
  auto lens = delta_binary_values(cur, nn);
  std::vector<uint8_t> out;
  uint64_t total_chars = 0;
  for (uint64_t l : lens) {
    if (int64_t(l) < 0 || l > cur.left()) throw Error("delta-length: bad length");
    total_chars += l;
  }
  if (total_chars > cur.left()) throw Error("delta-length: chars overrun");
  out.reserve(size_t(total_chars) + 4 * lens.size());
  for (uint64_t l : lens) put_prefixed(out, cur.bytes(size_t(l)), uint32_t(l));
  return out;
}

// DELTA_BYTE_ARRAY (incremental/front coding: shared prefix with the
// previous value + suffix) -> the PLAIN u32-prefixed layout.
inline std::vector<uint8_t> delta_ba_to_plain(Cursor& cur, int64_t nn) {
  auto plens = delta_binary_values(cur, nn);
  auto slens = delta_binary_values(cur, nn);
  std::vector<uint8_t> out;
  std::string prev, val;
  for (int64_t i = 0; i < nn; i++) {
    const uint64_t pl = plens[size_t(i)], sl = slens[size_t(i)];
    if (int64_t(pl) < 0 || pl > prev.size())
      throw Error("delta-ba: prefix exceeds previous value");
    if (int64_t(sl) < 0 || sl > cur.left())
      throw Error("delta-ba: suffix overrun");
    const uint8_t* suf = cur.bytes(size_t(sl));
    val.assign(prev, 0, size_t(pl));
    val.append(reinterpret_cast<const char*>(suf), size_t(sl));
    put_prefixed(out, reinterpret_cast<const uint8_t*>(val.data()),
                 uint32_t(val.size()));
    prev.swap(val);
  }
  return out;
}

// BYTE_STREAM_SPLIT: the k-th bytes of all values stored contiguously ->
// interleaved PLAIN fixed-width values.
inline std::vector<uint8_t> byte_stream_split_to_plain(const uint8_t* src,
                                                       size_t len, int64_t nn,
                                                       int w) {
  if (int64_t(len) < nn * int64_t(w))
    throw Error("byte_stream_split: section too short");
  std::vector<uint8_t> out(size_t(nn) * size_t(w));
  for (int j = 0; j < w; j++) {
    const uint8_t* plane = src + size_t(j) * size_t(nn);
    for (int64_t i = 0; i < nn; i++) out[size_t(i) * w + j] = plane[i];
  }
  return out;
}

}  // namespace dpq
