// dpq_common.hpp — shared enums and byte-cursor primitives for the TPU-native
// Parquet scan engine's host library.
//
// Behavioral contract mirrors the reference parser's enum values and cursor
// semantics (reference: include/common.hpp:16-106,110-173) but the code is a
// fresh design: the host library's job here is *not* to decode values (that is
// the TPU's job) — it parses metadata, builds the page index, and runs the
// structural pre-scan that turns data-dependent byte streams into fixed-layout
// SoA descriptor tables for the device kernels.
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace dpq {

// ── Parquet enums (numeric values fixed by the Parquet spec) ────────────────

enum PhysicalType : int32_t {
  T_BOOLEAN = 0,
  T_INT32 = 1,
  T_INT64 = 2,
  T_INT96 = 3,
  T_FLOAT = 4,
  T_DOUBLE = 5,
  T_BYTE_ARRAY = 6,
  T_FIXED_LEN_BYTE_ARRAY = 7,
};

enum EncodingId : int32_t {
  E_PLAIN = 0,
  E_PLAIN_DICTIONARY = 2,
  E_RLE = 3,
  E_BIT_PACKED = 4,
  E_DELTA_BINARY_PACKED = 5,
  E_DELTA_LENGTH_BYTE_ARRAY = 6,
  E_DELTA_BYTE_ARRAY = 7,
  E_RLE_DICTIONARY = 8,
  E_BYTE_STREAM_SPLIT = 9,
};

enum CodecId : int32_t {
  C_UNCOMPRESSED = 0,
  C_SNAPPY = 1,
  C_GZIP = 2,
  C_LZO = 3,
  C_BROTLI = 4,
  C_LZ4 = 5,
  C_ZSTD = 6,
  C_LZ4_RAW = 7,
};

inline const char* compression_name(int32_t c) {
  switch (c) {
    case C_UNCOMPRESSED: return "UNCOMPRESSED";
    case C_SNAPPY: return "SNAPPY";
    case C_GZIP: return "GZIP";
    case C_LZO: return "LZO";
    case C_BROTLI: return "BROTLI";
    case C_LZ4: return "LZ4";
    case C_ZSTD: return "ZSTD";
    case C_LZ4_RAW: return "LZ4_RAW";
    default: return "UNKNOWN";
  }
}

enum PageKind : int32_t {
  P_DATA = 0,
  P_INDEX = 1,
  P_DICTIONARY = 2,
  P_DATA_V2 = 3,
};

enum Repetition : int32_t {
  R_REQUIRED = 0,
  R_OPTIONAL = 1,
  R_REPEATED = 2,
};

inline const char* physical_type_name(int32_t t) {
  switch (t) {
    case T_BOOLEAN: return "BOOLEAN";
    case T_INT32: return "INT32";
    case T_INT64: return "INT64";
    case T_INT96: return "INT96";
    case T_FLOAT: return "FLOAT";
    case T_DOUBLE: return "DOUBLE";
    case T_BYTE_ARRAY: return "BYTE_ARRAY";
    case T_FIXED_LEN_BYTE_ARRAY: return "FIXED_LEN_BYTE_ARRAY";
    default: return "UNKNOWN";
  }
}

// Fixed-width byte size of a physical type's PLAIN representation
// (0 = variable length / bit-packed).
inline int plain_width(int32_t t) {
  switch (t) {
    case T_INT32:
    case T_FLOAT: return 4;
    case T_INT64:
    case T_DOUBLE: return 8;
    case T_INT96: return 12;
    default: return 0;  // BOOLEAN (bit-packed), BYTE_ARRAY (varlen), FLBA
  }
}

// ── Error type ──────────────────────────────────────────────────────────────

struct Error : std::runtime_error {
  explicit Error(const std::string& what) : std::runtime_error(what) {}
};

// ── Byte cursor ─────────────────────────────────────────────────────────────
//
// Bounds-checked forward cursor over an in-memory span.  Little-endian fixed
// reads, ULEB128 varints and zigzag (the three primitives both Thrift compact
// and the Parquet page payloads are built from).

class Cursor {
 public:
  Cursor() : p_(nullptr), n_(0), at_(0) {}
  Cursor(const uint8_t* p, size_t n) : p_(p), n_(n), at_(0) {}

  size_t tell() const { return at_; }
  void seek(size_t pos) { at_ = pos; }
  size_t left() const { return n_ - at_; }
  const uint8_t* head() const { return p_ + at_; }
  const uint8_t* base() const { return p_; }
  size_t size() const { return n_; }

  uint8_t u8() {
    need(1);
    return p_[at_++];
  }

  template <typename T>
  T le() {
    need(sizeof(T));
    T v;
    std::memcpy(&v, p_ + at_, sizeof(T));
    at_ += sizeof(T);
    return v;
  }

  const uint8_t* bytes(size_t k) {
    need(k);
    const uint8_t* q = p_ + at_;
    at_ += k;
    return q;
  }

  uint64_t uleb() {
    uint64_t out = 0;
    for (int shift = 0;; shift += 7) {
      if (shift > 63) throw Error("uleb128 overflow");
      uint8_t b = u8();
      out |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return out;
    }
  }

  int64_t zigzag() {
    uint64_t u = uleb();
    return int64_t(u >> 1) ^ -int64_t(u & 1);
  }

 private:
  void need(size_t k) const {
    if (at_ + k > n_)
      throw Error("cursor overrun: at=" + std::to_string(at_) + " need=" +
                  std::to_string(k) + " size=" + std::to_string(n_));
  }
  const uint8_t* p_;
  size_t n_;
  size_t at_;
};

// Append helpers for building byte streams (writer side).
inline void put_uleb(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(uint8_t(v) | 0x80);
    v >>= 7;
  }
  out.push_back(uint8_t(v));
}

inline void put_zigzag(std::vector<uint8_t>& out, int64_t v) {
  put_uleb(out, (uint64_t(v) << 1) ^ uint64_t(v >> 63));
}

template <typename T>
inline void put_le(std::vector<uint8_t>& out, T v) {
  uint8_t buf[sizeof(T)];
  std::memcpy(buf, &v, sizeof(T));
  out.insert(out.end(), buf, buf + sizeof(T));
}

}  // namespace dpq
