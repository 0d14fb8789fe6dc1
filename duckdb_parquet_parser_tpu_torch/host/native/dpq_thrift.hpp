// dpq_thrift.hpp — Thrift *compact protocol* codec (reader + writer).
//
// Parquet footers and page headers are Thrift compact-encoded structs.  This
// implements exactly the subset the format uses: field headers with id deltas,
// zigzag varint integers, length-prefixed binaries, lists, nested structs, and
// a skipper for everything else (maps/sets included so unknown fields never
// desync the stream).  Wire behavior matches the reference codec
// (reference: src/reader/thrift.cpp, src/writer/thrift_writer.cpp) while the
// API here is callback/visitor-flavored to keep struct decoding table-driven.
#pragma once

#include "dpq_common.hpp"

namespace dpq {
namespace tc {  // thrift compact wire type tags

constexpr uint8_t STOP = 0x00;
constexpr uint8_t BOOL_TRUE = 0x01;
constexpr uint8_t BOOL_FALSE = 0x02;
constexpr uint8_t I8 = 0x03;
constexpr uint8_t I16 = 0x04;
constexpr uint8_t I32 = 0x05;
constexpr uint8_t I64 = 0x06;
constexpr uint8_t DOUBLE = 0x07;
constexpr uint8_t BINARY = 0x08;
constexpr uint8_t LIST = 0x09;
constexpr uint8_t SET = 0x0A;
constexpr uint8_t MAP = 0x0B;
constexpr uint8_t STRUCT = 0x0C;

}  // namespace tc

// ── Reader ──────────────────────────────────────────────────────────────────

class TReader {
 public:
  TReader(const uint8_t* data, size_t size) : cur_(data, size) {}
  explicit TReader(Cursor cur) : cur_(cur) {}

  struct Field {
    int16_t id;
    uint8_t type;  // tc::STOP when the struct ends
    bool stop() const { return type == tc::STOP; }
  };

  // Reads the next field header of the current struct.
  Field field() {
    uint8_t head = cur_.u8();
    if (head == tc::STOP) return {0, tc::STOP};
    uint8_t type = head & 0x0F;
    int16_t delta = int16_t((head >> 4) & 0x0F);
    int16_t id = delta ? int16_t(fid_ + delta) : int16_t(cur_.zigzag());
    fid_ = id;
    return {id, type};
  }

  bool vbool(const Field& f) const { return f.type == tc::BOOL_TRUE; }
  // Bool LIST elements (unlike field-header bools) occupy one byte each on
  // the wire: 1 = true, 2 = false.
  bool vbool_elem() { return cur_.u8() == tc::BOOL_TRUE; }
  int32_t vi32() { return int32_t(cur_.zigzag()); }
  int64_t vi64() { return cur_.zigzag(); }
  double vdouble() { return cur_.le<double>(); }

  std::string vstring() {
    size_t len = size_t(cur_.uleb());
    const uint8_t* p = cur_.bytes(len);
    return std::string(reinterpret_cast<const char*>(p), len);
  }

  struct ListHead {
    uint8_t elem_type;
    int32_t count;
  };

  ListHead list() {
    uint8_t head = cur_.u8();
    uint8_t sz = (head >> 4) & 0x0F;
    int32_t count = (sz == 0x0F) ? int32_t(cur_.uleb()) : int32_t(sz);
    return {uint8_t(head & 0x0F), count};
  }

  // Enter/leave a nested struct value (saves the field-id delta base).
  void enter() {
    stack_.push_back(fid_);
    fid_ = 0;
  }
  void leave() {
    fid_ = stack_.back();
    stack_.pop_back();
  }

  // Decode one struct by dispatching each field to `on(field) -> bool`;
  // returning false means "not consumed" and the field is skipped.
  template <typename Fn>
  void read_struct(Fn&& on) {
    enter();
    for (;;) {
      Field f = field();
      if (f.stop()) break;
      if (!on(f)) skip(f.type);
    }
    leave();
  }

  void skip(uint8_t type) {
    switch (type) {
      case tc::BOOL_TRUE:
      case tc::BOOL_FALSE:
        return;
      case tc::I8:
        cur_.u8();
        return;
      case tc::I16:
      case tc::I32:
      case tc::I64:
        cur_.uleb();
        return;
      case tc::DOUBLE:
        cur_.bytes(8);
        return;
      case tc::BINARY:
        cur_.bytes(size_t(cur_.uleb()));
        return;
      case tc::LIST:
      case tc::SET: {
        ListHead lh = list();
        // bool list ELEMENTS are one byte each (field-header bools carry
        // their value in the type tag and consume nothing)
        if (lh.elem_type == tc::BOOL_TRUE || lh.elem_type == tc::BOOL_FALSE) {
          cur_.bytes(size_t(lh.count));
          return;
        }
        for (int32_t i = 0; i < lh.count; i++) skip(lh.elem_type);
        return;
      }
      case tc::MAP: {
        int32_t count = int32_t(cur_.uleb());
        if (count > 0) {
          uint8_t kv = cur_.u8();
          for (int32_t i = 0; i < count; i++) {
            skip((kv >> 4) & 0x0F);
            skip(kv & 0x0F);
          }
        }
        return;
      }
      case tc::STRUCT: {
        read_struct([](const Field&) { return false; });
        return;
      }
      default:
        throw Error("thrift skip: unknown wire type " + std::to_string(type));
    }
  }

  size_t tell() const { return cur_.tell(); }

 private:
  Cursor cur_;
  int16_t fid_ = 0;
  std::vector<int16_t> stack_;
};

// ── Writer ──────────────────────────────────────────────────────────────────

class TWriter {
 public:
  const std::vector<uint8_t>& buf() const { return buf_; }
  std::vector<uint8_t>&& take() { return std::move(buf_); }
  size_t size() const { return buf_.size(); }

  void field_head(int16_t id, uint8_t type) {
    int16_t delta = int16_t(id - fid_);
    if (delta > 0 && delta <= 15) {
      buf_.push_back(uint8_t((delta << 4) | type));
    } else {
      buf_.push_back(type);
      put_zigzag(buf_, id);
    }
    fid_ = id;
  }

  void f_bool(int16_t id, bool v) {
    field_head(id, v ? tc::BOOL_TRUE : tc::BOOL_FALSE);
  }
  void f_i32(int16_t id, int32_t v) {
    field_head(id, tc::I32);
    put_zigzag(buf_, v);
  }
  void f_i64(int16_t id, int64_t v) {
    field_head(id, tc::I64);
    put_zigzag(buf_, v);
  }
  void f_binary(int16_t id, const std::string& s) {
    field_head(id, tc::BINARY);
    put_uleb(buf_, s.size());
    buf_.insert(buf_.end(), s.begin(), s.end());
  }

  void f_list(int16_t id, uint8_t elem_type, int32_t count) {
    field_head(id, tc::LIST);
    if (count < 15) {
      buf_.push_back(uint8_t((count << 4) | elem_type));
    } else {
      buf_.push_back(uint8_t(0xF0 | elem_type));
      put_uleb(buf_, uint64_t(count));
    }
  }

  // Raw list-element emitters (list elements have no field headers).
  void elem_i32(int32_t v) { put_zigzag(buf_, v); }
  void elem_i64(int64_t v) { put_zigzag(buf_, v); }
  // bool LIST elements are one byte each on the wire (1 = true, 2 = false)
  void elem_bool(bool v) {
    buf_.push_back(v ? tc::BOOL_TRUE : tc::BOOL_FALSE);
  }
  void elem_binary(const std::string& s) {
    put_uleb(buf_, s.size());
    buf_.insert(buf_.end(), s.begin(), s.end());
  }

  void struct_begin(int16_t id) {
    field_head(id, tc::STRUCT);
    push();
  }
  void struct_end() {
    stop();
    pop();
  }

  // Struct appearing as a *list element*: no field header, fresh id base.
  void elem_struct_begin() { push(); }
  void elem_struct_end() {
    stop();
    pop();
  }

  void stop() { buf_.push_back(tc::STOP); }

 private:
  void push() {
    stack_.push_back(fid_);
    fid_ = 0;
  }
  void pop() {
    fid_ = stack_.back();
    stack_.pop_back();
  }

  std::vector<uint8_t> buf_;
  int16_t fid_ = 0;
  std::vector<int16_t> stack_;
};

}  // namespace dpq
