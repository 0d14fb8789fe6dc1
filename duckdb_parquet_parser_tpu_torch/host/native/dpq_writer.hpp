// dpq_writer.hpp — host-side Parquet writer (uncompressed or Snappy), the fixture
// generator and de-facto test harness of the framework.
//
// Behavioral constants follow the reference writer so that both readers see
// identical page layouts on generated fixtures
// (reference: src/writer/parquet_writer.cpp, include/writer/rle_bp_encoder.hpp):
//   * dictionary encoding iff 0 < #unique <= #non-null / 5        (:271-278)
//   * PLAIN pages split greedily at 1024 estimated bytes, breaking AFTER the
//     row that crosses the threshold                               (:56-80)
//   * dictionary data pages hold 1024 / ceil(bw/8) rows each       (:82-98)
//   * definition levels are written as pure RLE runs               (:103-135)
//   * dictionary indices use the hybrid encoder: RLE at >=4 repeats,
//     otherwise bit-packed groups of 8, zero-padded        (rle_bp_encoder.hpp)
//   * footer: version=2, minimal field sets                        (:463-581)
// One deliberate divergence: PLAIN BOOLEAN values are written bit-packed (the
// Parquet standard and what the reference READER decodes); the reference
// writer emits one byte per boolean, which its own reader cannot round-trip.
#pragma once

#include <fstream>
#include <unordered_map>

#include "dpq_meta.hpp"
#include "dpq_codec.hpp"

namespace dpq {

constexpr int64_t kMaxPlainPageBytes = 1024;

struct ColumnDecl {
  std::string name;
  int32_t type = T_INT64;
  bool optional = false;
  std::optional<int32_t> converted;
  std::optional<int32_t> scale;
  std::optional<int32_t> precision;
  std::optional<int32_t> type_length;  // FIXED_LEN_BYTE_ARRAY width
};

// Columnar input for one row group: fixed-width values are raw little-endian
// bytes at `width` pitch; strings are (offsets, chars); validity is a byte
// mask (nullptr = all valid).  Null slots still occupy a pitch slot (their
// bytes are ignored).
struct ColumnData {
  const uint8_t* valid = nullptr;  // n bytes, 0 = null
  const uint8_t* fixed = nullptr;  // n * width bytes
  int width = 0;
  const int64_t* offs = nullptr;   // n+1 (BYTE_ARRAY)
  const uint8_t* chars = nullptr;  // offs[n] bytes
  int64_t n = 0;
};

// Hybrid RLE / bit-packed encoder for dictionary indices; constants and
// commit rules match the reference encoder (include/writer/rle_bp_encoder.hpp).
class HybridEncoder {
 public:
  explicit HybridEncoder(uint8_t bw) : bw_(bw), byte_w_((bw + 7) / 8) {}

  void add(uint32_t v) {
    if (bp_n_ != 0) {  // committed to a bit-packed run
      bp_[bp_n_++] = v;
      if (bp_n_ == 8) flush_bp();
      return;
    }
    if (rle_n_ == 0) {
      rle_v_ = v;
      rle_n_ = 1;
      return;
    }
    if (rle_v_ == v) {
      rle_n_++;
      return;
    }
    if (rle_n_ >= 4) {  // long enough: emit the RLE run, start fresh
      flush_rle();
      rle_v_ = v;
      rle_n_ = 1;
      return;
    }
    for (uint32_t i = 0; i < rle_n_; i++) bp_[bp_n_++] = rle_v_;
    bp_[bp_n_++] = v;
    rle_n_ = 0;
    if (bp_n_ == 8) flush_bp();
  }

  void finish(std::vector<uint8_t>& out) {
    if (rle_n_ > 0) {
      flush_rle();
    } else if (bp_n_ > 0) {
      while (bp_n_ < 8) bp_[bp_n_++] = 0;  // zero-pad the partial group
      flush_bp();
    }
    out.insert(out.end(), buf_.begin(), buf_.end());
  }

 private:
  void flush_rle() {
    put_uleb(buf_, uint64_t(rle_n_) << 1);
    uint32_t v = rle_v_;
    for (uint8_t i = 0; i < byte_w_; i++) {
      buf_.push_back(uint8_t(v));
      v >>= 8;
    }
    rle_n_ = 0;
  }
  void flush_bp() {
    put_uleb(buf_, (1u << 1) | 1);  // one group of 8
    size_t base = buf_.size();
    buf_.resize(base + (size_t(8) * bw_ + 7) / 8, 0);
    uint32_t bit = 0;
    for (int i = 0; i < 8; i++) {
      for (uint8_t b = 0; b < bw_; b++) {
        if (bp_[i] & (1u << b)) buf_[base + bit / 8] |= uint8_t(1u << (bit % 8));
        bit++;
      }
    }
    bp_n_ = 0;
  }

  uint8_t bw_, byte_w_;
  uint32_t rle_v_ = 0, rle_n_ = 0;
  uint32_t bp_[8] = {};
  uint32_t bp_n_ = 0;
  std::vector<uint8_t> buf_;
};

class Writer {
 public:
  Writer(const std::string& path, std::vector<ColumnDecl> cols)
      : cols_(std::move(cols)) {
    out_.open(path, std::ios::binary | std::ios::trunc);
    if (!out_.is_open()) throw Error("writer: cannot open " + path);
    out_.write("PAR1", 4);
  }

  ~Writer() {
    if (!closed_) {
      try {
        close();
      } catch (...) {
      }
    }
  }

  void add_key_value(const std::string& key, const std::string& value) {
    kv_.emplace_back(key, value);
  }

  // Page-payload codec (extension beyond the reference, which writes and
  // reads UNCOMPRESSED only).  Must be set before the first row group.
  void set_codec(int32_t codec) {
    if (!rgs_.empty()) throw Error("writer: set codec before first row group");
    if (!codec_supported(codec))
      throw Error(std::string("writer: unsupported codec ") +
                  compression_name(codec) + " (supported: " +
                  codec_supported_list() + ")");
    codec_ = codec;
  }

  void write_row_group(const std::vector<ColumnData>& data) {
    if (closed_) throw Error("writer: already closed");
    if (data.size() != cols_.size()) throw Error("writer: column count mismatch");

    RGMeta rg;
    rg.num_rows = data.empty() ? 0 : data[0].n;

    for (size_t c = 0; c < cols_.size(); c++) {
      const ColumnDecl& decl = cols_[c];
      const ColumnData& col = data[c];
      if (col.n != rg.num_rows) throw Error("writer: ragged row group");
      if (decl.type == T_FIXED_LEN_BYTE_ARRAY &&
          (!decl.type_length || col.width != *decl.type_length))
        throw Error("writer: FIXED_LEN_BYTE_ARRAY data width must equal the "
                    "declared type_length");
      const int16_t max_def = decl.optional ? 1 : 0;

      Dict dict = analyze(decl, col);
      int64_t col_start = tellp();
      uncomp_acc_ = 0;
      ChunkMeta cm;
      cm.num_values = col.n;

      const bool stats_ok = stats_supported(decl.type);
      auto track = [&](int64_t at, int64_t cnt,
                       const std::vector<uint8_t>& page) {
        PageCI ci = stats_ok ? page_ci(decl, col, at, cnt) : PageCI{};
        ci.first_row = at;
        ci.offset = tellp();
        emit(page);
        ci.csize = int32_t(tellp() - ci.offset);
        cm.pages.push_back(std::move(ci));
      };

      if (dict.use) {
        cm.dict_page_offset = col_start;
        emit(dict_page(decl, col, dict));
        cm.data_page_offset = tellp();
        cm.dict_encoded = true;
        const uint8_t bw = index_bit_width(uint32_t(dict.order.size()));
        // Rows per page counts all rows (nulls included), matching the
        // reference's dictionary page-boundary rule.
        int64_t per_page = kMaxPlainPageBytes / std::max<int64_t>(1, (bw + 7) / 8);
        if (per_page == 0) per_page = 1;
        for (int64_t at = 0; at < col.n; at += per_page) {
          int64_t cnt = std::min(per_page, col.n - at);
          track(at, cnt, dict_data_page(decl, col, dict, bw, at, cnt, max_def));
        }
      } else {
        cm.data_page_offset = col_start;
        for (auto [at, cnt] : plain_boundaries(decl, col))
          track(at, cnt, plain_data_page(decl, col, at, cnt, max_def));
      }

      // chunk-level Statistics aggregation
      cm.has_stats = stats_ok;
      for (const PageCI& p : cm.pages) {
        cm.null_count += p.null_count;
        if (!p.comparable) cm.has_stats = false;
        if (p.null_page || !p.comparable) continue;
        if (!cm.has_minmax || stat_less(decl.type, p.min_v, cm.min_v))
          cm.min_v = p.min_v;
        if (!cm.has_minmax || stat_less(decl.type, cm.max_v, p.max_v))
          cm.max_v = p.max_v;
        cm.has_minmax = true;
      }

      cm.total_size = tellp() - col_start;
      cm.total_uncomp = uncomp_acc_;
      rg.chunks.push_back(cm);
    }

    total_rows_ += rg.num_rows;
    rgs_.push_back(std::move(rg));
  }

  void close() {
    if (closed_) return;
    closed_ = true;

    // ── Page Index region (engine extension; written between the last data
    // page and the footer: all ColumnIndexes, then all OffsetIndexes, the
    // layout arrow produces).  The reference writer emits neither.
    for (size_t g = 0; g < rgs_.size(); g++)
      for (size_t c = 0; c < rgs_[g].chunks.size(); c++) {
        ChunkMeta& cm = rgs_[g].chunks[c];
        if (!cm.has_stats || cm.pages.empty()) continue;
        TWriter ci;
        const int32_t n = int32_t(cm.pages.size());
        ci.f_list(1, tc::BOOL_TRUE, n);  // null_pages
        for (const PageCI& p : cm.pages) ci.elem_bool(p.null_page);
        ci.f_list(2, tc::BINARY, n);  // min_values ("" on null pages)
        for (const PageCI& p : cm.pages)
          ci.elem_binary(p.null_page ? std::string() : p.min_v);
        ci.f_list(3, tc::BINARY, n);  // max_values
        for (const PageCI& p : cm.pages)
          ci.elem_binary(p.null_page ? std::string() : p.max_v);
        ci.f_i32(4, boundary_order(cols_[c].type, cm.pages));
        ci.f_list(5, tc::I64, n);  // null_counts
        for (const PageCI& p : cm.pages) ci.elem_i64(p.null_count);
        ci.stop();
        cm.ci_off = tellp();
        cm.ci_len = int32_t(ci.size());
        emit(ci.buf());
      }
    for (RGMeta& rg : rgs_)
      for (ChunkMeta& cm : rg.chunks) {
        if (cm.pages.empty()) continue;
        TWriter oi;
        oi.f_list(1, tc::STRUCT, int32_t(cm.pages.size()));
        for (const PageCI& p : cm.pages) {
          oi.elem_struct_begin();
          oi.f_i64(1, p.offset);
          oi.f_i32(2, p.csize);
          oi.f_i64(3, p.first_row);  // row-group-relative, per spec
          oi.elem_struct_end();
        }
        oi.stop();
        cm.oi_off = tellp();
        cm.oi_len = int32_t(oi.size());
        emit(oi.buf());
      }

    int64_t footer_start = tellp();

    TWriter t;
    t.f_i32(1, 2);  // version

    t.f_list(2, tc::STRUCT, int32_t(1 + cols_.size()));
    t.elem_struct_begin();  // root element
    t.f_binary(4, "schema");
    t.f_i32(5, int32_t(cols_.size()));
    t.elem_struct_end();
    for (const ColumnDecl& c : cols_) {
      t.elem_struct_begin();
      t.f_i32(1, c.type);
      if (c.type_length) t.f_i32(2, *c.type_length);
      t.f_i32(3, c.optional ? R_OPTIONAL : R_REQUIRED);
      t.f_binary(4, c.name);
      if (c.converted) t.f_i32(6, *c.converted);
      if (c.scale) t.f_i32(7, *c.scale);
      if (c.precision) t.f_i32(8, *c.precision);
      t.elem_struct_end();
    }

    t.f_i64(3, total_rows_);

    t.f_list(4, tc::STRUCT, int32_t(rgs_.size()));
    for (const RGMeta& rg : rgs_) {
      t.elem_struct_begin();
      t.f_list(1, tc::STRUCT, int32_t(rg.chunks.size()));
      int64_t rg_bytes = 0;
      for (size_t c = 0; c < rg.chunks.size(); c++) {
        const ChunkMeta& cm = rg.chunks[c];
        rg_bytes += cm.total_size;
        t.elem_struct_begin();
        t.f_i64(2, cm.dict_encoded ? cm.dict_page_offset : cm.data_page_offset);
        t.struct_begin(3);  // ColumnMetaData
        t.f_i32(1, cols_[c].type);
        if (cm.dict_encoded) {
          t.f_list(2, tc::I32, 2);
          t.elem_i32(E_PLAIN);
          t.elem_i32(E_RLE_DICTIONARY);
        } else {
          t.f_list(2, tc::I32, 1);
          t.elem_i32(E_PLAIN);
        }
        t.f_list(3, tc::BINARY, 1);
        t.elem_binary(cols_[c].name);
        t.f_i32(4, codec_);
        t.f_i64(5, cm.num_values);
        t.f_i64(6, cm.total_uncomp);
        t.f_i64(7, cm.total_size);
        t.f_i64(9, cm.data_page_offset);
        if (cm.dict_encoded) t.f_i64(11, cm.dict_page_offset);
        if (cm.has_stats) {
          t.struct_begin(12);  // Statistics (engine extension)
          t.f_i64(3, cm.null_count);
          if (cm.has_minmax) {
            t.f_binary(5, cm.max_v);
            t.f_binary(6, cm.min_v);
          }
          t.struct_end();
        }
        t.struct_end();
        if (cm.oi_off >= 0) {
          t.f_i64(4, cm.oi_off);
          t.f_i32(5, cm.oi_len);
        }
        if (cm.ci_off >= 0) {
          t.f_i64(6, cm.ci_off);
          t.f_i32(7, cm.ci_len);
        }
        t.elem_struct_end();
      }
      t.f_i64(2, rg_bytes);
      t.f_i64(3, rg.num_rows);
      t.elem_struct_end();
    }

    if (!kv_.empty()) {
      t.f_list(5, tc::STRUCT, int32_t(kv_.size()));
      for (const auto& [k, v] : kv_) {
        t.elem_struct_begin();
        t.f_binary(1, k);
        t.f_binary(2, v);
        t.elem_struct_end();
      }
    }

    // column_orders (field 7): TypeDefinedOrder per leaf — without this,
    // readers (arrow included) must ignore the min/max statistics above.
    t.f_list(7, tc::STRUCT, int32_t(cols_.size()));
    for (size_t c = 0; c < cols_.size(); c++) {
      t.elem_struct_begin();
      t.struct_begin(1);  // ColumnOrder union: 1 = TYPE_ORDER (empty struct)
      t.struct_end();
      t.elem_struct_end();
    }

    t.stop();

    out_.write(reinterpret_cast<const char*>(t.buf().data()),
               std::streamsize(t.size()));
    uint32_t footer_len = uint32_t(tellp() - footer_start);
    out_.write(reinterpret_cast<const char*>(&footer_len), 4);
    out_.write("PAR1", 4);
    out_.close();
  }

 private:
  // Per-data-page location + value stats, collected at emit time for the
  // Page Index (engine extension — the reference writer emits neither
  // Statistics nor ColumnIndex/OffsetIndex).
  struct PageCI {
    int64_t offset = 0;     // file offset of the page header
    int32_t csize = 0;      // compressed size INCLUDING the header
    int64_t first_row = 0;  // row-group-relative first row
    int64_t null_count = 0;
    bool null_page = false;
    bool comparable = true;  // false when non-null values exist but none
                             // order (all-NaN float pages)
    std::string min_v, max_v;
  };

  struct ChunkMeta {
    int64_t data_page_offset = 0;
    int64_t dict_page_offset = 0;
    int64_t total_size = 0;    // bytes in the file (compressed)
    int64_t total_uncomp = 0;  // headers + logical payload bytes
    int64_t num_values = 0;
    bool dict_encoded = false;
    std::vector<PageCI> pages;  // data pages only (dict pages excluded)
    bool has_stats = false;
    bool has_minmax = false;
    std::string min_v, max_v;   // chunk-level (Statistics field 12)
    int64_t null_count = 0;
    int64_t ci_off = -1, oi_off = -1;  // page-index locations (close())
    int32_t ci_len = 0, oi_len = 0;
  };
  struct RGMeta {
    int64_t num_rows = 0;
    std::vector<ChunkMeta> chunks;
  };

  struct Dict {
    bool use = false;
    std::unordered_map<std::string, uint32_t> map;  // value bytes -> index
    std::vector<std::string> order;                 // first-appearance order
  };

  int64_t tellp() { return int64_t(out_.tellp()); }
  void emit(const std::vector<uint8_t>& b) {
    out_.write(reinterpret_cast<const char*>(b.data()), std::streamsize(b.size()));
  }

  static bool is_null(const ColumnData& col, int64_t i) {
    return col.valid && !col.valid[i];
  }

  static std::string cell_bytes(const ColumnDecl& decl, const ColumnData& col,
                                int64_t i) {
    if (decl.type == T_BYTE_ARRAY)
      return std::string(reinterpret_cast<const char*>(col.chars + col.offs[i]),
                         size_t(col.offs[i + 1] - col.offs[i]));
    return std::string(reinterpret_cast<const char*>(col.fixed + i * col.width),
                       size_t(col.width));
  }

  // ── Statistics / Page Index helpers ───────────────────────────────────────

  // INT96 has no defined order; everything else gets min/max stats.
  static bool stats_supported(int32_t type) { return type != T_INT96; }

  // Logical order on stat value bytes: signed ints, IEEE floats (NaN is
  // excluded at collection time), unsigned lexicographic bytes.
  static bool stat_less(int32_t type, const std::string& a,
                        const std::string& b) {
    auto as = [](const std::string& s, auto v) {
      std::memcpy(&v, s.data(), sizeof(v));
      return v;
    };
    switch (type) {
      case T_BOOLEAN: return uint8_t(a[0]) < uint8_t(b[0]);
      case T_INT32: return as(a, int32_t{}) < as(b, int32_t{});
      case T_INT64: return as(a, int64_t{}) < as(b, int64_t{});
      case T_FLOAT: return as(a, float{}) < as(b, float{});
      case T_DOUBLE: return as(a, double{}) < as(b, double{});
      default: return a < b;  // BYTE_ARRAY / FLBA: unsigned lexicographic
    }
  }

  // Value i's stat bytes; false when it does not participate (NaN floats).
  static bool stat_bytes(const ColumnDecl& decl, const ColumnData& col,
                         int64_t i, std::string* out) {
    *out = cell_bytes(decl, col, i);
    if (decl.type == T_FLOAT) {
      float v;
      std::memcpy(&v, out->data(), 4);
      return v == v;
    }
    if (decl.type == T_DOUBLE) {
      double v;
      std::memcpy(&v, out->data(), 8);
      return v == v;
    }
    return true;
  }

  // Per-page null_count + min/max over rows [at, at+cnt).
  PageCI page_ci(const ColumnDecl& decl, const ColumnData& col, int64_t at,
                 int64_t cnt) const {
    PageCI ci;
    ci.first_row = at;
    bool have = false;
    std::string v;
    for (int64_t i = at; i < at + cnt; i++) {
      if (is_null(col, i)) {
        ci.null_count++;
        continue;
      }
      if (!stat_bytes(decl, col, i, &v)) {
        ci.comparable = false;
        continue;
      }
      if (!have || stat_less(decl.type, v, ci.min_v)) ci.min_v = v;
      if (!have || stat_less(decl.type, ci.max_v, v)) ci.max_v = v;
      have = true;
    }
    ci.null_page = ci.null_count == cnt;
    if (!have && !ci.null_page) ci.comparable = false;
    if (have) ci.comparable = true;
    return ci;
  }

  // ColumnIndex.boundary_order: 1 ascending / 2 descending / 0 unordered
  // over the non-null pages' [min, max] sequences.
  static int32_t boundary_order(int32_t type, const std::vector<PageCI>& ps) {
    bool asc = true, desc = true;
    const PageCI* prev = nullptr;
    for (const PageCI& p : ps) {
      if (p.null_page) continue;
      if (prev) {
        if (stat_less(type, p.min_v, prev->min_v) ||
            stat_less(type, p.max_v, prev->max_v))
          asc = false;
        if (stat_less(type, prev->min_v, p.min_v) ||
            stat_less(type, prev->max_v, p.max_v))
          desc = false;
      }
      prev = &p;
    }
    return asc ? 1 : (desc ? 2 : 0);
  }

  // Estimated PLAIN size of one row, for page splitting (nulls cost 0).
  static int64_t row_cost(const ColumnDecl& decl, const ColumnData& col,
                          int64_t i) {
    if (is_null(col, i)) return 0;
    switch (decl.type) {
      case T_BOOLEAN: return 1;
      case T_INT32:
      case T_FLOAT: return 4;
      case T_INT64:
      case T_DOUBLE: return 8;
      case T_BYTE_ARRAY: return 4 + (col.offs[i + 1] - col.offs[i]);
      default: return 0;
    }
  }

  Dict analyze(const ColumnDecl& decl, const ColumnData& col) const {
    Dict d;
    int64_t nn = 0;
    for (int64_t i = 0; i < col.n; i++) {
      if (is_null(col, i)) continue;
      nn++;
      std::string key = cell_bytes(decl, col, i);
      if (!d.map.count(key)) {
        d.map.emplace(key, uint32_t(d.order.size()));
        d.order.push_back(std::move(key));
      }
    }
    int64_t uniq = int64_t(d.order.size());
    if (uniq == 0 || uniq > nn / 5) {
      d.map.clear();
      d.order.clear();
      return d;
    }
    d.use = true;
    return d;
  }

  static uint8_t index_bit_width(uint32_t dict_size) {
    uint32_t top = dict_size > 0 ? dict_size - 1 : 0;
    if (top == 0) return 1;  // minimum one bit
    uint8_t bw = 0;
    while (top > 0) {
      bw++;
      top >>= 1;
    }
    return bw;
  }

  std::vector<std::pair<int64_t, int64_t>> plain_boundaries(
      const ColumnDecl& decl, const ColumnData& col) const {
    std::vector<std::pair<int64_t, int64_t>> pages;
    if (col.n == 0) return pages;
    int64_t start = 0, acc = 0;
    for (int64_t i = 0; i < col.n; i++) {
      acc += row_cost(decl, col, i);
      if (acc >= kMaxPlainPageBytes) {  // break AFTER the crossing row
        pages.push_back({start, i - start + 1});
        start = i + 1;
        acc = 0;
      }
    }
    if (start < col.n) pages.push_back({start, col.n - start});
    return pages;
  }

  // Pure-RLE level encoding (no bit-packed runs), one run per span of equal
  // levels — the same stream shape the reference writer produces.
  static std::vector<uint8_t> rle_levels(const std::vector<int16_t>& lv,
                                         uint8_t bw) {
    std::vector<uint8_t> out;
    if (lv.empty() || bw == 0) return out;
    const uint32_t vbytes = (bw + 7) / 8;
    size_t i = 0;
    while (i < lv.size()) {
      size_t j = i + 1;
      while (j < lv.size() && lv[j] == lv[i]) j++;
      put_uleb(out, uint64_t(j - i) << 1);
      uint64_t v = uint64_t(lv[i]);
      for (uint32_t b = 0; b < vbytes; b++) {
        out.push_back(uint8_t(v));
        v >>= 8;
      }
      i = j;
    }
    return out;
  }

  std::vector<uint8_t> def_section(const ColumnData& col, int64_t at,
                                   int64_t cnt, int16_t max_def) const {
    std::vector<uint8_t> payload;
    if (max_def <= 0) return payload;
    std::vector<int16_t> lv(static_cast<size_t>(cnt));
    for (int64_t i = 0; i < cnt; i++)
      lv[size_t(i)] = is_null(col, at + i) ? 0 : max_def;
    std::vector<uint8_t> rle = rle_levels(lv, level_bit_width(max_def));
    put_le<uint32_t>(payload, uint32_t(rle.size()));
    payload.insert(payload.end(), rle.begin(), rle.end());
    return payload;
  }

  std::vector<uint8_t> plain_values(const ColumnDecl& decl,
                                    const ColumnData& col, int64_t at,
                                    int64_t cnt) const {
    std::vector<uint8_t> out;
    if (decl.type == T_BOOLEAN) {
      // Standard bit-packed PLAIN booleans (see divergence note above).
      uint32_t bit = 0;
      for (int64_t i = at; i < at + cnt; i++) {
        if (is_null(col, i)) continue;
        if (bit % 8 == 0) out.push_back(0);
        if (col.fixed[i]) out.back() |= uint8_t(1u << (bit % 8));
        bit++;
      }
      return out;
    }
    for (int64_t i = at; i < at + cnt; i++) {
      if (is_null(col, i)) continue;
      if (decl.type == T_BYTE_ARRAY) {
        put_le<uint32_t>(out, uint32_t(col.offs[i + 1] - col.offs[i]));
        out.insert(out.end(), col.chars + col.offs[i], col.chars + col.offs[i + 1]);
      } else {
        out.insert(out.end(), col.fixed + i * col.width,
                   col.fixed + (i + 1) * col.width);
      }
    }
    return out;
  }

  std::vector<uint8_t> page_with_header(
      int32_t kind, int32_t num_values, int32_t value_encoding,
      const std::vector<uint8_t>& payload) const {
    std::vector<uint8_t> stored;
    if (codec_ != C_UNCOMPRESSED)
      stored = codec_compress(codec_, payload.data(), payload.size());
    const std::vector<uint8_t>& body =
        codec_ != C_UNCOMPRESSED ? stored : payload;
    TWriter t;
    t.f_i32(1, kind);
    t.f_i32(2, int32_t(payload.size()));
    t.f_i32(3, int32_t(body.size()));
    if (kind == P_DATA) {
      t.struct_begin(5);
      t.f_i32(1, num_values);
      t.f_i32(2, value_encoding);
      t.f_i32(3, E_RLE);
      t.f_i32(4, E_RLE);
      t.struct_end();
    } else {
      t.struct_begin(7);
      t.f_i32(1, num_values);
      t.f_i32(2, E_PLAIN_DICTIONARY);
      t.struct_end();
    }
    t.stop();
    std::vector<uint8_t> out = t.take();
    // chunk uncompressed-total accounting (header bytes + logical payload)
    uncomp_acc_ += int64_t(out.size()) + int64_t(payload.size());
    out.insert(out.end(), body.begin(), body.end());
    return out;
  }

  std::vector<uint8_t> plain_data_page(const ColumnDecl& decl,
                                       const ColumnData& col, int64_t at,
                                       int64_t cnt, int16_t max_def) const {
    std::vector<uint8_t> payload = def_section(col, at, cnt, max_def);
    std::vector<uint8_t> vals = plain_values(decl, col, at, cnt);
    payload.insert(payload.end(), vals.begin(), vals.end());
    return page_with_header(P_DATA, int32_t(cnt), E_PLAIN, payload);
  }

  std::vector<uint8_t> dict_page(const ColumnDecl& decl, const ColumnData& col,
                                 const Dict& dict) const {
    (void)col;
    std::vector<uint8_t> payload;
    for (const std::string& v : dict.order) {
      if (decl.type == T_BYTE_ARRAY) {
        put_le<uint32_t>(payload, uint32_t(v.size()));
        payload.insert(payload.end(), v.begin(), v.end());
      } else if (decl.type == T_BOOLEAN) {
        payload.push_back(v.empty() ? 0 : (v[0] ? 1 : 0));
      } else {
        payload.insert(payload.end(), v.begin(), v.end());
      }
    }
    return page_with_header(P_DICTIONARY, int32_t(dict.order.size()), 0, payload);
  }

  std::vector<uint8_t> dict_data_page(const ColumnDecl& decl,
                                      const ColumnData& col, const Dict& dict,
                                      uint8_t bw, int64_t at, int64_t cnt,
                                      int16_t max_def) const {
    std::vector<uint8_t> payload = def_section(col, at, cnt, max_def);
    payload.push_back(bw);
    HybridEncoder enc(bw);
    for (int64_t i = at; i < at + cnt; i++) {
      if (is_null(col, i)) continue;
      enc.add(dict.map.at(cell_bytes(decl, col, i)));
    }
    enc.finish(payload);
    return page_with_header(P_DATA, int32_t(cnt), E_RLE_DICTIONARY, payload);
  }

  std::ofstream out_;
  std::vector<ColumnDecl> cols_;
  std::vector<std::pair<std::string, std::string>> kv_;
  std::vector<RGMeta> rgs_;
  int64_t total_rows_ = 0;
  int32_t codec_ = C_UNCOMPRESSED;
  mutable int64_t uncomp_acc_ = 0;  // per-chunk logical byte accumulator
  bool closed_ = false;
};

}  // namespace dpq
