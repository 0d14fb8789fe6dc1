// dpq_meta.hpp — Parquet footer metadata model and deserializers.
//
// Field-id maps follow the Parquet Thrift IDL and match the reference's
// coverage (reference: src/reader/metadata.cpp — SchemaElement ids 1-9,
// ColumnMetaData ids 1-7,9,10,11, ColumnChunk 1-3, DataPageHeader 1-4,
// DictionaryPageHeader 1-3, PageHeader 1-8, RowGroup 1-3, KeyValue 1-2,
// FileMetaData 1-6).  Unknown fields are skipped, Statistics are parsed and
// discarded, so decoding stays in lockstep with any conforming writer.
#pragma once

#include <optional>

#include "dpq_common.hpp"
#include "dpq_thrift.hpp"

namespace dpq {

struct SchemaElement {
  std::optional<int32_t> type;          // id 1 (PhysicalType)
  std::optional<int32_t> type_length;   // id 2
  std::optional<int32_t> repetition;    // id 3 (Repetition)
  std::string name;                     // id 4
  std::optional<int32_t> num_children;  // id 5
  std::optional<int32_t> converted;     // id 6 (ConvertedType)
  std::optional<int32_t> scale;         // id 7
  std::optional<int32_t> precision;     // id 8
  std::optional<int32_t> field_id;      // id 9
};

// Column-chunk Statistics (Thrift struct; engine extension — the reference
// parses these only to discard them, reference: src/reader/metadata.cpp:26-32;
// the engine keeps them and exposes typed min/max/null_count through
// ParquetReader.column_stats()).
struct Stats {
  std::optional<std::string> max;            // id 1 (deprecated physical order)
  std::optional<std::string> min;            // id 2 (deprecated physical order)
  std::optional<int64_t> null_count;         // id 3
  std::optional<int64_t> distinct_count;     // id 4
  std::optional<std::string> max_value;      // id 5 (logical order)
  std::optional<std::string> min_value;      // id 6 (logical order)
};

struct ColumnMeta {
  int32_t type = 0;                              // id 1
  std::vector<int32_t> encodings;                // id 2
  std::vector<std::string> path;                 // id 3
  int32_t codec = 0;                             // id 4
  int64_t num_values = 0;                        // id 5
  int64_t total_uncompressed_size = 0;           // id 6
  int64_t total_compressed_size = 0;             // id 7
  int64_t data_page_offset = 0;                  // id 9
  std::optional<int64_t> index_page_offset;      // id 10
  std::optional<int64_t> dictionary_page_offset; // id 11
  std::optional<Stats> stats;                    // id 12
};

struct ColumnChunk {
  std::string file_path;           // id 1
  int64_t file_offset = 0;         // id 2
  std::optional<ColumnMeta> meta;  // id 3
  // Page-index locations (engine extension — the reference parses chunk
  // ids 1-3 only, reference: src/reader/metadata.cpp:68-86)
  std::optional<int64_t> offset_index_offset;  // id 4
  std::optional<int32_t> offset_index_length;  // id 5
  std::optional<int64_t> column_index_offset;  // id 6
  std::optional<int32_t> column_index_length;  // id 7
};

struct RowGroup {
  std::vector<ColumnChunk> columns;  // id 1
  int64_t total_byte_size = 0;       // id 2
  int64_t num_rows = 0;              // id 3
};

struct KeyValue {
  std::string key;    // id 1
  std::string value;  // id 2
};

struct FileMeta {
  int32_t version = 0;                // id 1
  std::vector<SchemaElement> schema;  // id 2 (depth-first flattened tree)
  int64_t num_rows = 0;               // id 3
  std::vector<RowGroup> row_groups;   // id 4
  std::vector<KeyValue> kv;           // id 5
  std::string created_by;             // id 6
};

struct DataPageHead {
  int32_t num_values = 0;  // id 1
  int32_t encoding = 0;    // id 2
  int32_t def_encoding = 0;  // id 3
  int32_t rep_encoding = 0;  // id 4
};

struct DictPageHead {
  int32_t num_values = 0;  // id 1
  int32_t encoding = 0;    // id 2
  bool is_sorted = false;  // id 3
};

struct DataPageHeadV2 {
  int32_t num_values = 0;     // id 1
  int32_t num_nulls = 0;      // id 2
  int32_t num_rows = 0;       // id 3
  int32_t encoding = 0;       // id 4
  int32_t def_len = 0;        // id 5 (definition_levels_byte_length)
  int32_t rep_len = 0;        // id 6 (repetition_levels_byte_length)
  bool is_compressed = true;  // id 7 (default true per spec)
};

struct PageHead {
  int32_t kind = -1;                  // id 1 (PageKind)
  int32_t uncompressed_size = 0;      // id 2
  int32_t compressed_size = 0;        // id 3
  std::optional<int32_t> crc;         // id 4
  std::optional<DataPageHead> data;   // id 5
  std::optional<DictPageHead> dict;   // id 7
  std::optional<DataPageHeadV2> data_v2;  // id 8 (SKIPPED by the reference —
                                          // metadata.cpp:138-150; the engine
                                          // reads V2 pages as an extension)
};

// ── Deserializers ───────────────────────────────────────────────────────────

inline SchemaElement read_schema_element(TReader& r) {
  SchemaElement e;
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: e.type = r.vi32(); return true;
      case 2: e.type_length = r.vi32(); return true;
      case 3: e.repetition = r.vi32(); return true;
      case 4: e.name = r.vstring(); return true;
      case 5: e.num_children = r.vi32(); return true;
      case 6: e.converted = r.vi32(); return true;
      case 7: e.scale = r.vi32(); return true;
      case 8: e.precision = r.vi32(); return true;
      case 9: e.field_id = r.vi32(); return true;
      default: return false;
    }
  });
  return e;
}

inline ColumnMeta read_column_meta(TReader& r) {
  ColumnMeta m;
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: m.type = r.vi32(); return true;
      case 2: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++) m.encodings.push_back(r.vi32());
        return true;
      }
      case 3: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++) m.path.push_back(r.vstring());
        return true;
      }
      case 4: m.codec = r.vi32(); return true;
      case 5: m.num_values = r.vi64(); return true;
      case 6: m.total_uncompressed_size = r.vi64(); return true;
      case 7: m.total_compressed_size = r.vi64(); return true;
      case 9: m.data_page_offset = r.vi64(); return true;
      case 10: m.index_page_offset = r.vi64(); return true;
      case 11: m.dictionary_page_offset = r.vi64(); return true;
      case 12: {
        Stats s;
        r.read_struct([&](const TReader::Field& sf) {
          switch (sf.id) {
            case 1: s.max = r.vstring(); return true;
            case 2: s.min = r.vstring(); return true;
            case 3: s.null_count = r.vi64(); return true;
            case 4: s.distinct_count = r.vi64(); return true;
            case 5: s.max_value = r.vstring(); return true;
            case 6: s.min_value = r.vstring(); return true;
            default: return false;
          }
        });
        m.stats = std::move(s);
        return true;
      }
      default: return false;
    }
  });
  return m;
}

inline ColumnChunk read_column_chunk(TReader& r) {
  ColumnChunk c;
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: c.file_path = r.vstring(); return true;
      case 2: c.file_offset = r.vi64(); return true;
      case 3: c.meta = read_column_meta(r); return true;
      case 4: c.offset_index_offset = r.vi64(); return true;
      case 5: c.offset_index_length = r.vi32(); return true;
      case 6: c.column_index_offset = r.vi64(); return true;
      case 7: c.column_index_length = r.vi32(); return true;
      default: return false;
    }
  });
  return c;
}

inline RowGroup read_row_group(TReader& r) {
  RowGroup g;
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++)
          g.columns.push_back(read_column_chunk(r));
        return true;
      }
      case 2: g.total_byte_size = r.vi64(); return true;
      case 3: g.num_rows = r.vi64(); return true;
      default: return false;
    }
  });
  return g;
}

inline FileMeta read_file_meta(TReader& r) {
  FileMeta m;
  // FileMetaData is the top-level struct: no enclosing field header, but the
  // field loop itself is identical to a nested struct body.
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: m.version = r.vi32(); return true;
      case 2: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++)
          m.schema.push_back(read_schema_element(r));
        return true;
      }
      case 3: m.num_rows = r.vi64(); return true;
      case 4: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++)
          m.row_groups.push_back(read_row_group(r));
        return true;
      }
      case 5: {
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++) {
          KeyValue kv;
          r.read_struct([&](const TReader::Field& g) {
            switch (g.id) {
              case 1: kv.key = r.vstring(); return true;
              case 2: kv.value = r.vstring(); return true;
              default: return false;
            }
          });
          m.kv.push_back(std::move(kv));
        }
        return true;
      }
      case 6: m.created_by = r.vstring(); return true;
      default: return false;
    }
  });
  return m;
}

inline PageHead read_page_head(TReader& r) {
  PageHead h;
  r.read_struct([&](const TReader::Field& f) {
    switch (f.id) {
      case 1: h.kind = r.vi32(); return true;
      case 2: h.uncompressed_size = r.vi32(); return true;
      case 3: h.compressed_size = r.vi32(); return true;
      case 4: h.crc = r.vi32(); return true;
      case 5: {
        DataPageHead d;
        r.read_struct([&](const TReader::Field& g) {
          switch (g.id) {
            case 1: d.num_values = r.vi32(); return true;
            case 2: d.encoding = r.vi32(); return true;
            case 3: d.def_encoding = r.vi32(); return true;
            case 4: d.rep_encoding = r.vi32(); return true;
            default: return false;
          }
        });
        h.data = d;
        return true;
      }
      case 7: {
        DictPageHead d;
        r.read_struct([&](const TReader::Field& g) {
          switch (g.id) {
            case 1: d.num_values = r.vi32(); return true;
            case 2: d.encoding = r.vi32(); return true;
            case 3: d.is_sorted = r.vbool(g); return true;
            default: return false;
          }
        });
        h.dict = d;
        return true;
      }
      case 8: {
        DataPageHeadV2 d;
        r.read_struct([&](const TReader::Field& g) {
          switch (g.id) {
            case 1: d.num_values = r.vi32(); return true;
            case 2: d.num_nulls = r.vi32(); return true;
            case 3: d.num_rows = r.vi32(); return true;
            case 4: d.encoding = r.vi32(); return true;
            case 5: d.def_len = r.vi32(); return true;
            case 6: d.rep_len = r.vi32(); return true;
            case 7: d.is_compressed = r.vbool(g); return true;
            default: return false;
          }
        });
        h.data_v2 = d;
        return true;
      }
      default: return false;
    }
  });
  return h;
}

// ── Hand-rolled page-header fast path ───────────────────────────────────────
//
// The page-index walk parses one PageHeader per page (~100k headers on a
// 100 MB file); the generic visitor parser costs ~280 ns/header, which is
// most of a cold open() on this box.  This parser handles only the CANONICAL
// compact-protocol layouts — fields in wire order, no page statistics, no
// unknown fields — and returns 0 whenever the bytes deviate, at which point
// the caller retries with the generic read_page_head.  Every byte sequence
// this accepts decodes to exactly the values the generic parser would
// produce (it is a strict subset of the grammar), so parity is structural.
//
// Canonical layouts (field-header byte = (id delta << 4) | wire type):
//   PageHeader: 0x15 kind, 0x15 uncompressed, 0x15 compressed,
//               [0x15 crc,] ((hid-last)<<4|0xC) nested header, 0x00
//   DataPageHead (id 5):   0x15 ×4 (num_values, enc, def_enc, rep_enc), 0x00
//   DictPageHead (id 7):   0x15 ×2 (num_values, enc), [0x11|0x12,] 0x00
//   DataPageHeadV2 (id 8): 0x15 ×6 (nv, nulls, rows, enc, dlen, rlen),
//                          [0x11|0x12,] 0x00
inline size_t fast_page_head(const uint8_t* base, const uint8_t* end,
                             PageHead& h) {
  // Parse into a local and assign to `h` only on full success, so a failed
  // (return 0) attempt never leaves partially-mutated output behind.
  PageHead o;
  const uint8_t* p = base;
  auto zz32 = [&](int32_t& out) -> bool {  // zigzag varint (i32)
    uint64_t v = 0;
    int sh = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= uint64_t(b & 0x7F) << sh;
      if (!(b & 0x80)) {
        out = int32_t(int64_t(v >> 1) ^ -int64_t(v & 1));
        return true;
      }
      sh += 7;
      if (sh > 63) return false;
    }
    return false;
  };
  auto i32_field = [&](int32_t& out) -> bool {
    return p < end && *p == 0x15 && (p++, zz32(out));
  };
  if (!i32_field(o.kind) || !i32_field(o.uncompressed_size) ||
      !i32_field(o.compressed_size))
    return 0;
  int last_id = 3;
  if (p < end && *p == 0x15) {  // optional crc (id 4)
    p++;
    int32_t crc;
    if (!zz32(crc)) return 0;
    o.crc = crc;
    last_id = 4;
  }
  if (p >= end) return 0;
  uint8_t nested = *p++;
  if ((nested & 0x0F) != tc::STRUCT) return 0;
  int hid = last_id + int(nested >> 4);
  if (hid == 5) {  // DataPageHead
    DataPageHead d;
    if (!i32_field(d.num_values) || !i32_field(d.encoding) ||
        !i32_field(d.def_encoding) || !i32_field(d.rep_encoding))
      return 0;
    if (p >= end || *p++ != tc::STOP) return 0;  // page stats → generic path
    o.data = d;
  } else if (hid == 7) {  // DictPageHead
    DictPageHead d;
    if (!i32_field(d.num_values) || !i32_field(d.encoding)) return 0;
    if (p < end && (*p == 0x11 || *p == 0x12)) d.is_sorted = (*p++ == 0x11);
    if (p >= end || *p++ != tc::STOP) return 0;
    o.dict = d;
  } else if (hid == 8) {  // DataPageHeadV2
    DataPageHeadV2 d;
    if (!i32_field(d.num_values) || !i32_field(d.num_nulls) ||
        !i32_field(d.num_rows) || !i32_field(d.encoding) ||
        !i32_field(d.def_len) || !i32_field(d.rep_len))
      return 0;
    if (p < end && (*p == 0x11 || *p == 0x12)) d.is_compressed = (*p++ == 0x11);
    if (p >= end || *p++ != tc::STOP) return 0;
    o.data_v2 = d;
  } else {
    return 0;  // index pages / unknown header kinds → generic path
  }
  if (p >= end || *p++ != tc::STOP) return 0;  // trailing fields → generic
  h = o;
  return size_t(p - base);
}

// Bit width needed to encode values in [0, max_level] — matches the level
// bit-width rule of the format (reference: src/reader/column_reader.cpp:270).
inline uint8_t level_bit_width(int32_t max_level) {
  uint8_t w = 0;
  while (max_level > 0) {
    w++;
    max_level >>= 1;
  }
  return w;
}

}  // namespace dpq
