// dpq_capi.cpp — C ABI for the host library, consumed from Python via ctypes.
//
// Conventions: handle-returning functions return NULL on failure and write a
// message into (err, errcap); int-returning functions return 0 on success and
// -1 on failure.  Strings returned as char* must be freed with dpq_free.
#include <cstdlib>
#include <cstring>
#include <string>

#include "dpq_index.hpp"
#include "dpq_pageindex.hpp"
#include "dpq_prescan.hpp"
#include "dpq_reader.hpp"
#include "dpq_scan.hpp"
#include "dpq_codec.hpp"
#include "dpq_writer.hpp"

using namespace dpq;

namespace {

void set_err(char* err, size_t cap, const char* msg) {
  if (err && cap) {
    std::strncpy(err, msg, cap - 1);
    err[cap - 1] = '\0';
  }
}

char* dup_str(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

struct WriterHandle {
  std::unique_ptr<Writer> writer;
  std::vector<ColumnDecl> decls;          // collected before open
  std::vector<std::pair<std::string, std::string>> kv;
  std::string path;
  int32_t codec = C_UNCOMPRESSED;
  std::vector<ColumnData> pending;        // columns of the row group being built
  std::vector<std::vector<uint8_t>> own;  // copies of caller buffers
  std::vector<std::vector<int64_t>> own_offs;
};

}  // namespace

#define DPQ_TRY(body)                       \
  try {                                     \
    body                                    \
  } catch (const std::exception& e) {       \
    set_err(err, errcap, e.what());         \
    return nullptr;                         \
  }

#define DPQ_TRY_INT(body)                   \
  try {                                     \
    body                                    \
  } catch (const std::exception& e) {       \
    set_err(err, errcap, e.what());         \
    return -1;                              \
  }

extern "C" {

void dpq_free(void* p) { std::free(p); }

// ── Reader ──────────────────────────────────────────────────────────────────

void* dpq_open(const char* path, char* err, size_t errcap) {
  DPQ_TRY({
    auto* r = new Reader();
    try {
      r->open(path);
    } catch (...) {
      delete r;
      throw;
    }
    return static_cast<void*>(r);
  })
}

void dpq_close(void* h) { delete static_cast<Reader*>(h); }

// Test-only: parse one PageHeader from raw bytes with either the hand-rolled
// fast parser (use_fast=1; returns "" when it rejects the layout) or the
// generic Thrift visitor (use_fast=0; returns "ERR:<what>" on throw).  The
// JSON form lets tests assert the two parsers decode identical values on
// canonical headers and that the fast parser rejects non-canonical ones.
char* dpq_test_page_head(const uint8_t* buf, int64_t len, int use_fast) {
  PageHead h;
  size_t consumed = 0;
  if (use_fast) {
    consumed = fast_page_head(buf, buf + len, h);
    if (consumed == 0) return dup_str("");
  } else {
    try {
      TReader r(buf, size_t(len));
      h = read_page_head(r);
      consumed = r.tell();
    } catch (const std::exception& e) {
      return dup_str(std::string("ERR:") + e.what());
    }
  }
  std::string s = "{\"consumed\":" + std::to_string(consumed) +
                  ",\"kind\":" + std::to_string(h.kind) +
                  ",\"usize\":" + std::to_string(h.uncompressed_size) +
                  ",\"csize\":" + std::to_string(h.compressed_size) +
                  ",\"crc\":" + (h.crc ? std::to_string(*h.crc) : "null");
  if (h.data)
    s += ",\"data\":[" + std::to_string(h.data->num_values) + "," +
         std::to_string(h.data->encoding) + "," +
         std::to_string(h.data->def_encoding) + "," +
         std::to_string(h.data->rep_encoding) + "]";
  if (h.dict)
    s += ",\"dict\":[" + std::to_string(h.dict->num_values) + "," +
         std::to_string(h.dict->encoding) + "," +
         std::to_string(int(h.dict->is_sorted)) + "]";
  if (h.data_v2)
    s += ",\"v2\":[" + std::to_string(h.data_v2->num_values) + "," +
         std::to_string(h.data_v2->num_nulls) + "," +
         std::to_string(h.data_v2->num_rows) + "," +
         std::to_string(h.data_v2->encoding) + "," +
         std::to_string(h.data_v2->def_len) + "," +
         std::to_string(h.data_v2->rep_len) + "," +
         std::to_string(int(h.data_v2->is_compressed)) + "]";
  s += "}";
  return dup_str(s);
}

char* dpq_meta_json(void* h) {
  return dup_str(static_cast<Reader*>(h)->meta_json());
}

int64_t dpq_num_pages_all(void* h) {
  return int64_t(static_cast<Reader*>(h)->pages().size());
}

int64_t dpq_num_data_pages(void* h) {
  return int64_t(static_cast<Reader*>(h)->data_page_gids().size());
}

// Fills per-page arrays for ALL pages (length dpq_num_pages_all): offsets and
// sizes are for the page payload (after the header), matching the reference's
// PageIndexEntry fields.
void dpq_page_table(void* h, int64_t* header_off, int64_t* data_off,
                    int64_t* size, int32_t* kind, int32_t* rg, int32_t* col,
                    int32_t* num_values, int32_t* encoding, int64_t* gid,
                    int64_t* row_start) {
  const auto& pages = static_cast<Reader*>(h)->pages();
  for (size_t i = 0; i < pages.size(); i++) {
    const PageRec& p = pages[i];
    header_off[i] = p.header_off;
    data_off[i] = p.data_off;
    size[i] = p.size;
    kind[i] = p.kind;
    rg[i] = p.rg;
    col[i] = p.chunk_col;
    num_values[i] = p.num_values;
    encoding[i] = p.encoding;
    gid[i] = p.gid;
    row_start[i] = p.row_start;
  }
}

// Zero-copy pointer to the whole mmap'd file (NULL if mapping failed).
// Valid until dpq_close.
const void* dpq_file_view(void* h, int64_t* size) {
  auto* r = static_cast<Reader*>(h);
  if (size) *size = int64_t(r->file_size());
  return r->file_map();
}

int dpq_read_range(void* h, int64_t off, int64_t len, uint8_t* out, char* err,
                   size_t errcap) {
  DPQ_TRY_INT({
    static_cast<Reader*>(h)->read_range(off, len, out);
    return 0;
  })
}

// ── Pre-scan batches ────────────────────────────────────────────────────────

void* dpq_prescan(void* h, int32_t leaf_idx, int32_t rg0, int32_t rg1,
                  int64_t align, int64_t pad_strings, int64_t flags,
                  int64_t payload_align, int64_t row_lo, int64_t row_hi,
                  char* err, size_t errcap) {
  DPQ_TRY({
    auto batch = static_cast<Reader*>(h)->prescan(
        leaf_idx, rg0, rg1, align, pad_strings, flags, payload_align, row_lo,
        row_hi);
    return static_cast<void*>(batch.release());
  })
}

void dpq_batch_free(void* b) { delete static_cast<ArrayStore*>(b); }

// Chunked-index boundary plan over a PS_INDEX emission stream (idx_emit_pos /
// idx_emit_len arrays of a prescan batch).  Returns an ArrayStore handle with
// positions/lens/chunk_of_entry/tuple_to_chunk/chunk_starts — exact reference
// flush-before-append semantics (src/main.cpp:21-32).
void* dpq_index_plan(const int64_t* pos, const int32_t* lens, int64_t cap,
                     int64_t num_rows, int64_t chunk_size, char* err,
                     size_t errcap) {
  DPQ_TRY({
    auto out = index_plan(pos, lens, cap, num_rows, chunk_size);
    return static_cast<void*>(out.release());
  })
}

// Fused chunked-index build straight off an open reader (see
// dpq_index.hpp::Reader::index_build): header walk + emission + boundary
// plan in one native pass — no intermediate emission arrays.
void* dpq_index_build(void* reader, int32_t leaf_idx, int64_t num_rows,
                      int64_t chunk_size, char* err, size_t errcap) {
  DPQ_TRY({
    auto* r = static_cast<Reader*>(reader);
    auto out = r->index_build(leaf_idx, num_rows, chunk_size);
    return static_cast<void*>(out.release());
  })
}

// Value-boundary payload split plan (see dpq_scan.hpp::split_payload_plan):
// ArrayStore handle with seg_page/seg_off/seg_len/seg_nn + dims
// n_segs/seg_pitch — re-chunks big PLAIN pages at value starts for the
// device streaming matcher.
void* dpq_split_plan(const uint8_t* payload, int64_t n, int64_t pitch,
                     const int32_t* plen, const int32_t* nn,
                     const int32_t* kind, int64_t target, char* err,
                     size_t errcap) {
  DPQ_TRY({
    auto out = split_payload_plan(payload, n, pitch, plen, nn, kind, target);
    return static_cast<void*>(out.release());
  })
}

// Page Index (ColumnIndex/OffsetIndex) stats per data page — ArrayStore
// handle with gid/row_start/has_stats/null_page/null_count, raw min/max
// byte planes, and OffsetIndex locations (see dpq_pageindex.hpp).
void* dpq_page_stats(void* h, int32_t leaf_idx, char* err, size_t errcap) {
  DPQ_TRY({
    auto store = static_cast<Reader*>(h)->page_stats(leaf_idx);
    return static_cast<void*>(store.release());
  })
}

// Fused cold-path regex scan.  Chain mode when n_needles > 0 (needles packed
// back-to-back in `needle_buf` with lengths in `needle_lens`); otherwise DFA
// mode over (table [n_states, 256] i32, accept [n_states] u8).  Returns an
// ArrayStore handle (page_gid / match_counts / value_counts) — same
// manifest/view/free API as prescan batches.
void* dpq_cold_scan(void* h, int32_t leaf_idx, int32_t rg0, int32_t rg1,
                    int32_t neg, int32_t exact, const uint8_t* needle_buf,
                    const int32_t* needle_lens, int32_t n_needles,
                    const int32_t* table, const uint8_t* accept,
                    int32_t n_states, const uint8_t* prune_lo,
                    int32_t lo_len, const uint8_t* prune_hi, int32_t hi_len,
                    char* err, size_t errcap) {
  DPQ_TRY({
    ColdPattern pat;
    pat.neg = neg != 0;
    pat.exact = exact != 0;
    if (prune_lo && lo_len > 0 && !pat.neg) {
      pat.prune_lo.assign(reinterpret_cast<const char*>(prune_lo),
                          size_t(lo_len));
      if (prune_hi && hi_len > 0)
        pat.prune_hi.assign(reinterpret_cast<const char*>(prune_hi),
                            size_t(hi_len));
    }
    size_t at = 0;
    for (int32_t i = 0; i < n_needles; i++) {
      pat.needles.emplace_back(reinterpret_cast<const char*>(needle_buf) + at,
                               size_t(needle_lens[i]));
      at += size_t(needle_lens[i]);
    }
    pat.table = table;
    pat.accept = accept;
    pat.n_states = n_states;
    if (pat.needles.empty() && (!table || !accept || n_states <= 0))
      throw Error("cold_scan: no pattern (needles or DFA table required)");
    auto out = static_cast<Reader*>(h)->cold_scan(leaf_idx, pat, rg0, rg1);
    return static_cast<void*>(out.release());
  })
}

char* dpq_batch_manifest(void* b) {
  return dup_str(static_cast<ArrayStore*>(b)->manifest_json());
}

// Copies the named array into `out` (caller allocates using the manifest).
int dpq_batch_read(void* b, const char* name, void* out, char* err,
                   size_t errcap) {
  DPQ_TRY_INT({
    auto* store = static_cast<ArrayStore*>(b);
    auto it = store->arrays.find(name);
    if (it == store->arrays.end()) throw Error(std::string("no array: ") + name);
    std::memcpy(out, it->second.data(), it->second.nbytes);
    return 0;
  })
}

// Zero-copy view of the named array (valid until dpq_batch_free).
const void* dpq_batch_view(void* b, const char* name, int64_t* nbytes) {
  auto* store = static_cast<ArrayStore*>(b);
  auto it = store->arrays.find(name);
  if (it == store->arrays.end()) {
    if (nbytes) *nbytes = -1;
    return nullptr;
  }
  if (nbytes) *nbytes = int64_t(it->second.nbytes);
  return it->second.data();
}


// ── Snappy codec (raw format; engine extension — test surface) ─────────────

int64_t dpq_snappy_max_compressed(int64_t n) {
  // worst case: preamble (5) + one literal tag chain (~6 bytes per 2^32)
  return n + n / 6 + 32;
}

int64_t dpq_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, char* err, size_t errcap) {
  DPQ_TRY_INT({
    auto out = snappy_compress(src, size_t(n));
    if (int64_t(out.size()) > cap) throw Error("snappy: dst too small");
    std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  })
}

int dpq_snappy_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t dst_len, char* err, size_t errcap) {
  DPQ_TRY_INT({
    snappy_decompress(src, size_t(n), dst, size_t(dst_len));
    return 0;
  })
}

// ── Generic page codecs (GZIP/ZSTD/LZ4/LZ4_RAW/BROTLI; engine extension) ────

int dpq_codec_supported(int32_t codec) {
  return codec_supported(codec) ? 1 : 0;
}

int64_t dpq_codec_max_compressed(int32_t codec, int64_t n) {
  if (codec == C_SNAPPY) return dpq_snappy_max_compressed(n);
  // generous over every linked codec's bound (zlib/zstd/lz4/brotli are all
  // well under n + n/6 even incompressible; framing overhead is O(100) B)
  return n + n / 6 + 1024;
}

int64_t dpq_codec_compress(int32_t codec, const uint8_t* src, int64_t n,
                           uint8_t* dst, int64_t cap, char* err,
                           size_t errcap) {
  DPQ_TRY_INT({
    auto out = codec_compress(codec, src, size_t(n));
    if (int64_t(out.size()) > cap) throw Error("codec: dst too small");
    if (!out.empty()) std::memcpy(dst, out.data(), out.size());
    return int64_t(out.size());
  })
}

int dpq_codec_decompress(int32_t codec, const uint8_t* src, int64_t n,
                         uint8_t* dst, int64_t dst_len, char* err,
                         size_t errcap) {
  DPQ_TRY_INT({
    codec_decompress(codec, src, size_t(n), dst, size_t(dst_len));
    return 0;
  })
}

// ── Writer ──────────────────────────────────────────────────────────────────

void* dpq_writer_new(const char* path, char* err, size_t errcap) {
  DPQ_TRY({
    auto* w = new WriterHandle();
    w->path = path;
    return static_cast<void*>(w);
  })
}

int dpq_writer_declare(void* h, const char* name, int32_t type,
                       int32_t optional, int32_t converted, int32_t scale,
                       int32_t precision, int32_t type_length, char* err,
                       size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    if (w->writer) throw Error("writer: declare before first row group");
    ColumnDecl d;
    d.name = name;
    d.type = type;
    d.optional = optional != 0;
    if (converted >= 0) d.converted = converted;
    if (scale != INT32_MIN) d.scale = scale;
    if (precision != INT32_MIN) d.precision = precision;
    if (type_length != INT32_MIN) d.type_length = type_length;
    w->decls.push_back(std::move(d));
    return 0;
  })
}

int dpq_writer_codec(void* h, int32_t codec, char* err, size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    if (w->writer) throw Error("writer: set codec before first row group");
    if (!codec_supported(codec))
      throw Error(std::string("writer: unsupported codec ") +
                  compression_name(codec) + " (supported: " +
                  codec_supported_list() + ")");
    w->codec = codec;
    return 0;
  })
}

int dpq_writer_kv(void* h, const char* key, const char* value, char* err,
                  size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    if (w->writer) throw Error("writer: add key-values before first row group");
    w->kv.emplace_back(key, value);
    return 0;
  })
}

static ColumnData& push_col(WriterHandle* w, const uint8_t* valid, int64_t n) {
  ColumnData cd;
  cd.n = n;
  if (valid) {
    w->own.emplace_back(valid, valid + n);
    cd.valid = w->own.back().data();
  }
  w->pending.push_back(cd);
  return w->pending.back();
}

int dpq_writer_col_fixed(void* h, const uint8_t* valid, const uint8_t* data,
                         int32_t width, int64_t n, char* err, size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    ColumnData& cd = push_col(w, valid, n);
    w->own.emplace_back(data, data + n * width);
    cd.fixed = w->own.back().data();
    cd.width = width;
    return 0;
  })
}

int dpq_writer_col_bytes(void* h, const uint8_t* valid, const int64_t* offs,
                         const uint8_t* chars, int64_t n, char* err,
                         size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    ColumnData& cd = push_col(w, valid, n);
    w->own_offs.emplace_back(offs, offs + n + 1);
    cd.offs = w->own_offs.back().data();
    w->own.emplace_back(chars, chars + offs[n]);
    cd.chars = w->own.back().data();
    return 0;
  })
}

int dpq_writer_rg_end(void* h, char* err, size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    if (!w->writer) {
      w->writer = std::make_unique<Writer>(w->path, w->decls);
      w->writer->set_codec(w->codec);
      for (const auto& [k, v] : w->kv) w->writer->add_key_value(k, v);
    }
    w->writer->write_row_group(w->pending);
    w->pending.clear();
    w->own.clear();
    w->own_offs.clear();
    return 0;
  })
}

int dpq_writer_close(void* h, char* err, size_t errcap) {
  DPQ_TRY_INT({
    auto* w = static_cast<WriterHandle*>(h);
    if (!w->writer) {
      w->writer = std::make_unique<Writer>(w->path, w->decls);
      w->writer->set_codec(w->codec);
      for (const auto& [k, v] : w->kv) w->writer->add_key_value(k, v);
    }
    w->writer->close();
    delete w;
    return 0;
  })
}

void dpq_writer_abort(void* h) { delete static_cast<WriterHandle*>(h); }

}  // extern "C"
