// dpq_reader.hpp — host-side Parquet reader: footer parse, schema walk,
// global page index, and the *structural pre-scan* that packs column chunks
// into fixed-layout SoA batches for the TPU decode kernels.
//
// The TPU-first split implemented here: everything data-dependent and branchy
// (Thrift, varints, RLE run headers, string length prefixes) happens once on
// the host at O(runs + strings) cost; the device then sees only fixed-shape
// integer tensors (run descriptor tables, padded byte planes) and does all
// O(values) work branch-free.  Behavioral parity targets the reference
// decoder (reference: src/reader/column_reader.cpp, src/reader/
// parquet_reader.cpp) — quirks mirrored deliberately:
//   * RLE decoder zero-fills when a section is exhausted
//     (reference: include/reader/rle_decoder.hpp:20-24)
//   * literal (bit-packed) runs advertise groups*8 values
//     (reference: include/reader/rle_decoder.hpp:41-46)
//   * v1 level sections are read in SPEC order ([rep][def]).  The reference
//     reads def before rep (src/reader/column_reader.cpp:147-164) — a
//     deviation that is invisible on its own writer's files (no rep levels)
//     but misparses REAL nested files (docs/reference_bugs.md); we follow
//     the spec there, byte-identical everywhere the reference works
//   * out-of-range dictionary indices decode to NULL in column reads
//     (reference: src/reader/column_reader.cpp:190-194)
//   * page headers for DATA_PAGE and DATA_PAGE_V2 get global page ids;
//     dictionary pages do not (reference: src/reader/parquet_reader.cpp:588-599)
#pragma once

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <cstdio>
#include <map>
#include <memory>
#include <sstream>
#include <thread>

#include "dpq_meta.hpp"

namespace dpq {

// Optional pre-scan outputs.
enum PrescanFlags : int64_t {
  PS_HOST_STRINGS = 1,  // per-value host string tables (str_lens/offs/chars)
  PS_PAYLOAD = 2,       // raw value-section bytes per page ("payload"),
                        // for the fully device-side string kernels
  PS_RUNS_ONLY = 4,     // suppress the materialized level/index planes
                        // (def_levels / idx_vals) — parity tests exercise
                        // the device run-expansion path with this
  PS_STR_VIEWS = 8,     // PLAIN string tables as ZERO-COPY views into the
                        // file mapping: str_offs become absolute file
                        // offsets and no str_chars copy is made (dims
                        // str_abs=1; falls back to copying when a chunk
                        // leaves the mapped file)
  PS_COLUMN = 16,       // fully-materialized read_column arrays (col_values/
                        // col_valid, or col_offs/col_lens/col_src for
                        // BYTE_ARRAY) emitted during the pack pass — the
                        // decoded-column answer at C++ speed (dims col_mat=1)
  PS_REP_LEVELS = 32,   // materialize the repetition-level plane
                        // ("rep_levels" [n_pages, vmax]) on nested columns —
                        // list reconstruction only (read_list_column); scan
                        // and flat-decode paths never read it
  PS_INDEX = 64,        // chunked-index emission stream for BYTE_ARRAY
                        // columns: idx_emit_pos (global row) / idx_emit_len
                        // per non-null slot, written during the pack pass
                        // (len -1 marks dropped OOB dictionary indices) —
                        // feeds dpq_index_plan (reference workload:
                        // src/main.cpp:21-32)
  PS_COL_ONLY = 128,    // suppress the per-value string TABLES
                        // (str_nn_start/str_lens/str_offs/str_padded) —
                        // for callers that consume only the PS_COLUMN
                        // arrays (read_column fast path); the owned
                        // str_chars buffer is still emitted in copy mode
                        // because col_offs point into it
  PS_DELTA_RAW = 256,   // DELTA_BINARY_PACKED pages: emit STRUCTURE planes
                        // (delta_bw/delta_md_*/delta_cnt/delta_bytes per
                        // miniblock + per-page first values) instead of
                        // host-decoding to PLAIN — the device unpacks the
                        // bit-packed deltas and prefix-sums them
                        // (ops/delta.py).  Throws on mixed delta/plain
                        // pages (callers fall back to the host decode)
};

// ── Leaf column descriptor ──────────────────────────────────────────────────

struct Leaf {
  std::string name;
  int32_t type = T_BYTE_ARRAY;  // defaulted like the reference when absent
  int32_t chunk_idx = 0;        // index into row_group.columns
  int32_t max_def = 0;
  int32_t max_rep = 0;
  int32_t rep_def = 0;          // def level AT the innermost repeated node
                                // (list reconstruction: def >= rep_def means
                                // an element slot, rep_def-1 an empty list)
  // ordered def-contributing ancestors root->leaf: (def threshold, kind,
  // path depth) with kind 0 = OPTIONAL, 1 = REPEATED — the Dremel assembly
  // profile (host/reader.py list/struct reconstruction)
  std::vector<std::array<int32_t, 3>> def_nodes;
  std::string path;  // dotted schema path (e.g. "l.list.element") — leaf
                     // names repeat across lists, paths do not
  std::optional<int32_t> repetition;
  std::optional<int32_t> converted;
  std::optional<int32_t> type_length;
};

// One parsed page header, cached at open() time so the pre-scan and the raw
// page API never re-parse Thrift.
struct PageRec {
  int32_t rg = 0;
  int32_t chunk_col = 0;  // column index within the row group
  int64_t header_off = 0;
  int64_t data_off = 0;  // after header
  int64_t size = 0;      // compressed_page_size
  int64_t usize = 0;     // uncompressed_page_size (== size when UNCOMPRESSED)
  int32_t kind = 0;      // PageKind
  int32_t num_values = 0;
  int32_t encoding = 0;  // data pages: value encoding
  int64_t gid = -1;      // global data-page id (-1 for dictionary pages)
  int64_t row_start = 0; // absolute row index of first value (data pages)
  // DATA_PAGE_V2 extension (the reference skips the V2 header and decodes
  // nothing from these pages): level-section byte lengths (stored
  // uncompressed, no u32 prefix) and whether the VALUES section is compressed
  int32_t v2_def_len = 0;
  int32_t v2_rep_len = 0;
  bool v2_compressed = false;
};

// ── SoA array store (host→Python→device hand-off) ───────────────────────────

enum DType : int32_t { DT_U8 = 1, DT_I32 = 2, DT_I64 = 3 };

// Deleter for batch-array buffers: big planes are anonymous mmaps (huge-page
// madvised), small ones calloc.
struct BatchBufFree {
  size_t map_bytes = 0;  // 0 = calloc-backed
  void operator()(uint8_t* p) const {
    if (!p) return;
    if (map_bytes)
      ::munmap(p, map_bytes);
    else
      std::free(p);
  }
};

struct NamedArray {
  int32_t dtype = DT_U8;
  std::vector<int64_t> shape;
  // Zero pages come lazily from the kernel (first-touch) instead of an eager
  // memset — measured tens of ms on the 100+ MB payload matrices of a
  // 2M-row column.  Planes >= 2 MB are anonymous mmaps with MADV_HUGEPAGE:
  // this box runs THP in `madvise` mode, and 4 KB first-touch faults on the
  // fresh ~30 MB of column planes cost several ms PER READ (allocations are
  // per-call, so the faults recur every call).
  std::unique_ptr<uint8_t, BatchBufFree> buf{nullptr, BatchBufFree{}};
  size_t nbytes = 0;

  int64_t numel() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
  const uint8_t* data() const { return buf.get(); }
  uint8_t* data() { return buf.get(); }
};

struct ArrayStore {
  std::map<std::string, NamedArray> arrays;
  std::map<std::string, int64_t> dims;

  template <typename T>
  T* alloc(const std::string& name, std::vector<int64_t> shape) {
    NamedArray a;
    a.dtype = std::is_same<T, uint8_t>::value  ? DT_U8
              : std::is_same<T, int32_t>::value ? DT_I32
                                                : DT_I64;
    a.shape = std::move(shape);
    a.nbytes = size_t(a.numel()) * sizeof(T);
    // NOTE: MADV_HUGEPAGE was tried here (THP runs in `madvise` mode on this
    // box) and REVERTED: with defrag=madvise a huge-page fault does
    // synchronous compaction, and packs that cost 25 ms went to 220-380 ms
    // under memory pressure.  Plain calloc's 4 KB first-touch faults are the
    // stable choice.
    a.buf = std::unique_ptr<uint8_t, BatchBufFree>(
        static_cast<uint8_t*>(std::calloc(std::max(a.nbytes, size_t(1)), 1)),
        BatchBufFree{});
    if (!a.buf) throw Error("out of memory allocating batch array " + name);
    auto [it, ok] = arrays.emplace(name, std::move(a));
    (void)ok;
    return reinterpret_cast<T*>(it->second.buf.get());
  }

  std::string manifest_json() const;
};

// ── RLE/bit-packed hybrid structural pre-scan ───────────────────────────────

struct Run {
  int32_t kind;    // 0 = repeated(RLE), 1 = literal(bit-packed)
  int32_t count;   // values this run contributes (already capped)
  int32_t value;   // repeated value (RLE runs)
  int32_t bitoff;  // first value's bit offset within the section (literal)
  int32_t vstart;  // index of this run's first value within the page
};

// Walk a hybrid RLE/bit-packed section's run headers without touching value
// data.  Consumption rules mirror the reference decoder: varints tolerate
// truncation, repeated-value reads stop at the section end (missing bytes are
// zero), literal runs advertise groups*8 values, and an exhausted section
// zero-fills the remainder (emitted as a synthetic RLE run of value 0).
inline void rle_prescan(const uint8_t* d, size_t size, int bw, int64_t want,
                        std::vector<Run>& out) {
  size_t pos = 0;
  int64_t got = 0;
  const int vbytes = (bw + 7) / 8;
  while (got < want) {
    if (pos >= size) {
      out.push_back({0, int32_t(want - got), 0, 0, int32_t(got)});
      return;
    }
    uint32_t ind = 0;
    int shift = 0;
    while (pos < size) {
      uint8_t b = d[pos++];
      ind |= uint32_t(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (ind & 1) {
      int64_t adv = int64_t(ind >> 1) * 8;  // literal runs come in 8-groups
      int64_t take = std::min(adv, want - got);
      out.push_back({1, int32_t(take), 0, int32_t(pos * 8), int32_t(got)});
      got += take;
      pos += size_t((adv * bw + 7) / 8);
    } else {
      int64_t count = int64_t(ind >> 1);
      uint64_t val = 0;
      for (int i = 0; i < vbytes && pos < size; i++)
        val |= uint64_t(d[pos++]) << (i * 8);
      if (count == 0) continue;  // degenerate zero-length run
      int64_t take = std::min(count, want - got);
      out.push_back({0, int32_t(take), int32_t(val), 0, int32_t(got)});
      got += take;
    }
  }
}

// Expand pre-scanned runs to per-value integers (the host-side twin of
// ops/expand.py::expand_hybrid, emitted by the pre-scan as the materialized
// def_levels / idx_vals planes).  ~2 cycles per literal value via unaligned
// 4-byte windows — the byte-level parsing the device would otherwise redo
// with ~15 ns/element gathers every decode.
template <typename Write>
inline void expand_runs_to(const Run* runs, size_t n_runs, const uint8_t* sec,
                           size_t len, int bw, Write&& write) {
  const uint32_t mask = bw >= 32 ? ~0u : ((1u << bw) - 1);
  for (size_t ri = 0; ri < n_runs; ri++) {
    const Run& r = runs[ri];
    if (r.kind == 0) {
      for (int32_t i = 0; i < r.count; i++) write(r.vstart + i, r.value);
    } else if (bw > 0 && bw <= 24) {
      for (int32_t i = 0; i < r.count; i++) {
        const int64_t bit = r.bitoff + int64_t(i) * bw;
        const size_t byte = size_t(bit >> 3);
        uint32_t w = 0;
        if (byte + 4 <= len) {
          std::memcpy(&w, sec + byte, 4);
        } else if (byte < len) {
          std::memcpy(&w, sec + byte, len - byte);
        }
        write(r.vstart + i, int32_t((w >> (bit & 7)) & mask));
      }
    } else {
      for (int32_t i = 0; i < r.count; i++) {
        uint32_t v = 0;
        for (int k = 0; k < bw; k++) {
          const int64_t b = r.bitoff + int64_t(i) * bw + k;
          const size_t byte = size_t(b >> 3);
          if (byte < len && ((sec[byte] >> (b & 7)) & 1)) v |= 1u << k;
        }
        write(r.vstart + i, int32_t(v));
      }
    }
  }
}

template <typename Write>
inline void expand_runs_to(const std::vector<Run>& runs, const uint8_t* sec,
                           size_t len, int bw, Write&& write) {
  expand_runs_to(runs.data(), runs.size(), sec, len, bw,
                 std::forward<Write>(write));
}

// Extract one bw-bit little-endian value at `bitpos` (zero beyond `size`).
inline uint32_t bits_at(const uint8_t* d, size_t size, int64_t bitpos, int bw) {
  uint32_t v = 0;
  for (int k = 0; k < bw; k++) {
    int64_t b = bitpos + k;
    size_t byte = size_t(b >> 3);
    if (byte < size && (d[byte] >> (b & 7)) & 1) v |= 1u << k;
  }
  return v;
}

// Count values equal to `target` across pre-scanned runs of one section.
inline int64_t count_matching(const Run* runs, size_t n_runs, const uint8_t* d,
                              size_t size, int bw, int64_t target) {
  int64_t n = 0;
  for (size_t ri = 0; ri < n_runs; ri++) {
    const Run& r = runs[ri];
    if (r.kind == 0) {
      if (r.value == target) n += r.count;
    } else if (bw == 1 && target == 1) {
      // fast path: popcount over the literal bit range
      for (int32_t i = 0; i < r.count; i++)
        n += (bits_at(d, size, r.bitoff + i, 1) != 0);
    } else {
      for (int32_t i = 0; i < r.count; i++)
        n += (bits_at(d, size, r.bitoff + int64_t(i) * bw, bw) == uint32_t(target));
    }
  }
  return n;
}

inline int64_t count_matching(const std::vector<Run>& runs, const uint8_t* d,
                              size_t size, int bw, int64_t target) {
  return count_matching(runs.data(), runs.size(), d, size, bw, target);
}

inline int64_t round_up(int64_t v, int64_t m) { return (v + m - 1) / m * m; }

// Tiny work-stealing-free thread pool: runs fn(0..n_jobs) across up to
// hardware_concurrency threads (caller's thread included), rethrowing the
// first job error.  Jobs must write to disjoint state.
template <typename Fn>
inline void parallel_for(int n_jobs, Fn&& fn, int max_threads = 16) {
  if (n_jobs <= 0) return;
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = int(std::min<unsigned>(hw ? hw : 4, unsigned(max_threads)));
  n_threads = std::max(1, std::min(n_threads, n_jobs));
  if (n_threads <= 1) {
    for (int j = 0; j < n_jobs; j++) fn(j);
    return;
  }
  std::atomic<int> next{0};
  std::vector<std::string> errors;
  errors.resize(size_t(n_threads));
  auto worker = [&](int tid) {
    for (;;) {
      int j = next.fetch_add(1);
      if (j >= n_jobs) return;
      try {
        fn(j);
      } catch (const std::exception& e) {
        errors[size_t(tid)] = e.what();
        return;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 1; i < n_threads; i++) threads.emplace_back(worker, i);
  worker(0);
  for (auto& th : threads) th.join();
  for (const auto& e : errors)
    if (!e.empty()) throw Error(e);
}

// Parse the page header at buf[off] (canonical fast path, generic Thrift
// fallback) and fill rec's header-derived fields.  Numbered (data) pages get
// rec.gid = 0 as a "needs numbering" marker — build_page_index's merge and
// the cold scan's inline walk assign real gids.  Shared by every header walk
// (full index build, count-only, cold-scan inline) so page numbering and
// value bookkeeping can never diverge between them.  Returns the header size.
inline int64_t parse_page_rec(const uint8_t* buf, int64_t off, int64_t span,
                              int64_t abs_start, int32_t rg, int32_t col,
                              int64_t& rows_before, int64_t& values_seen,
                              PageRec& rec) {
  PageHead ph;
  int64_t header_size = int64_t(fast_page_head(buf + off, buf + span, ph));
  if (header_size == 0) {  // non-canonical layout: generic parser
    TReader hr(buf + off, size_t(span - off));
    ph = read_page_head(hr);
    header_size = int64_t(hr.tell());
  }
  // The walk is a dependent pointer chase (next header offset needs this
  // header's sizes); touch the next header's cache lines now so the miss
  // overlaps the PageRec bookkeeping below.  `next` derives from untrusted
  // compressed_size: also require it to move forward so a corrupt negative
  // size can't form an OOB pointer.
  int64_t next = off + header_size + ph.compressed_size;
  if (next > off && next + 64 < span) {
    __builtin_prefetch(buf + next);
    __builtin_prefetch(buf + next + 64);
  }

  rec = PageRec{};
  rec.rg = rg;
  rec.chunk_col = col;
  rec.header_off = abs_start + off;
  rec.data_off = abs_start + off + header_size;
  rec.size = ph.compressed_size;
  // uncompressed_size == 0 is legitimate (an EMPTY dictionary page's zstd
  // frame is 9 compressed bytes for 0 payload bytes); only a negative/absent
  // field falls back to the compressed size.
  rec.usize = ph.uncompressed_size >= 0 ? ph.uncompressed_size
                                        : ph.compressed_size;
  rec.kind = ph.kind;
  if (ph.kind == P_DATA && ph.data) {
    rec.num_values = ph.data->num_values;
    rec.encoding = ph.data->encoding;
    rec.gid = 0;  // marks "numbered"
    rec.row_start = rows_before;
    rows_before += ph.data->num_values;
    values_seen += ph.data->num_values;
  } else if (ph.kind == P_DATA_V2 && ph.data_v2) {
    rec.num_values = ph.data_v2->num_values;
    rec.encoding = ph.data_v2->encoding;
    rec.gid = 0;
    rec.row_start = rows_before;
    rec.v2_def_len = ph.data_v2->def_len;
    rec.v2_rep_len = ph.data_v2->rep_len;
    rec.v2_compressed = ph.data_v2->is_compressed;
    rows_before += ph.data_v2->num_values;
    values_seen += ph.data_v2->num_values;
  } else if (ph.kind == P_DATA_V2) {
    rec.gid = 0;  // numbered but contributes no values (parity)
  } else if (ph.kind == P_DICTIONARY && ph.dict) {
    rec.num_values = ph.dict->num_values;
    rec.encoding = ph.dict->encoding;
  }
  return header_size;
}

// ── Reader ──────────────────────────────────────────────────────────────────

struct ColdPattern;  // defined in dpq_scan.hpp (cold-path regex scan)

class Reader {
 public:
  ~Reader() {
    if (map_ && map_ != MAP_FAILED) ::munmap(const_cast<uint8_t*>(map_), file_size_);
    if (fd_ >= 0) ::close(fd_);
  }

  void open(const std::string& path) {
    fd_ = ::open(path.c_str(), O_RDONLY);
    if (fd_ < 0) throw Error("cannot open file: " + path);
    off_t end = ::lseek(fd_, 0, SEEK_END);
    if (end < 0) throw Error("cannot stat file: " + path);
    file_size_ = size_t(end);
    if (file_size_ < 12) throw Error("file too small to be Parquet");

    // mmap read-only: page payload spans become zero-copy pointers for the
    // pre-scan/cold-scan (no ifstream buffers, no syscall per page header).
    // MAP_POPULATE prefaults the page tables in one batched kernel walk —
    // measured ~2x cheaper than taking ~30k demand minor-faults during the
    // page-index scan of a 100+ MB file.
    void* m = ::mmap(nullptr, file_size_, PROT_READ, MAP_PRIVATE | MAP_POPULATE,
                     fd_, 0);
    if (m == MAP_FAILED)  // e.g. populate refused under memory pressure
      m = ::mmap(nullptr, file_size_, PROT_READ, MAP_PRIVATE, fd_, 0);
    if (m != MAP_FAILED) {
      map_ = static_cast<const uint8_t*>(m);
      ::madvise(m, file_size_, MADV_WILLNEED);
    }

    uint8_t head[4], tail[8];
    pread_full(0, 4, head);
    if (std::memcmp(head, "PAR1", 4) != 0) throw Error("missing PAR1 magic at start");
    pread_full(int64_t(file_size_) - 8, 8, tail);
    if (std::memcmp(tail + 4, "PAR1", 4) != 0) throw Error("missing PAR1 magic at end");

    uint32_t footer_len;
    std::memcpy(&footer_len, tail, 4);
    if (size_t(footer_len) + 8 > file_size_) throw Error("invalid footer length");

    std::vector<uint8_t> footer(footer_len);
    pread_full(int64_t(file_size_) - 8 - footer_len, footer_len, footer.data());
    TReader tr(footer.data(), footer.size());
    meta_ = read_file_meta(tr);

    build_leaves();

    // absolute row offset of each row group (page-index independent)
    rg_row_base_.assign(meta_.row_groups.size() + 1, 0);
    for (size_t i = 0; i < meta_.row_groups.size(); i++)
      rg_row_base_[i + 1] = rg_row_base_[i] + meta_.row_groups[i].num_rows;

    // The global page index (one PageHeader parse per page) is built LAZILY:
    // a cold one-shot scan never needs it (it walks its own chunk's headers
    // inline and takes gid bases from chunk_page_counts()), and on a ~100 MB
    // file the walk is most of open().  Every consumer reaches the table via
    // pages()/data_page_gids()/ensure_page_index(), which build on demand.
    if (std::getenv("DPQ_EAGER_INDEX")) ensure_page_index();
  }

  void ensure_page_index() const {
    if (index_built_) return;
    Reader* self = const_cast<Reader*>(this);
    if (std::getenv("DPQ_OPEN_TIMING")) {
      auto t0 = std::chrono::steady_clock::now();
      self->build_page_index();
      auto t1 = std::chrono::steady_clock::now();
      std::fprintf(stderr, "[open] page index: %.1f ms (%zu pages)\n",
                   std::chrono::duration<double, std::milli>(t1 - t0).count(),
                   pages_.size());
    } else {
      self->build_page_index();
    }
  }

  const FileMeta& meta() const { return meta_; }
  const uint8_t* file_map() const { return map_; }
  const std::vector<Leaf>& leaves() const { return leaves_; }
  const std::vector<PageRec>& pages() const {
    ensure_page_index();
    return pages_;
  }
  const std::vector<int64_t>& data_page_gids() const {
    ensure_page_index();
    return data_gids_;
  }

  // Per-chunk NUMBERED (data) page counts in (rg, col) order — the gid bases
  // for any single chunk's inline walk — WITHOUT building the page index:
  // the Thrift compact LIST HEADER of OffsetIndex.page_locations encodes the
  // page count directly, so chunks that carry an OffsetIndex cost one ~16 B
  // read each; chunks without one get a count-only header walk (identical
  // stopping rule to build_page_index via the shared parse_page_rec).  The
  // cold scan cross-checks its target chunks' counts against its own walk.
  const std::vector<int64_t>& chunk_page_counts() const {
    if (counts_built_) return chunk_counts_;
    Reader* self = const_cast<Reader*>(this);
    const size_t n_rg = meta_.row_groups.size();
    size_t ncols = 0;
    for (const auto& g : meta_.row_groups) ncols = std::max(ncols, g.columns.size());
    self->chunk_counts_.assign(n_rg * ncols, 0);
    self->chunk_ncols_ = int64_t(ncols);
    if (index_built_) {
      for (const PageRec& pr : pages_)
        if (pr.gid >= 0)
          self->chunk_counts_[size_t(pr.rg) * ncols + size_t(pr.chunk_col)]++;
      self->counts_built_ = true;
      return chunk_counts_;
    }
    struct Need { int32_t rg, col; const ColumnMeta* cm; };
    std::vector<Need> walks;
    for (size_t rg = 0; rg < n_rg; rg++) {
      const RowGroup& g = meta_.row_groups[rg];
      for (size_t c = 0; c < g.columns.size(); c++) {
        if (!g.columns[c].meta) continue;
        const ColumnMeta& cm = *g.columns[c].meta;
        int64_t n = offset_index_count(g.columns[c]);
        if (n >= 0)
          self->chunk_counts_[rg * ncols + c] = n;
        else
          walks.push_back({int32_t(rg), int32_t(c), &cm});
      }
    }
    parallel_for(int(walks.size()), [&](int j) {
      const Need& w = walks[size_t(j)];
      self->chunk_counts_[size_t(w.rg) * ncols + size_t(w.col)] =
          count_data_pages_walk(*w.cm);
    });
    self->counts_built_ = true;
    return chunk_counts_;
  }
  int64_t chunk_ncols() const { return chunk_ncols_; }
  size_t file_size() const { return file_size_; }

  int find_leaf(const std::string& name) const {
    for (size_t i = 0; i < leaves_.size(); i++)
      if (leaves_[i].name == name) return int(i);
    return -1;
  }

  // Zero-fill semantics beyond EOF, matching the reference's ifstream reads
  // into a zero-initialized vector (reference: src/reader/parquet_reader.cpp:173-178).
  void read_range(int64_t off, int64_t len, uint8_t* out) const {
    std::memset(out, 0, size_t(len));
    if (off >= int64_t(file_size_) || off < 0) return;
    int64_t avail = std::min(len, int64_t(file_size_) - off);
    if (map_) {
      std::memcpy(out, map_ + off, size_t(avail));
    } else {
      ssize_t got = ::pread(fd_, out, size_t(avail), off);
      (void)got;
    }
  }

  // Zero-copy pointer to [off, off+len) when fully inside the mapped file;
  // nullptr means the caller must take the zero-filled read_range copy path.
  const uint8_t* span_ptr(int64_t off, int64_t len) const {
    if (!map_ || off < 0 || len < 0 || off + len > int64_t(file_size_))
      return nullptr;
    return map_ + off;
  }

  std::string meta_json() const;

  // Parse one chunk's ColumnIndex (1 null_pages list<bool>, 2 min_values
  // list<binary>, 3 max_values, 5 null_counts list<i64>) if present.
  // Returns false when the chunk carries none.  Shared by page_stats and
  // the cold scan's stats pruning so entry alignment can never diverge.
  bool read_chunk_column_index(const ColumnChunk& cc,
                               std::vector<uint8_t>& null_pages,
                               std::vector<std::string>& mins,
                               std::vector<std::string>& maxs,
                               std::vector<int64_t>& null_counts) const {
    if (!cc.column_index_offset || !cc.column_index_length ||
        *cc.column_index_length <= 0)
      return false;
    std::vector<uint8_t> buf(size_t(*cc.column_index_length));
    read_range(*cc.column_index_offset, *cc.column_index_length, buf.data());
    TReader r(buf.data(), buf.size());
    r.read_struct([&](const TReader::Field& f) {
      switch (f.id) {
        case 1: {
          auto lh = r.list();
          for (int32_t i = 0; i < lh.count; i++)
            null_pages.push_back(r.vbool_elem() ? 1 : 0);
          return true;
        }
        case 2: {
          auto lh = r.list();
          for (int32_t i = 0; i < lh.count; i++) mins.push_back(r.vstring());
          return true;
        }
        case 3: {
          auto lh = r.list();
          for (int32_t i = 0; i < lh.count; i++) maxs.push_back(r.vstring());
          return true;
        }
        case 5: {
          auto lh = r.list();
          for (int32_t i = 0; i < lh.count; i++)
            null_counts.push_back(r.vi64());
          return true;
        }
        default:
          return false;
      }
    });
    return !mins.empty() || !null_pages.empty();
  }

  // Lean ColumnIndex read: ONLY the null_counts list (field 5).  The
  // min/max binary lists are length-walked by the generic field skip
  // without materializing any std::string — the cold scan uses this to
  // replace per-page def-level RLE parses on flat columns (null_count
  // gives the participating-value total directly).
  bool read_chunk_null_counts(const ColumnChunk& cc,
                              std::vector<int64_t>& null_counts) const {
    if (!cc.column_index_offset || !cc.column_index_length ||
        *cc.column_index_length <= 0)
      return false;
    std::vector<uint8_t> buf(size_t(*cc.column_index_length));
    read_range(*cc.column_index_offset, *cc.column_index_length, buf.data());
    TReader r(buf.data(), buf.size());
    r.read_struct([&](const TReader::Field& f) {
      if (f.id == 5) {
        auto lh = r.list();
        null_counts.reserve(size_t(lh.count));
        for (int32_t i = 0; i < lh.count; i++)
          null_counts.push_back(r.vi64());
        return true;
      }
      return false;
    });
    return !null_counts.empty();
  }

  // The structural pre-scan: pack one column across row groups [rg0, rg1)
  // into a device-ready SoA batch.  `align` pads trailing dims; when
  // `pad_strings` > 0, BYTE_ARRAY values/dictionaries are additionally packed
  // into fixed-pitch char matrices for the scan kernels.  `flags` selects
  // optional outputs (combine PrescanFlags bits).  `payload_align` (when > 0)
  // overrides `align` for the payload pitch so independent per-row-group
  // prescans of the same file land on ONE compiled device shape (the
  // streaming cold path's shape-bucketing knob).
  // row_lo/row_hi (when >= 0) restrict the batch to data pages overlapping
  // [row_lo, row_hi) — the page-granular substrate of read_rows().
  std::unique_ptr<ArrayStore> prescan(int leaf_idx, int rg0, int rg1,
                                      int64_t align, int64_t pad_strings,
                                      int64_t flags,
                                      int64_t payload_align = 0,
                                      int64_t row_lo = -1,
                                      int64_t row_hi = -1) const;

  // Fused cold-path regex scan (see dpq_scan.hpp): per-data-page match /
  // value counts for one BYTE_ARRAY column, straight off the file mapping.
  // Page Index (ColumnIndex/OffsetIndex) stats per data page, aligned with
  // global page ids (see dpq_pageindex.hpp; engine extension — the
  // reference never reads the page-index region).
  std::unique_ptr<ArrayStore> page_stats(int leaf_idx) const;

  std::unique_ptr<ArrayStore> cold_scan(int leaf_idx, const ColdPattern& pat,
                                        int rg0, int rg1) const;

  // Fused chunked-index build (see dpq_index.hpp): header walk + emission +
  // boundary plan in ONE native pass — no intermediate emission arrays.
  std::unique_ptr<ArrayStore> index_build(int leaf_idx, int64_t num_rows,
                                          int64_t chunk_size) const;

 private:
  void pread_full(int64_t off, size_t len, uint8_t* out) const {
    ssize_t got = ::pread(fd_, out, len, off);
    if (got != ssize_t(len)) throw Error("short read");
  }

  void build_leaves() {
    leaves_.clear();
    if (meta_.schema.empty()) return;
    int col = 0;
    walk_schema(1, int(meta_.schema.size()), 0, 0, col);
  }

  // Depth-first walk of the flattened schema tree computing max def/rep
  // levels: OPTIONAL adds a def level, REPEATED adds both (reference:
  // src/reader/parquet_reader.cpp:495-543).
  void walk_schema(int idx, int end, int def, int rep, int& col,
                   int rep_def = 0,
                   std::vector<std::array<int32_t, 3>> nodes = {},
                   const std::string& prefix = "", int depth = 1) {
    while (idx < end) {
      const SchemaElement& e = meta_.schema[size_t(idx)];
      int d = def, r = rep, rd = rep_def;
      auto nd = nodes;
      const std::string path = prefix.empty() ? e.name : prefix + "." + e.name;
      if (e.repetition) {
        if (*e.repetition == R_OPTIONAL) {
          d++;
          nd.push_back({d, 0, depth});
        }
        if (*e.repetition == R_REPEATED) {
          d++;
          r++;
          rd = d;  // def level at this (innermost) repeated node
          nd.push_back({d, 1, depth});
        }
      }
      if (e.num_children && *e.num_children > 0) {
        int child_begin = idx + 1;
        int child_end = child_begin;
        for (int k = 0; k < *e.num_children && child_end < end; k++)
          child_end = subtree_end(child_end);
        walk_schema(child_begin, child_end, d, r, col, rd, nd, path,
                    depth + 1);
        idx = child_end;
      } else {
        Leaf lf;
        lf.name = e.name;
        lf.path = path;
        lf.type = e.type.value_or(T_BYTE_ARRAY);
        lf.chunk_idx = col++;
        lf.max_def = d;
        lf.max_rep = r;
        lf.rep_def = rd;
        lf.def_nodes = nd;
        lf.repetition = e.repetition;
        lf.converted = e.converted;
        lf.type_length = e.type_length;
        leaves_.push_back(std::move(lf));
        idx++;
      }
    }
  }

  int subtree_end(int idx) const {
    const SchemaElement& e = meta_.schema[size_t(idx)];
    int n = (e.num_children && *e.num_children > 0) ? *e.num_children : 0;
    idx++;
    for (int k = 0; k < n; k++) idx = subtree_end(idx);
    return idx;
  }

  // Walk every column chunk's page headers once.  Data pages (V1 and V2) get
  // sequential global ids in (row group, column, file order); dictionary
  // pages are recorded but unnumbered — identical numbering to the
  // reference's build_page_index (src/reader/parquet_reader.cpp:559-605).
  //
  // Chunk walks are independent, so they run on the thread pool over the
  // mmap'd file; a sequential merge then assigns gids/row_starts in the
  // reference's (row group, column, file order) — identical numbering, ~2x
  // faster open on this box.
  // Number of data pages in a chunk from its OffsetIndex LIST HEADER alone
  // (no page_locations are parsed); -1 when absent or non-canonical.
  int64_t offset_index_count(const ColumnChunk& cc) const {
    if (!cc.offset_index_offset) return -1;
    int64_t off = *cc.offset_index_offset;
    uint8_t tmp[16];
    int64_t len = std::min<int64_t>(16, int64_t(file_size_) - off);
    if (off < 0 || len < 2) return -1;
    const uint8_t* p = span_ptr(off, len);
    if (!p) {
      pread_full(off, size_t(len), tmp);
      p = tmp;
    }
    if (p[0] != 0x19) return -1;  // field 1, LIST (short form)
    uint8_t lh = p[1];
    if ((lh & 0x0F) != tc::STRUCT) return -1;
    int64_t n = lh >> 4;
    if (n < 15) return n;
    n = 0;  // long form: varint element count follows
    int sh = 0;
    for (const uint8_t* q = p + 2; q < p + len; q++) {
      n |= int64_t(*q & 0x7F) << sh;
      if (!(*q & 0x80)) return n;
      sh += 7;
      if (sh > 35) return -1;
    }
    return -1;
  }

  // Count-only header walk of one chunk (no PageRec vector): same stopping
  // rule and numbering predicate as build_page_index via parse_page_rec.
  int64_t count_data_pages_walk(const ColumnMeta& cm) const {
    int64_t start = cm.data_page_offset;
    if (cm.dictionary_page_offset)
      start = std::min(start, *cm.dictionary_page_offset);
    int64_t span = std::max<int64_t>(cm.total_compressed_size, 16);
    std::vector<uint8_t> fallback;
    const uint8_t* buf = span_ptr(start, span);
    if (!buf) {
      fallback.resize(size_t(span));
      read_range(start, span, fallback.data());
      buf = fallback.data();
    }
    int64_t off = 0, values_seen = 0, rows_before = 0, n = 0;
    PageRec rec;
    while (values_seen < cm.num_values) {
      if (off >= span) break;
      int64_t hsz = parse_page_rec(buf, off, span, start, 0, 0, rows_before,
                                   values_seen, rec);
      n += (rec.gid == 0);
      off += hsz + rec.size;
    }
    return n;
  }

  void build_page_index() {
    pages_.clear();
    data_gids_.clear();
    index_built_ = true;

    struct ChunkJob {
      int32_t rg, col;
      const ColumnMeta* cm;
      std::vector<PageRec> pages;
    };
    std::vector<ChunkJob> jobs;
    for (size_t rg = 0; rg < meta_.row_groups.size(); rg++) {
      const RowGroup& g = meta_.row_groups[rg];
      for (size_t c = 0; c < g.columns.size(); c++)
        if (g.columns[c].meta)
          jobs.push_back({int32_t(rg), int32_t(c), &*g.columns[c].meta, {}});
    }

    parallel_for(int(jobs.size()), [&](int j) {
      ChunkJob& job = jobs[size_t(j)];
      const ColumnMeta& cm = *job.cm;
      int64_t start = cm.data_page_offset;
      if (cm.dictionary_page_offset)
        start = std::min(start, *cm.dictionary_page_offset);
      int64_t span = std::max<int64_t>(cm.total_compressed_size, 16);

      std::vector<uint8_t> fallback;  // copy path when span leaves the file
      const uint8_t* buf = span_ptr(start, span);
      if (!buf) {
        fallback.resize(size_t(span));
        read_range(start, span, fallback.data());
        buf = fallback.data();
      }

      int64_t off = 0;
      int64_t values_seen = 0;
      int64_t rows_before = 0;
      while (values_seen < cm.num_values) {
        if (off >= span) break;  // short chunk span: stop like the reference
        PageRec rec;
        int64_t header_size = parse_page_rec(buf, off, span, start, job.rg,
                                             job.col, rows_before,
                                             values_seen, rec);
        job.pages.push_back(rec);
        off += header_size + rec.size;
      }
    });

    size_t total_pages = 0, total_gids = 0;
    for (const auto& job : jobs) {
      total_pages += job.pages.size();
      for (const PageRec& r : job.pages) total_gids += (r.gid >= 0);
    }
    pages_.reserve(total_pages);
    data_gids_.reserve(total_gids);
    int64_t gid = 0;
    for (auto& job : jobs) {
      for (PageRec& rec : job.pages) {
        if (rec.gid >= 0) {
          rec.gid = gid++;
          if (rec.kind == P_DATA || rec.kind == P_DATA_V2)
            rec.row_start += rg_row_base_[size_t(rec.rg)];
          data_gids_.push_back(int64_t(pages_.size()));
        }
        pages_.push_back(rec);
      }
    }
  }

  int fd_ = -1;
  const uint8_t* map_ = nullptr;
  size_t file_size_ = 0;
  FileMeta meta_;
  std::vector<Leaf> leaves_;
  std::vector<PageRec> pages_;       // all pages (incl. dictionary pages)
  std::vector<int64_t> data_gids_;   // indices into pages_ of numbered pages
  std::vector<int64_t> rg_row_base_;
  bool index_built_ = false;         // pages_/data_gids_ valid (lazy build)
  bool counts_built_ = false;        // chunk_counts_ valid (lazy)
  std::vector<int64_t> chunk_counts_;  // numbered pages per (rg, col)
  int64_t chunk_ncols_ = 0;            // row stride of chunk_counts_
};

// ── JSON helpers ────────────────────────────────────────────────────────────

inline void json_escape(std::ostringstream& os, const std::string& s) {
  os << '"';
  for (char ch : s) {
    switch (ch) {
      case '"': os << "\\\""; break;
      case '\\': os << "\\\\"; break;
      case '\n': os << "\\n"; break;
      case '\r': os << "\\r"; break;
      case '\t': os << "\\t"; break;
      default:
        if (uint8_t(ch) < 0x20) {
          char hex[8];
          std::snprintf(hex, sizeof hex, "\\u%04x", ch);
          os << hex;
        } else {
          os << ch;
        }
    }
  }
  os << '"';
}

inline std::string ArrayStore::manifest_json() const {
  std::ostringstream os;
  os << "{\"dims\":{";
  bool first = true;
  for (const auto& [k, v] : dims) {
    if (!first) os << ',';
    first = false;
    json_escape(os, k);
    os << ':' << v;
  }
  os << "},\"arrays\":{";
  first = true;
  for (const auto& [k, a] : arrays) {
    if (!first) os << ',';
    first = false;
    json_escape(os, k);
    os << ":{\"dtype\":" << a.dtype << ",\"shape\":[";
    for (size_t i = 0; i < a.shape.size(); i++) {
      if (i) os << ',';
      os << a.shape[i];
    }
    os << "]}";
  }
  os << "}}";
  return os.str();
}

inline std::string Reader::meta_json() const {
  std::ostringstream os;
  os << "{\"version\":" << meta_.version << ",\"num_rows\":" << meta_.num_rows
     << ",\"created_by\":";
  json_escape(os, meta_.created_by);
  os << ",\"file_size\":" << file_size_;

  os << ",\"schema\":[";
  for (size_t i = 0; i < meta_.schema.size(); i++) {
    const auto& e = meta_.schema[i];
    if (i) os << ',';
    os << "{\"name\":";
    json_escape(os, e.name);
    auto opt = [&os](const char* key, const std::optional<int32_t>& v) {
      if (v) os << ",\"" << key << "\":" << *v;
    };
    opt("type", e.type);
    opt("type_length", e.type_length);
    opt("repetition", e.repetition);
    opt("num_children", e.num_children);
    opt("converted", e.converted);
    opt("scale", e.scale);
    opt("precision", e.precision);
    opt("field_id", e.field_id);
    os << '}';
  }
  os << ']';

  os << ",\"columns\":[";
  for (size_t i = 0; i < leaves_.size(); i++) {
    const auto& lf = leaves_[i];
    if (i) os << ',';
    os << "{\"name\":";
    json_escape(os, lf.name);
    os << ",\"path\":";
    json_escape(os, lf.path);
    os << ",\"type\":" << lf.type << ",\"chunk_idx\":" << lf.chunk_idx
       << ",\"max_def\":" << lf.max_def << ",\"max_rep\":" << lf.max_rep
       << ",\"rep_def\":" << lf.rep_def;
    os << ",\"def_nodes\":[";
    for (size_t k = 0; k < lf.def_nodes.size(); k++) {
      if (k) os << ',';
      os << '[' << lf.def_nodes[k][0] << ',' << lf.def_nodes[k][1] << ','
         << lf.def_nodes[k][2] << ']';
    }
    os << ']';
    if (lf.repetition) os << ",\"repetition\":" << *lf.repetition;
    if (lf.converted) os << ",\"converted\":" << *lf.converted;
    if (lf.type_length) os << ",\"type_length\":" << *lf.type_length;
    os << '}';
  }
  os << ']';

  os << ",\"row_groups\":[";
  for (size_t g = 0; g < meta_.row_groups.size(); g++) {
    const auto& rg = meta_.row_groups[g];
    if (g) os << ',';
    os << "{\"num_rows\":" << rg.num_rows
       << ",\"total_byte_size\":" << rg.total_byte_size << ",\"columns\":[";
    for (size_t c = 0; c < rg.columns.size(); c++) {
      const auto& cc = rg.columns[c];
      if (c) os << ',';
      os << "{\"file_offset\":" << cc.file_offset;
      if (cc.meta) {
        const auto& m = *cc.meta;
        os << ",\"type\":" << m.type << ",\"codec\":" << m.codec
           << ",\"num_values\":" << m.num_values
           << ",\"total_uncompressed_size\":" << m.total_uncompressed_size
           << ",\"total_compressed_size\":" << m.total_compressed_size
           << ",\"data_page_offset\":" << m.data_page_offset;
        if (m.dictionary_page_offset)
          os << ",\"dictionary_page_offset\":" << *m.dictionary_page_offset;
        if (m.stats) {
          const auto& s = *m.stats;
          auto hex = [&os](const char* key, const std::string& v) {
            static const char* d = "0123456789abcdef";
            os << ",\"" << key << "\":\"";
            for (unsigned char b : v) os << d[b >> 4] << d[b & 15];
            os << '"';
          };
          os << ",\"stats\":{\"present\":true";
          if (s.null_count) os << ",\"null_count\":" << *s.null_count;
          if (s.distinct_count)
            os << ",\"distinct_count\":" << *s.distinct_count;
          if (s.min_value) hex("min_value", *s.min_value);
          if (s.max_value) hex("max_value", *s.max_value);
          if (s.min) hex("min", *s.min);
          if (s.max) hex("max", *s.max);
          os << '}';
        }
        os << ",\"encodings\":[";
        for (size_t k = 0; k < m.encodings.size(); k++) {
          if (k) os << ',';
          os << m.encodings[k];
        }
        os << "],\"path\":[";
        for (size_t k = 0; k < m.path.size(); k++) {
          if (k) os << ',';
          json_escape(os, m.path[k]);
        }
        os << ']';
      }
      os << '}';
    }
    os << "]}";
  }
  os << ']';

  os << ",\"kv\":[";
  for (size_t i = 0; i < meta_.kv.size(); i++) {
    if (i) os << ',';
    os << '[';
    json_escape(os, meta_.kv[i].key);
    os << ',';
    json_escape(os, meta_.kv[i].value);
    os << ']';
  }
  os << "]}";
  return os.str();
}

}  // namespace dpq
