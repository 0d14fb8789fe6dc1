// dpq_prescan.hpp — implementation of Reader::prescan: packs one column's
// pages (over a row-group range) into the fixed-layout SoA batch consumed by
// the device decode kernels.
//
// Batch contract (array names ↔ duckdb_parquet_parser_tpu/ops/*.py):
//   dims: n_pages vmax nn_cap def_rmax idx_rmax def_pad idx_pad plain_w
//         bool_pad dict_n nn_total chars_total dict_chars_total str_pitch
//         dict_pitch payload_pad type max_def max_rep def_bw
//   per page  : page_num_values page_nn page_kind page_def_bw page_idx_bw
//               page_def_nruns page_idx_nruns page_row_start page_gid page_rg
//               page_dict_base page_dict_size page_payload_len
//   run tables: {def,idx}_run_{kind,count,value,bitoff,vstart}  [n_pages, rmax]
//   byte data : def_bytes [n_pages, def_pad], idx_bytes [n_pages, idx_pad],
//               plain_fixed [n_pages, nn_cap*plain_w], bool_bits, dict_fixed
//   payload   : payload [n_pages, payload_pad] raw value-section bytes
//               (PS_PAYLOAD; feeds the fully device-side string kernels)
//   strings   : str_nn_start [n_pages+1], str_lens/str_offs [nn_total],
//               str_chars, str_padded [nn_total, str_pitch]  (PS_HOST_STRINGS)
//   dict      : dict_lens/dict_offs/dict_chars/dict_padded  (BYTE_ARRAY)
//
// Performance shape: every column chunk is read from disk ONCE; row groups
// are independent, so chunks pre-scan on a thread pool and a merge pass
// stitches the global dictionary/char bases.  Per-page work is O(run
// headers) + bulk memcpy; the per-value string-prefix walk runs only under
// PS_HOST_STRINGS — the scan pipeline uses PS_PAYLOAD and parses prefixes on
// the device instead.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdio>
#include <thread>

#include "dpq_delta.hpp"
#include "dpq_reader.hpp"
#include "dpq_codec.hpp"

namespace dpq {

inline std::unique_ptr<ArrayStore> Reader::prescan(int leaf_idx, int rg0,
                                                   int rg1, int64_t align,
                                                   int64_t pad_strings,
                                                   int64_t flags,
                                                   int64_t payload_align,
                                                   int64_t row_lo,
                                                   int64_t row_hi) const {
  ensure_page_index();  // prescan iterates the global page table
  if (leaf_idx < 0 || size_t(leaf_idx) >= leaves_.size())
    throw Error("leaf index out of range");
  const Leaf& lf = leaves_[size_t(leaf_idx)];
  const int n_rg = int(meta_.row_groups.size());
  if (rg0 < 0) rg0 = 0;
  if (rg1 < 0 || rg1 > n_rg) rg1 = n_rg;
  if (align <= 0) align = 1;

  // FLBA decodes through the fixed-width machinery at the declared
  // type_length (the reference reader rejects the type outright:
  // src/reader/column_reader.cpp:254-255)
  const int w = lf.type == T_FIXED_LEN_BYTE_ARRAY
                    ? lf.type_length.value_or(0)
                    : plain_width(lf.type);
  if (lf.type == T_FIXED_LEN_BYTE_ARRAY && w <= 0)
    throw Error("FIXED_LEN_BYTE_ARRAY column lacks a type_length");
  const bool is_bool = lf.type == T_BOOLEAN;
  const bool is_ba = lf.type == T_BYTE_ARRAY;
  const int def_bw = lf.max_def > 0 ? level_bit_width(lf.max_def) : 0;
  const bool want_payload = is_ba && (flags & PS_PAYLOAD);

  // Zero-copy string views (PS_STR_VIEWS): per-value (abs file offset, len)
  // tables pointing straight into the mmap — no chars copy.  Falls back to
  // the copying tables when padding is requested or any chunk leaves the
  // mapped file.
  bool want_views = is_ba && (flags & PS_STR_VIEWS) && pad_strings <= 0;
  if (want_views) {
    for (int rg = std::max(rg0, 0);
         rg < (rg1 < 0 ? int(meta_.row_groups.size()) : rg1); rg++) {
      const RowGroup& g = meta_.row_groups[size_t(rg)];
      if (size_t(lf.chunk_idx) >= g.columns.size() ||
          !g.columns[size_t(lf.chunk_idx)].meta) continue;
      const ColumnMeta& cm = *g.columns[size_t(lf.chunk_idx)].meta;
      int64_t start = cm.data_page_offset;
      if (cm.dictionary_page_offset)
        start = std::min(start, *cm.dictionary_page_offset);
      // compressed chunks and delta-coded strings decode into batch-owned
      // buffers, so views into the file mapping are impossible — fall back
      // to the copying tables
      bool synthesized = false;
      for (int32_t e : cm.encodings)
        synthesized |= (e == E_DELTA_LENGTH_BYTE_ARRAY ||
                        e == E_DELTA_BYTE_ARRAY);
      if (cm.codec != C_UNCOMPRESSED || synthesized ||
          !span_ptr(start, std::max<int64_t>(cm.total_compressed_size, 16))) {
        want_views = false;
        break;
      }
    }
  }
  // PS_STR_VIEWS supersedes PS_HOST_STRINGS when views are possible
  // (callers pass both to mean "views preferred, copying fallback")
  const bool want_strings =
      is_ba && !want_views && (flags & (PS_HOST_STRINGS | PS_STR_VIEWS));
  // PS_INDEX: emission stream for the chunked index — needs per-value
  // lengths only (no char copies, no offset tables)
  const bool want_index = (flags & PS_INDEX) != 0;
  if (want_index && !is_ba)
    throw Error("PS_INDEX requires a BYTE_ARRAY column");
  // Lean views-mode column reads parse string prefixes straight into the
  // final col arrays in the pack pass (no intermediate slens/soffs
  // vectors) — the walk skips building them for null-free plain pages
  const bool col_direct = is_ba && want_views && (flags & PS_COLUMN) &&
                          (flags & PS_RUNS_ONLY) && (flags & PS_COL_ONLY) &&
                          !want_index;

  // Per-page accumulators; value-section spans point into the owning row
  // group's chunk buffer, which lives in its RgResult until final packing.
  struct PageTmp {
    int32_t num_values, nn, kind, idx_bw;
    int64_t row_start, gid;
    int32_t rg, dict_base, dict_size;  // dict_base local to rg; fixed in merge
    // def/idx runs live in the owning RgResult's run_arena (one heap alloc
    // per ROW GROUP instead of per page — a per-page std::vector<Run>
    // measured ~150 ns/page of malloc churn, the bulk of the walk on 1 KB-
    // page columns); def_runs_p/idx_runs_p are fixed up after the walk.
    bool delta_raw = false;  // PS_DELTA_RAW: val_ptr/val_len = raw stream
    int32_t def_run_at = 0, def_nruns = 0;
    int32_t idx_run_at = 0, idx_nruns = 0;
    const Run* def_runs_p = nullptr;
    const Run* idx_runs_p = nullptr;
    const uint8_t* def_ptr = nullptr;
    int64_t def_len = 0;
    const uint8_t* rep_ptr = nullptr;  // nested columns (max_rep > 0)
    int64_t rep_len = 0;
    const uint8_t* val_ptr = nullptr;
    int64_t val_len = 0;
    std::vector<int32_t> slens;   // PS_HOST_STRINGS / PS_STR_VIEWS
    std::vector<int64_t> soffs;   // PS_STR_VIEWS: absolute file offsets
    int64_t schar_start = 0;      // local to rg; fixed in merge
    bool fused = false;           // col arrays written during the walk
  };
  struct RgResult {
    std::vector<PageTmp> pages;
    std::vector<uint8_t> dict_fixed;
    std::vector<int32_t> dict_lens;
    std::vector<int64_t> dict_offs;   // local char offsets
    std::vector<uint8_t> dict_chars;
    std::vector<uint8_t> str_chars;
    std::vector<uint8_t> chunk_buf;   // fallback copy when the chunk span
                                      // leaves the file (else spans point
                                      // straight into the mmap)
    std::vector<std::vector<uint8_t>> decomp;  // per-page Snappy buffers
                                               // (PageTmp spans point here)
    std::vector<Run> run_arena;  // all pages' def/idx runs, back to back
    int32_t dict_n = 0;
  };
  std::vector<RgResult> rg_results(size_t(std::max(rg1 - rg0, 0)));

  auto store = std::make_unique<ArrayStore>();

  // ── FUSED lean col read (single pass over the value bytes) ────────────────
  // col_direct on uncompressed flat chunks: the walk writes col_offs/
  // col_lens/col_valid/col_src straight off the value sections it is
  // already positioned on, so the ~payload-sized value stream moves through
  // DRAM ONCE (the separate pack pass re-read every value cache line cold —
  // it was the dominant read_column cost).  Output slots come from page
  // row_starts bounded by each row group's METADATA row slice (no OOB
  // write is possible); a post-walk consistency check (page accounting ==
  // metadata) keeps the generic pack as the overwrite-fallback on
  // malformed files.
  bool fused_col = col_direct && lf.max_rep == 0 && row_lo < 0 && row_hi < 0;
  for (int rg = rg0; fused_col && rg < rg1; rg++) {
    const RowGroup& g = meta_.row_groups[size_t(rg)];
    if (size_t(lf.chunk_idx) >= g.columns.size() ||
        !g.columns[size_t(lf.chunk_idx)].meta ||
        g.columns[size_t(lf.chunk_idx)].meta->codec != C_UNCOMPRESSED)
      fused_col = false;
  }
  const int64_t fused_base0 = rg_row_base_[size_t(rg0)];
  const int64_t fused_rows = rg_row_base_[size_t(rg1)] - fused_base0;
  int64_t* f_offs = nullptr;
  int32_t* f_lens = nullptr;
  uint8_t* f_valid = nullptr;
  uint8_t* f_src = nullptr;
  if (fused_col) {
    const int64_t tr = std::max<int64_t>(fused_rows, 1);
    f_valid = store->alloc<uint8_t>("col_valid", {tr});
    f_offs = store->alloc<int64_t>("col_offs", {tr});
    f_lens = store->alloc<int32_t>("col_lens", {tr});
    f_src = store->alloc<uint8_t>("col_src", {tr});
  }

  auto process_rg = [&](int rg, RgResult& out) {
    const RowGroup& g = meta_.row_groups[size_t(rg)];
    if (size_t(lf.chunk_idx) >= g.columns.size() ||
        !g.columns[size_t(lf.chunk_idx)].meta)
      throw Error("column chunk missing metadata");
    const ColumnMeta& cm = *g.columns[size_t(lf.chunk_idx)].meta;
    if (!codec_supported(cm.codec))
      throw Error(std::string("unsupported codec ") +
                  compression_name(cm.codec) + " (supported: " +
                  codec_supported_list() +
                  "; the reference rejects everything but UNCOMPRESSED)");
    const bool compressed = cm.codec != C_UNCOMPRESSED;

    int64_t chunk_start = cm.data_page_offset;
    if (cm.dictionary_page_offset)
      chunk_start = std::min(chunk_start, *cm.dictionary_page_offset);
    int64_t span = std::max<int64_t>(cm.total_compressed_size, 16);
    const uint8_t* chunk_ptr = span_ptr(chunk_start, span);  // mmap zero-copy
    if (!chunk_ptr) {  // chunk claims bytes beyond EOF: zero-filled copy path
      out.chunk_buf.resize(size_t(span));
      read_range(chunk_start, span, out.chunk_buf.data());
      chunk_ptr = out.chunk_buf.data();
    }
    auto page_bytes = [&](const PageRec& pr) -> const uint8_t* {
      int64_t off = pr.data_off - chunk_start;
      if (off < 0 || off + pr.size > span)
        throw Error("page outside chunk span");
      return chunk_ptr + off;
    };
    // (ptr, len) of the page's LOGICAL payload: the raw span, or the
    // batch-owned Snappy decode of it
    auto page_span = [&](const PageRec& pr)
        -> std::pair<const uint8_t*, size_t> {
      const uint8_t* raw = page_bytes(pr);
      if (!compressed) return {raw, size_t(pr.size)};
      out.decomp.emplace_back(size_t(std::max<int64_t>(pr.usize, 0)));
      auto& buf = out.decomp.back();
      codec_decompress(cm.codec, raw, size_t(pr.size), buf.data(), buf.size());
      return {buf.data(), buf.size()};
    };

    int32_t rg_dict_base = -1, rg_dict_size = 0;

    for (size_t pi = 0; pi < pages_.size(); pi++) {
      const PageRec& pr = pages_[pi];
      if (pr.rg != rg || pr.chunk_col != lf.chunk_idx) continue;

      // The walk is a latency chase over a couple of cold cache lines per
      // page (level sections); unlike a header walk, the page table already
      // knows every future offset — start the miss several pages early so
      // it overlaps this page's parse.
      if (pi + 6 < pages_.size()) {
        const PageRec& pf = pages_[pi + 6];
        if (pf.rg == rg && pf.chunk_col == lf.chunk_idx) {
          const int64_t poff = pf.data_off - chunk_start;
          if (poff >= 0 && poff + 128 <= span) {
            __builtin_prefetch(chunk_ptr + poff);
            __builtin_prefetch(chunk_ptr + poff + 64);
          }
        }
      }

      if (pr.kind == P_DICTIONARY) {
        // Dictionary values are PLAIN-encoded; BOOLEAN dictionaries use one
        // byte per value (reference: src/reader/column_reader.cpp:128-138).
        rg_dict_base = out.dict_n;
        rg_dict_size = pr.num_values;
        auto [dp_ptr, dp_len] = page_span(pr);
        Cursor cur(dp_ptr, dp_len);
        if (is_ba) {
          out.dict_lens.reserve(out.dict_lens.size() + size_t(pr.num_values));
          for (int32_t i = 0; i < pr.num_values; i++) {
            uint32_t len = cur.le<uint32_t>();
            const uint8_t* p = cur.bytes(len);
            out.dict_lens.push_back(int32_t(len));
            out.dict_offs.push_back(int64_t(out.dict_chars.size()));
            out.dict_chars.insert(out.dict_chars.end(), p, p + len);
          }
        } else if (is_bool) {
          for (int32_t i = 0; i < pr.num_values; i++)
            out.dict_fixed.push_back(cur.u8());
        } else if (w > 0) {
          const uint8_t* p = cur.bytes(size_t(pr.num_values) * size_t(w));
          out.dict_fixed.insert(out.dict_fixed.end(), p,
                                p + size_t(pr.num_values) * size_t(w));
        } else {
          throw Error("unsupported dictionary value type");
        }
        out.dict_n += pr.num_values;
        continue;
      }
      // V2 data pages (engine extension — the reference skips their header
      // and decodes nothing): [rep_levels][def_levels][values], level
      // sections stored uncompressed WITHOUT the u32 prefix (lengths come
      // from the header), and only the values section codec-compressed.
      const bool v2 = pr.kind == P_DATA_V2 && pr.num_values > 0;
      if (pr.kind != P_DATA && !v2) continue;
      // Row-bounded reads (read_rows): skip data pages entirely outside
      // [row_lo, row_hi); dictionary pages above are always kept.
      if (row_lo >= 0 && pr.row_start + pr.num_values <= row_lo) continue;
      if (row_hi >= 0 && pr.row_start >= row_hi) continue;

      PageTmp t{};
      t.num_values = pr.num_values;
      t.rg = pr.rg;
      t.row_start = pr.row_start;
      t.gid = pr.gid;
      t.dict_base = rg_dict_base;
      t.dict_size = rg_dict_size;

      const uint8_t* pg_ptr;
      size_t pg_len;
      if (!v2) {
        auto ps = page_span(pr);
        pg_ptr = ps.first;
        pg_len = ps.second;
      } else {
        const int64_t lvl = int64_t(pr.v2_rep_len) + int64_t(pr.v2_def_len);
        if (lvl < 0 || lvl > pr.size || lvl > pr.usize)
          throw Error("V2 page level sections exceed the page");
        const uint8_t* raw = page_bytes(pr);
        if (compressed && pr.v2_compressed) {
          out.decomp.emplace_back(size_t(pr.usize));
          auto& buf = out.decomp.back();
          if (lvl) std::memcpy(buf.data(), raw, size_t(lvl));
          codec_decompress(cm.codec, raw + lvl, size_t(pr.size - lvl),
                           buf.data() + lvl, size_t(pr.usize - lvl));
          pg_ptr = buf.data();
          pg_len = buf.size();
        } else {
          pg_ptr = raw;
          pg_len = size_t(pr.size);
        }
      }
      Cursor cur(pg_ptr, pg_len);

      if (v2) {
        t.rep_ptr = cur.bytes(size_t(pr.v2_rep_len));  // flat decode ignores
        t.rep_len = pr.v2_rep_len;                     // these; list
        if (lf.max_def > 0) {                          // reconstruction reads
                                                       // the rep_levels plane
          t.def_ptr = cur.bytes(size_t(pr.v2_def_len));
          t.def_len = pr.v2_def_len;
          t.def_run_at = int32_t(out.run_arena.size());
          rle_prescan(t.def_ptr, size_t(t.def_len), def_bw, t.num_values,
                      out.run_arena);
          t.def_nruns = int32_t(out.run_arena.size()) - t.def_run_at;
          t.nn = int32_t(count_matching(
              out.run_arena.data() + t.def_run_at, size_t(t.def_nruns),
              t.def_ptr, size_t(t.def_len), def_bw, lf.max_def));
        } else {
          cur.bytes(size_t(pr.v2_def_len));
          t.nn = t.num_values;
        }
      } else {
        // v1 level sections.  The spec layout is [rep][def]; the reference
        // reads def first (header comment in dpq_reader.hpp), which only
        // DIFFERS on max_rep > 0 pages — real nested files, where that
        // order misparses both sections (the reference emits garbage
        // there; docs/reference_bugs.md).  Spec order for nested columns,
        // identical byte consumption everywhere else.
        if (lf.max_rep > 0) {  // flat decode ignores these; list
          uint32_t rep_len = cur.le<uint32_t>();  // reconstruction reads the
          t.rep_ptr = cur.bytes(rep_len);         // rep_levels plane
          t.rep_len = rep_len;
        }
        if (lf.max_def > 0) {
          uint32_t def_len = cur.le<uint32_t>();
          t.def_ptr = cur.bytes(def_len);
          t.def_len = def_len;
          t.def_run_at = int32_t(out.run_arena.size());
          rle_prescan(t.def_ptr, def_len, def_bw, t.num_values,
                      out.run_arena);
          t.def_nruns = int32_t(out.run_arena.size()) - t.def_run_at;
          t.nn = int32_t(count_matching(
              out.run_arena.data() + t.def_run_at, size_t(t.def_nruns),
              t.def_ptr, def_len, def_bw, lf.max_def));
        } else {
          t.nn = t.num_values;
        }
      }

      const bool enc_dict =
          pr.encoding == E_PLAIN_DICTIONARY || pr.encoding == E_RLE_DICTIONARY;
      const bool enc_ok =
          enc_dict || pr.encoding == E_PLAIN ||
          (is_bool && pr.encoding == E_RLE) ||
          (is_ba && (pr.encoding == E_DELTA_LENGTH_BYTE_ARRAY ||
                     pr.encoding == E_DELTA_BYTE_ARRAY)) ||
          (!is_ba && !is_bool && w > 0 &&
           (pr.encoding == E_DELTA_BINARY_PACKED ||
            pr.encoding == E_BYTE_STREAM_SPLIT));
      if (!enc_ok)
        throw Error(std::string("unsupported value encoding ") +
                    std::to_string(pr.encoding));

      if (enc_dict) {
        t.kind = 1;
        t.idx_bw = cur.u8();
        t.val_len = int64_t(cur.left());
        t.val_ptr = cur.bytes(size_t(t.val_len));
        t.idx_run_at = int32_t(out.run_arena.size());
        rle_prescan(t.val_ptr, size_t(t.val_len), t.idx_bw, t.nn,
                    out.run_arena);
        t.idx_nruns = int32_t(out.run_arena.size()) - t.idx_run_at;
      } else if (is_bool && pr.encoding == E_RLE) {
        // RLE booleans (pyarrow's V2 default for BOOLEAN): u32-prefixed
        // hybrid runs of 1-bit values — expanded here to the bit-packed
        // PLAIN layout so every downstream path stays unchanged
        t.kind = 0;
        uint32_t rle_len = cur.le<uint32_t>();
        const uint8_t* rp = cur.bytes(rle_len);
        std::vector<Run> bruns;
        rle_prescan(rp, rle_len, 1, t.nn, bruns);
        out.decomp.emplace_back(size_t((t.nn + 7) / 8));
        auto& bits = out.decomp.back();
        expand_runs_to(bruns, rp, size_t(rle_len), 1,
                       [&](int32_t v, int32_t val) {
                         if (val && v >= 0 && v < t.nn)
                           bits[size_t(v >> 3)] |= uint8_t(1u << (v & 7));
                       });
        t.val_ptr = bits.data();
        t.val_len = int64_t(bits.size());
      } else if (is_bool) {
        t.kind = 0;
        t.val_len = int64_t((t.nn + 7) / 8);
        t.val_ptr = cur.bytes(size_t(t.val_len));
      } else if (is_ba) {
        t.kind = 0;
        if (pr.encoding == E_DELTA_LENGTH_BYTE_ARRAY ||
            pr.encoding == E_DELTA_BYTE_ARRAY) {
          // delta-coded strings re-serialize to the PLAIN u32-prefixed
          // layout once on host; downstream (payload matrices, string
          // tables, device kernels) is encoding-oblivious
          out.decomp.push_back(
              pr.encoding == E_DELTA_LENGTH_BYTE_ARRAY
                  ? delta_length_ba_to_plain(cur, t.nn)
                  : delta_ba_to_plain(cur, t.nn));
          const auto& buf = out.decomp.back();
          t.val_ptr = buf.data();
          t.val_len = int64_t(buf.size());
        } else {
          t.val_len = int64_t(cur.left());
          t.val_ptr = cur.bytes(size_t(t.val_len));
        }
        if (want_strings) {
          Cursor vc(t.val_ptr, size_t(t.val_len));
          t.schar_start = int64_t(out.str_chars.size());
          t.slens.reserve(size_t(t.nn));
          for (int32_t i = 0; i < t.nn; i++) {
            uint32_t len = vc.le<uint32_t>();
            const uint8_t* p = vc.bytes(len);
            t.slens.push_back(int32_t(len));
            out.str_chars.insert(out.str_chars.end(), p, p + len);
          }
        } else if (want_views) {
          if (col_direct) {
            // plain page in lean views mode (null-free OR sparse): the
            // prefixes parse straight into col_offs/col_lens — during THIS
            // walk when the fused single-pass preconditions hold (the
            // value bytes are hot right here), else in the pack pass (def
            // runs drive the slot mapping for pages with nulls either
            // way); the intermediate vectors are skipped entirely (bounds
            // still checked via the same Cursor)
            const int64_t fb = pr.row_start - fused_base0;
            const int64_t rg_lo = rg_row_base_[size_t(rg)] - fused_base0;
            const int64_t rg_hi = rg_row_base_[size_t(rg) + 1] - fused_base0;
            if (fused_col && pr.encoding == E_PLAIN && map_ &&
                t.val_ptr >= map_ &&
                t.val_ptr + t.val_len <= map_ + file_size_ && fb >= rg_lo &&
                fb + t.num_values <= rg_hi) {
              if (t.nn == t.num_values) {
                Cursor vc(t.val_ptr, size_t(t.val_len));
                for (int32_t v = 0; v < t.nn; v++) {
                  uint32_t len = vc.le<uint32_t>();
                  const uint8_t* p = vc.bytes(len);
                  f_offs[fb + v] = int64_t(p - map_);
                  f_lens[fb + v] = int32_t(len);
                }
                std::memset(f_valid + fb, 1, size_t(t.nn));
                // f_src stays 0 (mmap source); calloc'd
              } else {
                // specialized run walk (same consumption order as
                // expand_runs_to + lambda): RLE max_def runs parse
                // prefixes in an unbranched tight loop, RLE null runs
                // bulk-fill sentinels, literal runs (rare at low null
                // rates) take the per-value bit extract.
                Cursor vc(t.val_ptr, size_t(t.val_len));
                const Run* rr = out.run_arena.data() + t.def_run_at;
                for (int32_t ri = 0; ri < t.def_nruns; ri++) {
                  const Run& rn = rr[ri];
                  const int32_t v0 = rn.vstart;
                  if (v0 >= t.num_values) continue;
                  const int32_t cnt =
                      std::min(rn.count, t.num_values - v0);
                  if (rn.kind == 0 && rn.value == lf.max_def) {
                    for (int32_t i = 0; i < cnt; i++) {
                      uint32_t len = vc.le<uint32_t>();
                      const uint8_t* p = vc.bytes(len);
                      f_offs[fb + v0 + i] = int64_t(p - map_);
                      f_lens[fb + v0 + i] = int32_t(len);
                    }
                    std::memset(f_valid + fb + v0, 1, size_t(cnt));
                  } else if (rn.kind == 0) {
                    std::fill(f_lens + fb + v0, f_lens + fb + v0 + cnt,
                              -1);
                  } else {
                    for (int32_t i = 0; i < cnt; i++) {
                      const int32_t lvl = int32_t(bits_at(
                          t.def_ptr, size_t(t.def_len),
                          rn.bitoff + int64_t(i) * def_bw, def_bw));
                      if (lvl != lf.max_def) {
                        f_lens[fb + v0 + i] = -1;
                        continue;
                      }
                      uint32_t len = vc.le<uint32_t>();
                      const uint8_t* p = vc.bytes(len);
                      f_offs[fb + v0 + i] = int64_t(p - map_);
                      f_lens[fb + v0 + i] = int32_t(len);
                      f_valid[fb + v0 + i] = 1;
                    }
                  }
                }
              }
              t.fused = true;
            }
          } else {
            Cursor vc(t.val_ptr, size_t(t.val_len));
            t.slens.reserve(size_t(t.nn));
            t.soffs.reserve(size_t(t.nn));
            for (int32_t i = 0; i < t.nn; i++) {
              uint32_t len = vc.le<uint32_t>();
              const uint8_t* p = vc.bytes(len);
              t.slens.push_back(int32_t(len));
              t.soffs.push_back(int64_t(p - map_));
            }
          }
        } else if (want_index) {
          // lengths only: the index emission needs no chars/offsets
          Cursor vc(t.val_ptr, size_t(t.val_len));
          t.slens.reserve(size_t(t.nn));
          for (int32_t i = 0; i < t.nn; i++) {
            uint32_t len = vc.le<uint32_t>();
            vc.bytes(len);
            t.slens.push_back(int32_t(len));
          }
        }
      } else if (w > 0 && pr.encoding == E_DELTA_BINARY_PACKED &&
                 (flags & PS_DELTA_RAW)) {
        if (lf.type != T_INT32 && lf.type != T_INT64)
          throw Error("DELTA_BINARY_PACKED on a non-integer column");
        // device route: keep the RAW stream; structure planes are emitted
        // in the pack pass and the bit-unpack + prefix sum run on device
        t.kind = 0;
        t.delta_raw = true;
        t.val_len = int64_t(cur.left());
        t.val_ptr = cur.bytes(size_t(t.val_len));
      } else if (w > 0 && pr.encoding == E_DELTA_BINARY_PACKED) {
        if (lf.type != T_INT32 && lf.type != T_INT64)
          throw Error("DELTA_BINARY_PACKED on a non-integer column");
        t.kind = 0;
        auto vals = delta_binary_values(cur, t.nn);
        out.decomp.emplace_back(size_t(t.nn) * size_t(w));
        auto& buf = out.decomp.back();
        for (int64_t i = 0; i < t.nn; i++)
          std::memcpy(buf.data() + i * w, &vals[size_t(i)], size_t(w));
        t.val_ptr = buf.data();
        t.val_len = int64_t(buf.size());
      } else if (w > 0 && pr.encoding == E_BYTE_STREAM_SPLIT) {
        t.kind = 0;
        out.decomp.push_back(
            byte_stream_split_to_plain(cur.head(), cur.left(), t.nn, w));
        const auto& buf = out.decomp.back();
        t.val_ptr = buf.data();
        t.val_len = int64_t(buf.size());
      } else if (w > 0) {
        t.kind = 0;
        t.val_len = int64_t(t.nn) * w;
        t.val_ptr = cur.bytes(size_t(t.val_len));
      } else {
        throw Error(std::string("unsupported plain type: ") +
                    physical_type_name(lf.type));
      }

      out.pages.push_back(std::move(t));
    }
  };

  const bool timing = std::getenv("DPQ_PRESCAN_TIMING") != nullptr;
  auto t_now = [] { return std::chrono::steady_clock::now(); };
  auto t_ms = [](auto a, auto b) {
    return std::chrono::duration<double, std::milli>(b - a).count();
  };
  auto t0 = t_now();

  // thread pool over row groups
  parallel_for(rg1 - rg0,
               [&](int j) { process_rg(rg0 + j, rg_results[size_t(j)]); });

  auto t1 = t_now();
  if (timing)
    std::fprintf(stderr, "[prescan] rg walk: %.1f ms\n", t_ms(t0, t1));

  // ── merge: global bases for dictionaries and string chars ─────────────────
  std::vector<const PageTmp*> tmp;
  std::vector<int32_t> page_dict_base_fix;   // per tmp entry, global base
  std::vector<int64_t> page_schar_fix;       // per tmp entry, global start
  int32_t dict_n = 0;
  int64_t dict_chars_total = 0, str_chars_total = 0;
  for (auto& res : rg_results) {
    for (auto& t : res.pages) {
      // run_arena is final now (the walk is done): resolve span pointers
      t.def_runs_p = res.run_arena.data() + t.def_run_at;
      t.idx_runs_p = res.run_arena.data() + t.idx_run_at;
      tmp.push_back(&t);
      page_dict_base_fix.push_back(t.dict_base >= 0 ? t.dict_base + dict_n : -1);
      page_schar_fix.push_back(t.schar_start + str_chars_total);
    }
    dict_n += res.dict_n;
    dict_chars_total += int64_t(res.dict_chars.size());
    str_chars_total += int64_t(res.str_chars.size());
  }

  // ── dims ──────────────────────────────────────────────────────────────────
  const int64_t N = int64_t(tmp.size());
  int64_t vmax = 1, nn_cap = 1, def_rmax = 1, idx_rmax = 1;
  int64_t def_pad = 0, idx_pad = 0, payload_max = 0;
  int64_t nn_total = 0, max_slen = 0, max_dlen = 0;
  for (const PageTmp* tp : tmp) {
    const PageTmp& t = *tp;
    vmax = std::max<int64_t>(vmax, t.num_values);
    nn_cap = std::max<int64_t>(nn_cap, t.nn);
    def_rmax = std::max<int64_t>(def_rmax, int64_t(t.def_nruns));
    idx_rmax = std::max<int64_t>(idx_rmax, int64_t(t.idx_nruns));
    def_pad = std::max<int64_t>(def_pad, t.def_len);
    if (t.kind == 1) idx_pad = std::max<int64_t>(idx_pad, t.val_len);
    payload_max = std::max<int64_t>(payload_max, t.val_len);
    nn_total += int64_t(t.slens.size());
    for (int32_t l : t.slens) max_slen = std::max<int64_t>(max_slen, l);
  }
  for (const auto& res : rg_results)
    for (int32_t l : res.dict_lens) max_dlen = std::max<int64_t>(max_dlen, l);
  // DELTA_BINARY_PACKED structure planes (PS_DELTA_RAW): uniform miniblock
  // geometry across pages, capacity = max miniblocks per page (deltas cover
  // values [1, nn), so a page needs ceil((nn-1)/mb_values) miniblocks)
  int64_t delta_mb_values = 0, delta_mb_cap = 0, n_delta = 0;
  for (const auto& tp : tmp) {
    const PageTmp& t = *tp;
    if (!t.delta_raw) continue;
    n_delta++;
    Cursor hc(t.val_ptr, size_t(t.val_len));
    const uint64_t bs = hc.uleb();
    const uint64_t mbs = hc.uleb();
    if (bs == 0 || mbs == 0 || bs % mbs != 0)
      throw Error("delta: bad block geometry");
    const int64_t mv = int64_t(bs / mbs);
    if (mv % 8 != 0 || mv > (1 << 20))
      throw Error("delta: bad miniblock size");
    if (delta_mb_values == 0) delta_mb_values = mv;
    else if (delta_mb_values != mv)
      throw Error("delta: mixed miniblock geometries (host decode fallback)");
    const int64_t need = std::max<int64_t>(t.nn - 1, 0);
    delta_mb_cap = std::max<int64_t>(delta_mb_cap, (need + mv - 1) / mv);
  }
  if (n_delta > 0 && n_delta != int64_t(tmp.size()))
    throw Error("delta: mixed delta/plain pages (host decode fallback)");
  const bool all_delta = n_delta > 0;
  const int64_t delta_pitch = all_delta ? delta_mb_values * 8 : 0;  // bw<=64
  vmax = round_up(vmax, 8);
  nn_cap = round_up(nn_cap, 8);
  def_pad = round_up(std::max<int64_t>(def_pad, 4) + 4, align);  // +4 slack so
  idx_pad = round_up(std::max<int64_t>(idx_pad, 4) + 4, align);  // 4B windows
  const int64_t bool_pad = is_bool ? round_up((nn_cap + 7) / 8, align) : 0;
  // +260 slack: the device extraction kernels read fixed windows (up to 256
  // bytes) starting at any value offset
  const int64_t payload_pad =
      want_payload
          ? round_up(payload_max + 260, payload_align > 0 ? payload_align : align)
          : 0;

  auto& dims = store->dims;
  dims["n_pages"] = N;
  dims["vmax"] = vmax;
  dims["nn_cap"] = nn_cap;
  dims["def_rmax"] = def_rmax;
  dims["idx_rmax"] = idx_rmax;
  dims["def_pad"] = def_pad;
  dims["idx_pad"] = idx_pad;
  dims["plain_w"] = w;
  dims["bool_pad"] = bool_pad;
  dims["dict_n"] = dict_n;
  dims["nn_total"] = nn_total;
  dims["chars_total"] = str_chars_total;
  dims["dict_chars_total"] = dict_chars_total;
  dims["payload_pad"] = payload_pad;
  dims["type"] = lf.type;
  dims["max_def"] = lf.max_def;
  dims["max_rep"] = lf.max_rep;
  dims["def_bw"] = def_bw;
  if (all_delta) {
    dims["delta_mb_values"] = delta_mb_values;
    dims["delta_mb_cap"] = std::max<int64_t>(delta_mb_cap, 1);
    dims["delta_pitch"] = delta_pitch;
  }

  const int64_t str_pitch =
      (want_strings && pad_strings > 0)
          ? round_up(std::max<int64_t>(max_slen, 1), pad_strings)
          : 0;
  const int64_t dict_pitch =
      (is_ba && pad_strings > 0)
          ? round_up(std::max<int64_t>(max_dlen, 1), pad_strings)
          : 0;
  dims["str_pitch"] = str_pitch;
  dims["dict_pitch"] = dict_pitch;

  auto t2 = t_now();
  if (timing)
    std::fprintf(stderr, "[prescan] dims/alloc prep: %.1f ms\n", t_ms(t1, t2));

  // ── per-page scalars ──────────────────────────────────────────────────────
  auto* p_nv = store->alloc<int32_t>("page_num_values", {N});
  auto* p_nn = store->alloc<int32_t>("page_nn", {N});
  auto* p_kind = store->alloc<int32_t>("page_kind", {N});
  auto* p_dbw = store->alloc<int32_t>("page_def_bw", {N});
  auto* p_ibw = store->alloc<int32_t>("page_idx_bw", {N});
  auto* p_dnr = store->alloc<int32_t>("page_def_nruns", {N});
  auto* p_inr = store->alloc<int32_t>("page_idx_nruns", {N});
  auto* p_row = store->alloc<int64_t>("page_row_start", {N});
  auto* p_gid = store->alloc<int64_t>("page_gid", {N});
  auto* p_rg = store->alloc<int32_t>("page_rg", {N});
  auto* p_db = store->alloc<int32_t>("page_dict_base", {N});
  auto* p_ds = store->alloc<int32_t>("page_dict_size", {N});
  auto* p_pl = store->alloc<int32_t>("page_payload_len", {N});

  // HOST-ONLY batches (lean column reads / index emission: PS_RUNS_ONLY
  // plus PS_COL_ONLY or PS_INDEX, no payload) never reach the device —
  // skip every device-only plane: the run descriptor tables, the level /
  // index byte planes, and the plain/bool payload copies.  Fallback
  // consumers re-prescan without the lean flags (host/reader._decode_leaf).
  const bool host_only =
      (flags & PS_RUNS_ONLY) &&
      ((flags & PS_COL_ONLY) || want_index) && !want_payload;

  struct RunPtrs {
    int32_t *kind = nullptr, *count = nullptr, *value = nullptr,
            *bitoff = nullptr, *vstart = nullptr;
  };
  auto alloc_runs = [&](const char* prefix, int64_t rmax) {
    RunPtrs p;
    std::string pre(prefix);
    p.kind = store->alloc<int32_t>(pre + "_run_kind", {N, rmax});
    p.count = store->alloc<int32_t>(pre + "_run_count", {N, rmax});
    p.value = store->alloc<int32_t>(pre + "_run_value", {N, rmax});
    p.bitoff = store->alloc<int32_t>(pre + "_run_bitoff", {N, rmax});
    p.vstart = store->alloc<int32_t>(pre + "_run_vstart", {N, rmax});
    return p;
  };
  RunPtrs dr, ir;
  uint8_t* a_def = nullptr;
  uint8_t* a_idx = nullptr;
  if (!host_only) {
    dr = alloc_runs("def", def_rmax);
    ir = alloc_runs("idx", idx_rmax);
    a_def = store->alloc<uint8_t>("def_bytes", {N, def_pad});
    a_idx = store->alloc<uint8_t>("idx_bytes", {N, idx_pad});
  }
  // Materialized planes (unless PS_RUNS_ONLY): definition levels per value
  // position and dictionary indices in VALUE SPACE (index of the value at
  // each row position, -1 at nulls — so the device needs neither run
  // expansion nor the null-rank mapping on the hot decode path; the run
  // tables stay for the fallback).
  const bool materialize = !(flags & PS_RUNS_ONLY);
  uint8_t* a_deflev = nullptr;
  int32_t* a_idxv = nullptr;
  bool any_dict_pages = false;
  for (const PageTmp* tp : tmp)
    if (tp->kind == 1) any_dict_pages = true;
  if (materialize && lf.max_def > 0)
    a_deflev = store->alloc<uint8_t>("def_levels", {N, vmax});
  // nested columns: materialized repetition levels, only when the caller
  // asked (list reconstruction — host/reader.py::read_list_column; scan and
  // flat-decode paths never read them, so they skip the N*vmax plane)
  uint8_t* a_replev = nullptr;
  const int rep_bw = lf.max_rep > 0 ? level_bit_width(lf.max_rep) : 0;
  if (lf.max_rep > 0 && (flags & PS_REP_LEVELS))
    a_replev = store->alloc<uint8_t>("rep_levels", {N, vmax});
  if (materialize && any_dict_pages) {
    a_idxv = store->alloc<int32_t>("idx_vals", {N, vmax});
    std::memset(a_idxv, 0xFF, size_t(N) * size_t(vmax) * sizeof(int32_t));
  }
  uint8_t* a_plain = nullptr;
  if (w > 0 && !host_only && !all_delta)
    a_plain = store->alloc<uint8_t>("plain_fixed", {N, nn_cap * w});
  int32_t* d_bw = nullptr;
  int32_t* d_mdl = nullptr;
  int32_t* d_mdh = nullptr;
  int32_t* d_cnt = nullptr;
  int32_t* d_dfl = nullptr;
  int32_t* d_dfh = nullptr;
  uint8_t* d_bytes = nullptr;
  const int64_t dmbc = std::max<int64_t>(delta_mb_cap, 1);
  if (all_delta) {
    d_bw = store->alloc<int32_t>("delta_bw", {N, dmbc});
    d_mdl = store->alloc<int32_t>("delta_md_lo", {N, dmbc});
    d_mdh = store->alloc<int32_t>("delta_md_hi", {N, dmbc});
    d_cnt = store->alloc<int32_t>("delta_cnt", {N, dmbc});
    d_dfl = store->alloc<int32_t>("delta_first_lo", {N});
    d_dfh = store->alloc<int32_t>("delta_first_hi", {N});
    d_bytes = store->alloc<uint8_t>("delta_bytes", {N, dmbc * delta_pitch});
  }
  uint8_t* a_bits = nullptr;
  if (is_bool && !host_only)
    a_bits = store->alloc<uint8_t>("bool_bits", {N, bool_pad});
  uint8_t* a_payload = nullptr;
  if (want_payload) a_payload = store->alloc<uint8_t>("payload", {N, payload_pad});

  // ── fully-materialized read_column arrays (PS_COLUMN) ─────────────────────
  // The pack pass below already walks every page with its bytes cache-hot;
  // emitting the final per-ROW decoded arrays there costs one more
  // O(values) sweep in C++ and removes the whole numpy assembly from
  // read_column (reference loop replaced: src/reader/column_reader.cpp:18-71
  // via src/reader/parquet_reader.cpp:133-165).
  // BYTE_ARRAY offsets point into the file mapping (views mode) or into the
  // batch-owned str_chars copy (compressed / padded chunks) — the
  // col_chars_owned dim tells the Python wrapper which chars source to pass.
  const bool want_column =
      (flags & PS_COLUMN) &&
      (w > 0 || is_bool || (is_ba && (want_views || want_strings)));
  int64_t total_rows = 0;
  std::vector<int64_t> row0(tmp.size(), 0);
  for (size_t i = 0; i < tmp.size(); i++) {
    row0[i] = total_rows;
    total_rows += tmp[i]->num_values;
  }
  // fused-walk consistency: the metadata row accounting the walk's direct
  // writes assumed must match the actual page accounting — else the
  // direct writes are DISCARDED (the generic pack below overwrites them;
  // the col arrays realloc at the actual size).  Malformed-file path only.
  bool fused_ok = fused_col;
  if (fused_col) {
    if (total_rows != fused_rows) fused_ok = false;
    for (size_t i = 0; fused_ok && i < tmp.size(); i++)
      if (tmp[i]->fused && tmp[i]->row_start - fused_base0 != row0[i])
        fused_ok = false;
  }
  std::vector<int64_t> rg_char_base(rg_results.size() + 1, 0);
  for (size_t r = 0; r < rg_results.size(); r++)
    rg_char_base[r + 1] = rg_char_base[r] + int64_t(rg_results[r].dict_chars.size());

  uint8_t* col_valid = nullptr;
  uint8_t* col_values = nullptr;
  int64_t* col_offs = nullptr;
  int32_t* col_lens = nullptr;
  uint8_t* col_src = nullptr;
  const int col_w = is_bool ? 1 : w;
  if (want_column) {
    dims["col_mat"] = 1;
    dims["col_chars_owned"] = (is_ba && !want_views) ? 1 : 0;
    dims["total_rows"] = total_rows;
    const int64_t tr = std::max<int64_t>(total_rows, 1);
    if (fused_col && fused_ok) {
      // the walk already owns correctly-sized arrays (fused_rows ==
      // total_rows here) with fused pages written
      col_valid = f_valid;
      col_offs = f_offs;
      col_lens = f_lens;
      col_src = f_src;
    } else {
      if (fused_col)  // inconsistent accounting: drop the walk's arrays
        for (const char* nm : {"col_valid", "col_offs", "col_lens",
                               "col_src"})
          store->arrays.erase(nm);
      col_valid = store->alloc<uint8_t>("col_valid", {tr});
      if (is_ba) {
        col_offs = store->alloc<int64_t>("col_offs", {tr});
        // -1 = NULL sentinel in col_lens: filled PER PAGE inside the
        // parallel pack pass (generic pages only — the direct branches
        // write every slot), not as an eager single-threaded memset here
        col_lens = store->alloc<int32_t>("col_lens", {tr});
        col_src = store->alloc<uint8_t>("col_src", {tr});
      } else {
        col_values = store->alloc<uint8_t>("col_values", {tr, col_w});
      }
    }
  }

  // ── chunked-index emission stream (PS_INDEX) ──────────────────────────────
  // One slot per non-null value, page-contiguous (pages write disjoint
  // [emit_base[i], emit_base[i]+nn) ranges in the parallel pack pass); len -1
  // marks dropped OOB dictionary indices (reference drops them silently,
  // src/reader/parquet_reader.cpp:436-439) — dpq_index_plan skips them.
  int64_t* idx_pos = nullptr;
  int32_t* idx_len = nullptr;
  std::vector<int64_t> emit_base;
  if (want_index) {
    int64_t idx_cap = 0;
    emit_base.resize(tmp.size());
    for (size_t i = 0; i < tmp.size(); i++) {
      emit_base[i] = idx_cap;
      idx_cap += std::max(tmp[i]->nn, 0);
    }
    dims["idx_cap"] = idx_cap;
    dims["total_rows"] = total_rows;
    const int64_t ic = std::max<int64_t>(idx_cap, 1);
    idx_pos = store->alloc<int64_t>("idx_emit_pos", {ic});
    // -1 = dropped-slot sentinel: filled per page in the pack pass (generic
    // pages only), same as col_lens above
    idx_len = store->alloc<int32_t>("idx_emit_len", {ic});
  }

  // Pack pass: each page writes a disjoint row of every plane, so split the
  // page range across the pool (the pass is fault+memcpy bound — ~2x on this
  // box; first-touch of the calloc'd planes happens here).
  const int64_t PACK_BLOCK = 8192;
  const int n_blocks = int((N + PACK_BLOCK - 1) / PACK_BLOCK);
  parallel_for(n_blocks, [&](int blk) {
  const int64_t i_lo = int64_t(blk) * PACK_BLOCK;
  const int64_t i_hi = std::min(N, i_lo + PACK_BLOCK);
  std::vector<int32_t> idx_scratch;  // per-block dict-index expansion
  std::vector<Run> rep_scratch;      // per-block rep-level run prescan
  for (int64_t i = i_lo; i < i_hi; i++) {
    const PageTmp& t = *tmp[size_t(i)];
    p_nv[i] = t.num_values;
    p_nn[i] = t.nn;
    p_kind[i] = t.kind;
    p_dbw[i] = lf.max_def > 0 ? def_bw : 0;
    p_ibw[i] = t.idx_bw;
    p_dnr[i] = t.def_nruns;
    p_inr[i] = t.idx_nruns;
    p_row[i] = t.row_start;
    p_gid[i] = t.gid;
    p_rg[i] = t.rg;
    p_db[i] = page_dict_base_fix[size_t(i)];
    p_ds[i] = t.dict_size;
    p_pl[i] = int32_t(t.val_len);

    if (dr.kind) {
      for (size_t r = 0; r < size_t(t.def_nruns); r++) {
        const Run& rn = t.def_runs_p[r];
        int64_t k = i * def_rmax + int64_t(r);
        dr.kind[k] = rn.kind;
        dr.count[k] = rn.count;
        dr.value[k] = rn.value;
        dr.bitoff[k] = rn.bitoff;
        dr.vstart[k] = rn.vstart;
      }
      for (size_t r = 0; r < size_t(t.idx_nruns); r++) {
        const Run& rn = t.idx_runs_p[r];
        int64_t k = i * idx_rmax + int64_t(r);
        ir.kind[k] = rn.kind;
        ir.count[k] = rn.count;
        ir.value[k] = rn.value;
        ir.bitoff[k] = rn.bitoff;
        ir.vstart[k] = rn.vstart;
      }
    }
    if (a_def && t.def_len)
      std::memcpy(a_def + i * def_pad, t.def_ptr, size_t(t.def_len));
    if (a_idx && t.kind == 1 && t.val_len)
      std::memcpy(a_idx + i * idx_pad, t.val_ptr, size_t(t.val_len));
    if (a_deflev && t.def_len) {
      uint8_t* row = a_deflev + i * vmax;
      expand_runs_to(t.def_runs_p, size_t(t.def_nruns), t.def_ptr,
                     size_t(t.def_len), def_bw,
                     [&](int32_t v, int32_t val) {
                       if (v >= 0 && v < vmax) row[v] = uint8_t(val);
                     });
    }
    if (a_replev && t.rep_len) {
      uint8_t* row = a_replev + i * vmax;
      rep_scratch.clear();
      rle_prescan(t.rep_ptr, size_t(t.rep_len), rep_bw, t.num_values,
                  rep_scratch);
      expand_runs_to(rep_scratch, t.rep_ptr, size_t(t.rep_len), rep_bw,
                     [&](int32_t v, int32_t val) {
                       if (v >= 0 && v < vmax) row[v] = uint8_t(val);
                     });
    }
    if (a_idxv && t.kind == 1) {
      // value-space indices: walk def levels and place each rank-k index at
      // its row position (nulls keep the -1 fill)
      int32_t* row = a_idxv + i * vmax;
      idx_scratch.assign(size_t(std::max(t.nn, 0)), 0);
      expand_runs_to(t.idx_runs_p, size_t(t.idx_nruns), t.val_ptr,
                     size_t(t.val_len), t.idx_bw,
                     [&](int32_t v, int32_t val) {
                       if (v >= 0 && v < t.nn) idx_scratch[size_t(v)] = val;
                     });
      if (lf.max_def > 0) {
        int32_t k = 0;
        expand_runs_to(t.def_runs_p, size_t(t.def_nruns), t.def_ptr,
                     size_t(t.def_len), def_bw,
                       [&](int32_t v, int32_t lvl) {
                         if (lvl == lf.max_def && v < t.num_values &&
                             k < t.nn) {
                           if (v < vmax) row[v] = idx_scratch[size_t(k)];
                           k++;
                         }
                       });
      } else {
        for (int32_t v = 0; v < t.num_values && v < t.nn; v++)
          if (v < vmax) row[v] = idx_scratch[size_t(v)];
      }
    }
    if (a_plain && t.kind == 0 && !is_ba && !is_bool && !t.delta_raw &&
        t.val_len)
      std::memcpy(a_plain + i * nn_cap * w, t.val_ptr, size_t(t.val_len));
    if (d_bytes && t.delta_raw) {
      Cursor dc(t.val_ptr, size_t(t.val_len));
      const uint64_t bs = dc.uleb();
      const uint64_t mbs = dc.uleb();
      dc.uleb();  // total (the stream may carry more than nn)
      const uint64_t first = uint64_t(dc.zigzag());
      d_dfl[i] = int32_t(uint32_t(first));
      d_dfh[i] = int32_t(uint32_t(first >> 32));
      const int64_t mv = int64_t(bs / mbs);
      int64_t need = std::max<int64_t>(t.nn - 1, 0);
      int64_t mb_at = 0;
      while (need > 0) {
        const uint64_t md = uint64_t(dc.zigzag());
        const uint8_t* bws = dc.bytes(size_t(mbs));
        for (uint64_t m = 0; m < mbs && need > 0; m++) {
          const int bw = bws[m];
          if (bw > 64) throw Error("delta: bit width > 64");
          const size_t sec = size_t(mv) * size_t(bw) / 8;
          const uint8_t* db = dc.bytes(sec);
          if (mb_at >= dmbc) throw Error("delta: miniblock overflow");
          const int64_t k = i * dmbc + mb_at;
          d_bw[k] = bw;
          d_mdl[k] = int32_t(uint32_t(md));
          d_mdh[k] = int32_t(uint32_t(md >> 32));
          const int64_t cnt = std::min<int64_t>(need, mv);
          d_cnt[k] = int32_t(cnt);
          if (sec) std::memcpy(d_bytes + k * delta_pitch, db, sec);
          mb_at++;
          need -= cnt;
        }
      }
    }
    if (a_bits && t.kind == 0 && t.val_len)
      std::memcpy(a_bits + i * bool_pad, t.val_ptr, size_t(t.val_len));
    if (a_payload && t.kind == 0 && t.val_len)
      std::memcpy(a_payload + i * payload_pad, t.val_ptr, size_t(t.val_len));

    if (want_column || want_index) {
      const size_t rg_local = size_t(t.rg - rg0);
      const RgResult& rgres = rg_results[rg_local];
      const int64_t base = row0[size_t(i)];
      const int64_t ebase = want_index ? emit_base[size_t(i)] : 0;
      // fused pages: the walk already wrote this page's col slots (and
      // fused mode excludes index emission) — nothing left to pack
      if (fused_ok && t.fused) continue;
      // BULK fast path: a null-free PLAIN string page is contiguous copies
      // instead of a per-value lambda walk (the slens/soffs vectors already
      // hold the final values).  Column emission needs views mode (copy
      // mode accumulates char offsets); index emission needs lengths only.
      if (is_ba && t.kind == 0 && t.nn == t.num_values && t.nn > 0 &&
          (want_views || !want_column)) {
        const size_t nv = size_t(t.nn);
        if (want_column) {
          if (t.slens.empty()) {
            // lean views mode (col_direct): parse the u32 length prefixes
            // straight into the final arrays — one bounds-checked pass
            Cursor vc(t.val_ptr, size_t(t.val_len));
            for (size_t v = 0; v < nv; v++) {
              uint32_t len = vc.le<uint32_t>();
              const uint8_t* p = vc.bytes(len);
              col_offs[base + int64_t(v)] = int64_t(p - map_);
              col_lens[base + int64_t(v)] = int32_t(len);
            }
          } else {
            std::memcpy(col_lens + base, t.slens.data(),
                        nv * sizeof(int32_t));
            std::memcpy(col_offs + base, t.soffs.data(),
                        nv * sizeof(int64_t));
          }
          std::memset(col_src + base, 0, nv);
          std::memset(col_valid + base, 1, nv);
        }
        if (want_index) {
          std::memcpy(idx_len + ebase, t.slens.data(), nv * sizeof(int32_t));
          for (size_t v = 0; v < nv; v++)
            idx_pos[size_t(ebase) + v] = base + int64_t(v);
        }
        continue;
      }
      // Sparse plain page in lean views mode (col_direct skipped the
      // slens/soffs vectors in the walk): the def runs drive the slot
      // mapping — non-null storage order IS prefix order — and the
      // prefixes parse straight into the final arrays.  col_valid/col_src
      // stay 0 at null slots (planes are zero-initialized).
      if (is_ba && t.kind == 0 && want_views && want_column &&
          t.slens.empty() && t.nn != t.num_values) {
        Cursor vc(t.val_ptr, size_t(t.val_len));
        expand_runs_to(t.def_runs_p, size_t(t.def_nruns), t.def_ptr,
                     size_t(t.def_len), def_bw,
                       [&](int32_t v, int32_t lvl) {
                         if (v >= t.num_values) return;
                         if (lvl != lf.max_def) {
                           col_lens[base + v] = -1;  // NULL sentinel
                           return;
                         }
                         uint32_t len = vc.le<uint32_t>();
                         const uint8_t* p = vc.bytes(len);
                         col_offs[base + v] = int64_t(p - map_);
                         col_lens[base + v] = int32_t(len);
                         col_valid[base + v] = 1;
                       });
        continue;
      }
      // Generic pages (dict-encoded, copy-mode strings, V2/delta shapes):
      // pre-fill the NULL/dropped sentinels the value walk below leaves
      // unset — per page, inside this parallel pass (an eager whole-column
      // memset measured several single-threaded ms on 2M-row columns)
      if (col_lens && t.num_values > 0)
        std::memset(col_lens + base, 0xFF,
                    size_t(t.num_values) * sizeof(int32_t));
      if (want_index && t.nn > 0)
        std::memset(idx_len + ebase, 0xFF, size_t(t.nn) * sizeof(int32_t));
      if (t.kind == 1) {
        idx_scratch.assign(size_t(std::max(t.nn, 0)), 0);
        expand_runs_to(t.idx_runs_p, size_t(t.idx_nruns), t.val_ptr,
                     size_t(t.val_len), t.idx_bw,
                       [&](int32_t v, int32_t val) {
                         if (v >= 0 && v < t.nn) idx_scratch[size_t(v)] = val;
                       });
      }
      // copy-mode plain strings: offsets into the global str_chars buffer
      // (value_at sees k in ascending order, so a running sum of slens is
      // the per-value char offset within the page)
      int64_t schar_off = page_schar_fix[size_t(i)];
      auto value_at = [&](int32_t v, int32_t k) {
        const int64_t o = base + v;
        int32_t emit_len = -1;  // index emission length (-1 = no emission)
        if (t.kind == 1) {  // dictionary page
          const int32_t idx = idx_scratch[size_t(k)];
          if (idx < 0 || idx >= t.dict_size) return;  // OOB index -> NULL
          // (reference: src/reader/column_reader.cpp:190-194)
          if (is_ba) {
            const size_t g = size_t(t.dict_base + idx);
            if (want_column) {
              col_offs[o] = rg_char_base[rg_local] + rgres.dict_offs[g];
              col_lens[o] = rgres.dict_lens[g];
              col_src[o] = 1;
            }
            emit_len = rgres.dict_lens[g];
          } else if (want_column) {
            std::memcpy(col_values + o * col_w,
                        rgres.dict_fixed.data() +
                            size_t(t.dict_base + idx) * size_t(col_w),
                        size_t(col_w));
          }
        } else if (is_ba) {
          if (want_column) {
            if (want_views) {
              col_offs[o] = t.soffs[size_t(k)];
            } else {
              col_offs[o] = schar_off;
              schar_off += t.slens[size_t(k)];
            }
            col_lens[o] = t.slens[size_t(k)];
            col_src[o] = 0;
          }
          emit_len = t.slens[size_t(k)];
        } else if (is_bool) {
          const int64_t byte = k >> 3;
          col_values[o] =
              byte < t.val_len && ((t.val_ptr[byte] >> (k & 7)) & 1) ? 1 : 0;
        } else {
          if (int64_t(k + 1) * w <= t.val_len)
            std::memcpy(col_values + o * col_w, t.val_ptr + int64_t(k) * w,
                        size_t(w));
        }
        if (want_column) col_valid[o] = 1;
        if (want_index) {
          idx_pos[ebase + k] = o;
          idx_len[ebase + k] = emit_len;
        }
      };
      if (lf.max_def > 0 && t.nn != t.num_values) {
        int32_t k = 0;
        expand_runs_to(t.def_runs_p, size_t(t.def_nruns), t.def_ptr,
                     size_t(t.def_len), def_bw,
                       [&](int32_t v, int32_t lvl) {
                         if (lvl == lf.max_def && v < t.num_values)
                           value_at(v, k++);
                       });
      } else {
        // null-free page (nn == num_values): every slot is defined, so the
        // non-null rank IS the slot index — skip the def-run walk (~80% of
        // pages on low-null columns)
        for (int32_t v = 0; v < t.num_values; v++) value_at(v, v);
      }
    }
  }
  });

  auto t3 = t_now();
  if (timing)
    std::fprintf(stderr, "[prescan] page pack: %.1f ms\n", t_ms(t2, t3));

  // ── dictionaries (concatenated across row groups) ─────────────────────────
  if (dict_n > 0 && !is_ba) {
    auto* dst = store->alloc<uint8_t>("dict_fixed",
                                      {dict_n, is_bool ? 1 : int64_t(w)});
    size_t at = 0;
    for (const auto& res : rg_results) {
      std::memcpy(dst + at, res.dict_fixed.data(), res.dict_fixed.size());
      at += res.dict_fixed.size();
    }
  }
  if (is_ba && dict_n > 0) {
    auto* d_lens = store->alloc<int32_t>("dict_lens", {dict_n});
    auto* d_offs = store->alloc<int64_t>("dict_offs", {dict_n});
    auto* d_chars = store->alloc<uint8_t>(
        "dict_chars", {std::max<int64_t>(dict_chars_total, 1)});
    int64_t ent = 0, chars_at = 0;
    for (const auto& res : rg_results) {
      for (size_t k = 0; k < res.dict_lens.size(); k++) {
        d_lens[ent] = res.dict_lens[k];
        d_offs[ent] = res.dict_offs[k] + chars_at;
        ent++;
      }
      std::memcpy(d_chars + chars_at, res.dict_chars.data(),
                  res.dict_chars.size());
      chars_at += int64_t(res.dict_chars.size());
    }
    if (dict_pitch > 0) {
      auto* padded = store->alloc<uint8_t>("dict_padded", {dict_n, dict_pitch});
      for (int32_t v = 0; v < dict_n; v++)
        std::memcpy(padded + int64_t(v) * dict_pitch, d_chars + d_offs[v],
                    size_t(d_lens[v]));
    }
  }

  // ── zero-copy string views (PS_STR_VIEWS) ─────────────────────────────────
  const bool want_str_tables = !(flags & PS_COL_ONLY);
  if (want_views && want_str_tables) {
    dims["str_abs"] = 1;
    auto* nn_start = store->alloc<int64_t>("str_nn_start", {N + 1});
    auto* s_lens =
        store->alloc<int32_t>("str_lens", {std::max<int64_t>(nn_total, 1)});
    auto* s_offs =
        store->alloc<int64_t>("str_offs", {std::max<int64_t>(nn_total, 1)});
    int64_t at = 0;
    for (int64_t i = 0; i < N; i++) {
      nn_start[i] = at;
      const PageTmp& t = *tmp[size_t(i)];
      if (!t.slens.empty()) {
        std::memcpy(s_lens + at, t.slens.data(),
                    t.slens.size() * sizeof(int32_t));
        std::memcpy(s_offs + at, t.soffs.data(),
                    t.soffs.size() * sizeof(int64_t));
        at += int64_t(t.slens.size());
      }
    }
    nn_start[N] = at;
  }

  // ── host string tables (PS_HOST_STRINGS) ──────────────────────────────────
  if (want_strings) {
    // the owned chars buffer is emitted even under PS_COL_ONLY: in copy
    // mode the PS_COLUMN col_offs index into it
    auto* s_chars = store->alloc<uint8_t>(
        "str_chars", {std::max<int64_t>(str_chars_total, 1)});
    {
      int64_t chars_at = 0;
      for (const auto& res : rg_results) {
        if (!res.str_chars.empty())
          std::memcpy(s_chars + chars_at, res.str_chars.data(),
                      res.str_chars.size());
        chars_at += int64_t(res.str_chars.size());
      }
    }
    if (want_str_tables) {
      auto* nn_start = store->alloc<int64_t>("str_nn_start", {N + 1});
      auto* s_lens =
          store->alloc<int32_t>("str_lens", {std::max<int64_t>(nn_total, 1)});
      auto* s_offs =
          store->alloc<int64_t>("str_offs", {std::max<int64_t>(nn_total, 1)});
      int64_t at = 0;
      for (int64_t i = 0; i < N; i++) {
        nn_start[i] = at;
        const PageTmp& t = *tmp[size_t(i)];
        int64_t off = page_schar_fix[size_t(i)];
        for (size_t k = 0; k < t.slens.size(); k++) {
          s_lens[at] = t.slens[k];
          s_offs[at] = off;
          off += t.slens[k];
          at++;
        }
      }
      nn_start[N] = at;

      if (str_pitch > 0 && nn_total > 0) {
        auto* padded =
            store->alloc<uint8_t>("str_padded", {nn_total, str_pitch});
        for (int64_t v = 0; v < nn_total; v++)
          std::memcpy(padded + v * str_pitch, s_chars + s_offs[v],
                      size_t(s_lens[v]));
      }
    }
  }

  if (timing)
    std::fprintf(stderr, "[prescan] total: %.1f ms\n", t_ms(t0, t_now()));
  return store;
}

}  // namespace dpq
