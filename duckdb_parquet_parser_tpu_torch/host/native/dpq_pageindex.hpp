// dpq_pageindex.hpp — Parquet Page Index (ColumnIndex / OffsetIndex) reader.
//
// Engine extension: the reference parses ColumnChunk ids 1-3 only and never
// touches the page-index region (reference: src/reader/metadata.cpp:68-86),
// so it cannot prune pages by value range.  The engine reads the
// ColumnIndex written by modern writers (per-data-page null_pages /
// min_values / max_values / null_counts) plus the OffsetIndex (page
// locations), aligned with the engine's own global page ids: ColumnIndex
// entry k IS data page k of the chunk in file order (dictionary pages are
// excluded from both, mirroring build_page_index's gid assignment).
//
// Truncation semantics (format spec): stored min_values are LOWER bounds
// and max_values UPPER bounds of the true page min/max — stats-based
// pruning on these is sound, never exact-match.
#pragma once

#include "dpq_reader.hpp"

namespace dpq {

inline std::unique_ptr<ArrayStore> Reader::page_stats(int leaf_idx) const {
  ensure_page_index();  // aligns OffsetIndex entries with the page table
  if (leaf_idx < 0 || size_t(leaf_idx) >= leaves_.size())
    throw Error("leaf index out of range");
  const Leaf& lf = leaves_[size_t(leaf_idx)];

  struct PageStat {
    int64_t gid;
    int64_t row_start;       // engine page index (always present)
    uint8_t has_stats;
    uint8_t null_page;
    int64_t null_count;      // -1 when absent
    std::string min_v, max_v;
    int64_t oi_offset;       // OffsetIndex page header offset (-1 absent)
    int64_t oi_csize;        // OffsetIndex compressed size incl. header (-1)
    int64_t oi_first_row;    // OffsetIndex first_row_index (-1 absent)
  };
  std::vector<PageStat> out;
  int64_t n_with_ci = 0, n_with_oi = 0;

  const int n_rg = int(meta_.row_groups.size());
  int64_t rg_row_base = 0;  // OffsetIndex.first_row_index is rg-relative;
                            // emitted absolute to align with row_start
  for (int rg = 0; rg < n_rg; rg++) {
    const RowGroup& g = meta_.row_groups[size_t(rg)];
    if (size_t(lf.chunk_idx) >= g.columns.size()) continue;
    const ColumnChunk& cc = g.columns[size_t(lf.chunk_idx)];

    // this chunk's data pages, in file order (== ColumnIndex entry order)
    std::vector<const PageRec*> dps;
    for (const PageRec& pr : pages_)
      if (pr.rg == rg && pr.chunk_col == lf.chunk_idx &&
          (pr.kind == P_DATA || pr.kind == P_DATA_V2))
        dps.push_back(&pr);

    // ColumnIndex: 1 null_pages (list<bool>), 2 min_values (list<binary>),
    // 3 max_values, 4 boundary_order (i32), 5 null_counts (list<i64>)
    std::vector<uint8_t> null_pages;
    std::vector<std::string> mins, maxs;
    std::vector<int64_t> null_counts;
    const bool has_ci =
        read_chunk_column_index(cc, null_pages, mins, maxs, null_counts);
    if (has_ci && (mins.size() != dps.size() || maxs.size() != dps.size()))
      throw Error("ColumnIndex entry count does not match the chunk's "
                  "data pages");
    if (has_ci) n_with_ci++;

    // OffsetIndex: 1 page_locations (list<struct{1 offset i64,
    // 2 compressed_page_size i32, 3 first_row_index i64}>)
    std::vector<int64_t> oi_off, oi_csz, oi_row;
    if (cc.offset_index_offset && cc.offset_index_length &&
        *cc.offset_index_length > 0) {
      std::vector<uint8_t> buf(size_t(*cc.offset_index_length));
      read_range(*cc.offset_index_offset, *cc.offset_index_length, buf.data());
      TReader r(buf.data(), buf.size());
      r.read_struct([&](const TReader::Field& f) {
        if (f.id != 1) return false;
        auto lh = r.list();
        for (int32_t i = 0; i < lh.count; i++) {
          int64_t off = -1, row = -1;
          int64_t csz = -1;
          r.read_struct([&](const TReader::Field& pf) {
            switch (pf.id) {
              case 1: off = r.vi64(); return true;
              case 2: csz = r.vi32(); return true;
              case 3: row = r.vi64(); return true;
              default: return false;
            }
          });
          oi_off.push_back(off);
          oi_csz.push_back(csz);
          oi_row.push_back(row);
        }
        return true;
      });
      if (!oi_off.empty()) {
        if (oi_off.size() != dps.size())
          throw Error("OffsetIndex entry count does not match the chunk's "
                      "data pages");
        n_with_oi++;
      }
    }

    for (size_t k = 0; k < dps.size(); k++) {
      PageStat ps{};
      ps.gid = dps[k]->gid;
      ps.row_start = dps[k]->row_start;
      ps.has_stats = has_ci ? 1 : 0;
      ps.null_page = has_ci && k < null_pages.size() && null_pages[k] ? 1 : 0;
      ps.null_count =
          has_ci && k < null_counts.size() ? null_counts[k] : -1;
      if (has_ci && !ps.null_page) {
        ps.min_v = mins[k];
        ps.max_v = maxs[k];
      }
      ps.oi_offset = k < oi_off.size() ? oi_off[k] : -1;
      ps.oi_csize = k < oi_csz.size() ? oi_csz[k] : -1;
      ps.oi_first_row = k < oi_row.size() && oi_row[k] >= 0
                            ? rg_row_base + oi_row[k]
                            : -1;
      out.push_back(std::move(ps));
    }
    rg_row_base += g.num_rows;
  }

  const int64_t n = int64_t(out.size());
  auto store = std::make_unique<ArrayStore>();
  store->dims["n_pages"] = n;
  store->dims["chunks_with_column_index"] = n_with_ci;
  store->dims["chunks_with_offset_index"] = n_with_oi;
  auto* a_gid = store->alloc<int64_t>("gid", {n});
  auto* a_row = store->alloc<int64_t>("row_start", {n});
  auto* a_has = store->alloc<uint8_t>("has_stats", {n});
  auto* a_np = store->alloc<uint8_t>("null_page", {n});
  auto* a_nc = store->alloc<int64_t>("null_count", {n});
  auto* a_oo = store->alloc<int64_t>("oi_offset", {n});
  auto* a_oc = store->alloc<int64_t>("oi_csize", {n});
  auto* a_or = store->alloc<int64_t>("oi_first_row", {n});
  int64_t min_chars = 0, max_chars = 0;
  for (const auto& ps : out) {
    min_chars += int64_t(ps.min_v.size());
    max_chars += int64_t(ps.max_v.size());
  }
  auto* a_mino = store->alloc<int64_t>("min_offs", {n + 1});
  auto* a_maxo = store->alloc<int64_t>("max_offs", {n + 1});
  auto* a_minc = store->alloc<uint8_t>("min_chars", {std::max<int64_t>(min_chars, 1)});
  auto* a_maxc = store->alloc<uint8_t>("max_chars", {std::max<int64_t>(max_chars, 1)});
  store->dims["min_chars_len"] = min_chars;
  store->dims["max_chars_len"] = max_chars;
  int64_t mo = 0, xo = 0;
  for (int64_t i = 0; i < n; i++) {
    const PageStat& ps = out[size_t(i)];
    a_gid[i] = ps.gid;
    a_row[i] = ps.row_start;
    a_has[i] = ps.has_stats;
    a_np[i] = ps.null_page;
    a_nc[i] = ps.null_count;
    a_oo[i] = ps.oi_offset;
    a_oc[i] = ps.oi_csize;
    a_or[i] = ps.oi_first_row;
    a_mino[i] = mo;
    a_maxo[i] = xo;
    if (!ps.min_v.empty())
      std::memcpy(a_minc + mo, ps.min_v.data(), ps.min_v.size());
    if (!ps.max_v.empty())
      std::memcpy(a_maxc + xo, ps.max_v.data(), ps.max_v.size());
    mo += int64_t(ps.min_v.size());
    xo += int64_t(ps.max_v.size());
  }
  a_mino[n] = mo;
  a_maxo[n] = xo;
  return store;
}

}  // namespace dpq
