// Chunked-index boundary plan over the PS_INDEX emission stream.
//
// Reproduces the reference prototype's chunking exactly (reference:
// src/main.cpp:10-38): entries append `std::to_string(len) + value` to the
// current chunk; the chunk is flushed BEFORE an append once its accumulated
// size has reached `chunk_size` (chunks overshoot by one entry — a quirk
// preserved deliberately), and every emitted row records its chunk id in the
// row->chunk map (rows with no emission keep 0).
//
// The emission stream comes from the prescan pack pass (PS_INDEX):
// page-contiguous (pos, len) slots in row order, len == -1 marking dropped
// OOB dictionary indices (skipped — they are NULL in column space).  The
// whole plan is one sequential O(M) sweep — a few ms at 10^6 entries — so
// the index build's cost is the prescan itself.

#pragma once

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

#include "dpq_codec.hpp"
#include "dpq_delta.hpp"
#include "dpq_reader.hpp"

namespace dpq {

inline int dec_digits_i64(int64_t v) {
  int d = 1;
  while (v >= 10) {
    v /= 10;
    d++;
  }
  return d;
}

inline std::unique_ptr<ArrayStore> index_plan(const int64_t* pos,
                                              const int32_t* lens,
                                              int64_t cap, int64_t num_rows,
                                              int64_t chunk_size) {
  if (cap < 0 || num_rows < 0 || chunk_size <= 0)
    throw Error("index_plan: bad arguments");

  int64_t m = 0;
  for (int64_t j = 0; j < cap; j++) m += (lens[j] >= 0);

  auto store = std::make_unique<ArrayStore>();
  store->dims["m"] = m;
  store->dims["num_rows"] = num_rows;
  const int64_t m1 = std::max<int64_t>(m, 1);
  auto* out_pos = store->alloc<int64_t>("positions", {m1});
  auto* out_len = store->alloc<int64_t>("lens", {m1});
  auto* out_chunk = store->alloc<int64_t>("chunk_of_entry", {m1});
  auto* t2c =
      store->alloc<int64_t>("tuple_to_chunk", {std::max<int64_t>(num_rows, 1)});
  // calloc-backed: rows without an emission keep chunk 0 (reference quirk)

  std::vector<int64_t> starts;
  starts.push_back(0);
  int64_t acc = 0, chunk = 0, e = 0;
  for (int64_t j = 0; j < cap; j++) {
    const int32_t ln = lens[j];
    if (ln < 0) continue;
    if (acc >= chunk_size) {  // flush BEFORE the append (src/main.cpp:26-29)
      chunk++;
      acc = 0;
      starts.push_back(e);
    }
    const int64_t p = pos[j];
    out_pos[e] = p;
    out_len[e] = ln;
    out_chunk[e] = chunk;
    if (p >= 0 && p < num_rows) t2c[p] = chunk;
    acc += ln + dec_digits_i64(ln);
    e++;
  }
  store->dims["num_chunks"] = chunk + 1;
  auto* out_starts =
      store->alloc<int64_t>("chunk_starts", {int64_t(starts.size())});
  std::memcpy(out_starts, starts.data(), starts.size() * sizeof(int64_t));
  return store;
}

// ── Fused native index build ────────────────────────────────────────────────
//
// One pass from the file mapping to the finished ChunkedIndex arrays: the
// inline header walk (parse_page_rec — shared with the cold scan and the
// page-index build, so numbering can never diverge), per-page def/idx run
// decode, and length emission happen together per row group in parallel;
// the sequential part is ONLY the O(M) boundary sweep over the compact
// length stream (chunk state is a running accumulator, reference:
// src/main.cpp:21-32), and the per-entry chunk ids + row map fill back in
// parallel over chunk ranges.  Compared to the two-call route
// (prescan(PS_INDEX) + index_plan) this skips the slens vectors, the
// idx_emit_pos/idx_emit_len intermediate planes, and every -1 dropped-slot
// sentinel — OOB dictionary indices (reference drops them silently,
// src/reader/parquet_reader.cpp:436-439) simply never emit.
//
// Unsupported value encodings throw; ops/index.py falls back to the
// emission route (which re-serializes V2/delta shapes host-side).
inline std::unique_ptr<ArrayStore> Reader::index_build(
    int leaf_idx, int64_t num_rows, int64_t chunk_size) const {
  if (leaf_idx < 0 || size_t(leaf_idx) >= leaves_.size())
    throw Error("leaf index out of range");
  const Leaf& lf = leaves_[size_t(leaf_idx)];
  if (lf.type != T_BYTE_ARRAY)
    throw Error("index build requires a BYTE_ARRAY column");
  if (chunk_size <= 0 || num_rows < 0)
    throw Error("index_build: bad arguments");
  const int n_rg = int(meta_.row_groups.size());
  const int def_bw = lf.max_def > 0 ? level_bit_width(lf.max_def) : 0;

  struct RgEmit {
    std::vector<int64_t> pos;
    std::vector<int32_t> len;
  };
  std::vector<RgEmit> emits;
  emits.resize(size_t(n_rg));

  parallel_for(n_rg, [&](int rg) {
    RgEmit& em = emits[size_t(rg)];
    const RowGroup& g = meta_.row_groups[size_t(rg)];
    if (size_t(lf.chunk_idx) >= g.columns.size() ||
        !g.columns[size_t(lf.chunk_idx)].meta)
      throw Error("column chunk missing metadata");
    const ColumnMeta& cm = *g.columns[size_t(lf.chunk_idx)].meta;
    if (!codec_supported(cm.codec))
      throw Error(std::string("unsupported codec ") +
                  compression_name(cm.codec));
    const bool compressed = cm.codec != C_UNCOMPRESSED;
    std::vector<uint8_t> dbuf;

    int64_t chunk_start = cm.data_page_offset;
    if (cm.dictionary_page_offset)
      chunk_start = std::min(chunk_start, *cm.dictionary_page_offset);
    int64_t span = std::max<int64_t>(cm.total_compressed_size, 16);
    std::vector<uint8_t> fallback;
    const uint8_t* chunk_ptr = span_ptr(chunk_start, span);
    if (!chunk_ptr) {
      fallback.resize(size_t(span));
      read_range(chunk_start, span, fallback.data());
      chunk_ptr = fallback.data();
    }

    em.pos.reserve(size_t(std::max<int64_t>(cm.num_values, 0)));
    em.len.reserve(size_t(std::max<int64_t>(cm.num_values, 0)));

    std::vector<int32_t> dict_lens;  // this chunk's dictionary entry lengths
    std::vector<Run> runs;           // def/idx run scratch (reused)
    std::vector<int32_t> idx_scratch;

    // absolute value offset of the first value in this row group: pages
    // number values from the walk's running counter, but emission positions
    // are GLOBAL (concatenated row groups) — mirror the prescan's row0.
    int64_t rg_value_base = 0;
    for (int r2 = 0; r2 < rg; r2++) {
      const auto& g2 = meta_.row_groups[size_t(r2)];
      if (size_t(lf.chunk_idx) < g2.columns.size() &&
          g2.columns[size_t(lf.chunk_idx)].meta)
        rg_value_base += g2.columns[size_t(lf.chunk_idx)].meta->num_values;
    }

    int64_t hoff = 0, walk_values = 0, walk_rows = 0;
    while (walk_values < cm.num_values) {
      if (hoff >= span) break;
      PageRec pr;
      int64_t hsz = parse_page_rec(chunk_ptr, hoff, span, chunk_start, rg,
                                   lf.chunk_idx, walk_rows, walk_values, pr);
      hoff += hsz + pr.size;
      int64_t off = pr.data_off - chunk_start;
      if (off < 0 || off + pr.size > span)
        throw Error("page outside chunk span");
      const uint8_t* d = chunk_ptr + off;
      size_t dlen = size_t(pr.size);
      if (compressed && (pr.kind == P_DICTIONARY || pr.kind == P_DATA)) {
        dbuf.resize(size_t(std::max<int64_t>(pr.usize, 0)));
        codec_decompress(cm.codec, d, dlen, dbuf.data(), dbuf.size());
        d = dbuf.data();
        dlen = dbuf.size();
      } else if (pr.kind == P_DATA_V2 && compressed && pr.v2_compressed) {
        const int64_t lvl = int64_t(pr.v2_rep_len) + int64_t(pr.v2_def_len);
        if (lvl < 0 || lvl > pr.size || lvl > pr.usize)
          throw Error("V2 page level sections exceed the page");
        dbuf.resize(size_t(pr.usize));
        if (lvl) std::memcpy(dbuf.data(), d, size_t(lvl));
        codec_decompress(cm.codec, d + lvl, size_t(pr.size - lvl),
                         dbuf.data() + lvl, size_t(pr.usize - lvl));
        d = dbuf.data();
        dlen = dbuf.size();
      }

      if (pr.kind == P_DICTIONARY) {
        dict_lens.clear();
        dict_lens.reserve(size_t(std::max(pr.num_values, 0)));
        Cursor cur(d, dlen);
        for (int32_t i = 0; i < pr.num_values; i++) {
          uint32_t len = cur.le<uint32_t>();
          cur.bytes(len);
          dict_lens.push_back(int32_t(len));
        }
        continue;
      }
      const bool v2 = pr.kind == P_DATA_V2 && pr.num_values > 0;
      if (pr.kind != P_DATA && !v2) continue;
      // value offset of this page's slot 0 (page row_start counts values
      // from walk start of THIS chunk; pr.row_start was fed walk_rows)
      const int64_t page_base = rg_value_base + pr.row_start;

      Cursor cur(d, dlen);
      int64_t nn = pr.num_values;
      const uint8_t* def_ptr = nullptr;
      int64_t def_len = 0;
      if (v2) {
        cur.bytes(size_t(pr.v2_rep_len));
        def_ptr = cur.bytes(size_t(pr.v2_def_len));
        def_len = pr.v2_def_len;
      } else {
        if (lf.max_rep > 0) {
          uint32_t rep_len = cur.le<uint32_t>();
          cur.bytes(rep_len);
        }
        if (lf.max_def > 0) {
          uint32_t dl = cur.le<uint32_t>();
          def_ptr = cur.bytes(dl);
          def_len = dl;
        }
      }
      runs.clear();
      if (lf.max_def > 0 && def_len >= 0) {
        rle_prescan(def_ptr, size_t(def_len), def_bw, pr.num_values, runs);
        nn = count_matching(runs, def_ptr, size_t(def_len), def_bw,
                            lf.max_def);
      }

      const bool enc_dict =
          pr.encoding == E_PLAIN_DICTIONARY || pr.encoding == E_RLE_DICTIONARY;
      std::vector<uint8_t> plainified;  // delta shapes re-serialized
      const uint8_t* vp = nullptr;
      int64_t vlen = 0;
      if (enc_dict) {
        // expand the in-page dictionary indices to rank order
        int idx_bw = cur.u8();
        vlen = int64_t(cur.left());
        vp = cur.bytes(size_t(vlen));
        std::vector<Run> iruns;
        rle_prescan(vp, size_t(vlen), idx_bw, nn, iruns);
        // zero-fill on exhaustion: a short index section leaves trailing
        // ranks at index 0, matching the reference RleDecoder quirk (and
        // the prescan emission path) — NOT dropped
        idx_scratch.assign(size_t(std::max<int64_t>(nn, 0)), 0);
        expand_runs_to(iruns, vp, size_t(vlen), idx_bw,
                       [&](int32_t v, int32_t val) {
                         if (v >= 0 && v < nn) idx_scratch[size_t(v)] = val;
                       });
        const int32_t dn = int32_t(dict_lens.size());
        auto emit_rank = [&](int32_t v, int32_t k) {
          const int32_t idx = idx_scratch[size_t(k)];
          if (idx < 0 || idx >= dn) return;  // OOB -> silently dropped
          em.pos.push_back(page_base + v);
          em.len.push_back(dict_lens[size_t(idx)]);
        };
        if (lf.max_def > 0 && nn != pr.num_values) {
          int32_t k = 0;
          expand_runs_to(runs, def_ptr, size_t(def_len), def_bw,
                         [&](int32_t v, int32_t lvl) {
                           if (lvl == lf.max_def && v < pr.num_values &&
                               k < nn)
                             emit_rank(v, k++);
                         });
        } else {
          for (int32_t v = 0; v < pr.num_values && v < nn; v++)
            emit_rank(v, v);
        }
        continue;
      }
      if (pr.encoding == E_DELTA_LENGTH_BYTE_ARRAY ||
          pr.encoding == E_DELTA_BYTE_ARRAY) {
        plainified = pr.encoding == E_DELTA_LENGTH_BYTE_ARRAY
                         ? delta_length_ba_to_plain(cur, nn)
                         : delta_ba_to_plain(cur, nn);
        vp = plainified.data();
        vlen = int64_t(plainified.size());
      } else if (pr.encoding == E_PLAIN) {
        vlen = int64_t(cur.left());
        vp = cur.bytes(size_t(vlen));
      } else {
        throw Error(std::string("index build: unsupported value encoding ") +
                    std::to_string(pr.encoding));
      }

      // PLAIN page: prefixes parse in non-null storage order; def runs map
      // each to its slot.  Null-free pages take the straight loop.
      Cursor vc(vp, size_t(vlen));
      if (lf.max_def == 0 || nn == pr.num_values) {
        for (int32_t v = 0; v < nn; v++) {
          uint32_t len = vc.le<uint32_t>();
          vc.bytes(len);
          em.pos.push_back(page_base + v);
          em.len.push_back(int32_t(len));
        }
      } else {
        for (const Run& rn : runs) {
          const int32_t v0 = rn.vstart;
          if (v0 >= pr.num_values) continue;
          const int32_t cnt = std::min(rn.count, pr.num_values - v0);
          if (rn.kind == 0 && rn.value == lf.max_def) {
            for (int32_t i = 0; i < cnt; i++) {
              uint32_t len = vc.le<uint32_t>();
              vc.bytes(len);
              em.pos.push_back(page_base + v0 + i);
              em.len.push_back(int32_t(len));
            }
          } else if (rn.kind != 0) {
            for (int32_t i = 0; i < cnt; i++) {
              const int32_t lvl = int32_t(bits_at(def_ptr, size_t(def_len),
                                                  rn.bitoff +
                                                      int64_t(i) * def_bw,
                                                  def_bw));
              if (lvl != lf.max_def) continue;
              uint32_t len = vc.le<uint32_t>();
              vc.bytes(len);
              em.pos.push_back(page_base + v0 + i);
              em.len.push_back(int32_t(len));
            }
          }
          // kind==0 null runs: nothing stored, nothing emitted
        }
      }
    }
  });

  // compact concat bases
  int64_t m = 0;
  std::vector<int64_t> rg_base(size_t(n_rg) + 1, 0);
  for (int rg = 0; rg < n_rg; rg++) {
    rg_base[size_t(rg)] = m;
    m += int64_t(emits[size_t(rg)].pos.size());
  }
  rg_base[size_t(n_rg)] = m;

  auto store = std::make_unique<ArrayStore>();
  store->dims["m"] = m;
  store->dims["num_rows"] = num_rows;
  const int64_t m1 = std::max<int64_t>(m, 1);
  auto* out_pos = store->alloc<int64_t>("positions", {m1});
  auto* out_len = store->alloc<int64_t>("lens", {m1});
  auto* out_chunk = store->alloc<int64_t>("chunk_of_entry", {m1});
  auto* t2c =
      store->alloc<int64_t>("tuple_to_chunk", {std::max<int64_t>(num_rows, 1)});

  parallel_for(n_rg, [&](int rg) {
    const RgEmit& em = emits[size_t(rg)];
    const int64_t b = rg_base[size_t(rg)];
    for (size_t e = 0; e < em.pos.size(); e++) {
      out_pos[b + int64_t(e)] = em.pos[e];
      out_len[b + int64_t(e)] = em.len[e];
    }
  });

  // sequential boundary sweep (the ONLY serial part): flush BEFORE the
  // append once the accumulated size reached chunk_size (src/main.cpp:26-29)
  std::vector<int64_t> starts;
  starts.push_back(0);
  {
    int64_t acc = 0;
    for (int64_t e = 0; e < m; e++) {
      if (acc >= chunk_size) {
        acc = 0;
        starts.push_back(e);
      }
      const int64_t ln = out_len[e];
      acc += ln + dec_digits_i64(ln);
    }
  }
  const int64_t n_chunks = int64_t(starts.size());
  store->dims["num_chunks"] = n_chunks;
  auto* out_starts = store->alloc<int64_t>("chunk_starts", {n_chunks});
  std::memcpy(out_starts, starts.data(), size_t(n_chunks) * sizeof(int64_t));

  // chunk ids + row map fill, parallel over chunk ranges (disjoint entries;
  // t2c rows without an emission keep 0 — calloc'd, reference quirk)
  const int64_t CBLK = 256;
  parallel_for(int((n_chunks + CBLK - 1) / CBLK), [&](int blk) {
    const int64_t c_lo = int64_t(blk) * CBLK;
    const int64_t c_hi = std::min<int64_t>(n_chunks, c_lo + CBLK);
    for (int64_t c = c_lo; c < c_hi; c++) {
      const int64_t e0 = starts[size_t(c)];
      const int64_t e1 = c + 1 < n_chunks ? starts[size_t(c + 1)] : m;
      for (int64_t e = e0; e < e1; e++) {
        out_chunk[e] = c;
        const int64_t p = out_pos[e];
        if (p >= 0 && p < num_rows) t2c[p] = c;
      }
    }
  });
  return store;
}

}  // namespace dpq
