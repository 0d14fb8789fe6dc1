// dpq_scan.hpp — the fused COLD-PATH regex scan: one streaming pass over the
// mmap'd column chunks answering a one-shot page-pruning query at host speed
// while the device copy warms in the background.
//
// Rationale: a cold device scan pays prescan + upload + dispatch latency
// before the first result; for a single query on a cold file a host pass
// wins that race.  This pass eliminates every intermediate: no batch packing, no
// padded planes, no upload — page headers, definition levels, and value
// payloads are consumed straight out of the file mapping, chunk-parallel on
// the host thread pool.
//
// Parity contract (bit-identical page sets vs the device engine):
//   * per-value accept == ops/strings.py::match_payload_stream finalize
//     rules: a value only participates when its length prefix AND bytes fit
//     inside the value section; zero-length values score accept-of-empty.
//   * dictionary pages == ops/scan.py::_device_scan_step: each dict value is
//     matched once, then counts flow through the RLE/bit-packed index stream;
//     out-of-range indices are excluded from counts AND value totals
//     (reference ColumnReader turns them into NULLs:
//     src/reader/column_reader.cpp:190-194).
//   * negation inverts the per-value accept (README.md:60-64), with
//     match_counts = nn - accepted so truncated values count as accepted,
//     exactly like the device's (nn - hits).
//
// Matching modes:
//   * substring chain ('%a%b%'-class): ordered memmem walk per value; pages
//     are pre-screened with one memmem chain over the whole value section
//     (a page cannot contain a matching value unless the concatenated
//     section contains the needles in order) — pruned pages never walk
//     values at all.
//   * dense DFA table (from ops/regex.py): scalar table walk per value.
#pragma once

#include <cstring>

#if defined(__SSE2__)
#include <immintrin.h>
#endif

#include "dpq_reader.hpp"
#include "dpq_codec.hpp"

namespace dpq {

struct ColdPattern {
  std::vector<std::string> needles;  // chain mode when non-empty
  const int32_t* table = nullptr;    // [n_states, 256] (DFA mode)
  const uint8_t* accept = nullptr;   // [n_states]
  int32_t n_states = 0;
  bool neg = false;
  // exact=false: match_counts become 0/1 survivor indicators and pages stop
  // at the first deciding value (same surviving/pruned sets, ~2x faster on
  // match-heavy data); exact=true reproduces the device engine's counts.
  bool exact = true;
  // Unified ColumnIndex prune range (ops/regex.anchored_prune_range):
  // every matching value v satisfies prune_lo <= v and (prune_hi empty or
  // v < prune_hi), so a page whose stored range cannot intersect it skips
  // all def/payload work (engine extension — the reference never reads
  // the page-index region: src/reader/metadata.cpp:68-86).  Covers literal
  // prefixes [P, inc P), exact literals [L, L+"\0"), and class-extended
  // prefixes [P+min_c, inc(P+max_c)).  The caller must leave prune_lo
  // empty under negation (a no-match page SURVIVES a negated scan).
  std::string prune_lo;
  std::string prune_hi;  // empty = no upper bound

  bool use_chain() const { return !needles.empty(); }
  bool accept_empty() const {
    if (use_chain()) return false;
    return accept && n_states > 0 && accept[0] != 0;
  }
};

// Substring search for short haystacks: memchr on the first needle byte +
// memcmp confirm (glibc memmem's per-call two-way setup costs ~35 ns — more
// than an entire value scan here).
inline const uint8_t* find_sub(const uint8_t* h, size_t hl, const uint8_t* n,
                               size_t nl) {
  if (nl == 0) return h;
  if (nl > hl) return nullptr;
  const uint8_t c0 = n[0];
  const uint8_t* p = h;
  const uint8_t* last = h + (hl - nl);  // last admissible start
  if (hl <= 64) {
    // tiny haystacks (split-range chain confirms): a plain byte loop beats
    // memchr's per-call startup (~10-15 ns) — on text where c0 is dense,
    // several calls per range
    for (; p <= last; p++)
      if (*p == c0 && (nl == 1 || ::memcmp(p + 1, n + 1, nl - 1) == 0))
        return p;
    return nullptr;
  }
  while (p <= last) {
    p = static_cast<const uint8_t*>(::memchr(p, c0, size_t(last - p) + 1));
    if (!p) return nullptr;
    if (nl == 1 || ::memcmp(p + 1, n + 1, nl - 1) == 0) return p;
    p++;
  }
  return nullptr;
}

// Ordered-needle chain over one byte span (shared by the per-value accept
// and the page screen).
inline bool chain_match(const std::vector<std::string>& needles,
                        const uint8_t* s, size_t len) {
  size_t pos = 0;
  for (const auto& nd : needles) {
    if (pos + nd.size() > len) return false;
    const uint8_t* f =
        find_sub(s + pos, len - pos,
                 reinterpret_cast<const uint8_t*>(nd.data()), nd.size());
    if (!f) return false;
    pos = size_t(f - s) + nd.size();
  }
  return true;
}

// ALL occurrences of `nd` in [s, s+len), appended to `out` (overlapping
// included).  SIMD first-two-byte filter (Muła's algorithm): one 16-lane
// compare pair per 16 bytes, then memcmp confirm on candidate bigrams —
// frequency of the bigram, not the first letter, gates the confirm rate, so
// text-heavy data ('s' every ~8 bytes) stays vectorized.  The per-page occ
// lists then drive the value-boundary chain walk in O(values + occs),
// replacing per-value substring scans (measured ~4x on the confirm pass).
// ── Bigram candidate masks ──────────────────────────────────────────────────
//
// One SIMD sweep per (page section, needle) fills a bitmask — bit i set iff
// s[i..i+1] equals the needle's first two bytes.  No positions are
// materialized and no per-candidate work happens at sweep time (measured:
// position lists cost ~18 ns per occurrence — 30+ ms on a 2M-row column with
// dense needles; raw masks are pure compare+store).  The value-boundary walk
// then consumes mask bits lazily, confirming full needles with memcmp and
// memoizing failed confirms by clearing their bits.

#if defined(__SSE2__)
inline bool have_avx512bw() {
  static const bool ok = __builtin_cpu_supports("avx512bw");
  return ok;
}

// Processes ALL of [0, len): full 64-byte blocks while 64+lo+1 bytes are
// readable, then fault-suppressing masked loads for the tail blocks — so
// no scalar tail remains (a ~65-130 byte scalar tail on ~1 KB pages was
// most of the per-page sweep cost).  Returns len.
__attribute__((target("avx512bw"))) inline size_t bigram_mask_avx512(
    const uint8_t* s, size_t len, uint8_t c0, uint8_t c1, bool pair,
    uint8_t cl, size_t lo, uint64_t* out) {
  const __m512i f0 = _mm512_set1_epi8(char(c0));
  const __m512i f1 = _mm512_set1_epi8(char(c1));
  const __m512i fl = _mm512_set1_epi8(char(cl));
  size_t i = 0;
  for (; i + 65 + lo <= len; i += 64) {
    const __m512i b0 = _mm512_loadu_si512(s + i);
    uint64_t m = _mm512_cmpeq_epi8_mask(b0, f0);
    if (pair && m) {
      const __m512i b1 = _mm512_loadu_si512(s + i + 1);
      m &= _mm512_cmpeq_epi8_mask(b1, f1);
    }
    if (lo && m) {  // last-byte filter: kills most false bigram candidates
      const __m512i bl = _mm512_loadu_si512(s + i + lo);
      m &= _mm512_cmpeq_epi8_mask(bl, fl);
    }
    out[i >> 6] = m;
  }
  for (; i < len; i += 64) {  // masked tail: bits whose filter bytes fall
    const size_t rem = len - i;  // past len are dead (the needle can't fit)
    const uint64_t k0 = rem >= 64 ? ~0ull : ((1ull << rem) - 1);
    const __m512i b0 = _mm512_maskz_loadu_epi8(k0, s + i);
    uint64_t m = _mm512_cmpeq_epi8_mask(b0, f0) & k0;
    if (pair && m) {
      const size_t r1 = rem - 1;  // bytes readable at s + i + 1
      const uint64_t k1 = r1 >= 64 ? ~0ull : (r1 ? ((1ull << r1) - 1) : 0);
      const __m512i b1 = _mm512_maskz_loadu_epi8(k1, s + i + 1);
      m &= _mm512_cmpeq_epi8_mask(b1, f1) & k1;
    }
    if (lo && m) {
      const size_t rl = rem > lo ? rem - lo : 0;  // readable at s + i + lo
      const uint64_t kl = rl >= 64 ? ~0ull : (rl ? ((1ull << rl) - 1) : 0);
      const __m512i bl = _mm512_maskz_loadu_epi8(kl, s + i + lo);
      m &= _mm512_cmpeq_epi8_mask(bl, fl) & kl;
    }
    out[i >> 6] = m;
  }
  return len;
}
#endif

inline void bigram_masks(const uint8_t* s, size_t len, const std::string& nd,
                         std::vector<uint64_t>& out) {
  const size_t nblocks = (len + 63) >> 6;
  out.assign(nblocks, 0);
  if (nd.empty() || nd.size() > len) return;
  const uint8_t c0 = uint8_t(nd[0]);
  const bool pair = nd.size() > 1;
  const uint8_t c1 = pair ? uint8_t(nd[1]) : c0;
  const size_t lo = nd.size() > 2 ? nd.size() - 1 : 0;  // last-byte offset
  const uint8_t cl = uint8_t(nd.back());
  size_t tail = 0;
#if defined(__SSE2__)
  if (have_avx512bw()) {
    tail = bigram_mask_avx512(s, len, c0, c1, pair, cl, lo, out.data());
  } else if (len >= 18) {
    const __m128i g0 = _mm_set1_epi8(char(c0));
    const __m128i g1 = _mm_set1_epi8(char(c1));
    size_t i = 0;
    for (; i + 17 <= len; i += 16) {
      const __m128i b0 =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i));
      uint32_t m =
          uint32_t(_mm_movemask_epi8(_mm_cmpeq_epi8(b0, g0)));
      if (pair && m) {
        const __m128i b1 =
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(s + i + 1));
        m &= uint32_t(_mm_movemask_epi8(_mm_cmpeq_epi8(b1, g1)));
      }
      out[i >> 6] |= uint64_t(m) << (i & 63);
    }
    tail = i;
  }
#endif
  for (size_t i = tail; i < len; i++)
    if (s[i] == c0 && (!pair || (i + 1 < len && s[i + 1] == c1)) &&
        (!lo || (i + lo < len && s[i + lo] == cl)))
      out[i >> 6] |= 1ull << (i & 63);
}

// Segment fill for the lazy sweep: candidates of `nd` over the window
// [from, win_hi) of `s`, written at ABSOLUTE bit positions into `words`
// (`from` must be 64-aligned).  The indicator-mode walk sweeps one segment
// at a time and stops at the first accepting value, so a decided page
// never streams its tail bytes through the cache at all.
inline void bigram_masks_into(const uint8_t* s, int64_t from, int64_t win_hi,
                              const std::string& nd, uint64_t* words) {
  const int64_t w_lo = from >> 6;
  const int64_t w_hi = (win_hi - 1) >> 6;  // inclusive
  const size_t wlen = size_t(win_hi - from);
  if (nd.empty() || nd.size() > wlen) {
    for (int64_t w = w_lo; w <= w_hi; w++) words[w] = 0;
    return;
  }
  const uint8_t c0 = uint8_t(nd[0]);
  const bool pair = nd.size() > 1;
  const uint8_t c1 = pair ? uint8_t(nd[1]) : c0;
  const size_t lo = nd.size() > 2 ? nd.size() - 1 : 0;
  const uint8_t cl = uint8_t(nd.back());
  size_t done = 0;
#if defined(__SSE2__)
  if (have_avx512bw()) {
    done = bigram_mask_avx512(s + from, wlen, c0, c1, pair, cl, lo,
                              words + w_lo);
    if (done >= wlen) return;  // fully processed (masked-tail kernel)
  }
#endif
  for (int64_t w = int64_t(from + done) >> 6; w <= w_hi; w++) words[w] = 0;
  for (size_t i = done; i < wlen; i++)
    if (s[from + int64_t(i)] == c0 &&
        (!pair || (i + 1 < wlen && s[from + int64_t(i) + 1] == c1)) &&
        (!lo || (i + lo < wlen && s[from + int64_t(i + lo)] == cl)))
      words[(from + int64_t(i)) >> 6] |= 1ull << ((from + int64_t(i)) & 63);
}

#if defined(__SSE2__)
// Fused K-needle sweep: ONE read of the span fills every needle's bigram
// mask (the per-needle sweep re-reads the span K times and is memory-bound
// on ~100 MB chunks — measured ~40% of the cold scan with K=2).
__attribute__((target("avx512bw"))) inline size_t bigram_masks_multi_avx512(
    const uint8_t* s, size_t len, const uint8_t* c0s, const uint8_t* c1s,
    const uint8_t* pairs, const uint8_t* cls, const size_t* los, size_t K,
    uint64_t* const* outs) {
  __m512i f0[8], f1[8], fl[8];
  if (K > 8) return 0;  // fall back to per-needle sweeps
  size_t max_lo = 0;
  for (size_t k = 0; k < K; k++) {
    f0[k] = _mm512_set1_epi8(char(c0s[k]));
    f1[k] = _mm512_set1_epi8(char(c1s[k]));
    fl[k] = _mm512_set1_epi8(char(cls[k]));
    max_lo = std::max(max_lo, los[k]);
  }
  size_t i = 0;
  for (; i + 65 + max_lo <= len; i += 64) {
    const __m512i b0 = _mm512_loadu_si512(s + i);
    __m512i b1;
    bool have_b1 = false;
    for (size_t k = 0; k < K; k++) {
      uint64_t m = _mm512_cmpeq_epi8_mask(b0, f0[k]);
      if (pairs[k] && m) {
        if (!have_b1) {
          b1 = _mm512_loadu_si512(s + i + 1);
          have_b1 = true;
        }
        m &= _mm512_cmpeq_epi8_mask(b1, f1[k]);
      }
      if (los[k] && m) {
        const __m512i bl = _mm512_loadu_si512(s + i + los[k]);
        m &= _mm512_cmpeq_epi8_mask(bl, fl[k]);
      }
      outs[k][i >> 6] = m;
    }
  }
  for (; i < len; i += 64) {  // masked tail (fault-suppressing loads) —
    const size_t rem = len - i;  // no scalar tail remains (see single-needle
    const uint64_t k0m = rem >= 64 ? ~0ull : ((1ull << rem) - 1);  // kernel)
    const __m512i b0 = _mm512_maskz_loadu_epi8(k0m, s + i);
    __m512i b1;
    uint64_t k1m = 0;
    bool have_b1 = false;
    for (size_t k = 0; k < K; k++) {
      uint64_t m = _mm512_cmpeq_epi8_mask(b0, f0[k]) & k0m;
      if (pairs[k] && m) {
        if (!have_b1) {
          const size_t r1 = rem - 1;
          k1m = r1 >= 64 ? ~0ull : (r1 ? ((1ull << r1) - 1) : 0);
          b1 = _mm512_maskz_loadu_epi8(k1m, s + i + 1);
          have_b1 = true;
        }
        m &= _mm512_cmpeq_epi8_mask(b1, f1[k]) & k1m;
      }
      if (los[k] && m) {
        const size_t rl = rem > los[k] ? rem - los[k] : 0;
        const uint64_t klm = rl >= 64 ? ~0ull : (rl ? ((1ull << rl) - 1) : 0);
        const __m512i bl = _mm512_maskz_loadu_epi8(klm, s + i + los[k]);
        m &= _mm512_cmpeq_epi8_mask(bl, fl[k]) & klm;
      }
      outs[k][i >> 6] = m;
    }
  }
  return len;
}
#endif

// One pass over [s, len) filling all K needle masks (falls back to K
// per-needle sweeps off AVX512 or for K > 8).
inline void bigram_masks_multi(const uint8_t* s, size_t len,
                               const std::vector<std::string>& needles,
                               std::vector<std::vector<uint64_t>>& outs) {
  const size_t K = needles.size();
  const size_t nblocks = (len + 63) >> 6;
  size_t tail = size_t(-1);
#if defined(__SSE2__)
  if (have_avx512bw() && K >= 2 && K <= 8) {
    uint8_t c0s[8], c1s[8], pairs[8], cls[8];
    size_t los[8];
    uint64_t* ptrs[8];
    bool ok = true;
    for (size_t k = 0; k < K; k++) {
      const std::string& nd = needles[k];
      if (nd.empty() || nd.size() > len) ok = false;
      outs[k].assign(nblocks, 0);
      c0s[k] = nd.empty() ? 0 : uint8_t(nd[0]);
      pairs[k] = nd.size() > 1;
      c1s[k] = pairs[k] ? uint8_t(nd[1]) : c0s[k];
      los[k] = nd.size() > 2 ? nd.size() - 1 : 0;
      cls[k] = nd.empty() ? 0 : uint8_t(nd.back());
      ptrs[k] = outs[k].data();
    }
    if (ok)
      tail = bigram_masks_multi_avx512(s, len, c0s, c1s, pairs, cls, los, K,
                                       ptrs);
  }
#endif
  if (tail == size_t(-1)) {
    for (size_t k = 0; k < K; k++) bigram_masks(s, len, needles[k], outs[k]);
    return;
  }
  for (size_t i = tail; i < len; i++)
    for (size_t k = 0; k < K; k++) {
      const std::string& nd = needles[k];
      const uint8_t c0 = uint8_t(nd[0]);
      const bool pair = nd.size() > 1;
      const size_t lo = nd.size() > 2 ? nd.size() - 1 : 0;
      if (s[i] == c0 &&
          (!pair || (i + 1 < len && s[i + 1] == uint8_t(nd[1]))) &&
          (!lo || (i + lo < len && s[i + lo] == uint8_t(nd.back()))))
        outs[k][i >> 6] |= 1ull << (i & 63);
    }
}

// Value-boundary payload split plan: big PLAIN pages re-chunk into ~target-
// byte segments that START AT VALUE STARTS, so the device streaming matcher
// walks many short lanes instead of one mega-page (a pyarrow-default ~1 MB
// page otherwise forces a ~1M-step sequential walk).  No matcher state crosses a value start, so the
// per-segment walk is exact; segments partition each page's values, so the
// page's hits/seen are the segment sums (ops/scan.py applies a segment-sum
// keyed by seg_page).  Truncated values stop the split — the tail segment
// inherits everything remaining, reproducing the unsplit walk's
// never-finalizes semantics.  Dictionary pages and pages <= target pass
// through as single segments.
inline std::unique_ptr<ArrayStore> split_payload_plan(
    const uint8_t* payload, int64_t n, int64_t pitch, const int32_t* plen,
    const int32_t* nn, const int32_t* kind, int64_t target) {
  struct Seg {
    int32_t page;
    int64_t off;
    int32_t len;
    int32_t nn;
  };
  std::vector<Seg> segs;
  segs.reserve(size_t(n));
  for (int64_t i = 0; i < n; i++) {
    const int64_t pl = std::min<int64_t>(std::max<int64_t>(plen[i], 0), pitch);
    const int32_t nv = nn[i];
    if (kind[i] != 0 || pl <= target || nv <= 1) {
      segs.push_back({int32_t(i), 0, int32_t(pl), nv});
      continue;
    }
    const uint8_t* row = payload + i * pitch;
    int64_t pos = 0, seg_start = 0;
    int32_t seg_nn = 0, emitted = 0;
    for (int32_t v = 0; v < nv; v++) {
      if (pos + 4 > pl) break;  // truncated prefix: stop splitting here
      uint32_t len;
      std::memcpy(&len, row + pos, 4);
      if (pos + 4 + int64_t(len) > pl) break;  // truncated bytes: stop
      if (seg_nn > 0 && pos - seg_start >= target) {
        segs.push_back(
            {int32_t(i), seg_start, int32_t(pos - seg_start), seg_nn});
        emitted += seg_nn;
        seg_start = pos;
        seg_nn = 0;
      }
      pos += 4 + int64_t(len);
      seg_nn++;
    }
    segs.push_back({int32_t(i), seg_start, int32_t(pl - seg_start),
                    nv - emitted});
  }
  auto store = std::make_unique<ArrayStore>();
  const int64_t m = int64_t(segs.size());
  store->dims["n_segs"] = m;
  int64_t seg_max = 1;
  for (const Seg& s : segs) seg_max = std::max<int64_t>(seg_max, s.len);
  // pitch quantized like ops/scan.scan_steps so compiled shapes stay stable
  const int64_t seg_pitch = round_up(seg_max, 128);
  store->dims["seg_pitch"] = seg_pitch;
  // Blowup guard: one giant VALUE sets the pitch for every segment; if the
  // split matrix would outgrow the unsplit one by >1.5x, report not-ok and
  // let the caller keep the original layout.
  if (m * seg_pitch > (n * pitch * 3) / 2 + (64 << 10)) {
    store->dims["split_ok"] = 0;
    return store;
  }
  store->dims["split_ok"] = 1;
  auto* a_page = store->alloc<int32_t>("seg_page", {m});
  auto* a_off = store->alloc<int64_t>("seg_off", {m});
  auto* a_len = store->alloc<int32_t>("seg_len", {m});
  auto* a_nn = store->alloc<int32_t>("seg_nn", {m});
  for (int64_t s = 0; s < m; s++) {
    a_page[s] = segs[size_t(s)].page;
    a_off[s] = segs[size_t(s)].off;
    a_len[s] = segs[size_t(s)].len;
    a_nn[s] = segs[size_t(s)].nn;
  }
  auto* a_pay = store->alloc<uint8_t>("seg_payload", {m, seg_pitch});
  const int64_t BLK = 4096;
  parallel_for(int((m + BLK - 1) / BLK), [&](int blk) {
    const int64_t lo = int64_t(blk) * BLK, hi = std::min(m, lo + BLK);
    for (int64_t s = lo; s < hi; s++)
      std::memcpy(a_pay + s * seg_pitch,
                  payload + int64_t(a_page[s]) * pitch + a_off[s],
                  size_t(a_len[s]));
  });
  return store;
}

// Raw accept of one value's bytes (before negation).
inline bool cold_accept(const ColdPattern& p, const uint8_t* s, size_t len) {
  if (p.use_chain()) return chain_match(p.needles, s, len);
  int32_t st = 0;
  for (size_t i = 0; i < len; i++) st = p.table[st * 256 + s[i]];
  return p.accept[st] != 0;
}


inline std::unique_ptr<ArrayStore> Reader::cold_scan(
    int leaf_idx, const ColdPattern& pat, int rg0, int rg1) const {
  if (leaf_idx < 0 || size_t(leaf_idx) >= leaves_.size())
    throw Error("leaf index out of range");
  const Leaf& lf = leaves_[size_t(leaf_idx)];
  if (lf.type != T_BYTE_ARRAY)
    throw Error(std::string("regex scan requires a BYTE_ARRAY column; '") +
                lf.name + "' is " + physical_type_name(lf.type));
  const int n_rg = int(meta_.row_groups.size());
  if (rg0 < 0) rg0 = 0;
  if (rg1 < 0 || rg1 > n_rg) rg1 = n_rg;
  const int def_bw = lf.max_def > 0 ? level_bit_width(lf.max_def) : 0;

  struct PageOut {
    int64_t gid;
    int64_t counts;  // match_counts (post-negation)
    int64_t values;  // participating values
  };
  struct RgOut {
    std::vector<PageOut> pages;
  };
  std::vector<RgOut> rg_out(size_t(std::max(rg1 - rg0, 0)));

  // gid bases for the target column's chunks: data pages are numbered in
  // (rg, col, file order), so each base is the count of numbered pages in
  // every preceding chunk — available from chunk_page_counts() (OffsetIndex
  // list headers / count-only walks) WITHOUT building the global page index.
  // The inline walk below cross-checks its own count against `expect`.
  const std::vector<int64_t>& chunk_counts = chunk_page_counts();
  const int64_t ncols = chunk_ncols();
  std::vector<int64_t> gid_base(size_t(std::max(rg1 - rg0, 0)), 0);
  std::vector<int64_t> expect(size_t(std::max(rg1 - rg0, 0)), 0);
  {
    int64_t acc = 0;
    int at = 0;
    for (int rg = 0; rg < rg1; rg++)
      for (int64_t c = 0; c < ncols; c++) {
        if (rg >= rg0 && c == int64_t(lf.chunk_idx)) {
          gid_base[size_t(at)] = acc;
          expect[size_t(at)] = chunk_counts[size_t(rg * ncols + c)];
          at++;
        }
        acc += chunk_counts[size_t(rg * ncols + c)];
      }
  }

  const bool timing = std::getenv("DPQ_SCAN_TIMING") != nullptr;
  std::atomic<int64_t> ns_def{0}, ns_sweep{0}, ns_walk{0}, ns_hdr{0};
  std::atomic<int64_t> n_screened{0}, n_walked{0}, n_vals{0};
  std::atomic<int64_t> n_stats_pruned{0};  // pages skipped via ColumnIndex
  std::atomic<int64_t> n_dict_skipped{0};  // all-miss dict short-circuits
  auto tick = [] { return std::chrono::steady_clock::now(); };
  auto lap = [&](std::atomic<int64_t>& acc, auto t0) {
    acc += std::chrono::duration_cast<std::chrono::nanoseconds>(tick() - t0)
               .count();
  };

  parallel_for(rg1 - rg0, [&](int j) {
    const int rg = rg0 + j;
    RgOut& out = rg_out[size_t(j)];
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
    std::vector<uint8_t> dbuf;  // per-page Snappy scratch (reused)

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

    // per-row-group dictionary accepts (pre-negation) — one match per entry
    std::vector<uint8_t> dict_acc;
    int32_t dict_n = 0;
    bool dict_all_miss = false;  // positive pattern, zero accepted entries

    // ── Page-Index stats pruning (anchored-prefix patterns) ──────────────
    // prune[k] (k = data-page ordinal in this chunk — ColumnIndex entry k IS
    // data page k in file order) marks pages whose [min, max] range cannot
    // intersect [prefix, next_prefix): no value there can start with the
    // prefix, so the page cannot match.  Sound under the format's
    // truncation semantics (stored min is a LOWER bound, stored max an
    // UPPER bound of the true extremes).  ci_null_counts additionally lets
    // a pruned flat page report its participating-value count without
    // decoding definition levels.
    std::vector<uint8_t> prune;
    std::vector<int64_t> ci_null_counts;
    if (!pat.prune_lo.empty() && !pat.neg) {
      std::vector<uint8_t> ci_null_pages;
      std::vector<std::string> ci_mins, ci_maxs;
      if (read_chunk_column_index(g.columns[size_t(lf.chunk_idx)],
                                  ci_null_pages, ci_mins, ci_maxs,
                                  ci_null_counts)) {
        const size_t nk = size_t(expect[size_t(j)]);
        if (ci_mins.size() != nk || ci_maxs.size() != nk)
          throw Error("ColumnIndex entry count does not match the chunk's "
                      "data pages");
        // [LO, HI): sound under truncation (stored min is a LOWER bound,
        // stored max an UPPER bound of the true extremes); empty HI means
        // no finite upper bound (only the max < LO test applies)
        const std::string& LO = pat.prune_lo;
        const std::string& HI = pat.prune_hi;
        prune.assign(nk, 0);
        for (size_t k = 0; k < nk; k++) {
          if (k < ci_null_pages.size() && ci_null_pages[k])
            continue;  // all-null pages already skip matching (nn == 0)
          if (ci_maxs[k] < LO || (!HI.empty() && ci_mins[k] >= HI))
            prune[k] = 1;
        }
        if (ci_null_counts.size() != nk) ci_null_counts.clear();
      }
    }
    // ColumnIndex null_counts replace the per-page def-level RLE parse on
    // flat optional columns (nn = num_values - null_count): the def section
    // is cursor-skipped, not decoded.  Only exercised when every per-page
    // entry is in range; DPQ_NO_CI_NN=1 forces the decode (A/B lane).
    if (lf.max_def > 0 && lf.max_rep == 0 && ci_null_counts.empty() &&
        !std::getenv("DPQ_NO_CI_NN")) {
      read_chunk_null_counts(g.columns[size_t(lf.chunk_idx)], ci_null_counts);
      if (int64_t(ci_null_counts.size()) != expect[size_t(j)])
        ci_null_counts.clear();
    }
    const bool have_ci_nn = lf.max_rep == 0 &&
                            int64_t(ci_null_counts.size()) == expect[size_t(j)];

    std::vector<Run> runs;  // reused per page
    const size_t K = pat.needles.size();
    std::vector<std::vector<uint64_t>> masks(K);  // chain candidate bitmasks

    // Chunk-level candidate sweep (uncompressed chains): ONE SIMD pass per
    // needle over the whole chunk span instead of one per 1 KB page — the
    // per-page sweeps were call/setup bound (~1.6 GB/s effective on AVX512
    // hardware).  Mask bits sit at ABSOLUTE chunk offsets; candidates inside
    // page headers / level sections are dead bits the confirm walk never
    // visits, and memoized failed confirms persist across pages (same byte
    // -> same failure).  Compressed chunks keep the per-page sweep (their
    // value sections live in per-page scratch buffers).
    // DPQ_COLD_DIRECT=1 forces the mask-free per-value chain (measurement
    // mode; ~45 ns/value on 40 B values — the mask-filtered walk below beats
    // it by ~2x on the host).
    bool direct_chain = false;
    if (const char* e = std::getenv("DPQ_COLD_DIRECT"))
      direct_chain = pat.use_chain() && e[0] == '1';
    // FILTER-NEEDLE page sweeps (chains): sample-sweep every needle over the
    // chunk's first 1 MB once, pick the rarest (fewest candidates under the
    // first-two + last byte masks), then sweep each PAGE's value section for
    // that needle only, right before walking it — the ~1 KB payload is still
    // in L1 when the boundary walk re-reads it, so the chunk streams through
    // DRAM ONCE (a chunk-wide sweep pass costs a second full-span read, and
    // the walk's length-prefix chase touches every cache line again cold).
    // The mask is a per-value EXISTENCE filter: a value without the rarest
    // needle cannot match, and a page with no candidate at all skips its
    // boundary walk entirely.  neg+indicator pages need "some value FAILS",
    // which a missing-candidate value decides immediately — they fill every
    // needle's masks and take the per-value confirm walk below.
    size_t screen_k = 0;  // filter needle (rarest by sampled candidates)
    if (pat.use_chain() && !direct_chain && K > 1 && !compressed) {
      auto t0 = tick();
      const size_t sample = std::min<size_t>(size_t(span), 1 << 20);
      std::vector<std::vector<uint64_t>> smasks(K);
      bigram_masks_multi(chunk_ptr, sample, pat.needles, smasks);
      int64_t best_pop = INT64_MAX;
      for (size_t k = 0; k < K; k++) {
        int64_t pop = 0;
        for (uint64_t w : smasks[k]) pop += __builtin_popcountll(w);
        if (pop < best_pop) {
          best_pop = pop;
          screen_k = k;
        }
      }
      if (timing) lap(ns_sweep, t0);
    }

    // Inline page-header walk FUSED into the scan: the chunk's headers are
    // parsed on the fly (they share cache lines with the payloads the sweep
    // touches), so the cold path never builds the global page index —
    // header parse + gid numbering + match walk happen in one pass.
    int64_t gid_next = gid_base[size_t(j)];
    int64_t hoff = 0, walk_values = 0, walk_rows = 0;
    const int64_t cold_pf = [] {
      const char* e = std::getenv("DPQ_COLD_PF");
      if (!e) return int64_t(4096);
      const int64_t v = std::atoll(e);
      return v == 1 ? int64_t(4096) : v;  // legacy "1" = default window
    }();
    // env reads hoisted out of the page loop (getenv is a linear environ
    // scan — per-page calls cost real milliseconds at ~78k pages)
    const bool env_multi_masks = [&] {
      const char* e = std::getenv("DPQ_COLD_SWEEP");
      return K > 1 && e && e[0] == 'm';
    }();
    const bool env_seg_mode = [&] {
      const char* e = std::getenv("DPQ_COLD_SEG");
      return !pat.exact && !pat.neg && !env_multi_masks && e && e[0] == '1';
    }();
    // GROUP sweeps (uncompressed chains): one AVX512 pass covers ~GSPAN of
    // the chunk at a time — header/level bytes inside get dead bits the
    // walk never visits, and the per-page sweep setup (vector zeroing,
    // masked tails, call overhead) amortizes across ~40 pages.  Chain
    // confirms stay find_sub-based, so only the filter needle's mask is
    // group-wide.  Negated patterns keep per-page sweeps (their per-value
    // path wants page-local masks).  Measured NEUTRAL on the 1 KB-page
    // lineitem fixture (interleaved min-of-13: 38.4 vs 37.0 ms) — the
    // per-page setup it amortizes was already small after the masked-tail
    // and getenv-hoist fixes — so it is OPT-IN (DPQ_COLD_GROUP=1).
    std::vector<uint64_t> gmask;
    int64_t gm_lo = 0, gm_hi = 0;  // chunk-offset range currently swept
    const int64_t GSPAN = 64 << 10;
    const bool group_sweeps = [&] {
      const char* e = std::getenv("DPQ_COLD_GROUP");
      return pat.use_chain() && !compressed && !pat.neg &&
             !env_multi_masks && !env_seg_mode && !direct_chain &&
             e && e[0] == '1';
    }();
    while (walk_values < cm.num_values) {
      if (hoff >= span) break;  // short chunk span: stop like the reference
      PageRec pr;
      auto th0 = timing ? tick() : std::chrono::steady_clock::time_point();
      int64_t hsz = parse_page_rec(chunk_ptr, hoff, span, chunk_start, rg,
                                   lf.chunk_idx, walk_rows, walk_values, pr);
      if (timing) lap(ns_hdr, th0);
      hoff += hsz + pr.size;
      // Look-ahead prefetch (DPQ_COLD_PF=bytes, 0 disables, default 4096):
      // pull the next pages' bytes toward L2 while this page's sweep/walk
      // runs — per-page processing stalls the HW streamer (~1 KB
      // sequential bursts), so the next page's first touch otherwise pays
      // DRAM latency; re-prefetching lines already fetched is ~free.
      if (cold_pf) {
        const int64_t pf_end = std::min<int64_t>(hoff + cold_pf, span);
        for (int64_t pf = hoff & ~63; pf < pf_end; pf += 64)
          __builtin_prefetch(chunk_ptr + pf);
      }
      if (pr.gid == 0) pr.gid = gid_next++;
      // stats-pruned PLAIN page: the ColumnIndex proves no value here can
      // start with the pattern's mandatory prefix — skip decompression, the
      // def decode (when null_counts give the participating total) and the
      // match walk.  Dict-encoded pages are never pruned: their per-entry
      // accepts already short-circuit payload walks, and their value totals
      // exclude out-of-range indices, which stats cannot see.
      bool stats_pruned = false;
      if (!prune.empty() && pr.gid >= gid_base[size_t(j)] &&
          pr.encoding == E_PLAIN &&
          prune[size_t(pr.gid - gid_base[size_t(j)])]) {
        stats_pruned = true;
        const size_t ord = size_t(pr.gid - gid_base[size_t(j)]);
        if (lf.max_rep == 0 && ord < ci_null_counts.size() &&
            ci_null_counts[ord] >= 0) {
          n_stats_pruned++;
          out.pages.push_back(
              {pr.gid, 0, int64_t(pr.num_values) - ci_null_counts[ord]});
          continue;
        }
        // null_counts absent (or nested leaf slots): fall through to the
        // def-level decode for the participating-value total, then skip
        // the match walk below.
      }
      int64_t off = pr.data_off - chunk_start;
      if (off < 0 || off + pr.size > span) throw Error("page outside chunk span");
      const uint8_t* d = chunk_ptr + off;
      size_t dlen = size_t(pr.size);
      // CI null_counts replace the def decode (flat columns): nn is known
      // without parsing the def section (also feeds the dict-miss skip).
      const int64_t ci_ord = pr.gid - gid_base[size_t(j)];
      const bool ci_nn_ok =
          have_ci_nn && ci_ord >= 0 &&
          ci_ord < int64_t(ci_null_counts.size()) &&
          ci_null_counts[size_t(ci_ord)] >= 0 &&
          ci_null_counts[size_t(ci_ord)] <= int64_t(pr.num_values);
      // Dict-miss short-circuit, stage 1 (pre-decompress): a POSITIVE
      // pattern matching ZERO dictionary entries cannot match any value of
      // a dict-encoded page.  Soundness needs two facts without decoding:
      // nn (CI null_counts) and that no index can be OUT-OF-RANGE — OOB
      // indices decode as NULL (reference drops them silently,
      // src/reader/column_reader.cpp:190-194) and would shrink the
      // participating count below nn.  (1 << idx_bw) <= dict_n proves OOB
      // impossible from the bit width alone; the width byte sits after the
      // level sections, readable in place on UNCOMPRESSED pages.
      // Compressed pages decompress first and take stage 2 below.
      const bool enc_dict_hdr =
          pr.encoding == E_PLAIN_DICTIONARY || pr.encoding == E_RLE_DICTIONARY;
      if (dict_all_miss && enc_dict_hdr && !compressed && ci_nn_ok &&
          (pr.kind == P_DATA || pr.kind == P_DATA_V2)) {
        Cursor qc(d, dlen);
        if (pr.kind == P_DATA_V2) {
          qc.bytes(size_t(pr.v2_rep_len));
          qc.bytes(size_t(pr.v2_def_len));
        } else {
          if (lf.max_rep > 0) {
            uint32_t rl = qc.le<uint32_t>();
            qc.bytes(rl);
          }
          if (lf.max_def > 0) {
            uint32_t dl = qc.le<uint32_t>();
            qc.bytes(dl);
          }
        }
        const int bw = qc.left() ? int(qc.u8()) : 255;
        if (bw < 31 && (int64_t(1) << bw) <= int64_t(dict_n)) {
          n_dict_skipped++;
          out.pages.push_back(
              {pr.gid, 0,
               int64_t(pr.num_values) - ci_null_counts[size_t(ci_ord)]});
          continue;
        }
      }
      if (compressed && (pr.kind == P_DICTIONARY || pr.kind == P_DATA)) {
        dbuf.resize(size_t(std::max<int64_t>(pr.usize, 0)));
        codec_decompress(cm.codec, d, dlen, dbuf.data(), dbuf.size());
        d = dbuf.data();
        dlen = dbuf.size();
      } else if (pr.kind == P_DATA_V2 && compressed && pr.v2_compressed) {
        // V2: level sections stored uncompressed; only values compressed
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
        dict_acc.clear();
        dict_acc.reserve(size_t(pr.num_values));
        Cursor cur(d, dlen);
        bool any_acc = false;
        for (int32_t i = 0; i < pr.num_values; i++) {
          uint32_t len = cur.le<uint32_t>();
          const uint8_t* p = cur.bytes(len);
          const bool a = cold_accept(pat, p, len);
          any_acc |= a;
          dict_acc.push_back(a ? 1 : 0);
        }
        dict_n = pr.num_values;
        // negated patterns can match through NON-accepted entries, so the
        // all-miss short-circuit is positive-only (DPQ_NO_DICT_SKIP=1
        // forces the full walk — the bench A/B lane)
        dict_all_miss = !pat.neg && dict_n > 0 && !any_acc &&
                        !std::getenv("DPQ_NO_DICT_SKIP");
        continue;
      }
      const bool v2 = pr.kind == P_DATA_V2 && pr.num_values > 0;
      if (pr.kind != P_DATA && !v2) continue;

      Cursor cur(d, dlen);
      int64_t nn = pr.num_values;
      if (v2) {
        cur.bytes(size_t(pr.v2_rep_len));  // rep levels: ignored
        if (lf.max_def > 0 && ci_nn_ok) {
          cur.bytes(size_t(pr.v2_def_len));
          nn = pr.num_values - ci_null_counts[size_t(ci_ord)];
        } else if (lf.max_def > 0) {
          auto t0 = tick();
          const uint8_t* dp = cur.bytes(size_t(pr.v2_def_len));
          runs.clear();
          rle_prescan(dp, size_t(pr.v2_def_len), def_bw, pr.num_values, runs);
          nn = count_matching(runs, dp, size_t(pr.v2_def_len), def_bw,
                              lf.max_def);
          if (timing) lap(ns_def, t0);
        } else {
          cur.bytes(size_t(pr.v2_def_len));
        }
      } else {
        // v1 spec order [rep][def] on nested columns (see dpq_prescan.hpp —
        // the reference's def-first order misparses real nested pages)
        if (lf.max_rep > 0) {
          uint32_t rep_len = cur.le<uint32_t>();
          cur.bytes(rep_len);
        }
        if (lf.max_def > 0 && ci_nn_ok) {
          uint32_t def_len = cur.le<uint32_t>();
          cur.bytes(def_len);
          nn = pr.num_values - ci_null_counts[size_t(ci_ord)];
        } else if (lf.max_def > 0) {
          auto t0 = tick();
          uint32_t def_len = cur.le<uint32_t>();
          const uint8_t* dp = cur.bytes(def_len);
          runs.clear();
          rle_prescan(dp, def_len, def_bw, pr.num_values, runs);
          nn = count_matching(runs, dp, def_len, def_bw, lf.max_def);
          if (timing) lap(ns_def, t0);
        }
      }

      if (stats_pruned) {  // def levels decoded above for the value total
        n_stats_pruned++;
        out.pages.push_back({pr.gid, 0, nn});
        continue;
      }

      const bool enc_dict =
          pr.encoding == E_PLAIN_DICTIONARY || pr.encoding == E_RLE_DICTIONARY;
      if (!enc_dict && pr.encoding != E_PLAIN)
        throw Error(std::string("cold scan: unsupported value encoding ") +
                    std::to_string(pr.encoding) +
                    " (callers fall back to the prescan path)");
      int64_t accepted = 0;   // pre-negation accepts among finalized values
      int64_t values = nn;    // participating values

      if (enc_dict) {
        int idx_bw = cur.u8();
        // Dict-miss short-circuit, stage 2 (post-decompress): the width
        // check proves no OOB index is expressible, so the participating
        // count is exactly nn and zero accepted entries means zero
        // matches — the index-run walk drops out.
        if (dict_all_miss && idx_bw < 31 &&
            (int64_t(1) << idx_bw) <= int64_t(dict_n)) {
          n_dict_skipped++;
          out.pages.push_back({pr.gid, 0, nn});
          continue;
        }
        int64_t vlen = int64_t(cur.left());
        const uint8_t* vp = cur.bytes(size_t(vlen));
        runs.clear();
        rle_prescan(vp, size_t(vlen), idx_bw, nn, runs);
        int64_t in_range = 0;
        for (const Run& rn : runs) {
          if (rn.kind == 0) {
            if (rn.value >= 0 && rn.value < dict_n) {
              in_range += rn.count;
              if (dict_acc[size_t(rn.value)]) accepted += rn.count;
            }
          } else {
            for (int32_t i = 0; i < rn.count; i++) {
              uint32_t v =
                  bits_at(vp, size_t(vlen), rn.bitoff + int64_t(i) * idx_bw,
                          idx_bw);
              if (v < uint32_t(dict_n)) {
                in_range++;
                if (dict_acc[v]) accepted++;
              }
            }
          }
        }
        values = in_range;
        // dict pages: counts are over in-range values only (OOB == NULL)
        int64_t counts = pat.neg ? in_range - accepted : accepted;
        if (!pat.exact) counts = counts > 0 ? 1 : 0;
        out.pages.push_back({pr.gid, counts, values});
        continue;
      }

      // PLAIN page: length-prefix walk over the value section.
      int64_t vlen = int64_t(cur.left());
      const uint8_t* vp = cur.bytes(size_t(vlen));

      if (direct_chain && nn > 0) {
        auto t0 = tick();
        int64_t vlen2 = vlen;
        const uint8_t* vp2 = vp;
        int64_t pos = 0;
        if (timing) n_vals += nn;
        for (int64_t v = 0; v < nn; v++) {
          if (pos + 4 > vlen2) break;  // prefix never finalizes
          uint32_t len;
          std::memcpy(&len, vp2 + pos, 4);
          if (pos + 4 + int64_t(len) > vlen2) break;  // bytes never finalize
          if (chain_match(pat.needles, vp2 + pos + 4, len)) {
            accepted++;
            if (!pat.exact && !pat.neg) break;
          } else if (!pat.exact && pat.neg) {
            accepted = 0;
            break;
          }
          pos += 4 + int64_t(len);
        }
        if (timing) lap(ns_walk, t0);
        int64_t counts = pat.neg ? nn - accepted : accepted;
        if (!pat.exact) counts = counts > 0 ? 1 : 0;
        out.pages.push_back({pr.gid, counts, nn});
        continue;
      }

      if (pat.use_chain() && nn > 0) {
        // Page-local SIMD bigram-mask sweep (pure compare+store) right
        // before the boundary walk — the payload is hot in cache for both.
        // Rarest needle first: no candidate anywhere → the page cannot
        // contain a matching value and skips its walk entirely.  The walk
        // consumes mask bits lazily — greedy earliest CONFIRMED occurrence
        // == the bitap register semantics — memoizing failed confirms by
        // clearing their bits.
        auto t0 = tick();
        const bool neg_ind = pat.neg && !pat.exact;
        constexpr int64_t mbase = 0;  // masks are page-local (vp-relative)
        bool possible = true;
        // Sweep strategy (DPQ_COLD_SWEEP=single|multi overrides): `multi`
        // fills EVERY needle's mask in one fused pass (chain confirms then
        // run on mask bits alone, and any empty mask screens the page);
        // `single` sweeps only the filter needle (the other needles
        // confirm by find_sub inside each candidate's split ranges).
        // Multi pays ~K mask stores + extra compares per block; single
        // pays byte scans per candidate.  Measured on the lineitem bench
        // fixture (2026-08-21, interleaved min-of-9): single wins for
        // K=2 (31.8 vs 35.4 ms) and K=3 (33.5 vs 42.8 ms) — the extra
        // mask planes cost more than the short split-range find_subs they
        // replace — so single is the default.
        const bool multi_masks = env_multi_masks;
        // Indicator-positive pages decide at their FIRST accepting value,
        // so the sweep can be LAZY there (DPQ_COLD_SEG=1): one 512 B
        // segment at a time inside the walk below — a decided page never
        // touches its tail bytes.  Off by default: on the lineitem bench
        // fixture per-value match density (~1.6%) means most pages sweep
        // nearly fully anyway (measured neutral, min 43.8 vs 43.2 ms in
        // the same interleaved run); it pays on match-DENSE columns where
        // the first accepting value sits early in every page.
        const bool seg_mode = env_seg_mode;
        int64_t mb = 0;                 // bit offset of vp[0] in the mask
        const uint64_t* wk = nullptr;   // filter-needle mask words
        int64_t wnb = 0;                // mask word count
        if (group_sweeps) {
          const int64_t vp_off = vp - chunk_ptr;
          if (vp_off < gm_lo || vp_off + vlen > gm_hi || gmask.empty()) {
            gm_lo = vp_off & ~int64_t(63);
            gm_hi = std::min(span, std::max(gm_lo + GSPAN,
                                            (vp_off + vlen + 63)
                                                & ~int64_t(63)));
            gmask.resize(size_t((gm_hi - gm_lo + 63) >> 6));
            bigram_masks_into(chunk_ptr + gm_lo, 0, gm_hi - gm_lo,
                              pat.needles[screen_k], gmask.data());
          }
          mb = vp_off - gm_lo;
          wk = gmask.data();
          wnb = int64_t(gmask.size());
          uint64_t any = 0;
          const int64_t b0 = mb >> 6;
          const int64_t b1 = std::min(wnb - 1, (mb + vlen) >> 6);
          for (int64_t b = b0; b <= b1; b++) {
            uint64_t w = wk[b];
            if (b == b0 && (mb & 63)) w &= ~0ull << (mb & 63);
            if (b == b1) {
              const int64_t endbit = mb + vlen - (b << 6);
              if (endbit >= 0 && endbit < 64)
                w &= endbit ? ((1ull << endbit) - 1) : 0;
            }
            any |= w;
          }
          possible = any != 0;
        } else if (seg_mode) {
          masks[screen_k].assign(size_t((vlen + 63) >> 6), 0);
        } else if (!multi_masks) {
          bigram_masks(vp, size_t(vlen), pat.needles[screen_k],
                       masks[screen_k]);
          uint64_t any = 0;
          for (uint64_t w : masks[screen_k]) any |= w;
          possible = any != 0;
        } else {
          bigram_masks_multi(vp, size_t(vlen), pat.needles, masks);
          for (size_t k = 0; k < K && possible; k++) {
            uint64_t any = 0;
            for (uint64_t w : masks[k]) any |= w;
            possible = any != 0;
          }
        }
        if (timing && !seg_mode) (possible ? n_walked : n_screened)++;
        if (possible && !neg_ind) {
          // BIT-DRIVEN walk: iterate the filter needle's candidate bits in
          // this value section (ascending) and chase value boundaries
          // lazily up to each candidate — values without the rarest needle
          // (the common case) are chased past at ~5 ns each with no mask or
          // match work at all.  Each candidate is confirmed ANCHORED at its
          // bit (the mask proved the first two + last bytes; only the
          // middle bytes need a memcmp) and the remaining needles chain in
          // the split ranges [value_start, p] / [p + len, value_end) — the
          // full-value chain_match re-search (memchr from the value start,
          // expensive on text where the needle's first byte is dense) drops
          // out.  A value matches iff SOME confirmed candidate of the
          // filter needle splits it this way (any full chain contains a
          // true filter-needle occurrence, and greedy earliest chaining in
          // each half is exchange-optimal), so accepting on the first
          // working candidate and skipping the value's remaining bits is
          // exact.  (The neg+indicator mode needs "some value fails",
          // which non-candidate values decide implicitly — it keeps the
          // per-value path below.)
          if (timing) { lap(ns_sweep, t0); t0 = tick(); }
          if (wk == nullptr) {  // page-local modes (seg / single / multi)
            wk = masks[screen_k].data();
            wnb = int64_t(masks[screen_k].size());
          }
          const std::string& ndk = pat.needles[screen_k];
          const int64_t lk = int64_t(ndk.size());
          const uint8_t* ndk_p = reinterpret_cast<const uint8_t*>(ndk.data());
          // first confirmed candidate of needle k2 in [from, last_start]
          // (bit-skipping on its own mask + middle-byte memcmp; failed
          // confirms memoize by clearing their bit — same byte, same
          // failure, page-wide)
          auto next_conf = [&](size_t k2, int64_t from,
                               int64_t last_start) -> int64_t {
            if (from > last_start) return -1;
            const std::string& nd2 = pat.needles[k2];
            const size_t nl = nd2.size();
            auto& mk2 = masks[k2];
            const int64_t nb2 = int64_t(mk2.size());
            int64_t b2 = from >> 6;
            const int64_t bhi = last_start >> 6;
            uint64_t w2 =
                b2 < nb2 ? mk2[size_t(b2)] & (~0ull << (from & 63)) : 0;
            for (;;) {
              while (!w2) {
                if (++b2 > bhi || b2 >= nb2) return -1;
                w2 = mk2[size_t(b2)];
              }
              const int64_t q2 = b2 * 64 + __builtin_ctzll(w2);
              if (q2 > last_start) return -1;
              if (nl <= 3 ||
                  ::memcmp(vp + q2 + 2, nd2.data() + 2, nl - 3) == 0)
                return q2;
              const uint64_t low = w2 & (~w2 + 1);
              mk2[size_t(b2)] &= ~low;
              w2 &= ~low;
            }
          };
          if (timing) n_vals += nn;
          int64_t pos = 0, v = 0;        // prefix-chase cursor
          int64_t cur_a = -1, cur_b = -1;  // current value byte range
          int64_t done_b = -1;            // end of the last ACCEPTED value
          bool chased_out = false;        // prefix/bytes never finalize
          bool decided = false;
          // Lazy segment sweep (seg_mode): fill the filter needle's mask
          // one 64-aligned 512 B segment at a time and walk its bits; a
          // decision stops the page before its tail bytes are ever read.
          // The sweep window extends past the segment by the needle's
          // filter span so boundary-straddling candidates land in the
          // NEXT segment's words (rewritten before they are consumed).
          constexpr int64_t SEG = 512;
          const int64_t lo_scr = lk > 2 ? lk - 1 : 0;
          int64_t seg_lo = 0;
          bool any_bits = false;
          const int64_t mb_lo = mb >> 6;
          while (!decided) {
          int64_t blk_lo = mb_lo;
          int64_t blk_hi = std::min<int64_t>(wnb - 1, (mb + vlen) >> 6);
          if (seg_mode) {
            if (seg_lo >= vlen) break;
            const int64_t seg_hi = std::min<int64_t>(seg_lo + SEG, vlen);
            const int64_t win_hi = std::min<int64_t>(seg_hi + lo_scr + 1,
                                                     vlen);
            bigram_masks_into(vp, seg_lo, win_hi, ndk,
                              masks[screen_k].data());
            blk_lo = seg_lo >> 6;
            blk_hi = (seg_hi - 1) >> 6;
            seg_lo = seg_hi;
          }
          for (int64_t blk = blk_lo; blk <= blk_hi && !decided; blk++) {
            uint64_t w = wk[size_t(blk)];
            if (blk == mb_lo && (mb & 63)) w &= ~0ull << (mb & 63);
            if (w) any_bits = true;
            while (w && !decided) {
              const int64_t p = (blk << 6 | __builtin_ctzll(w)) - mb;
              w &= w - 1;
              if (p >= vlen) break;
              if (p < done_b) continue;  // value already accepted
              if (p >= cur_b) {
                // chase forward to the value containing p
                while (v < nn) {
                  if (pos + 4 > vlen) { chased_out = true; break; }
                  uint32_t len;
                  std::memcpy(&len, vp + pos, 4);
                  cur_a = pos + 4;
                  cur_b = cur_a + int64_t(len);
                  if (cur_b > vlen) { chased_out = true; break; }
                  pos = cur_b;
                  v++;
                  if (p < cur_b) break;
                }
                if (chased_out || v > nn) { decided = true; break; }
              }
              if (p < cur_a || p > cur_b - lk) continue;  // dead bit
              // anchored confirm: the mask proved bytes 0,1 and lk-1 —
              // only the middle [2, lk-1) needs checking
              if (lk > 3 &&
                  std::memcmp(vp + p + 2, ndk_p + 2, size_t(lk - 3)) != 0)
                continue;
              // chain the needles before the filter needle in [cur_a, p)
              // (each occurrence must fit fully before p) and the ones
              // after it in [p + lk, cur_b) — on their own candidate masks
              // (bit skips + middle memcmp) when multi-swept, by find_sub
              // byte scan otherwise
              bool m = true;
              int64_t q = cur_a;
              for (size_t k2 = 0; k2 < screen_k && m; k2++) {
                const std::string& nd2 = pat.needles[k2];
                const int64_t l2 = int64_t(nd2.size());
                if (multi_masks) {
                  const int64_t hit = next_conf(k2, q, p - l2);
                  if (hit < 0) m = false;
                  else q = hit + l2;
                } else {
                  const uint8_t* f = find_sub(
                      vp + q, size_t(p - q),
                      reinterpret_cast<const uint8_t*>(nd2.data()),
                      nd2.size());
                  if (!f) m = false;
                  else q = int64_t(f - vp) + l2;
                }
              }
              if (m) {
                q = p + lk;
                for (size_t k2 = screen_k + 1; k2 < K && m; k2++) {
                  const std::string& nd2 = pat.needles[k2];
                  const int64_t l2 = int64_t(nd2.size());
                  if (multi_masks) {
                    const int64_t hit = next_conf(k2, q, cur_b - l2);
                    if (hit < 0) m = false;
                    else q = hit + l2;
                  } else {
                    const uint8_t* f = find_sub(
                        vp + q, size_t(cur_b - q),
                        reinterpret_cast<const uint8_t*>(nd2.data()),
                        nd2.size());
                    if (!f) m = false;
                    else q = int64_t(f - vp) + l2;
                  }
                }
              }
              if (m) {
                accepted++;
                done_b = cur_b;  // value decided — skip its remaining bits
                if (!pat.exact) { decided = true; break; }  // survivor known
              }
            }
          }
          if (!seg_mode) break;
          }
          if (timing && seg_mode) (any_bits ? n_walked : n_screened)++;
          if (timing) lap(ns_walk, t0);
          int64_t counts = pat.neg ? nn - accepted : accepted;
          if (!pat.exact) counts = counts > 0 ? 1 : 0;
          out.pages.push_back({pr.gid, counts, nn});
          continue;
        }
        // per-value confirm walk (neg+indicator, or screened-out pages):
        // needs every needle's masks — already filled when multi-swept;
        // the single-sweep route fills the rest here.  A needle with no
        // candidate anywhere decides the page immediately (every value
        // fails the chain).
        if (!multi_masks)
          for (size_t k = 0; k < K && possible; k++) {
            if (k == screen_k) continue;  // already swept
            bigram_masks(vp, size_t(vlen), pat.needles[k], masks[k]);
            uint64_t any = 0;
            for (uint64_t w : masks[k]) any |= w;
            possible = any != 0;
          }
        auto& msel = masks;
        if (timing) {
          lap(ns_sweep, t0);
          t0 = tick();
        }
        if (possible) {
          const int64_t nb = int64_t(msel[0].size());
          // first confirmed candidate of needle k in [from, last_start]
          // (vp-relative; mask bits live at mbase + rel)
          auto next_conf = [&](size_t k, int64_t from,
                               int64_t last_start) -> int64_t {
            if (from > last_start) return -1;
            const std::string& nd = pat.needles[k];
            const size_t nl = nd.size();
            auto& mk = msel[k];
            const int64_t afrom = mbase + from;
            const int64_t alast = mbase + last_start;
            int64_t blk = afrom >> 6;
            const int64_t blk_hi = alast >> 6;
            uint64_t w =
                blk < nb ? mk[size_t(blk)] & (~0ull << (afrom & 63)) : 0;
            for (;;) {
              while (!w) {
                if (++blk > blk_hi || blk >= nb) return -1;
                w = mk[size_t(blk)];
              }
              const int64_t pos = blk * 64 + __builtin_ctzll(w);
              if (pos > alast) return -1;
              if (nl <= 2 ||
                  ::memcmp(vp + (pos - mbase) + 2, nd.data() + 2, nl - 2) == 0)
                return pos - mbase;
              const uint64_t low = w & (~w + 1);
              mk[size_t(blk)] &= ~low;  // memoize failed confirm
              w &= ~low;
            }
          };
          int64_t pos = 0;
          if (timing) n_vals += nn;
          for (int64_t v = 0; v < nn; v++) {
            if (pos + 4 > vlen) break;  // prefix never finalizes
            uint32_t len;
            std::memcpy(&len, vp + pos, 4);
            const int64_t a = pos + 4;
            const int64_t b = a + int64_t(len);
            if (b > vlen) break;  // bytes never finalize
            int64_t need = a;
            bool m = true;
            for (size_t k = 0; k < K; k++) {
              const int64_t lk = int64_t(pat.needles[k].size());
              const int64_t hit = next_conf(k, need, b - lk);
              if (hit < 0) {
                m = false;
                break;
              }
              need = hit + lk;
            }
            if (m) {
              accepted++;
              if (!pat.exact && !pat.neg) break;  // survivor decided
            } else if (!pat.exact && pat.neg) {
              accepted = 0;  // ensure nn - accepted > 0 ==> indicator 1
              break;
            }
            pos = b;
          }
        }
        if (timing) lap(ns_walk, t0);
        int64_t counts = pat.neg ? nn - accepted : accepted;
        if (!pat.exact) counts = counts > 0 ? 1 : 0;
        out.pages.push_back({pr.gid, counts, nn});
        continue;
      }

      // DFA mode (or empty page): per-value table walk.
      if (nn > 0) {
        int64_t pos = 0;
        for (int64_t v = 0; v < nn; v++) {
          if (pos + 4 > vlen) break;  // prefix never finalizes
          uint32_t len;
          std::memcpy(&len, vp + pos, 4);
          if (pos + 4 + int64_t(len) > vlen) break;  // bytes never finalize
          if (len == 0 ? pat.accept_empty()
                       : cold_accept(pat, vp + pos + 4, len)) {
            accepted++;
            if (!pat.exact && !pat.neg) break;  // survivor decided
          } else if (!pat.exact && pat.neg) {
            accepted = 0;  // indicator: some value fails the accept
            break;
          }
          pos += 4 + int64_t(len);
        }
      }
      int64_t counts = pat.neg ? nn - accepted : accepted;
      if (!pat.exact) counts = counts > 0 ? 1 : 0;
      out.pages.push_back({pr.gid, counts, nn});
    }
    // gid soundness: the walk's own data-page count must match the base
    // source (OffsetIndex / count-only walk), or every later gid is shifted.
    if (gid_next - gid_base[size_t(j)] != expect[size_t(j)])
      throw Error("cold scan: chunk data-page count mismatch vs offset index"
                  " (corrupt page index?)");
  });

  if (timing)
    std::fprintf(stderr,
                 "[cold_scan] hdr: %.1f ms  def: %.1f ms  sweep: %.1f ms  "
                 "walk: %.1f ms (thread-summed)  screened %lld walked %lld "
                 "vals %lld\n",
                 double(ns_hdr.load()) / 1e6, double(ns_def.load()) / 1e6,
                 double(ns_sweep.load()) / 1e6, double(ns_walk.load()) / 1e6,
                 (long long)n_screened.load(), (long long)n_walked.load(),
                 (long long)n_vals.load());

  int64_t n_pages = 0;
  for (const auto& r : rg_out) n_pages += int64_t(r.pages.size());

  auto store = std::make_unique<ArrayStore>();
  store->dims["n_pages"] = n_pages;
  store->dims["stats_pruned_pages"] = n_stats_pruned.load();
  store->dims["dict_skipped_pages"] = n_dict_skipped.load();
  auto* a_gid = store->alloc<int64_t>("page_gid", {n_pages});
  auto* a_cnt = store->alloc<int64_t>("match_counts", {n_pages});
  auto* a_val = store->alloc<int64_t>("value_counts", {n_pages});
  int64_t at = 0;
  for (const auto& r : rg_out)
    for (const PageOut& p : r.pages) {
      a_gid[at] = p.gid;
      a_cnt[at] = p.counts;
      a_val[at] = p.values;
      at++;
    }
  return store;
}

}  // namespace dpq
