// Table-DFA walk for Hopper (sm_90a): kernel K3, two entry points.
//
// Replaces the JAX package's device walk of every pattern outside the
// register-machine family: duckdb_parquet_parser_tpu/ops/mxu_dfa.py::
// make_transition (a byte-class one-hot matmul over [T | A] on the matrix
// unit) inside the lax.scan of ops/strings.py::_match_stream_multi (the page
// walk, reached from match_payload_stream), and the lax.scan of
// ops/scan.py::dfa_match (the per-value walk).  No Pallas kernel stood there;
// the one-hot existed only because gathers are slow on that machine.  Here a
// transition is a table load.
//
// The table is data, not generated code, so one build serves every pattern.
// Layout (ops/kernels/dfa_walk.pack_table): 256 bytes of byte -> class map,
// then the [S, C] class table as uint16, each entry the next state in bits
// 0-14 and that state's accept bit in bit 15 (the [T | A] pair as one word:
// one load gives both), padded to a multiple of 16 bytes.  Up to 64 states,
// a block folds it in shared memory into a byte-indexed table whose entries
// are the shared-memory address of the next state's row (rows of 257 words:
// 256 bytes, then the state's accept; an odd row length spreads the states'
// rows over the banks), so a byte is one dependent shared load.  Larger
// automata walk the packed table (class, then entry), staged in shared
// memory or read from device memory by the wrapper's occupancy rule.
//
// dpq_dfa_stream (the page walk).  One thread per lane (a page or a split
// segment) over the resident [chunks, n, 16] u8 stream of K1
// (stream_matcher.chunk_stream); hits[lane], seen[lane] int32.  The value
// boundaries are K1's: a 4-byte little-endian length prefix (through
// uint32_t: its last byte reaches bit 31), then the value's bytes; the state
// resets at each value, a zero-length value adds accept[0], a value cut by
// min(plen, steps) adds nothing, and the lane stops once nn values are seen.
// What bounds it: the stream's bytes, read once; what sets its pace is the
// table's loads, one a byte on a dependent chain, a lane a thread, and the
// control between them.  So:
//  * the boundary control is off the byte path: a thread walks each 16-byte
//    chunk of its lane once, fully unrolled, each byte at a constant
//    position and predicated on masks of the bytes that lie in the value
//    going on from the chunk before (A) and in the one starting in this
//    chunk (B), two independent chains of loads; a boundary (accept, count,
//    the next prefix, which may straddle two chunks, reset) runs once a
//    value, and the walk skips a value that cannot end inside the lane (a
//    chunk in which B ends too is walked again for the value after it);
//  * a thread holds chunks i to i + 2 in registers (a prefix straddles into
//    i + 1) and loads chunk i + 3 when it moves on, from the L2, which it
//    asked for that chunk three chunks before;
//  * the grid is one block an SM (the wrapper passes the blocks the SMs
//    hold), each block a contiguous run of the length-sorted lanes in whole
//    warps, so the table is staged once an SM and a warp's lanes stop
//    together; past 1,024 lanes a block, its threads take every
//    (grid x block)-th lane.
//
// dpq_dfa_values (the per-value walk).  chars [L, P] u8, one row per value,
// zero-padded; for j < min(len, P): state = T[state, chars[j]]; out =
// accept[state].  What bounds it: the bytes of the rows, which must come
// from device memory once, and the table's loads, one a byte, whose bank
// conflicts keep the shared-memory pipe busy for about half as long.  So:
//  * a persistent grid (the blocks the SMs hold at once); a block stages
//    the table once, then each thread walks every stride-th row;
//  * a row is walked in windows of 64 bytes held in registers, and a
//    thread loads its next window (the next row's first, or this row's
//    next) before it walks this one: the loads of 32 neighbouring rows lie
//    in 32 * P contiguous bytes, and the next row's length is loaded with
//    its bytes, so no load waits on another.  A window is loaded whole up
//    to the pitch (16-, 8-, 4- or 1-byte loads, the largest that divides
//    the pitch and the address of chars): reading a row's last sector past
//    its length costs less than the requests cut at the length would;
//  * with the folded table a byte is byte extract, address (one add), the
//    dependent shared load and the length test.
// A tile ring in shared memory, filled by cp.async (32 rows a warp), was
// measured and lost: its copies share the shared-memory pipe that the table
// loads already hold.  The wrapper picks where the table sits by the same
// occupancy rule as the page walk, and passes the grid.
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

struct dpq_chunk { uint64_t lo, hi; };  // bytes 0-7 and 8-15, little-endian

// The per-value walk's window and table modes.
#define DPQ_WINDOW 64           // bytes of a row a thread holds at once
#define DPQ_FOLD_ROW 257        // words a folded state row: 256 bytes, accept
#define DPQ_FOLD_ROW_BYTES (4 * DPQ_FOLD_ROW)
#define DPQ_FOLD_MAX_STATES 64  // 65,792 bytes of folded table
enum { DPQ_FOLDED = 0, DPQ_PACKED_SHARED = 1, DPQ_PACKED_GLOBAL = 2 };

#ifdef __CUDACC__
__device__ __forceinline__ dpq_chunk dpq_load_chunk(const uint8_t* __restrict__ p)
{
    const ulonglong2 w = __ldg((const ulonglong2*)p);
    dpq_chunk c;
    c.lo = w.x;
    c.hi = w.y;
    return c;
}

// LDG: the table lies in device memory (read through the read-only cache);
// otherwise it was staged in shared memory.
template <bool LDG>
__device__ __forceinline__ uint32_t dpq_class(const uint8_t* __restrict__ m,
                                              int32_t c)
{
    return LDG ? __ldg(m + c) : m[c];
}

template <bool LDG>
__device__ __forceinline__ uint32_t dpq_entry(const uint16_t* __restrict__ t,
                                              int32_t i)
{
    return LDG ? __ldg(t + i) : t[i];
}
#else
#define __device__
#define __forceinline__ inline
static inline dpq_chunk dpq_load_chunk(const uint8_t* p)
{
    dpq_chunk c;
    memcpy(&c, p, 16);
    return c;
}

template <bool LDG>
static inline uint32_t dpq_class(const uint8_t* m, int32_t c) { return m[c]; }

template <bool LDG>
static inline uint32_t dpq_entry(const uint16_t* t, int32_t i) { return t[i]; }
#endif

// ── the per-value walk's pieces, shared by the kernel and the host build ──

// The bytes one load of a window moves: the largest of 16, 8, 4 that
// divides both the pitch and the address of chars, else 1.
static inline int32_t dpq_piece_bytes(int32_t pitch, const void* chars)
{
    const uintptr_t a = (uintptr_t)chars | (uintptr_t)pitch;
    return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 1;
}

// The bytes of a row that its walk reads: min(len, pitch), 0 below 0.
__device__ __forceinline__ int32_t dpq_row_lim(int32_t len, int32_t pitch)
{
    return len < 0 ? 0 : len < pitch ? len : pitch;
}

// The bytes of window w that lie in the row.
__device__ __forceinline__ int32_t dpq_window_bytes(int32_t pitch, int32_t w)
{
    const int32_t left = pitch - DPQ_WINDOW * w;
    return left < DPQ_WINDOW ? left : DPQ_WINDOW;
}

// Bytes of the folded table of `n_states` states (a multiple of 16).
static inline int32_t dpq_fold_bytes(int32_t n_states)
{
    return (DPQ_FOLD_ROW_BYTES * n_states + 15) & ~15;
}

// The folded table's entry for the packed entry e: the address of the next
// state's row, `fold` being the table's own address (on the card a
// shared-memory address, so a byte costs one load and no base add; on the
// host 0, an offset); *next gets that state.
__device__ __forceinline__ uint32_t dpq_fold_entry(uint32_t e, uint32_t fold,
                                                   uint32_t* next)
{
    *next = e & 0x7fffu;
    return fold + *next * DPQ_FOLD_ROW_BYTES;
}

// Byte J of a 16-byte chunk (J a constant), zero-extended.
template <int J>
__device__ __forceinline__ uint32_t dpq_chunk_byte(const dpq_chunk& q)
{
    return (uint32_t)(((J < 8 ? q.lo : q.hi) >> (8 * (J & 7))) & 0xffu);
}

// The folded walk's step for byte J of a chunk whose bytes from `left` on
// lie past the value: st = the word at st + 4 * b, where J < left.
#ifdef __CUDACC__
template <int J>
__device__ __forceinline__ void dpq_fold_step(uint32_t& st, uint32_t b,
                                              int32_t left, const uint8_t*)
{
    asm("{\n\t.reg .pred p;\n\tsetp.gt.s32 p, %2, %3;\n\t"
        "@p ld.shared.u32 %0, [%1];\n\t}"
        : "+r"(st) : "r"(st + 4 * b), "r"(left), "n"(J));
}

__device__ __forceinline__ uint32_t dpq_fold_word(const uint8_t*, uint32_t at)
{
    uint32_t v;
    asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(at));
    return v;
}
#else
template <int J>
static inline void dpq_fold_step(uint32_t& st, uint32_t b, int32_t left,
                                 const uint8_t* fold)
{
    if (J < left) memcpy(&st, fold + st + 4 * b, 4);
}

static inline uint32_t dpq_fold_word(const uint8_t* fold, uint32_t at)
{
    uint32_t v;
    memcpy(&v, fold + at, 4);
    return v;
}
#endif

// One byte b of a value under the packed table: `st` the state, `acc` the
// accept of its last entry.
template <bool LDG>
__device__ __forceinline__ void dpq_packed_step(
    uint32_t b, uint32_t& st, uint32_t& acc, const uint8_t* __restrict__ table,
    int32_t n_classes)
{
    const uint32_t e = dpq_entry<LDG>(
        (const uint16_t*)(table + 256),
        (int32_t)st * n_classes + (int32_t)dpq_class<LDG>(table, (int32_t)b));
    st = e & 0x7fffu;
    acc = e >> 15;
}

// The accept of a value whose walk ended in `st` (folded: its row's
// address).
template <int MODE>
__device__ __forceinline__ uint32_t dpq_value_accept(
    uint32_t st, uint32_t acc, const uint8_t* __restrict__ table)
{
    return MODE == DPQ_FOLDED ? dpq_fold_word(table, st + 4 * 256) : acc;
}

template <int J, int MODE>
__device__ __forceinline__ void dpq_chunk_step(
    const dpq_chunk& q, int32_t left, uint32_t& st, uint32_t& acc,
    const uint8_t* __restrict__ table, int32_t n_classes)
{
    if constexpr (MODE == DPQ_FOLDED) {
        dpq_fold_step<J>(st, dpq_chunk_byte<J>(q), left, table);
    } else {
        if (J < left)
            dpq_packed_step<MODE == DPQ_PACKED_GLOBAL>(
                dpq_chunk_byte<J>(q), st, acc, table, n_classes);
    }
    if constexpr (J < 15)
        dpq_chunk_step<J + 1, MODE>(q, left, st, acc, table, n_classes);
}

// PIECE bytes at p, zero-extended (PIECE 1, 4 or 8).
#ifdef __CUDACC__
template <int PIECE>
__device__ __forceinline__ uint64_t dpq_load_piece(const uint8_t* __restrict__ p)
{
    if constexpr (PIECE == 8) return __ldg((const unsigned long long*)p);
    if constexpr (PIECE == 4) return __ldg((const unsigned int*)p);
    return __ldg(p);
}
#else
template <int PIECE>
static inline uint64_t dpq_load_piece(const uint8_t* p)
{
    uint64_t v = 0;
    memcpy(&v, p, PIECE);
    return v;
}
#endif

// A window into registers: bytes [0, avail) of p (avail <= DPQ_WINDOW, a
// multiple of PIECE), zeros after them.
template <int PIECE>
__device__ __forceinline__ void dpq_load_window(const uint8_t* __restrict__ p,
                                                int32_t avail, dpq_chunk* q)
{
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int32_t k = 0; k < DPQ_WINDOW / 16; ++k) {
        q[k].lo = q[k].hi = 0;
        if constexpr (PIECE == 16) {
            if (16 * k < avail) q[k] = dpq_load_chunk(p + 16 * k);
        } else {
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int32_t j = 0; j < 16; j += PIECE) {
                if (16 * k + j >= avail) continue;
                const uint64_t v = dpq_load_piece<PIECE>(p + 16 * k + j);
                if (j < 8)
                    q[k].lo |= v << (8 * j);
                else
                    q[k].hi |= v << (8 * (j - 8));
            }
        }
    }
}

// Walks bytes [0, nb) of a window (nb may pass its end: the walk stops
// there).  The folded table's `table` is its base (host) or unused (card:
// the entries are shared-memory addresses).
template <int MODE>
__device__ __forceinline__ void dpq_walk_window(
    const dpq_chunk* q, int32_t nb, uint32_t& st, uint32_t& acc,
    const uint8_t* __restrict__ table, int32_t n_classes)
{
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int32_t k = 0; k < DPQ_WINDOW / 16; ++k)
        if (16 * k < nb)
            dpq_chunk_step<0, MODE>(q[k], nb - 16 * k, st, acc, table,
                                    n_classes);
}

// ── the page walk's pieces, shared by the kernel and the host build ──

#define DPQ_PREFETCH 3  // chunks a lane asks the L2 for ahead of its loads

// Byte J of a 16-byte chunk (J a constant), zero-extended: one byte
// permute of the word that holds it.
template <int J>
__device__ __forceinline__ uint32_t dpq_page_byte(const dpq_chunk& q)
{
    const uint64_t h = J < 8 ? q.lo : q.hi;
    const uint32_t w = (J & 4) ? (uint32_t)(h >> 32) : (uint32_t)h;
#ifdef __CUDACC__
    return __byte_perm(w, 0, 0x4440 + (J & 3));
#else
    return (w >> (8 * (J & 3))) & 0xffu;
#endif
}

// Asks the L2 for the 16 bytes at p (a no-op on the host).
__device__ __forceinline__ void dpq_prefetch(const uint8_t* p)
{
#ifdef __CUDACC__
    asm volatile("prefetch.global.L2 [%0];" : : "l"(p));
#else
    (void)p;
#endif
}

// The 4-byte little-endian length prefix at byte k (0 to 16) of the 32
// bytes cur, then nxt.
__device__ __forceinline__ uint32_t dpq_prefix(const dpq_chunk& cur,
                                               const dpq_chunk& nxt,
                                               int32_t k)
{
    const uint64_t a = k < 8 ? cur.lo : k < 16 ? cur.hi : nxt.lo;
    const uint64_t b = k < 8 ? cur.hi : k < 16 ? nxt.lo : nxt.hi;
    const int32_t s = 8 * (k & 7);
    return (uint32_t)(s ? (a >> s) | (b << (64 - s)) : a);
}

// The folded walk's step for byte J of a chunk, taken where bit J of `mask`
// is set: st = the word at st + 4 * b (a volatile load with a memory
// clobber: it reads the table the block staged).
#ifdef __CUDACC__
template <int J>
__device__ __forceinline__ void dpq_fold_step_masked(uint32_t& st, uint32_t b,
                                                     uint32_t mask,
                                                     const uint8_t*)
{
    asm volatile("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
                 "and.b32 t, %2, %3;\n\tsetp.ne.b32 p, t, 0;\n\t"
                 "@p ld.shared.u32 %0, [%1];\n\t}"
                 : "+r"(st) : "r"(st + 4 * b), "r"(mask), "n"(1 << J)
                 : "memory");
}
#else
template <int J>
static inline void dpq_fold_step_masked(uint32_t& st, uint32_t b,
                                        uint32_t mask, const uint8_t* fold)
{
    if (mask >> J & 1) memcpy(&st, fold + st + 4 * b, 4);
}
#endif

// The bytes of a value [vs, ve) in the chunk at c0, as a mask.
__device__ __forceinline__ uint32_t dpq_value_mask(int32_t vs, int32_t ve,
                                                   int32_t c0)
{
    const int32_t lo = vs - c0 < 0 ? 0 : vs - c0 < 16 ? vs - c0 : 16;
    const int32_t hi = ve - c0 < 16 ? ve - c0 : 16;
    return (1u << hi) - (1u << lo);
}

// The next chunk of a lane: cur, nxt and ahead move on by one, the chunk
// after them is loaded and the L2 asked for the one DPQ_PREFETCH further.
__device__ __forceinline__ void dpq_advance(
    int32_t& c0, dpq_chunk& cur, dpq_chunk& nxt, dpq_chunk& ahead,
    const uint8_t* p, long long pitch, int32_t n_chunks)
{
    c0 += 16;
    cur = nxt;
    nxt = ahead;
    const int32_t next = (c0 >> 4) + 2;
    if (next < n_chunks) ahead = dpq_load_chunk(p + next * pitch);
    if (next + DPQ_PREFETCH < n_chunks)
        dpq_prefetch(p + (next + DPQ_PREFETCH) * pitch);
}

// Bytes J to 15 of chunk q for two values at once, each byte at a constant
// position: value A's where bit J of ma is set, value B's where bit J of mb
// is (two independent chains of loads, so the chunk in which one value ends
// and the next starts is walked once).
template <int J, int MODE>
__device__ __forceinline__ void dpq_page_step(
    const dpq_chunk& q, uint32_t ma, uint32_t mb, uint32_t& sa, uint32_t& aa,
    uint32_t& sb, uint32_t& ab, const uint8_t* __restrict__ table,
    int32_t n_classes)
{
    const uint32_t b = dpq_page_byte<J>(q);
    if constexpr (MODE == DPQ_FOLDED) {
        dpq_fold_step_masked<J>(sa, b, ma, table);
        dpq_fold_step_masked<J>(sb, b, mb, table);
    } else {
        if (ma >> J & 1)
            dpq_packed_step<MODE == DPQ_PACKED_GLOBAL>(b, sa, aa, table,
                                                       n_classes);
        if (mb >> J & 1)
            dpq_packed_step<MODE == DPQ_PACKED_GLOBAL>(b, sb, ab, table,
                                                       n_classes);
    }
    if constexpr (J < 15)
        dpq_page_step<J + 1, MODE>(q, ma, mb, sa, aa, sb, ab, table,
                                    n_classes);
}

// One lane of the page walk.  pay: the [chunks, n, 16] stream, chunks * 16
// >= steps; table: the folded table, whose rows start at `start` (on the
// card a shared-memory address, on the host 0), or the packed one.
template <int MODE>
__device__ __forceinline__ void dpq_page_lane(
    const uint8_t* __restrict__ pay, long long n, long long lane,
    int32_t steps, int32_t pl, int32_t nv, const uint8_t* __restrict__ table,
    uint32_t start, int32_t n_classes, int32_t accept0,
    int32_t* __restrict__ hits, int32_t* __restrict__ seen)
{
    const int32_t lim = pl < steps ? pl : steps;
    const int32_t n_chunks = (lim + 15) >> 4;
    int32_t h = 0, done = 0;
    if (nv > 0 && lim >= 4) {
        const uint8_t* p = pay + 16 * lane;
        const long long pitch = 16 * n;
        // chunks i, i + 1 and i + 2 in registers (a copy out of a register
        // that a load has not filled yet stalls, so a chunk is loaded two
        // chunks before it is walked, from the L2, which was asked for it
        // DPQ_PREFETCH chunks before that)
        dpq_chunk cur = dpq_load_chunk(p), nxt = {0, 0}, ahead = {0, 0};
        if (n_chunks > 1) nxt = dpq_load_chunk(p + pitch);
        if (n_chunks > 2) ahead = dpq_load_chunk(p + 2 * pitch);
        for (int32_t k = 3; k < 3 + DPQ_PREFETCH && k < n_chunks; ++k)
            dpq_prefetch(p + k * pitch);
        int32_t c0 = 0;  // the lane's byte at cur's byte 0
        uint32_t len = dpq_prefix(cur, nxt, 0);
        uint32_t st = start, acc = (uint32_t)accept0;
        // a value is walked only where it ends inside the lane
        bool live = len <= (uint32_t)(lim - 4);
        int32_t vs = 4;  // the value's first byte
        while (live) {
            // A: the value [vs, ve); B: the next one, where A ends here
            const int32_t ve = vs + (int32_t)len;
            const bool ends = ve <= c0 + 16;
            bool more = ends && done + 1 < nv && ve <= lim - 4;
            const uint32_t len_b = more ? dpq_prefix(cur, nxt, ve - c0) : 0u;
            const int32_t vs_b = ve + 4;
            more = more && len_b <= (uint32_t)(lim - vs_b);
            const int32_t ve_b = more ? vs_b + (int32_t)len_b : vs_b;
            uint32_t st_b = start, acc_b = (uint32_t)accept0;
            dpq_page_step<0, MODE>(cur, dpq_value_mask(vs, ve, c0),
                                    more ? dpq_value_mask(vs_b, ve_b, c0) : 0u,
                                    st, acc, st_b, acc_b, table, n_classes);
            bool stay = false;  // a value after B starts in this chunk
            // A's and B's accepts where they end here; B goes on as A
            if (ends) {
                h += (int32_t)dpq_value_accept<MODE>(st, acc, table);
                ++done;
                live = more;
                if (more) {
                    st = st_b;
                    acc = acc_b;
                    vs = vs_b;
                    len = len_b;
                    // B ends here too: the chunk is walked again for
                    // the value after it
                    if (ve_b <= c0 + 16) {
                        h += (int32_t)dpq_value_accept<MODE>(st, acc, table);
                        ++done;
                        live = done < nv && ve_b <= lim - 4;
                        if (live) {
                            len = dpq_prefix(cur, nxt, ve_b - c0);
                            vs = ve_b + 4;
                            live = len <= (uint32_t)(lim - vs);
                            st = start;
                            acc = (uint32_t)accept0;
                            stay = true;
                        }
                    }
                }
            }
            if (live && !stay)
                dpq_advance(c0, cur, nxt, ahead, p, pitch, n_chunks);
        }
    }
    hits[lane] = h;
    seen[lane] = done;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

// The page walk's block: at most 1,024 lanes, one block an SM (registers
// capped at 64).
constexpr int kPageThreads = 1024;
// The per-value walk's block: registers capped at 64 (two blocks an SM),
// so an SM holds 1,024 threads and 64 KB of windows on their way.
// utils/probe_value_walk.py --sweep times other sizes.
#ifndef DPQ_VALUE_THREADS
#define DPQ_VALUE_THREADS 512
#endif
constexpr int kValueThreads = DPQ_VALUE_THREADS;

// Copies the packed table (`words` 16-byte words) into shared memory.
__device__ __forceinline__ void stage(uint8_t* smem,
                                     const uint8_t* __restrict__ packed,
                                     int32_t words)
{
    for (int32_t i = threadIdx.x; i < words; i += blockDim.x)
        ((uint4*)smem)[i] = __ldg((const uint4*)packed + i);
    __syncthreads();
}

// Folds the packed table into shared memory, the block's threads together:
// thread b builds column b; its entries are the shared-memory addresses of
// the next rows, and word 256 of a row its state's accept.
__device__ __forceinline__ void fold(uint8_t* smem,
                                    const uint8_t* __restrict__ packed,
                                    int32_t n_states, int32_t n_classes,
                                    int32_t accept0)
{
    uint32_t* rows = (uint32_t*)smem;
    const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
    for (int32_t s = threadIdx.x; s < n_states; s += blockDim.x)
        rows[s * DPQ_FOLD_ROW + 256] = s == 0 ? (uint32_t)accept0 : 0;
    __syncthreads();
    for (int32_t b = threadIdx.x; b < 256; b += blockDim.x) {
        const uint16_t* tab = (const uint16_t*)(packed + 256)
                              + __ldg(packed + b);
#pragma unroll 8
        for (int32_t s = 0; s < n_states; ++s) {
            const uint32_t e = __ldg(tab + s * n_classes);
            uint32_t next;
            rows[s * DPQ_FOLD_ROW + b] = dpq_fold_entry(e, base, &next);
            if (e >> 15) rows[next * DPQ_FOLD_ROW + 256] = 1;  // accepts
        }
    }
    __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(kPageThreads, 1) dfa_stream_kernel(
    const uint8_t* __restrict__ pay, long long n, int32_t steps,
    const int32_t* __restrict__ plen, const int32_t* __restrict__ nn,
    const uint8_t* __restrict__ packed, int32_t words, int32_t n_states,
    int32_t n_classes, int32_t accept0, int32_t* __restrict__ hits,
    int32_t* __restrict__ seen)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const uint8_t* table = packed;
    if constexpr (MODE == DPQ_FOLDED) {
        fold(smem, packed, n_states, n_classes, accept0);
        table = smem;
    } else if constexpr (MODE == DPQ_PACKED_SHARED) {
        stage(smem, packed, words);
        table = smem;
    }
    const uint32_t start = MODE == DPQ_FOLDED
        ? (uint32_t)__cvta_generic_to_shared(smem) : 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         lane < n; lane += stride)
        dpq_page_lane<MODE>(pay, n, lane, steps, plen[lane], nn[lane], table,
                            start, n_classes, accept0, hits, seen);
}

// ── the per-value walk ──

template <int MODE, int PIECE>
__global__ void __launch_bounds__(kValueThreads, 1024 / kValueThreads)
dfa_values_kernel(
    const uint8_t* __restrict__ chars, long long count, int32_t pitch,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ packed,
    int32_t words, int32_t n_states, int32_t n_classes, int32_t accept0,
    uint8_t* __restrict__ out)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const long long stride = (long long)gridDim.x * blockDim.x;
    long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    // the first window is on its way while the block stages its table
    int32_t lim = 0;
    dpq_chunk q[DPQ_WINDOW / 16];
    if (v < count) lim = dpq_row_lim(__ldg(lens + v), pitch);
    dpq_load_window<PIECE>(chars + v * pitch,
                           v < count ? dpq_window_bytes(pitch, 0) : 0, q);

    const uint8_t* table = packed;
    if constexpr (MODE == DPQ_FOLDED) {
        fold(smem, packed, n_states, n_classes, accept0);
        table = smem;
    } else if constexpr (MODE == DPQ_PACKED_SHARED) {
        stage(smem, packed, words);
        table = smem;
    }
    const uint32_t start = MODE == DPQ_FOLDED
        ? (uint32_t)__cvta_generic_to_shared(smem) : 0;

    uint32_t st = start, acc = (uint32_t)accept0;
    int32_t w = 0;  // q holds window w of row v
    while (v < count) {
        // load the next window, row v's next or the next row's first (its
        // length with it), then walk this one
        const bool same = DPQ_WINDOW * (w + 1) < lim;
        const long long nv = same ? v : v + stride;
        const int32_t nw = same ? w + 1 : 0;
        int32_t nlim = lim;
        if (!same && nv < count) nlim = dpq_row_lim(__ldg(lens + nv), pitch);
        dpq_chunk n[DPQ_WINDOW / 16];
        dpq_load_window<PIECE>(chars + nv * pitch + DPQ_WINDOW * nw,
                               nv < count ? dpq_window_bytes(pitch, nw) : 0,
                               n);
        dpq_walk_window<MODE>(q, lim - DPQ_WINDOW * w, st, acc, table,
                              n_classes);
        if (!same) {
            out[v] = (uint8_t)dpq_value_accept<MODE>(st, acc, table);
            st = start;
            acc = (uint32_t)accept0;
        }
#pragma unroll
        for (int32_t k = 0; k < DPQ_WINDOW / 16; ++k) q[k] = n[k];
        v = nv;
        w = nw;
        lim = nlim;
    }
}

// The dynamic shared memory of `kernel`, raised past the 48 KB default
// where it needs more.
template <typename K>
cudaError_t shared_bytes(K kernel, int bytes)
{
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
}

// Blocks of `kernel` one SM holds at once, with `bytes` of dynamic shared
// memory (0 when it cannot launch so; the failed call's error is cleared,
// or the next launch's cudaGetLastError would report it).
template <typename K>
int blocks_per_sm(K kernel, int threads, int bytes)
{
    int n = 0;
    if (shared_bytes(kernel, bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      bytes) != cudaSuccess) {
        cudaGetLastError();
        return 0;
    }
    return n;
}

template <int MODE, int PIECE>
cudaError_t launch_values(const uint8_t* chars, long long count, int pitch,
                          const int32_t* lens, const uint8_t* packed,
                          int packed_bytes, int n_states, int n_classes,
                          int accept0, int grid, uint8_t* out,
                          cudaStream_t s)
{
    const int bytes = MODE == DPQ_FOLDED ? dpq_fold_bytes(n_states)
                      : MODE == DPQ_PACKED_SHARED ? packed_bytes : 0;
    const cudaError_t rc = shared_bytes(dfa_values_kernel<MODE, PIECE>, bytes);
    if (rc != cudaSuccess) return rc;
    const long long need = (count + kValueThreads - 1) / kValueThreads;
    const unsigned blocks = (unsigned)(need < grid ? need : grid);
    dfa_values_kernel<MODE, PIECE><<<blocks, kValueThreads, bytes, s>>>(
        chars, count, pitch, lens, packed, packed_bytes / 16, n_states,
        n_classes, accept0, out);
    return cudaSuccess;
}

// The launch of `mode`'s kernel for the loads `pitch` and chars allow.
template <int MODE>
cudaError_t launch_values_mode(const uint8_t* chars, long long count,
                               int pitch, const int32_t* lens,
                               const uint8_t* packed, int packed_bytes,
                               int n_states, int n_classes, int accept0,
                               int grid, uint8_t* out, cudaStream_t s)
{
    switch (dpq_piece_bytes(pitch, chars)) {
    case 16:
        return launch_values<MODE, 16>(chars, count, pitch, lens, packed,
                                       packed_bytes, n_states, n_classes,
                                       accept0, grid, out, s);
    case 8:
        return launch_values<MODE, 8>(chars, count, pitch, lens, packed,
                                      packed_bytes, n_states, n_classes,
                                      accept0, grid, out, s);
    case 4:
        return launch_values<MODE, 4>(chars, count, pitch, lens, packed,
                                      packed_bytes, n_states, n_classes,
                                      accept0, grid, out, s);
    default:
        return launch_values<MODE, 1>(chars, count, pitch, lens, packed,
                                      packed_bytes, n_states, n_classes,
                                      accept0, grid, out, s);
    }
}

template <int MODE>
cudaError_t launch_stream(const uint8_t* pay, long long n, int steps,
                          const int32_t* plen, const int32_t* nn,
                          const uint8_t* packed, int packed_bytes,
                          int n_states, int n_classes, int accept0, int grid,
                          int32_t* hits, int32_t* seen, cudaStream_t s)
{
    const int bytes = MODE == DPQ_FOLDED ? dpq_fold_bytes(n_states)
                      : MODE == DPQ_PACKED_SHARED ? packed_bytes : 0;
    const cudaError_t rc = shared_bytes(dfa_stream_kernel<MODE>, bytes);
    if (rc != cudaSuccess) return rc;
    if (grid < 1) return cudaErrorInvalidValue;
    // a block: a contiguous run of ceil(n / grid) lanes, in whole warps
    const long long run = (n + grid - 1) / grid;
    const int threads = (int)(run > kPageThreads ? kPageThreads
                              : (run + 31) / 32 * 32);
    const long long need = (n + threads - 1) / threads;
    const unsigned blocks = (unsigned)(need < grid ? need : grid);
    dfa_stream_kernel<MODE><<<blocks, threads, bytes, s>>>(
        pay, n, steps, plen, nn, packed, packed_bytes / 16, n_states,
        n_classes, accept0, hits, seen);
    return cudaSuccess;
}

}  // namespace

// Blocks one SM of the current device holds at once.  walk 0: the page
// walk with the packed table; 3: the page walk with the folded table (both
// at 1,024 threads a block); 1: the per-value walk with the folded table;
// 2: the per-value walk with the packed table.  `staged_bytes`: the
// table's bytes in shared memory, or 0 for the variant that reads it from
// device memory.  The wrapper stages a table only where the staged variant
// keeps more than half the device-memory variant's blocks, and launches
// each walk with as many blocks as the SMs hold.
extern "C" int dpq_dfa_blocks_per_sm(int walk, int staged_bytes)
{
    if (walk == 0 || walk == 3) {
        if (staged_bytes == 0)
            return blocks_per_sm(dfa_stream_kernel<DPQ_PACKED_GLOBAL>,
                                 kPageThreads, 0);
        return walk == 3
            ? blocks_per_sm(dfa_stream_kernel<DPQ_FOLDED>, kPageThreads,
                            staged_bytes)
            : blocks_per_sm(dfa_stream_kernel<DPQ_PACKED_SHARED>,
                            kPageThreads, staged_bytes);
    }
    if (staged_bytes == 0)
        return blocks_per_sm(dfa_values_kernel<DPQ_PACKED_GLOBAL, 16>,
                             kValueThreads, 0);
    return walk == 1
        ? blocks_per_sm(dfa_values_kernel<DPQ_FOLDED, 16>, kValueThreads,
                        staged_bytes)
        : blocks_per_sm(dfa_values_kernel<DPQ_PACKED_SHARED, 16>,
                        kValueThreads, staged_bytes);
}

// pay: [chunks, n, 16] u8; plen, nn, hits, seen: [n] int32; packed: the
// packed table of `n_states` states, `packed_bytes` a multiple of 16; mode:
// DPQ_FOLDED (needs n_states <= DPQ_FOLD_MAX_STATES), DPQ_PACKED_SHARED or
// DPQ_PACKED_GLOBAL; grid: the blocks to launch at most (those the SMs hold
// at once).  n >= 1.
extern "C" int dpq_dfa_stream(
    const void* pay, long long n, int steps, const void* plen, const void* nn,
    const void* packed, int packed_bytes, int n_states, int n_classes,
    int accept0, int mode, int grid, void* hits, void* seen, void* stream)
{
    const uint8_t* y = (const uint8_t*)pay;
    const int32_t* l = (const int32_t*)plen;
    const int32_t* v = (const int32_t*)nn;
    const uint8_t* t = (const uint8_t*)packed;
    int32_t* h = (int32_t*)hits;
    int32_t* c = (int32_t*)seen;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t rc = cudaErrorInvalidValue;
    if (mode == DPQ_FOLDED && n_states <= DPQ_FOLD_MAX_STATES)
        rc = launch_stream<DPQ_FOLDED>(y, n, steps, l, v, t, packed_bytes,
                                       n_states, n_classes, accept0, grid, h,
                                       c, s);
    else if (mode == DPQ_PACKED_SHARED)
        rc = launch_stream<DPQ_PACKED_SHARED>(y, n, steps, l, v, t,
                                              packed_bytes, n_states,
                                              n_classes, accept0, grid, h, c,
                                              s);
    else if (mode == DPQ_PACKED_GLOBAL)
        rc = launch_stream<DPQ_PACKED_GLOBAL>(y, n, steps, l, v, t,
                                              packed_bytes, n_states,
                                              n_classes, accept0, grid, h, c,
                                              s);
    if (rc != cudaSuccess) {
        cudaGetLastError();  // clear it: it is reported here
        return (int)rc;
    }
    return (int)cudaGetLastError();
}

// chars: [count, pitch] u8; lens: [count] int32; out: [count] u8 (0 / 1);
// packed: the packed table of `n_states` states; mode: DPQ_FOLDED (needs
// n_states <= DPQ_FOLD_MAX_STATES), DPQ_PACKED_SHARED or DPQ_PACKED_GLOBAL;
// grid: the blocks to launch at most (those the SMs hold at once).
// count >= 1.
extern "C" int dpq_dfa_values(
    const void* chars, long long count, int pitch, const void* lens,
    const void* packed, int packed_bytes, int n_states, int n_classes,
    int accept0, int mode, int grid, void* out, void* stream)
{
    const uint8_t* c = (const uint8_t*)chars;
    const int32_t* l = (const int32_t*)lens;
    const uint8_t* p = (const uint8_t*)packed;
    uint8_t* o = (uint8_t*)out;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t rc = cudaErrorInvalidValue;
    if (mode == DPQ_FOLDED && n_states <= DPQ_FOLD_MAX_STATES)
        rc = launch_values_mode<DPQ_FOLDED>(c, count, pitch, l, p,
                                            packed_bytes, n_states, n_classes,
                                            accept0, grid, o, s);
    else if (mode == DPQ_PACKED_SHARED)
        rc = launch_values_mode<DPQ_PACKED_SHARED>(c, count, pitch, l, p,
                                                   packed_bytes, n_states,
                                                   n_classes, accept0, grid,
                                                   o, s);
    else if (mode == DPQ_PACKED_GLOBAL)
        rc = launch_values_mode<DPQ_PACKED_GLOBAL>(c, count, pitch, l, p,
                                                   packed_bytes, n_states,
                                                   n_classes, accept0, grid,
                                                   o, s);
    if (rc != cudaSuccess) {
        cudaGetLastError();  // clear it: it is reported here
        return (int)rc;
    }
    return (int)cudaGetLastError();
}
#else
// The same walks on the host, over the same layouts (the CPU tests build
// this file with g++).

// The folded table of `packed` (as a block of the kernels folds it, with
// offsets from its start for addresses), malloc'ed.
static uint32_t* dpq_fold_host(const uint8_t* packed, int32_t n_states,
                               int32_t n_classes, int32_t accept0)
{
    uint32_t* fold = (uint32_t*)malloc((size_t)dpq_fold_bytes(n_states));
    for (int32_t s = 0; s < n_states; ++s)
        fold[s * DPQ_FOLD_ROW + 256] = s == 0 ? (uint32_t)accept0 : 0;
    const uint16_t* tab = (const uint16_t*)(packed + 256);
    for (int32_t b = 0; b < 256; ++b)
        for (int32_t s = 0; s < n_states; ++s) {
            const uint32_t e = tab[s * n_classes + packed[b]];
            uint32_t next;
            fold[s * DPQ_FOLD_ROW + b] = dpq_fold_entry(e, 0, &next);
            if (e >> 15) fold[next * DPQ_FOLD_ROW + 256] = 1;
        }
    return fold;
}

// mode: DPQ_FOLDED (up to DPQ_FOLD_MAX_STATES states) or either packed
// mode, as the kernel walks it.
extern "C" void dpq_dfa_stream_host(
    const uint8_t* pay, long long n, int steps, const int32_t* plen,
    const int32_t* nn, const uint8_t* packed, int n_states, int n_classes,
    int accept0, int mode, int32_t* hits, int32_t* seen)
{
    if (mode != DPQ_FOLDED || n_states > DPQ_FOLD_MAX_STATES) {
        for (long long lane = 0; lane < n; ++lane)
            dpq_page_lane<DPQ_PACKED_SHARED>(pay, n, lane, steps, plen[lane],
                                             nn[lane], packed, 0, n_classes,
                                             accept0, hits, seen);
        return;
    }
    uint32_t* fold = dpq_fold_host(packed, n_states, n_classes, accept0);
    for (long long lane = 0; lane < n; ++lane)
        dpq_page_lane<DPQ_FOLDED>(pay, n, lane, steps, plen[lane], nn[lane],
                                  (const uint8_t*)fold, 0, n_classes, accept0,
                                  hits, seen);
    free(fold);
}

template <int MODE, int PIECE>
static void dpq_values_rows(const uint8_t* chars, long long count, int pitch,
                            const int32_t* lens, const uint8_t* table,
                            int n_classes, int accept0, uint8_t* out)
{
    for (long long v = 0; v < count; ++v) {
        const int32_t lim = dpq_row_lim(lens[v], pitch);
        uint32_t st = 0, acc = (uint32_t)accept0;
        for (int32_t w = 0;; ++w) {
            dpq_chunk q[DPQ_WINDOW / 16];
            dpq_load_window<PIECE>(chars + v * pitch + DPQ_WINDOW * w,
                                   dpq_window_bytes(pitch, w), q);
            dpq_walk_window<MODE>(q, lim - DPQ_WINDOW * w, st, acc, table,
                                  n_classes);
            if (DPQ_WINDOW * (w + 1) >= lim) break;
        }
        out[v] = (uint8_t)dpq_value_accept<MODE>(st, acc, table);
    }
}

// The kernel's loads for `pitch` and chars (dpq_piece_bytes).
template <int MODE>
static void dpq_values_host_mode(const uint8_t* chars, long long count,
                                 int pitch, const int32_t* lens,
                                 const uint8_t* table, int n_classes,
                                 int accept0, uint8_t* out)
{
    switch (dpq_piece_bytes(pitch, chars)) {
    case 16:
        return dpq_values_rows<MODE, 16>(chars, count, pitch, lens, table,
                                         n_classes, accept0, out);
    case 8:
        return dpq_values_rows<MODE, 8>(chars, count, pitch, lens, table,
                                        n_classes, accept0, out);
    case 4:
        return dpq_values_rows<MODE, 4>(chars, count, pitch, lens, table,
                                        n_classes, accept0, out);
    default:
        return dpq_values_rows<MODE, 1>(chars, count, pitch, lens, table,
                                        n_classes, accept0, out);
    }
}

// mode: DPQ_FOLDED (the table folded first, as a block of the kernel does)
// or either packed mode.
extern "C" void dpq_dfa_values_host(
    const uint8_t* chars, long long count, int pitch, const int32_t* lens,
    const uint8_t* packed, int n_states, int n_classes, int accept0, int mode,
    uint8_t* out)
{
    if (mode != DPQ_FOLDED || n_states > DPQ_FOLD_MAX_STATES) {
        dpq_values_host_mode<DPQ_PACKED_SHARED>(chars, count, pitch, lens,
                                                packed, n_classes, accept0,
                                                out);
        return;
    }
    uint32_t* fold = dpq_fold_host(packed, n_states, n_classes, accept0);
    dpq_values_host_mode<DPQ_FOLDED>(chars, count, pitch, lens,
                                     (const uint8_t*)fold, n_classes, accept0,
                                     out);
    free(fold);
}
#endif
