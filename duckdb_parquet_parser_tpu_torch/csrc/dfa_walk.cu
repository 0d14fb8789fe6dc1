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
// one load gives both), padded to a multiple of 16 bytes.
//
// dpq_dfa_stream (the page walk).  One thread per lane (a page or a split
// segment) over the resident [chunks, n, 16] u8 stream of K1
// (stream_matcher.chunk_stream): a thread reads 16 bytes of its lane in one
// load and loads chunk i + 1 before it walks chunk i.  The value-boundary
// control is K1's (stream_matcher.cu.in): the length prefix accumulates
// through uint32_t (its last byte reaches bit 31), then counts down; a
// zero-length value adds accept[0]; the state resets to 0 when a prefix ends
// and holds during prefix bytes; the lane stops at its first inactive byte
// (b >= plen or all nn values seen).  hits[lane], seen[lane] int32.
//
// dpq_dfa_values (the per-value walk).  chars [L, P] u8, one row per value,
// zero-padded; for j < min(len, P): state = T[state, chars[j]]; out =
// accept[state].  One thread per value reads its own row 16 bytes a load
// when rows are 16-byte aligned, byte by byte otherwise.
//
// What bounds it: operations and load latency, not bytes.  Each byte is a
// dependent chain of two loads (class, then entry) and K1's control, while
// the stream is read once.  So the table sits where a load is shortest:
// both kernels stage the class map and table in shared memory (dynamic
// shared memory, above 48 KB after cudaFuncSetAttribute) while the staged
// kernel keeps more than half the resident blocks of the device-memory one
// (dpq_dfa_blocks_per_sm: every block copies the whole table, so a large
// staged table leaves an SM a warp or two; on the H100 that rule stages
// up to ~16 KB, where staging was faster in every case measured);
// any other table (up to 16 MB at the 32,768-state limit; 2 MB at the
// compiler's default 4,096-state budget) is read through __ldg from device
// memory, where the L1 and the 50 MB L2 hold it.  The wrapper picks the
// variant; both are the same walk.  The stream's loads stay out of the
// chain as in K1, and lanes arrive sorted by length, so a warp's lanes
// stop together.
#include <stdint.h>
#include <string.h>

struct dpq_chunk { uint64_t lo, hi; };  // bytes 0-7 and 8-15, little-endian

#ifdef __CUDACC__
__device__ __forceinline__ dpq_chunk dpq_load_chunk(const uint8_t* __restrict__ p)
{
    const ulonglong2 w = __ldg((const ulonglong2*)p);
    dpq_chunk c;
    c.lo = w.x;
    c.hi = w.y;
    return c;
}

__device__ __forceinline__ dpq_chunk dpq_load_bytes(const uint8_t* __restrict__ p,
                                                    int32_t nb)
{
    dpq_chunk c = {0, 0};
    for (int32_t k = 0; k < nb; ++k) {
        const uint64_t b = __ldg(p + k);
        if (k < 8)
            c.lo |= b << (8 * k);
        else
            c.hi |= b << (8 * (k - 8));
    }
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

static inline dpq_chunk dpq_load_bytes(const uint8_t* p, int32_t nb)
{
    dpq_chunk c = {0, 0};
    memcpy(&c, p, (size_t)nb);
    return c;
}

template <bool LDG>
static inline uint32_t dpq_class(const uint8_t* m, int32_t c) { return m[c]; }

template <bool LDG>
static inline uint32_t dpq_entry(const uint16_t* t, int32_t i) { return t[i]; }
#endif

// One lane of the page walk.  pay: the [chunks, n, 16] stream, chunks * 16
// >= steps; cls / tab: the packed table's class map and entries.
template <bool LDG>
__device__ __forceinline__ void dpq_dfa_lane(
    const uint8_t* __restrict__ pay, long long n, long long lane,
    int32_t steps, int32_t pl, int32_t nv,
    const uint8_t* __restrict__ cls, const uint16_t* __restrict__ tab,
    int32_t n_classes, int32_t accept0,
    int32_t* __restrict__ hits, int32_t* __restrict__ seen)
{
    int32_t prefix_left = 4, ctr = 0, done = 0, state = 0, h = 0;
    const int32_t lim = pl < steps ? pl : steps;
    const int32_t n_chunks = (lim + 15) >> 4;
    dpq_chunk next = {0, 0};
    if (n_chunks > 0 && nv > 0) next = dpq_load_chunk(pay + 16 * lane);
    // A lane is active while b < plen and done < nn.  Both conditions only
    // ever turn false, and an inactive byte changes no hit and no count,
    // so the walk stops at the first inactive byte.
    for (int32_t ch = 0; ch < n_chunks && done < nv; ++ch) {
        uint64_t lo = next.lo, hi = next.hi;
        if (ch + 1 < n_chunks)
            next = dpq_load_chunk(pay + 16 * ((long long)(ch + 1) * n + lane));
        const int32_t left = lim - (ch << 4);
        const int32_t nb = left < 16 ? left : 16;
#ifdef __CUDACC__
#pragma unroll 1
#endif
        for (int32_t j = 0; j < nb && done < nv; ++j) {
            const int32_t c = (int32_t)(lo & 0xffu);
            lo = (lo >> 8) | (hi << 56);
            hi >>= 8;
            // the transition, taken on every byte: during a prefix byte its
            // result is dropped and the state held
            const uint32_t e = dpq_entry<LDG>(
                tab, state * n_classes + (int32_t)dpq_class<LDG>(cls, c));
            const int32_t nxt = (int32_t)(e & 0x7fffu);
            const int32_t acc = (int32_t)(e >> 15);
            const bool in_prefix = prefix_left > 0;
            // prefix byte: accumulate the little-endian length (through
            // uint32_t: the last byte reaches bit 31)
            const int32_t la2 = ctr | (int32_t)((uint32_t)c
                                                << ((8 * (4 - prefix_left)) & 31));
            const int32_t pl2 = prefix_left - 1;
            const bool prefix_done = in_prefix && pl2 == 0;
            const bool zero_len = prefix_done && la2 == 0;
            // value byte: count the bytes left down
            const int32_t bl2 = (int32_t)((uint32_t)ctr - 1u);
            const bool value_done = !in_prefix && bl2 == 0;
            const bool fin = zero_len || value_done;
            if (fin) h += zero_len ? accept0 : acc;
            done += fin ? 1 : 0;
            prefix_left = fin ? 4 : (in_prefix ? pl2 : prefix_left);
            ctr = fin ? 0 : (in_prefix ? la2 : bl2);
            state = prefix_done ? 0 : (in_prefix ? state : nxt);
        }
    }
    hits[lane] = h;
    seen[lane] = done;
}

// One value of the per-value walk: its row of `pitch` bytes, `len` of them
// real.  `wide`: rows are 16-byte aligned and pitch is a multiple of 16.
template <bool LDG>
__device__ __forceinline__ uint8_t dpq_dfa_value(
    const uint8_t* __restrict__ row, int32_t pitch, int32_t len, int wide,
    const uint8_t* __restrict__ cls, const uint16_t* __restrict__ tab,
    int32_t n_classes, int32_t accept0)
{
    const int32_t lim = len < pitch ? len : pitch;
    int32_t state = 0;
    uint32_t acc = (uint32_t)accept0;
    for (int32_t j0 = 0; j0 < lim; j0 += 16) {
        const int32_t left = lim - j0;
        const int32_t nb = left < 16 ? left : 16;
        const dpq_chunk ch = wide ? dpq_load_chunk(row + j0)
                                  : dpq_load_bytes(row + j0, nb);
        uint64_t lo = ch.lo, hi = ch.hi;
#ifdef __CUDACC__
#pragma unroll 1
#endif
        for (int32_t j = 0; j < nb; ++j) {
            const int32_t c = (int32_t)(lo & 0xffu);
            lo = (lo >> 8) | (hi << 56);
            hi >>= 8;
            const uint32_t e = dpq_entry<LDG>(
                tab, state * n_classes + (int32_t)dpq_class<LDG>(cls, c));
            state = (int32_t)(e & 0x7fffu);
            acc = e >> 15;
        }
    }
    return (uint8_t)acc;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

namespace {

constexpr int kStreamThreads = 64;   // lanes a block: spread over the SMs
constexpr int kValueThreads = 128;

// Copies the packed table (`words` 16-byte words) into shared memory.
__device__ __forceinline__ void stage(uint8_t* smem,
                                     const uint8_t* __restrict__ packed,
                                     int32_t words)
{
    for (int32_t i = threadIdx.x; i < words; i += blockDim.x)
        ((uint4*)smem)[i] = __ldg((const uint4*)packed + i);
    __syncthreads();
}

template <bool SHARED>
__global__ void __launch_bounds__(kStreamThreads) dfa_stream_kernel(
    const uint8_t* __restrict__ pay, long long n, int32_t steps,
    const int32_t* __restrict__ plen, const int32_t* __restrict__ nn,
    const uint8_t* __restrict__ packed, int32_t words, int32_t n_classes,
    int32_t accept0, int32_t* __restrict__ hits, int32_t* __restrict__ seen)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const uint8_t* table = packed;
    if (SHARED) {
        stage(smem, packed, words);
        table = smem;
    }
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    dpq_dfa_lane<!SHARED>(pay, n, lane, steps, plen[lane], nn[lane], table,
                          (const uint16_t*)(table + 256), n_classes, accept0,
                          hits, seen);
}

template <bool SHARED>
__global__ void __launch_bounds__(kValueThreads) dfa_values_kernel(
    const uint8_t* __restrict__ chars, long long count, int32_t pitch,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ packed,
    int32_t words, int32_t n_classes, int32_t accept0, int wide,
    uint8_t* __restrict__ out)
{
    extern __shared__ __align__(16) uint8_t smem[];
    const uint8_t* table = packed;
    if (SHARED) {
        stage(smem, packed, words);
        table = smem;
    }
    const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= count) return;
    out[v] = dpq_dfa_value<!SHARED>(chars + v * pitch, pitch, lens[v], wide,
                                    table, (const uint16_t*)(table + 256),
                                    n_classes, accept0);
}

// The dynamic shared memory of the SHARED variant, raised past the 48 KB
// default where the table needs it.
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

}  // namespace

// Blocks one SM of the current device holds at once: of the per-value walk
// when `values`, else of the page walk; of its staged variant with a table
// of `staged_bytes` in shared memory, or, with `staged_bytes` 0, of its
// device-memory variant.  The wrapper stages a table only where the staged
// variant keeps more than half the device-memory variant's blocks (each
// block copies the whole table, and fewer blocks leave fewer warps to hide
// the walk's load latency).
extern "C" int dpq_dfa_blocks_per_sm(int values, int staged_bytes)
{
    if (values)
        return staged_bytes
            ? blocks_per_sm(dfa_values_kernel<true>, kValueThreads, staged_bytes)
            : blocks_per_sm(dfa_values_kernel<false>, kValueThreads, 0);
    return staged_bytes
        ? blocks_per_sm(dfa_stream_kernel<true>, kStreamThreads, staged_bytes)
        : blocks_per_sm(dfa_stream_kernel<false>, kStreamThreads, 0);
}

// pay: [chunks, n, 16] u8; plen, nn, hits, seen: [n] int32; packed: the
// packed table, `packed_bytes` a multiple of 16.  n >= 1.
extern "C" int dpq_dfa_stream(
    const void* pay, long long n, int steps, const void* plen, const void* nn,
    const void* packed, int packed_bytes, int n_classes, int accept0,
    int use_shared, void* hits, void* seen, void* stream)
{
    const unsigned blocks = (unsigned)((n + kStreamThreads - 1) / kStreamThreads);
    const int words = packed_bytes / 16;
    cudaStream_t s = (cudaStream_t)stream;
    if (use_shared) {
        const cudaError_t rc = shared_bytes(dfa_stream_kernel<true>, packed_bytes);
        if (rc != cudaSuccess) {
            cudaGetLastError();  // clear it: it is reported here
            return (int)rc;
        }
        dfa_stream_kernel<true><<<blocks, kStreamThreads, packed_bytes, s>>>(
            (const uint8_t*)pay, n, steps, (const int32_t*)plen,
            (const int32_t*)nn, (const uint8_t*)packed, words, n_classes,
            accept0, (int32_t*)hits, (int32_t*)seen);
    } else {
        dfa_stream_kernel<false><<<blocks, kStreamThreads, 0, s>>>(
            (const uint8_t*)pay, n, steps, (const int32_t*)plen,
            (const int32_t*)nn, (const uint8_t*)packed, words, n_classes,
            accept0, (int32_t*)hits, (int32_t*)seen);
    }
    return (int)cudaGetLastError();
}

// chars: [count, pitch] u8; lens: [count] int32; out: [count] u8 (0 / 1).
// count >= 1.
extern "C" int dpq_dfa_values(
    const void* chars, long long count, int pitch, const void* lens,
    const void* packed, int packed_bytes, int n_classes, int accept0,
    int use_shared, void* out, void* stream)
{
    const unsigned blocks = (unsigned)((count + kValueThreads - 1) / kValueThreads);
    const int words = packed_bytes / 16;
    const int wide = pitch % 16 == 0 && (uintptr_t)chars % 16 == 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (use_shared) {
        const cudaError_t rc = shared_bytes(dfa_values_kernel<true>, packed_bytes);
        if (rc != cudaSuccess) {
            cudaGetLastError();  // clear it: it is reported here
            return (int)rc;
        }
        dfa_values_kernel<true><<<blocks, kValueThreads, packed_bytes, s>>>(
            (const uint8_t*)chars, count, pitch, (const int32_t*)lens,
            (const uint8_t*)packed, words, n_classes, accept0, wide,
            (uint8_t*)out);
    } else {
        dfa_values_kernel<false><<<blocks, kValueThreads, 0, s>>>(
            (const uint8_t*)chars, count, pitch, (const int32_t*)lens,
            (const uint8_t*)packed, words, n_classes, accept0, wide,
            (uint8_t*)out);
    }
    return (int)cudaGetLastError();
}
#else
// The same walks on the host, over the same layouts (the CPU tests build
// this file with g++).
extern "C" void dpq_dfa_stream_host(
    const uint8_t* pay, long long n, int steps, const int32_t* plen,
    const int32_t* nn, const uint8_t* packed, int n_classes, int accept0,
    int32_t* hits, int32_t* seen)
{
    for (long long lane = 0; lane < n; ++lane)
        dpq_dfa_lane<false>(pay, n, lane, steps, plen[lane], nn[lane], packed,
                            (const uint16_t*)(packed + 256), n_classes,
                            accept0, hits, seen);
}

extern "C" void dpq_dfa_values_host(
    const uint8_t* chars, long long count, int pitch, const int32_t* lens,
    const uint8_t* packed, int n_classes, int accept0, uint8_t* out)
{
    const int wide = pitch % 16 == 0 && (uintptr_t)chars % 16 == 0;
    for (long long v = 0; v < count; ++v)
        out[v] = dpq_dfa_value<false>(chars + v * pitch, pitch, lens[v], wide,
                                      packed, (const uint16_t*)(packed + 256),
                                      n_classes, accept0);
}
#endif
