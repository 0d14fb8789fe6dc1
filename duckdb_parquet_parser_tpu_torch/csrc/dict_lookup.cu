// Dictionary lookup for Hopper (sm_90a): kernel K2, two entry points.
//
// Replaces the TPU kernel duckdb_parquet_parser_tpu/ops/pallas/
// dict_lookup.py::_kernel, which looks indices up in a table as a bf16
// 8-bit-limb one-hot matmul because gathers are slow on that machine.  On
// the H100 a gather is native, and the work is far below the card's ridge:
// what bounds it is the bytes it moves and the number of launches around
// it.  So the scan's entry fuses everything that surrounded the lookup.
//
// dpq_dict_count (the scan's entry).  For N pages and K patterns:
//
//   valid[n, v]  = v < num_values[n] and levels[n, v] == max_def
//                  and 0 <= idx[n, v] < dict_size[n]
//   g[n, v]      = clamp(dict_base[n] + max(idx[n, v], 0), 0, DN - 1)
//   counts[k, n] = sum_v valid[n, v] and ((table[k, g[n, v]] != 0) xor negate)
//   values[n]    = sum_v valid[n, v]
//
// for rows with page_kind == 1; other rows write 0.  The [N, V] index,
// mask and accept planes never reach device memory: each index and level is
// read once (16 values a thread and step: four 16-byte index loads and one
// 16-byte level load, neighbouring threads on neighbouring addresses), the
// [K, DN] byte table sits in L1 behind __ldg, the sums reduce by warp
// shuffles (and through shared memory when a block shares one long row),
// and K + 1 integers leave per page.  One warp serves a row of up to 1024
// values, a block of 256 threads a longer one.  No atomics: integer sums
// are exact in any order.  The stored planes may be narrower than V (the
// missing cells are padding: index -1, level 0) or wider (the rest is cut);
// a REQUIRED column (max_def == 0) has no level plane.
//
// dpq_dict_lookup (the gather entry): out[p][i] = planes[p][gidx[i]], one
// output position a thread, the table through __ldg, at most 1024 blocks
// striding.  Indices are pre-clipped by the caller; the kernel clamps them
// again so a bad index cannot read outside the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 16;  // values a thread takes per step

// KT patterns per pass (K > KT runs ceil(K / KT) passes over the row, whose
// indices then come from cache); T threads per page row (32 or kBlock).
template <int KT, int T>
__global__ void __launch_bounds__(kBlock) dict_count_kernel(
    const int32_t* __restrict__ idx, int idx_w,
    const uint8_t* __restrict__ lev, int lev_w,
    const int32_t* __restrict__ num_values,
    const int32_t* __restrict__ page_kind,
    const int32_t* __restrict__ dict_base,
    const int32_t* __restrict__ dict_size,
    const uint8_t* __restrict__ table, int k_total, int dn, int n, int vmax,
    int max_def, int negate, int wide,
    int32_t* __restrict__ counts, int32_t* __restrict__ values)
{
    constexpr int ROWS = kBlock / T;
    const int row = blockIdx.x * ROWS + threadIdx.x / T;
    const int t = threadIdx.x % T;
    const bool in_grid = row < n;
    const bool live = in_grid && page_kind[row] == 1;
    // cells at or past `lim` are invalid: past the page's values, past V,
    // or in the padding of a narrower stored plane
    int lim = 0;
    int32_t base = 0, size = 0;
    if (live) {
        lim = min(min(num_values[row], vmax), idx_w);
        if (max_def > 0) lim = min(lim, lev_w);
        base = dict_base[row];
        size = dict_size[row];
    }
    const int32_t* irow = idx + (long long)row * idx_w;
    const uint8_t* lrow = lev + (long long)row * lev_w;
    __shared__ int32_t part[kBlock / 32][KT + 1];

    for (int k0 = 0; k0 < k_total; k0 += KT) {
        int32_t cnt[KT];
#pragma unroll
        for (int j = 0; j < KT; ++j) cnt[j] = 0;
        int32_t vals = 0;
        for (int v0 = t * kVec; v0 < lim; v0 += T * kVec) {
            int32_t ix[kVec];
            uint32_t lv[kVec / 4] = {0, 0, 0, 0};
            const bool full = wide && v0 + kVec <= idx_w
                              && (max_def == 0 || v0 + kVec <= lev_w);
            if (full) {
#pragma unroll
                for (int q = 0; q < kVec / 4; ++q) {
                    const int4 w = __ldg((const int4*)(irow + v0) + q);
                    ix[4 * q] = w.x; ix[4 * q + 1] = w.y;
                    ix[4 * q + 2] = w.z; ix[4 * q + 3] = w.w;
                }
                if (max_def > 0) {
                    const uint4 w = __ldg((const uint4*)(lrow + v0));
                    lv[0] = w.x; lv[1] = w.y; lv[2] = w.z; lv[3] = w.w;
                }
            } else {
#pragma unroll
                for (int j = 0; j < kVec; ++j) {
                    const bool in = v0 + j < lim;
                    ix[j] = in ? __ldg(irow + v0 + j) : -1;
                    if (in && max_def > 0)
                        lv[j / 4] |= (uint32_t)__ldg(lrow + v0 + j)
                                     << (8 * (j % 4));
                }
            }
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
                const int32_t level = (lv[j / 4] >> (8 * (j % 4))) & 0xff;
                const bool ok = v0 + j < lim
                                && (max_def == 0 || level == max_def)
                                && ix[j] >= 0 && ix[j] < size;
                if (!ok) continue;
                vals += 1;
                long long g = (long long)base + ix[j];
                g = g < 0 ? 0 : (g >= dn ? dn - 1 : g);
#pragma unroll
                for (int q = 0; q < KT; ++q) {
                    const int k = min(k0 + q, k_total - 1);
                    const int a = __ldg(table + (long long)k * dn + g) != 0;
                    cnt[q] += a ^ negate;
                }
            }
        }
        // sum over the row's threads
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            vals += __shfl_down_sync(0xffffffffu, vals, off);
#pragma unroll
            for (int q = 0; q < KT; ++q)
                cnt[q] += __shfl_down_sync(0xffffffffu, cnt[q], off);
        }
        if (T > 32) {
            const int warp = threadIdx.x / 32;
            if (threadIdx.x % 32 == 0) {
#pragma unroll
                for (int q = 0; q < KT; ++q) part[warp][q] = cnt[q];
                part[warp][KT] = vals;
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                vals = 0;
#pragma unroll
                for (int q = 0; q < KT; ++q) cnt[q] = 0;
                for (int w = 0; w < kBlock / 32; ++w) {
#pragma unroll
                    for (int q = 0; q < KT; ++q) cnt[q] += part[w][q];
                    vals += part[w][KT];
                }
            }
            __syncthreads();
        }
        if (t == 0 && in_grid) {
#pragma unroll
            for (int q = 0; q < KT; ++q)
                if (k0 + q < k_total)
                    counts[(long long)(k0 + q) * n + row] = cnt[q];
            if (k0 == 0) values[row] = vals;
        }
    }
}

template <int KT>
void launch_count(int long_rows, unsigned blocks_warp, unsigned blocks_row,
                  cudaStream_t s, const int32_t* idx, int idx_w,
                  const uint8_t* lev, int lev_w, const int32_t* nv,
                  const int32_t* kind, const int32_t* base,
                  const int32_t* size, const uint8_t* table, int k, int dn,
                  int n, int vmax, int max_def, int negate, int wide,
                  int32_t* counts, int32_t* values)
{
    if (long_rows)
        dict_count_kernel<KT, kBlock><<<blocks_row, kBlock, 0, s>>>(
            idx, idx_w, lev, lev_w, nv, kind, base, size, table, k, dn, n,
            vmax, max_def, negate, wide, counts, values);
    else
        dict_count_kernel<KT, 32><<<blocks_warp, kBlock, 0, s>>>(
            idx, idx_w, lev, lev_w, nv, kind, base, size, table, k, dn, n,
            vmax, max_def, negate, wide, counts, values);
}

__global__ void __launch_bounds__(kBlock) dict_lookup_kernel(
    const int32_t* __restrict__ planes, int n_planes, int dn,
    const int32_t* __restrict__ gidx, long long m, int32_t* __restrict__ out)
{
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < m; i += stride) {
        const int g0 = gidx[i];
        const int g = g0 < 0 ? 0 : (g0 >= dn ? dn - 1 : g0);
        for (int p = 0; p < n_planes; ++p)
            out[p * m + i] = __ldg(planes + (long long)p * dn + g);
    }
}

}  // namespace

// idx: [n, idx_w] int32; lev: [n, lev_w] u8 (unread when max_def == 0);
// num_values, page_kind, dict_base, dict_size: [n] int32; table: [k, dn] u8;
// counts: [k, n] int32; values: [n] int32.  n >= 1, k >= 1, dn >= 1.
extern "C" int dpq_dict_count(
    const void* idx, int idx_w, const void* lev, int lev_w,
    const void* num_values, const void* page_kind, const void* dict_base,
    const void* dict_size, const void* table, int k, int dn, int n, int vmax,
    int max_def, int negate, void* counts, void* values, void* stream)
{
    // 16-byte loads need 16-byte aligned rows
    const int wide = idx_w % 4 == 0 && (uintptr_t)idx % 16 == 0
                     && (max_def == 0
                         || (lev_w % 16 == 0 && (uintptr_t)lev % 16 == 0));
    const int long_rows = vmax > 32 * kVec * 2;
    const unsigned blocks_warp = (unsigned)((n + kBlock / 32 - 1)
                                            / (kBlock / 32));
    const unsigned blocks_row = (unsigned)n;
    cudaStream_t s = (cudaStream_t)stream;
#define DPQ_COUNT(KT)                                                        \
    launch_count<KT>(long_rows, blocks_warp, blocks_row, s,                  \
                     (const int32_t*)idx, idx_w, (const uint8_t*)lev, lev_w, \
                     (const int32_t*)num_values, (const int32_t*)page_kind,  \
                     (const int32_t*)dict_base, (const int32_t*)dict_size,   \
                     (const uint8_t*)table, k, dn, n, vmax, max_def,         \
                     negate != 0, wide, (int32_t*)counts, (int32_t*)values)
    switch (k < 4 ? k : 4) {
    case 1: DPQ_COUNT(1); break;
    case 2: DPQ_COUNT(2); break;
    case 3: DPQ_COUNT(3); break;
    default: DPQ_COUNT(4); break;
    }
#undef DPQ_COUNT
    return (int)cudaGetLastError();
}

// planes: [n_planes, dn] int32; gidx: [m] int32; out: [n_planes, m] int32.
extern "C" int dpq_dict_lookup(const void* planes, int n_planes, int dn,
                               const void* gidx, long long m, void* out,
                               void* stream)
{
    long long blocks = (m + kBlock - 1) / kBlock;
    if (blocks > 1024) blocks = 1024;
    dict_lookup_kernel<<<(unsigned)blocks, kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)planes, n_planes, dn, (const int32_t*)gidx, m,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
