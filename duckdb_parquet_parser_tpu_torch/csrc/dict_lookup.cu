// Dictionary lookup for Hopper (sm_90a): out[p][i] = planes[p][gidx[i]].
//
// Replaces the TPU kernel duckdb_parquet_parser_tpu/ops/pallas/
// dict_lookup.py::_kernel, which does this lookup as a bf16 8-bit-limb
// one-hot matmul on the MXU because TPU gathers are slow.  On the H100 a
// gather is native: each thread produces one output position (all planes)
// by reading the table through the read-only cache (__ldg); at most 1024
// blocks stride over the positions.  Indices are pre-clipped to [0, DN) by
// the caller; the kernel clamps them again so a bad index cannot read
// outside the table.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256) dpq_dict_lookup_ldg(
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

// planes: [n_planes, dn] int32; gidx: [m] int32; out: [n_planes, m] int32.
extern "C" int dpq_dict_lookup(const void* planes, int n_planes, int dn,
                               const void* gidx, long long m, void* out,
                               void* stream)
{
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    if (blocks > 1024) blocks = 1024;
    dpq_dict_lookup_ldg<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)planes, n_planes, dn, (const int32_t*)gidx, m,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
