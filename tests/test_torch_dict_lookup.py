"""Dictionary lookup K2 (duckdb_parquet_parser_tpu_torch/ops/kernels/
dict_lookup.py) against the reference's Pallas kernel `dict_lookup_pallas`,
which runs in interpret mode on the CPU.  CPU tensors take the port's plain
version; the kernel-vs-plain cases need a CUDA device.  Tolerance 0: the
outputs are int32 planes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from duckdb_parquet_parser_tpu_torch.ops.kernels import dict_lookup


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dn, n_planes, seed=0, shape=(37, 29)):
    rng = np.random.default_rng(seed + dn + n_planes)
    planes = [rng.integers(-2**31, 2**31, dn, dtype=np.int64).astype(np.int32)
              for _ in range(n_planes)]
    g = rng.integers(0, dn, shape).astype(np.int32)
    g.flat[:4] = [0, dn - 1, dn - 1, 0]  # table edges
    return planes, g


@pytest.mark.parametrize("n_planes", [1, 2, 3])
@pytest.mark.parametrize("dn", [513, 1000, 4096, 8192])
def test_matches_pallas(dn, n_planes):
    import jax.numpy as jnp

    from duckdb_parquet_parser_tpu.ops.pallas.dict_lookup import (
        dict_lookup_pallas,
    )

    planes, g = _case(dn, n_planes)
    want = dict_lookup_pallas([jnp.asarray(p) for p in planes],
                              jnp.asarray(g), dn)
    got = dict_lookup.dict_lookup([torch.from_numpy(p) for p in planes],
                                  torch.from_numpy(g))
    assert len(got) == n_planes
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_empty_planes_and_unsupported_device():
    assert dict_lookup.dict_lookup([], torch.zeros((2, 2), dtype=torch.int32)) == []
    with pytest.raises(ValueError):
        dict_lookup.dict_lookup(
            [torch.zeros(4, dtype=torch.int32, device="meta")],
            torch.zeros((2, 2), dtype=torch.int32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_planes", [1, 3, 16])
@pytest.mark.parametrize("dn", [1, 513, 4096, 8192])
def test_kernel_matches_plain(cuda, dn, n_planes):
    planes, g = _case(dn, n_planes, shape=(301, 64))
    tp = [torch.from_numpy(p).to(cuda) for p in planes]
    tg = torch.from_numpy(g).to(cuda)
    before = dict_lookup.launches
    got = dict_lookup.dict_lookup(tp, tg)
    want = dict_lookup.dict_lookup_plain(tp, tg)
    torch.cuda.synchronize()
    assert dict_lookup.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_checks_its_inputs(cuda):
    p = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dict_lookup.dict_lookup([p], torch.zeros((2, 2), dtype=torch.int64,
                                                 device=cuda))
    with pytest.raises(ValueError):
        dict_lookup.dict_lookup([p.to(torch.int64)],
                                torch.zeros((2, 2), dtype=torch.int32,
                                            device=cuda))
