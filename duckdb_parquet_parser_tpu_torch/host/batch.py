"""DecodeBatch — the prescan's page batch, and its move onto a device.

Counterpart of `duckdb_parquet_parser_tpu.host.batch.DecodeBatch`.  It holds
the native prescan's `dims` and numpy `arrays` — the same output both
packages get from `host.bindings.native_prescan` — with typed views (the
int32 value planes of the fixed-width decode) and page slicing, and
`to_device` turns the arrays into tensors on a torch device.  The
reference's per-page local dictionary tables (`dict_planes_pp`) served its
select-based lookup, a cost choice of the TPU with identical outputs; the
port gathers from the one concatenated table and does not build them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np
import torch

from ..ops import decode as _decode
from ..utils.tracing import count
from .schema import ParquetType

_PER_PAGE_ARRAYS = [
    "page_num_values", "page_nn", "page_kind", "page_def_bw", "page_idx_bw",
    "page_def_nruns", "page_idx_nruns", "page_row_start", "page_gid",
    "page_rg", "page_dict_base", "page_dict_size",
    "def_run_kind", "def_run_count", "def_run_value", "def_run_bitoff",
    "def_run_vstart", "idx_run_kind", "idx_run_count", "idx_run_value",
    "idx_run_bitoff", "idx_run_vstart",
    "def_bytes", "idx_bytes", "plain_fixed", "bool_bits",
    "payload", "page_payload_len",
    "def_levels", "idx_vals",
]


_NUMPY_DTYPES = {
    ParquetType.INT32: np.dtype("<i4"),
    ParquetType.INT64: np.dtype("<i8"),
    ParquetType.FLOAT: np.dtype("<f4"),
    ParquetType.DOUBLE: np.dtype("<f8"),
}


def to_tensor(a: np.ndarray, device, rows=None, dtype=None) -> torch.Tensor:
    """A copy of `a` (or of its rows `rows`, as `dtype`) as a tensor on
    `device`.  The prescan's arrays are read-only views over native memory,
    so they are copied before torch wraps them."""
    a = np.asarray(a)
    a = a.copy(order="C") if rows is None else a[rows]  # owned memory
    a = np.ascontiguousarray(a, dtype=dtype)
    count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


@dataclass
class DecodeBatch:
    dims: dict
    arrays: dict = field(repr=False)

    @property
    def n_pages(self) -> int:
        return int(self.dims["n_pages"])

    @property
    def type(self) -> ParquetType:
        return ParquetType(self.dims["type"])

    @property
    def max_def(self) -> int:
        return int(self.dims["max_def"])

    @property
    def vmax(self) -> int:
        return int(self.dims["vmax"])

    @property
    def nn_cap(self) -> int:
        return int(self.dims["nn_cap"])

    @property
    def total_rows(self) -> int:
        return int(self.arrays["page_num_values"].sum())

    @property
    def value_dtype(self) -> np.dtype | None:
        return _NUMPY_DTYPES.get(self.type)

    @cached_property
    def mode(self) -> str:
        """Static decode specialization: 'plain' | 'dict' | 'mixed'."""
        kinds = np.unique(self.arrays["page_kind"])
        if kinds.size <= 1:
            return "dict" if (kinds.size and kinds[0] == 1) else "plain"
        return "mixed"

    @cached_property
    def plain_planes(self) -> list[np.ndarray]:
        w = int(self.dims["plain_w"])
        if w == 0 or "plain_fixed" not in self.arrays:
            return []
        return _decode.fixed_planes_from_bytes(self.arrays["plain_fixed"], w)

    @cached_property
    def dict_planes(self) -> list[np.ndarray]:
        if "dict_fixed" not in self.arrays:
            return []
        w = self.arrays["dict_fixed"].shape[1]
        return _decode.dict_planes_from_bytes(self.arrays["dict_fixed"],
                                              int(w))

    @property
    def bool_bits(self) -> np.ndarray | None:
        return self.arrays.get("bool_bits")

    def slice_pages(self, lo: int, hi: int) -> "DecodeBatch":
        """A view batch over pages [lo, hi) (string globals kept whole)."""
        dims = dict(self.dims)
        dims["n_pages"] = hi - lo
        arrays = dict(self.arrays)
        for name in _PER_PAGE_ARRAYS:
            if name in arrays:
                arrays[name] = arrays[name][lo:hi]
        if "str_nn_start" in arrays:
            arrays["str_nn_start"] = arrays["str_nn_start"][lo:hi + 1]
        return DecodeBatch(dims, arrays)

    def to_device(self, device, names=None, rows=None) -> dict:
        """{name: tensor on `device`} for `names` (default: every array),
        with the per-page arrays restricted to page rows `rows` when
        given."""
        names = self.arrays.keys() if names is None else names
        return {k: to_tensor(self.arrays[k], device,
                             rows if k in _PER_PAGE_ARRAYS else None)
                for k in names if k in self.arrays}
