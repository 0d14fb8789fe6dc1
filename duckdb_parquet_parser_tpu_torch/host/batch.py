"""DecodeBatch — the prescan's page batch, and its move onto a device.

JAX-free counterpart of `duckdb_parquet_parser_tpu.host.batch.DecodeBatch`
(whose module imports the reference's JAX decode).  It holds the native
prescan's `dims` and numpy `arrays` — the same output both packages get
from `host.bindings.native_prescan` — and `to_device` turns them into
tensors on a torch device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

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


def to_tensor(a: np.ndarray, device, rows=None, dtype=None) -> torch.Tensor:
    """A copy of `a` (or of its rows `rows`, as `dtype`) as a tensor on
    `device`.  The prescan's arrays are read-only views over native memory,
    so they are copied before torch wraps them."""
    a = np.asarray(a)
    a = a.copy(order="C") if rows is None else a[rows]  # owned memory
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


@dataclass
class DecodeBatch:
    dims: dict
    arrays: dict = field(repr=False)

    @property
    def n_pages(self) -> int:
        return int(self.dims["n_pages"])

    @property
    def max_def(self) -> int:
        return int(self.dims["max_def"])

    @property
    def vmax(self) -> int:
        return int(self.dims["vmax"])

    @property
    def nn_cap(self) -> int:
        return int(self.dims["nn_cap"])

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
