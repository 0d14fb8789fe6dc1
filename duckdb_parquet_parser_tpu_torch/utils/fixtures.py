"""Seeded Parquet fixtures for the port's smoke run and benchmarks.

`lineitem` writes the same file as the reference benchmark's
`bench.gen_fixture` (TPC-H-lineitem-like: an `l_comment` string column of
five words each, 1% null, beside INT64/DOUBLE columns, 500,000-row row
groups); `dict_strings` writes a dictionary-encoded string column over
several row groups, each with its own distinct values.  Both use the shared
JAX-free writer and return the path, writing only when it does not exist.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from duckdb_parquet_parser_tpu.host.schema import ParquetType
from duckdb_parquet_parser_tpu.host.writer import ColumnSpec, ParquetWriter

LINEITEM_WORDS = [
    b"carefully", b"furiously", b"quickly", b"slyly", b"blithely", b"requests",
    b"deposits", b"packages", b"accounts", b"theodolites", b"pending", b"final",
    b"special", b"express", b"regular", b"ironic", b"unusual", b"bold",
    b"among", b"across", b"above", b"sleep", b"haggle", b"nag", b"wake",
]
CITY_BASES = [b"san diego", b"san francisco", b"new york", b"new orleans",
              b"chicago", b"boston", b"seattle", b"denver"]


def lineitem(path, rows: int, seed: int = 2026) -> Path:
    """`rows` lineitem-like rows: l_quantity INT64, l_extendedprice DOUBLE,
    l_tax DOUBLE (10% null) and l_comment BYTE_ARRAY (1% null)."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = ParquetWriter(
        str(path),
        [ColumnSpec("l_quantity", ParquetType.INT64),
         ColumnSpec("l_extendedprice", ParquetType.DOUBLE),
         ColumnSpec("l_tax", ParquetType.DOUBLE, optional=True),
         ColumnSpec("l_comment", ParquetType.BYTE_ARRAY, optional=True)],
        key_value={"pad": "x" * 512},
    )
    lens_of = np.array([len(x) for x in LINEITEM_WORDS])
    done = 0
    while done < rows:
        n = min(500_000, rows - done)
        pick = rng.integers(0, len(LINEITEM_WORDS), (n, 5))
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens_of[pick].sum(axis=1) + 4, out=offs[1:])
        chars = np.full(offs[-1], ord(" "), np.uint8)
        at = offs[:-1].copy()
        for k in range(5):
            for wi, word in enumerate(LINEITEM_WORDS):
                sel = pick[:, k] == wi
                if not sel.any():
                    continue
                wb = np.frombuffer(word, np.uint8)
                idx = at[sel][:, None] + np.arange(len(wb))[None, :]
                chars[idx.ravel()] = np.tile(wb, int(sel.sum()))
            at += lens_of[pick[:, k]] + 1
        valid = (rng.random(n) > 0.01).astype(np.uint8)
        valid_tax = (rng.random(n) > 0.10).astype(np.uint8)
        w.write_row_group({
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.random(n) * 1e5,
            "l_tax": (rng.random(n) * 0.1, valid_tax),
            "l_comment": (offs, chars, valid),
        })
        done += n
    w.close()
    return path


def dict_strings(path, rows_per_rg: int, n_rg: int, distinct: int,
                 seed: int = 11) -> Path:
    """A `city` BYTE_ARRAY column (2% null), dictionary-encoded: row group
    `rg` draws from its own `distinct` values, so the concatenated
    dictionary holds n_rg * distinct entries."""
    path = Path(path)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = ParquetWriter(str(path), [ColumnSpec("city", ParquetType.BYTE_ARRAY,
                                             optional=True)],
                      key_value={"pad": "x" * 512})
    for rg in range(n_rg):
        pool = [CITY_BASES[k % len(CITY_BASES)] + f"-{rg}{k}".encode()
                for k in range(distinct)]
        pick = rng.integers(0, distinct, rows_per_rg)
        valid = rng.random(rows_per_rg) > 0.02
        w.write_row_group({"city": [pool[int(k)] if v else None
                                    for k, v in zip(pick, valid)]})
    w.close()
    return path
