"""ParquetReader — a thin host reader over the native library.

JAX-free counterpart of the parts of `duckdb_parquet_parser_tpu.host.
reader.ParquetReader` the scan needs (`__init__`, `open`, `find_column`,
`column`, `prescan`): the reference module imports its JAX decode at
import time.  Everything here goes through the port's own native layer
(`host/bindings.py`: open, metadata, structural prescan).
"""

from __future__ import annotations

from ..utils.config import get_config
from . import bindings
from .batch import DecodeBatch
from .schema import (
    ColumnInfo,
    ConvertedType,
    FieldRepetitionType,
    ParquetType,
)


class ParquetReader:
    """Opens a Parquet file and serves its schema and prescan batches."""

    def __init__(self, path: str):
        self.handle = None
        self.path = str(path)
        try:
            self.handle = bindings.native_open(self.path)
        except bindings.NativeError as e:
            raise IOError(f"cannot open parquet file: {path}: {e}") from e
        self._meta = bindings.native_meta(self.handle)
        self._columns = [
            ColumnInfo(
                name=c["name"],
                type=ParquetType(c["type"]),
                column_index=c["chunk_idx"],
                max_def_level=c["max_def"],
                max_rep_level=c["max_rep"],
                repetition=(FieldRepetitionType(c["repetition"])
                            if "repetition" in c else None),
                converted_type=(ConvertedType(c["converted"])
                                if "converted" in c else None),
                type_length=c.get("type_length"),
            )
            for c in self._meta["columns"]
        ]
        self._by_name = {c.name: i for i, c in enumerate(self._columns)}

    def close(self) -> None:
        if self.handle is not None:
            bindings.lib().dpq_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def num_rows(self) -> int:
        return int(self._meta["num_rows"])

    def find_column(self, name: str) -> int:
        """Leaf index by name, then by dotted schema path, then by a unique
        run of path segments (the reference reader's rules); -1 if none."""
        idx = self._by_name.get(name, -1)
        if idx >= 0:
            return idx
        cols = self._meta["columns"]
        hits = [i for i, c in enumerate(cols) if c.get("path") == name]
        if not hits:
            want = name.split(".")
            w = len(want)

            def seg_hit(p: str) -> bool:
                segs = p.split(".")
                return any(segs[s:s + w] == want
                           for s in range(len(segs) - w + 1))

            hits = [i for i, c in enumerate(cols)
                    if (p := c.get("path", "")) and seg_hit(p)]
        return hits[0] if len(hits) == 1 else -1

    def column(self, key) -> ColumnInfo:
        if isinstance(key, str):
            idx = self.find_column(key)
            if idx < 0:
                raise KeyError(f"Column not found: {key}")
            return self._columns[idx]
        if key < 0 or key >= len(self._columns):
            raise IndexError(f"Column index {key} out of range")
        return self._columns[key]

    def prescan(self, column: str | int, rg0: int = 0, rg1: int = -1,
                pad_strings: int = 0, flags: int = bindings.PS_PAYLOAD,
                payload_align: int = 0) -> DecodeBatch:
        """The native structural prescan of one column over row groups
        [rg0, rg1) (-1: to the end)."""
        idx = self.find_column(column) if isinstance(column, str) else column
        if idx < 0:
            raise KeyError(f"Column not found: {column}")
        dims, arrays = bindings.native_prescan(
            self.handle, idx, rg0, rg1, get_config().batch_align,
            pad_strings, flags, payload_align)
        return DecodeBatch(dims, arrays)
