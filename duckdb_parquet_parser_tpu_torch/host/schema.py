"""Schema objects and enum mirrors for the Parquet engine (the port's own
copy of `duckdb_parquet_parser_tpu/host/schema.py`).

Python mirrors of the host library's enums (values fixed by the Parquet spec;
the reference defines the same sets in include/common.hpp:16-106) plus the
`ColumnInfo` descriptor matching the reference's surface
(include/reader/column_info.hpp:6-20).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ParquetType(enum.IntEnum):
    BOOLEAN = 0
    INT32 = 1
    INT64 = 2
    INT96 = 3
    FLOAT = 4
    DOUBLE = 5
    BYTE_ARRAY = 6
    FIXED_LEN_BYTE_ARRAY = 7


class Encoding(enum.IntEnum):
    PLAIN = 0
    GROUP_VAR_INT = 1
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    DELTA_BINARY_PACKED = 5
    DELTA_LENGTH_BYTE_ARRAY = 6
    DELTA_BYTE_ARRAY = 7
    RLE_DICTIONARY = 8
    BYTE_STREAM_SPLIT = 9


class CompressionCodec(enum.IntEnum):
    UNCOMPRESSED = 0
    SNAPPY = 1
    GZIP = 2
    LZO = 3
    BROTLI = 4
    LZ4 = 5
    ZSTD = 6
    LZ4_RAW = 7


class PageType(enum.IntEnum):
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


class FieldRepetitionType(enum.IntEnum):
    REQUIRED = 0
    OPTIONAL = 1
    REPEATED = 2


class ConvertedType(enum.IntEnum):
    NONE = -1
    UTF8 = 0
    MAP = 1
    MAP_KEY_VALUE = 2
    LIST = 3
    ENUM = 4
    DECIMAL = 5
    DATE = 6
    TIME_MILLIS = 7
    TIME_MICROS = 8
    TIMESTAMP_MILLIS = 9
    TIMESTAMP_MICROS = 10
    UINT_8 = 11
    UINT_16 = 12
    UINT_32 = 13
    UINT_64 = 14
    INT_8 = 15
    INT_16 = 16
    INT_32 = 17
    INT_64 = 18
    JSON = 19
    BSON = 20
    INTERVAL = 21


@dataclass(frozen=True)
class ColumnInfo:
    """Leaf-column descriptor (parity: reference ColumnInfo)."""

    name: str
    type: ParquetType
    column_index: int
    max_def_level: int
    max_rep_level: int
    repetition: FieldRepetitionType | None = None
    converted_type: ConvertedType | None = None
    type_length: int | None = None

    def type_name(self) -> str:
        return self.type.name

    def converted_type_string(self) -> str:
        return self.converted_type.name if self.converted_type is not None else "NONE"

    def is_required(self) -> bool:
        return self.repetition == FieldRepetitionType.REQUIRED

    def is_optional(self) -> bool:
        return self.repetition == FieldRepetitionType.OPTIONAL

    def is_repeated(self) -> bool:
        return self.repetition == FieldRepetitionType.REPEATED


@dataclass(frozen=True)
class PageIndexEntry:
    """Offset/size/location of one global data page (parity: reference
    PageIndexEntry, include/reader/parquet_reader.hpp:12-17)."""

    data_offset: int
    data_size: int
    row_group_idx: int
    column_idx: int


@dataclass
class RawPage:
    page_id: int
    row_group_idx: int
    column_idx: int
    data: bytes
