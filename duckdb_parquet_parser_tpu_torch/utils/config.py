"""Engine configuration: one dataclass plus `DPQ_*` environment overrides.

The port's own copy of `duckdb_parquet_parser_tpu/utils/config.py`, cut to
the fields the port reads, with the reference's defaults (its writer,
Pallas and metrics switches have no reader here).  One field differs by
design: `scan_engine` names the port's engines, "torch" (the device
pipeline, the reference's "jax"; on `device="cpu"` it is the golden model
the reference calls "numpy") and "native" (the fused host scan).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass
class EngineConfig:
    # format / layout
    index_chunk_size: int = 4096       # bytes a chunk holds before it flushes
    batch_align: int = 128             # device trailing-dim padding

    # scan
    scan_engine: str = "torch"         # "torch" | "native"
    max_dfa_states: int = 4096

    # parallel
    pages_per_shard_multiple: int = 8
    exchange_capacity_slack: float = 1.0
    exchange_mode: str = "ragged"      # "ragged": exact-size all_to_all with
                                       # split sizes; "padded": dense
                                       # [D, D, cap] buckets

    # observability
    profile_dir: str | None = None     # torch.profiler trace output

    @classmethod
    def from_env(cls, prefix: str = "DPQ_") -> "EngineConfig":
        cfg = cls()
        for f in fields(cls):
            key = prefix + f.name.upper()
            if key in os.environ:
                raw = os.environ[key]
                default = getattr(cfg, f.name)
                cast = type(default) if isinstance(default, (int, float)) \
                    else str
                setattr(cfg, f.name, cast(raw))
        return cfg


_default: EngineConfig | None = None


def get_config() -> EngineConfig:
    global _default
    if _default is None:
        _default = EngineConfig.from_env()
    return _default


def set_config(cfg: EngineConfig | None) -> None:
    """Installs `cfg` as the process default (None re-reads the env on next
    get_config) — tests and embedding applications use this."""
    global _default
    _default = cfg
