"""Engine configuration: one dataclass plus `DPQ_*` environment overrides.

The port's own copy of `duckdb_parquet_parser_tpu/utils/config.py`, cut to
the fields the port reads (the reference's JAX, Pallas and exchange
switches have no meaning here).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


@dataclass
class EngineConfig:
    # format / layout
    batch_align: int = 128             # device trailing-dim padding

    # scan
    max_dfa_states: int = 4096

    # observability
    profile_dir: str | None = None     # torch.profiler trace output

    @classmethod
    def from_env(cls, prefix: str = "DPQ_") -> "EngineConfig":
        cfg = cls()
        for f in fields(cls):
            key = prefix + f.name.upper()
            if key in os.environ:
                raw = os.environ[key]
                is_int = isinstance(getattr(cfg, f.name), int)
                setattr(cfg, f.name, int(raw) if is_int else raw)
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
