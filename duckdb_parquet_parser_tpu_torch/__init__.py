"""duckdb_parquet_parser_tpu_torch — the Parquet regex page-pruning scan in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of `duckdb_parquet_parser_tpu` (the JAX reference, which stays in the
repository unchanged).  Module names mirror the reference so every port
module has an obvious counterpart.  The package imports `torch` and never
`jax` and nothing of the reference: it keeps its own copies of the host
layer (native prescan bindings, writer, schema, config) and of the regex
and register-machine compilers.

Public entry points: `models.scan.ScanEngine` and `ResidentColumn`, the
command line (`python -m duckdb_parquet_parser_tpu_torch.cli`) and, for runs
sharded over several devices (one process a device, `parallel/mesh.py`),
`python -m duckdb_parquet_parser_tpu_torch.launch`.  Every entry point takes
an explicit `device`; CUDA tensors go through the kernels in `ops/kernels/`
and CPU tensors through their plain PyTorch versions.
"""

from .version import __version__

__all__ = ["__version__", "ScanEngine", "ResidentColumn", "ParquetReader"]

_LAZY = {
    "ScanEngine": ("duckdb_parquet_parser_tpu_torch.models.scan", "ScanEngine"),
    "ResidentColumn": ("duckdb_parquet_parser_tpu_torch.models.scan",
                       "ResidentColumn"),
    "ParquetReader": ("duckdb_parquet_parser_tpu_torch.host.reader",
                      "ParquetReader"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
