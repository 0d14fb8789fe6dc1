"""The port's benchmark: data-driven cells over `duckdb_parquet_parser_tpu_torch`.

`python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on a CUDA card and prints one JSON line.
"""
