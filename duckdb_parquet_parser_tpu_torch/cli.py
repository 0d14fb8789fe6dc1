"""Command-line interface.

Counterpart of `duckdb_parquet_parser_tpu.cli`: the same six modes, the same
exit codes (1: the file cannot be opened; 2: bad arguments or a regex scan
of a column that is not BYTE_ARRAY) and, for the same file and arguments,
the same bytes on stdout.

  dpq-torch <file>                        print schema, row groups, page sizes
  dpq-torch <file> --regex-column C --regex P [--neg-regex] [--rows] [--like]
                                          report data pages with NO values
                                          matching P (NOT LIKE via --neg-regex)
  dpq-torch index <file> <column> [--chunk-size N]
                                          chunked inverted index totals
  dpq-torch column <file> <column> [--row-group N]
                                          one line per row of the column
  dpq-torch table <file> [columns...] [--limit N]
                                          whole-file read, first rows
  dpq-torch stats <file> <column> [--prune-op OP --value V [--hi V]]
                                          Page Index statistics and pruning

--engine native|torch selects the match backend: native is the fused
one-shot host scan (the default), torch the device pipeline (the resident
layout, the stream matcher and the dictionary kernel).  --device cuda|cpu
says where the device pipeline and the --rows listing run: on the card by
default, where they raise without one; `--engine torch --device cpu` is
the golden model (the reference's `--engine numpy`).  Run it as
`python -m duckdb_parquet_parser_tpu_torch.cli`.
"""

from __future__ import annotations

import argparse
import sys


from .host.reader import ParquetReader
from .host.schema import PageType
from .ops.index import build_index_for_column
from .ops.regex import like_to_regex
from .ops.scan import match_rows, scan_batch


def _print_file_info(reader: ParquetReader) -> None:
    sys.stdout.write(reader.schema_string())
    pages = reader._pages  # page table incl. dictionary pages
    print()
    for rg_idx, rg in enumerate(reader.metadata()["row_groups"]):
        print(f"Row group {rg_idx}: {rg['num_rows']} rows, "
              f"{rg['total_byte_size']} bytes")
        for col_idx, info in enumerate(reader.columns()):
            sel = (pages["rg"] == rg_idx) & (pages["col"] == info.column_index)
            kinds = pages["kind"][sel]
            sizes = pages["size"][sel]
            n_data = int((kinds == PageType.DATA_PAGE).sum())
            n_dict = int((kinds == PageType.DICTIONARY_PAGE).sum())
            dict_note = f" + {n_dict} dict" if n_dict else ""
            print(
                f"  {info.name}: {n_data} data pages{dict_note}, "
                f"page sizes [{sizes.min() if len(sizes) else 0}"
                f"..{sizes.max() if len(sizes) else 0}] bytes"
            )
    print(f"\nTotal data pages: {reader.num_pages()}")


def _run_regex_scan(reader: ParquetReader, args) -> int:
    from .host.schema import ParquetType
    from .models.scan import ResidentColumn, cold_scan
    from .ops.regex import UnsupportedPattern, compile_pattern

    info = reader.column(args.regex_column)
    if info.type != ParquetType.BYTE_ARRAY:
        print(
            f"error: regex scan requires a BYTE_ARRAY column; "
            f"'{args.regex_column}' is {info.type_name()}",
            file=sys.stderr,
        )
        return 2

    pattern = like_to_regex(args.regex) if args.like else args.regex
    rows_batch = None  # pad_strings batch reusable by --rows (avoids a
    # second prescan — the dominant cold-path cost on large files)
    if args.engine == "native":
        # one-shot default: the fused host scan answers straight off the
        # file mapping — no batch packing, no device upload
        result = cold_scan(reader, args.regex_column, pattern,
                           negate=args.neg_regex, exact_counts=True)
    else:
        try:
            compile_pattern(pattern)
        except UnsupportedPattern:
            # outside the DFA subset: the host `re` route of scan_batch
            rows_batch = reader.prescan(args.regex_column, pad_strings=8)
            result = scan_batch(rows_batch, pattern, negate=args.neg_regex,
                                device=args.device)
        else:
            result = ResidentColumn(
                reader, args.regex_column, device=args.device,
            ).scan(pattern, negate=args.neg_regex)
    total_match = int(result.match_counts.sum())
    total_vals = int(result.value_counts.sum())
    mode = "NOT matching" if args.neg_regex else "matching"
    print(
        f"Scanned column '{args.regex_column}': {len(result.page_gid)} data "
        f"pages, {total_vals} values, {total_match} {mode} '{args.regex}'"
    )
    pruned = result.pruned_pages()
    print(f"Pages with no {mode} values ({len(pruned)}):")
    for gid in pruned:
        e = reader.page_index_entry(int(gid))
        print(f"  page {int(gid)} (row_group={e.row_group_idx}, "
              f"size={e.data_size})")
    if args.rows:
        if rows_batch is None:
            rows_batch = reader.prescan(args.regex_column, pad_strings=8)
        rows = match_rows(rows_batch, pattern, negate=args.neg_regex,
                          device=args.device)
        head = ", ".join(str(r) for r in rows[:10])
        tail = ", ..." if len(rows) > 10 else ""
        print(f"Matching rows ({len(rows)}): {head}{tail}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if argv and argv[0] == "index":
        ap = argparse.ArgumentParser(prog="dpq-torch index")
        ap.add_argument("file")
        ap.add_argument("column")
        ap.add_argument("--chunk-size", type=int, default=4096)
        args = ap.parse_args(argv[1:])
        reader = ParquetReader()
        if not reader.open(args.file):
            print(f"error: cannot open {args.file}", file=sys.stderr)
            return 1
        idx = build_index_for_column(reader, args.column, args.chunk_size)
        print(f"Total tuples: {idx.num_rows}")
        print(f"Total chunks: {idx.num_chunks}")
        return 0

    if argv and argv[0] == "column":
        # one Value::to_string() line per row (NULL / true/false / ints /
        # %f doubles / raw strings)
        ap = argparse.ArgumentParser(prog="dpq-torch column")
        ap.add_argument("file")
        ap.add_argument("column")
        ap.add_argument("--row-group", type=int, default=None)
        args = ap.parse_args(argv[1:])
        reader = ParquetReader()
        if not reader.open(args.file):
            print(f"error: cannot open {args.file}", file=sys.stderr)
            return 1
        col = reader.read_column(args.column, args.row_group)
        out = col.to_strings()
        sys.stdout.write("\n".join(out) + ("\n" if out else ""))
        return 0

    if argv and argv[0] == "table":
        # one-call whole-file read with per-shape reconstruction (generic
        # Dremel assembly for nested fields)
        ap = argparse.ArgumentParser(prog="dpq-torch table")
        ap.add_argument("file")
        ap.add_argument("columns", nargs="*",
                        help="top-level fields (default: all)")
        ap.add_argument("--limit", type=int, default=10,
                        help="rows to print (0 = totals only)")
        args = ap.parse_args(argv[1:])
        reader = ParquetReader()
        if not reader.open(args.file):
            print(f"error: cannot open {args.file}", file=sys.stderr)
            return 1
        tab = reader.read_table(args.columns or None)
        names = list(tab)
        n = len(tab[names[0]]) if names else 0
        print(f"Rows: {n}  Columns: {', '.join(names)}")
        if args.limit > 0 and names:
            lists = {f: tab[f].to_pylist()[:args.limit] for f in names}
            for r in range(min(args.limit, n)):
                print(" | ".join(repr(lists[f][r]) for f in names))
        return 0

    if argv and argv[0] == "stats":
        # Page Index stats + optional stats-based pruning
        ap = argparse.ArgumentParser(prog="dpq-torch stats")
        ap.add_argument("file")
        ap.add_argument("column")
        ap.add_argument("--prune-op",
                        choices=["==", "<", "<=", ">", ">=", "between"])
        ap.add_argument("--value", help="predicate value (typed per column)")
        ap.add_argument("--hi", help="upper bound for 'between'")
        args = ap.parse_args(argv[1:])
        reader = ParquetReader()
        if not reader.open(args.file):
            print(f"error: cannot open {args.file}", file=sys.stderr)
            return 1
        ps = reader.page_stats(args.column)
        n_st = int(ps.has_stats.sum())
        print(f"Column '{args.column}': {len(ps)} data pages, "
              f"{n_st} with ColumnIndex stats")
        for rg_stat in reader.column_stats(args.column):
            print(f"  row-group stats: {rg_stat}")
        if args.prune_op:
            info = reader.columns()[reader.find_column(args.column)]
            conv = (bytes.fromhex if info.type.name in
                    ("BYTE_ARRAY", "FIXED_LEN_BYTE_ARRAY") else
                    (float if info.type.name in ("FLOAT", "DOUBLE") else int))
            val = conv(args.value)
            hi = conv(args.hi) if args.hi is not None else None
            pruned = ps.prune(args.prune_op, val, hi)
            print(f"Pages that cannot match ({len(pruned)}):")
            print(" ".join(str(int(g)) for g in pruned))
        return 0

    ap = argparse.ArgumentParser(
        prog="dpq-torch", description="Parquet scan engine (PyTorch + CUDA)"
    )
    ap.add_argument("file")
    ap.add_argument("--regex-column", help="column to scan")
    ap.add_argument("--regex", help="pattern to match against values")
    ap.add_argument("--neg-regex", action="store_true",
                    help="invert the match (NOT LIKE)")
    ap.add_argument("--rows", action="store_true",
                    help="also list the absolute row ids of matching values")
    ap.add_argument("--like", action="store_true",
                    help="treat the pattern as a SQL LIKE expression")
    ap.add_argument("--engine", choices=["native", "torch"],
                    default="native",
                    help="native = fused one-shot host scan (default); "
                    "torch = device pipeline")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the device pipeline and --rows run "
                    "(default: the card; raises without one)")
    args = ap.parse_args(argv)

    reader = ParquetReader()
    if not reader.open(args.file):
        print(f"error: cannot open {args.file}", file=sys.stderr)
        return 1

    if args.regex_column or args.regex:
        if not (args.regex_column and args.regex):
            print("error: --regex-column and --regex must be used together",
                  file=sys.stderr)
            return 2
        return _run_regex_scan(reader, args)

    _print_file_info(reader)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
