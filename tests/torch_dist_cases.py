"""The sharded paths' test cases, written once for both packages.

`run_cases(M, mesh, n, paths, names)` drives the distributed scan, the two
exchanges, the index build, the sharded emission decode, the sharded
column decode and the elastic routes through the namespace `M`, which
holds either the JAX package's functions (tests/test_torch_distributed.py,
on its virtual CPU mesh) or the port's (in the test process at one rank,
in tests/torch_dist_worker.py's child processes at 2 and 4 ranks).  Every
case flattens its result into named numpy arrays; the two packages' arrays
must be equal in value (and in dtype, but for integer widths).  This module imports numpy only, so the
child processes can import it with JAX and the JAX package blocked.
"""

from __future__ import annotations

import numpy as np

# cases over a string file (run once on a PLAIN and once on a dictionary
# fixture); the second element says at which mesh sizes the case runs
STRING_CASES = [
    ("scan-alpha", (1, 2, 4)),
    ("scan-negate", (1, 2, 4)),
    ("exchange", (1, 2, 4)),
    ("ragged", (1, 2, 4)),
    ("index-ragged", (1, 2, 4)),
    ("index-padded", (1, 2, 4)),
    ("emissions", (1, 2, 4)),
    ("elastic-none", (1,)),
    ("elastic-one", (2, 4)),
    ("elastic-cascade", (4,)),
    ("elastic-index", (2, 4)),
    ("engine-hook", (2, 4)),
]
# cases with a file of their own
OTHER_CASES = [("decode", (1, 2, 4))]
KINDS = ("plain", "dict")


def case_ids(n: int) -> list[str]:
    """Every "kind/case" id that runs at mesh size `n`."""
    out = [f"{kind}/{name}" for kind in KINDS
           for name, sizes in STRING_CASES if n in sizes]
    return out + [f"k/{name}" for name, sizes in OTHER_CASES if n in sizes]


def _scan_fields(res) -> dict:
    return {f: np.asarray(getattr(res, f))
            for f in ("page_gid", "match_counts", "value_counts", "totals")}


def _ragged_list(arrays) -> dict:
    arrays = [np.asarray(a) for a in arrays]
    return {"lengths": np.array([len(a) for a in arrays], np.int64),
            "rows": (np.concatenate(arrays) if arrays
                     else np.zeros(0, np.int64))}


def _index_fields(res) -> dict:
    out = {f: np.asarray(getattr(res.index, f))
           for f in ("positions", "lens", "chunk_of_entry", "tuple_to_chunk",
                     "chunk_starts")}
    out["num_rows"] = np.int64(res.index.num_rows)
    out["chunk_size"] = np.int64(res.index.chunk_size)
    out["chunk_owners"] = np.asarray(res.chunk_owners)
    out["salted_primary"] = np.asarray(res.salted.primary)
    for k, v in _ragged_list(res.salted.owners).items():
        out["salted_owners_" + k] = v
    for k, v in _ragged_list(res.received).items():
        out["received_" + k] = v
    for f in ("shuffle_bytes", "exchange_capacity", "n_exchange_blocks",
              "exchange_planned_slots"):
        out[f] = np.int64(getattr(res, f))
    out["skew_factor"] = np.float64(res.skew_factor)
    out["exchange_mode"] = np.str_(res.exchange_mode)
    return out


def _report(report) -> dict:
    return {"failed": np.array(report["failed"], np.int64),
            "rounds": np.int64(report["rounds"]),
            "reruns": np.int64(report["reruns"])}


def _exchange_inputs(M, reader, batch, n):
    pos, lens, _offs, _chars = M._string_stream(batch)
    index = M.build_index(pos, lens, reader.num_rows(), 1024)
    sizes = np.diff(np.concatenate([index.chunk_starts, [len(lens)]]))
    owners = M.balanced_chunk_owners(sizes, n)
    dst = owners[index.chunk_of_entry]
    src = (np.arange(len(dst)) * n) // max(len(dst), 1)
    payload = np.stack([pos, lens], axis=1).astype(np.int64)
    return dst, src, payload


def _string_case(M, mesh, n, name, reader, batch, path) -> dict:
    last = n - 1
    if name in ("scan-alpha", "scan-negate"):
        pattern, negate = (("alpha", False) if name == "scan-alpha"
                           else ("o[a-z]t", True))
        res = M.distributed_scan(mesh, M.pad_pages(batch, 8),
                                 M.compile_pattern(pattern), negate=negate)
        return _scan_fields(res)
    if name == "exchange":
        dst, src, payload = _exchange_inputs(M, reader, batch, n)
        plan = M.ExchangePlan.plan(dst, src, n)
        send = plan.build_send_buffer(payload, src, fill=-1)
        return {"recv": np.asarray(M.exchange_entries(mesh, send))}
    if name == "ragged":
        dst, src, payload = _exchange_inputs(M, reader, batch, n)
        plan = M.RaggedExchangePlan.plan(dst, src, n)
        recv = np.asarray(M.ragged_exchange_entries(mesh, plan, payload,
                                                    fill=-1))
        # the receive layout, row for row: valid rows first, source-major
        for d in range(n):
            k = int(plan.recv_total[d])
            assert (recv[d, :k, 0] >= 0).all() and (recv[d, k:] == -1).all()
        return {"recv": recv, "recv_total": np.asarray(plan.recv_total)}
    if name in ("index-ragged", "index-padded"):
        try:
            M.set_config(M.EngineConfig(exchange_mode=name.split("-")[1]))
            res = M.distributed_index_build(mesh, reader, "s",
                                            chunk_size=512)
        finally:
            M.set_config(None)
        return _index_fields(res)
    if name == "emissions":
        pos, lens = M.sharded_emissions(mesh, batch, block_pages=16)
        host_pos, host_lens, _o, _c = M._string_stream(batch)
        np.testing.assert_array_equal(pos, host_pos)
        np.testing.assert_array_equal(lens, host_lens)
        return {"pos": np.asarray(pos), "lens": np.asarray(lens)}
    if name in ("elastic-none", "elastic-one", "elastic-cascade"):
        padded = M.pad_pages(batch, 8)
        dfa = M.compile_pattern("a[bc]+d|q" if name != "elastic-cascade"
                                else "[ab]x?")

        def hook(result, rnd):
            if name == "elastic-none":
                return ()
            if name == "elastic-cascade":
                return {1} if rnd == 0 else ({last} if rnd == 1 else ())
            if rnd == 0:
                # the failed rank's shard results are lost
                pp = len(result.match_counts) // n
                result.match_counts[last * pp:(last + 1) * pp] = -999
                return {last}
            return ()

        res, report = M.elastic_distributed_scan(mesh, padded, dfa,
                                                 fault_hook=hook)
        # the merged result equals a clean run (on the real pages: a pad
        # page that the hook poisoned is never re-run, in either package)
        clean = M.distributed_scan(mesh, padded, dfa)
        keep = clean.page_gid >= 0
        np.testing.assert_array_equal(res.match_counts[keep],
                                      clean.match_counts[keep])
        np.testing.assert_array_equal(res.totals, clean.totals)
        return {**_scan_fields(res), **_report(report)}
    if name == "elastic-index":
        calls = []

        def hook(blk, lens, emit):
            calls.append(blk)
            return {last} if blk == 0 else ()

        res = M.distributed_index_build(mesh, reader, "s", chunk_size=700,
                                        fault_hook=hook)
        return {**_index_fields(res), "hook_calls": np.array(calls, np.int64)}
    if name == "engine-hook":
        eng = M.ScanEngine(path, mesh=mesh)

        def hook(result, rnd):
            return {last} if rnd == 0 else ()

        res = eng.scan("s", "a.*b", fault_hook=hook)
        return {**_scan_fields(res), **_report(res.elastic_report)}
    raise KeyError(name)


def run_cases(M, mesh, n: int, paths: dict, ids: list[str]) -> dict:
    """{case id: {array name: array}} (or {case id: error text}) of `ids`
    through the functions of `M` on `mesh` (`n` ranks)."""
    out = {}
    readers = {}
    for cid in ids:
        kind, name = cid.split("/")
        try:
            if kind not in readers:
                reader = M.ParquetReader(paths[kind])
                batch = None
                if kind != "k":
                    batch = reader.prescan(
                        "s", pad_strings=8,
                        flags=M.bindings.PS_HOST_STRINGS
                        | M.bindings.PS_PAYLOAD)
                readers[kind] = (reader, batch)
            reader, batch = readers[kind]
            if name == "decode":
                b = reader.prescan("k")
                planes, nonnull, checksum = M.distributed_decode(
                    mesh, M.pad_pages(b, 8))
                out[cid] = {"nonnull": np.asarray(nonnull),
                            "checksum": np.int64(checksum),
                            **{f"plane{j}": np.asarray(p)
                               for j, p in enumerate(planes)}}
            else:
                out[cid] = _string_case(M, mesh, n, name, reader, batch,
                                        paths[kind])
        except Exception as e:  # noqa: BLE001 - reported per case
            import traceback

            out[cid] = "".join(traceback.format_exception(e))[-3000:]
    return out


def compare(got: dict, want: dict) -> str:
    """"ok", or what differs between one case's arrays in the two
    packages."""
    if isinstance(got, str):
        return "the port raised:\n" + got
    if isinstance(want, str):
        return "the reference raised:\n" + want
    if sorted(got) != sorted(want):
        return f"keys differ: {sorted(got)} != {sorted(want)}"
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        # an integer array may differ in width: JAX runs without 64-bit
        # types, so what passed through a device comes back as int32 where
        # the port keeps the payload's int64; the values must be equal
        same_type = a.dtype == b.dtype or (a.dtype.kind == "i"
                                           and b.dtype.kind == "i")
        if not same_type or a.shape != b.shape:
            return (f"{k}: {a.dtype}{a.shape} in the port, "
                    f"{b.dtype}{b.shape} in the reference")
        if not np.array_equal(a, b):
            return f"{k}: values differ"
    return "ok"


def save(path, results: dict) -> None:
    """One .npz for all cases: "<case id>|<array name>" keys; a case that
    raised is stored as its error text under "<case id>|!"."""
    flat = {}
    for cid, arrays in results.items():
        if isinstance(arrays, str):
            flat[f"{cid}|!"] = np.str_(arrays)
        else:
            for k, v in arrays.items():
                flat[f"{cid}|{k}"] = np.asarray(v)
    np.savez(path, **flat)


def load(path) -> dict:
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            cid, name = key.split("|")
            if name == "!":
                out[cid] = str(z[key])
            else:
                out.setdefault(cid, {})[name] = z[key]
    return out
