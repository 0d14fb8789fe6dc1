"""The port's public odds and ends against the reference's:
`duckdb_parquet_parser_tpu_torch.__version__` and `utils/tracing`: the
spans (`stage`, its decorator form `annotate`, `front_door`) and counters
that a CPU torch.profiler session records, where the port places them
(`dpq.query` down to the compile's parts on a resident scan, the cold
route's open, prescan, split plan and upload), that nothing is recorded
or counted with no profiler, and the benchmark's readers of them
(`portbench/metrics/`) over such a session's profile."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import duckdb_parquet_parser_tpu_torch as port
from duckdb_parquet_parser_tpu_torch.host import bindings
from duckdb_parquet_parser_tpu_torch.models import scan as mscan
from duckdb_parquet_parser_tpu_torch.models.scan import ScanEngine
from duckdb_parquet_parser_tpu_torch.ops import scan as pscan
from duckdb_parquet_parser_tpu_torch.utils import tracing
from portbench import run as bench_run
from portbench import trace as bench_trace

PATTERNS = ["special.*requests", "carefully|quickly"]


def _spans(fn) -> list[str]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_version_follows_the_reference():
    from duckdb_parquet_parser_tpu import __version__ as ref

    assert port.__version__ == ref
    assert "__version__" in port.__all__
    from duckdb_parquet_parser_tpu_torch.version import __version__

    assert __version__ == port.__version__


def test_annotate_names_its_span():
    @tracing.annotate("dpq.test_span")
    def add(a, b, *, scale=1):
        """Adds."""
        return (a + b) * scale

    out = []
    names = _spans(lambda: out.append(add(torch.ones(3), torch.ones(3),
                                          scale=2)))
    assert "dpq.test_span" in names
    assert torch.equal(out[0], torch.full((3,), 4.0))
    assert add.__name__ == "add" and add.__doc__ == "Adds."


def test_stage_names_its_span():
    def body():
        with tracing.stage("dpq.test_stage"):
            torch.ones(2).sum()

    assert "dpq.test_stage" in _spans(body)


@pytest.fixture(scope="module")
def big_pages(tmp_path_factory):
    """A file of one PLAIN string column whose pages are over
    `SPLIT_TRIGGER` bytes (pyarrow's 1 MB default), so the resident column
    and `scan_streaming` take the split layout."""
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rng = np.random.default_rng(16)
    words = [b"carefully", b"quickly", b"special", b"requests", b"deposits"]
    vals = [b" ".join(rng.choice(words, 5)) for _ in range(3000)]
    path = str(tmp_path_factory.mktemp("tracing") / "big.parquet")
    pq.write_table(pa.table({"s": vals}), path, compression="none",
                   use_dictionary=False)
    return path


def _no_walk(stream, plen, nn, irs, dfa, steps):
    """A stand-in for the byte walk: zero hits.  The plain CPU walk records
    some 700,000 profiler events a scan of the split layout; its answers
    are held to the reference in test_torch_scan.py."""
    return torch.zeros((max(len(irs), 1), plen.shape[0]), dtype=torch.int32)


@pytest.fixture
def cheap_walk(monkeypatch):
    monkeypatch.setattr(pscan, "walk_hits", _no_walk)


def _events(fn):
    """(the profile, its events) of `fn()` run under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, [e for e in prof.events() if e.name.startswith("dpq.")]


def _named(events, name):
    return [e for e in events if e.name == name]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _uploaded(buckets) -> int:
    """The bytes of the host arrays `resident_buckets` hands to its device:
    each bucket's decode arrays, lane arrays and the `steps` bytes of each
    lane of its stream."""
    total = 0
    for bk in buckets:
        tensors = list(bk["core"].values()) + [bk["walk_plen"], bk["walk_nn"]]
        if bk["seg"] is not None:
            tensors.append(bk["seg"])
        total += sum(t.numel() * t.element_size() for t in tensors)
        total += bk["steps"] * bk["walk_plen"].numel()
    return total


def test_resident_scan_spans_nest_and_count_one_compile(big_pages,
                                                        cheap_walk):
    col = ScanEngine(big_pages).resident("s", device="cpu")
    assert col.split
    before = tracing.counters()
    _prof, ev = _events(lambda: col.scan(PATTERNS[0]))
    after = tracing.counters()
    assert after.get("compiles", 0) - before.get("compiles", 0) == 1
    (query,) = _named(ev, "dpq.query")
    (comp,) = _named(ev, "dpq.compile")
    (subset,) = _named(ev, "dpq.compile.subset")
    (minimize,) = _named(ev, "dpq.compile.minimize")
    (step,) = _named(ev, "dpq.step")
    assert _inside(comp, query) and _inside(step, query)
    assert _inside(subset, comp) and _inside(minimize, comp)
    assert subset.time_range.end <= minimize.time_range.start
    assert comp.time_range.end <= step.time_range.start
    assert not _named(ev, "dpq.upload") and not _named(ev, "dpq.prescan")


def test_a_front_door_inside_another_opens_no_query_span(big_pages,
                                                         cheap_walk):
    col = ScanEngine(big_pages).resident("s", device="cpu")
    _prof, ev = _events(lambda: col.scan_many(PATTERNS))
    (query,) = _named(ev, "dpq.query")
    assert len(_named(ev, "dpq.compile")) == len(_named(ev, "dpq.step")) == 2
    assert all(_inside(e, query) for e in ev if e is not query)


def test_streaming_scan_spans_the_cold_route(big_pages, cheap_walk):
    mscan._streaming_matchers.cache_clear()
    ScanEngine(big_pages).scan_streaming("s", PATTERNS[0], device="cpu")
    out = []
    _prof, ev = _events(lambda: out.append(ScanEngine(big_pages).scan_streaming(
        "s", PATTERNS[0], device="cpu")))
    assert len(out[0].page_gid) > 0
    (opened,) = _named(ev, "dpq.open")
    (query,) = _named(ev, "dpq.query")
    prescans = _named(ev, "dpq.prescan")
    (split,) = _named(ev, "dpq.split_plan")
    (upload,) = _named(ev, "dpq.upload")
    (step,) = _named(ev, "dpq.step")
    assert opened.time_range.end <= query.time_range.start
    assert len(prescans) == 2  # the first row group's, the whole column's
    assert all(_inside(e, query) for e in prescans + [split, upload, step])
    assert split.time_range.end <= upload.time_range.start
    assert upload.time_range.end <= step.time_range.start
    assert not _named(ev, "dpq.compile")  # the matchers are cached


def test_streaming_scan_counts_the_bytes_it_uploads(big_pages, cheap_walk):
    reader = ScanEngine(big_pages).reader
    batch = reader.prescan("s", pad_strings=8, flags=bindings.PS_PAYLOAD)
    before = tracing.counters()
    got = []
    _events(lambda: got.append(pscan.resident_buckets(batch, "cpu")))
    uploaded = tracing.counters()["h2d_bytes"] - before.get("h2d_bytes", 0)
    buckets, split = got[0]
    assert split and uploaded == _uploaded(buckets) > batch.arrays[
        "payload"].shape[0]

    _pats, dfas = pscan.prepare_patterns([PATTERNS[0]])
    accepts = pscan.dict_accepts(batch, dfas).nbytes
    before = tracing.counters()
    _events(lambda: ScanEngine(big_pages).scan_streaming("s", PATTERNS[0],
                                                         device="cpu"))
    assert (tracing.counters()["h2d_bytes"] - before["h2d_bytes"]
            == uploaded + accepts)


def test_no_profiler_records_no_span_and_counts_nothing(big_pages, cheap_walk,
                                                        monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    before = tracing.counters()
    col = ScanEngine(big_pages).resident("s", device="cpu")
    col.scan_many(PATTERNS)
    ScanEngine(big_pages).scan_streaming("s", PATTERNS[1], device="cpu")
    with tracing.stage("dpq.test_off"):
        tracing.count("dpq.test_off", 5)
    assert not opened
    assert tracing.counters() == before
    _events(lambda: col.scan(PATTERNS[0]))
    assert "dpq.query" in opened  # the same calls record under a profiler


def _window(session, ops: int):
    """A `portbench.run.Window` of `ops` operations whose trace is the
    benchmark's reading of the session's profile."""
    win = bench_run.Window()
    win.attempted = ops
    win.trace = session["trace"]
    return win


def _span_ms(events, name) -> float:
    return 1e-3 * sum(e["dur"] for e in events if e["name"] == name)


def _session(path, fn) -> dict:
    """`fn()` under a CPU profiler, the byte walk stood in for: the
    benchmark's reading of the profile (`trace`), the profile's own
    annotation events (`events`) and what the counters counted
    (`counts`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pscan, "walk_hits", _no_walk)
        before = tracing.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        after = tracing.counters()
    trace = bench_trace.read_profile(prof, path)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return {"trace": trace, "events": events,
            "counts": {k: v - before.get(k, 0) for k, v in after.items()}}


@pytest.fixture(scope="module")
def resident_session(big_pages, tmp_path_factory):
    """Two resident queries."""
    col = ScanEngine(big_pages).resident("s", device="cpu")

    def queries():
        for p in PATTERNS:
            col.scan(p, negate=True)

    return _session(tmp_path_factory.mktemp("resident") / "trace.json",
                    queries)


@pytest.fixture(scope="module")
def cold_session(big_pages, tmp_path_factory):
    """Two cold scans on fresh engines, their matchers cached first; and
    the bytes one scan uploads."""
    for p in PATTERNS:
        mscan._streaming_matchers(p)

    def scans():
        for p in PATTERNS:
            ScanEngine(big_pages).scan_streaming("s", p, negate=True,
                                                 device="cpu")

    out = _session(tmp_path_factory.mktemp("cold") / "trace.json", scans)
    batch = ScanEngine(big_pages).reader.prescan(
        "s", pad_strings=8, flags=bindings.PS_PAYLOAD)
    out["per_scan"] = _uploaded(pscan.resident_buckets(batch, "cpu")[0]) + 1
    return out


@pytest.mark.parametrize("name,spans", [
    ("compile_span_ms", ["dpq.compile"]),
    ("compile_subset_ms", ["dpq.compile.subset"]),
    ("compile_minimize_ms", ["dpq.compile.minimize"]),
    ("step_span_ms", ["dpq.step"]),
    ("front_self_ms", ["dpq.query", "dpq.compile", "dpq.step"]),
])
def test_resident_span_readers_sum_the_profile(resident_session, name,
                                               spans):
    sums = [_span_ms(resident_session["events"], s) for s in spans]
    want = (sums[0] - sum(sums[1:])) / len(PATTERNS)
    got = bench_run.metric_reader(name).read(
        _window(resident_session, len(PATTERNS)))
    assert got == pytest.approx(want, rel=1e-9) and got > 0


@pytest.mark.parametrize("name,span", [
    ("open_ms", "dpq.open"),
    ("prescan_span_ms", "dpq.prescan"),
    ("split_plan_ms", "dpq.split_plan"),
    ("upload_span_ms", "dpq.upload"),
])
def test_cold_span_readers_sum_the_profile(cold_session, name, span):
    want = _span_ms(cold_session["events"], span) / len(PATTERNS)
    got = bench_run.metric_reader(name).read(
        _window(cold_session, len(PATTERNS)))
    assert got == pytest.approx(want, rel=1e-9) and got > 0


def test_counter_readers_read_the_window(resident_session, cold_session,
                                         monkeypatch):
    monkeypatch.setattr(tracing, "_counts", dict(resident_session["counts"]))
    compiles = sum(e["name"] == "dpq.compile"
                   for e in resident_session["events"])
    assert compiles == len(PATTERNS)
    assert bench_run.metric_reader("compiles_per_query").read(
        _window(resident_session, len(PATTERNS))) == 1.0

    per_scan = cold_session["per_scan"]
    monkeypatch.setattr(tracing, "_counts", dict(cold_session["counts"]))
    assert cold_session["counts"]["h2d_bytes"] == len(PATTERNS) * per_scan
    assert bench_run.metric_reader("h2d_gb_per_scan").read(
        _window(cold_session, len(PATTERNS))) == pytest.approx(
            per_scan / 1e9, rel=1e-12)


def test_readers_give_nothing_without_the_program_s_spans(tmp_path,
                                                         monkeypatch):
    """A program without these spans and counters (an older one): every
    new reader gives None, so its metric is left out of the line."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("query"):
            torch.ones(2).sum()
    win = _window({"trace": bench_trace.read_profile(
        prof, tmp_path / "trace.json")}, 1)
    monkeypatch.delattr(tracing, "counters")
    for name in ("compile_span_ms", "compile_subset_ms", "compile_minimize_ms",
                 "compiles_per_query", "step_span_ms", "front_self_ms",
                 "open_ms", "prescan_span_ms", "split_plan_ms",
                 "upload_span_ms", "h2d_gb_per_scan"):
        assert bench_run.metric_reader(name).read(win) is None, name
