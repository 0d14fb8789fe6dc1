"""The port's public odds and ends against the reference's:
`duckdb_parquet_parser_tpu_torch.__version__` and `utils/tracing.annotate`,
the decorator form of `stage`, whose span a CPU torch.profiler session
records under its name."""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

import duckdb_parquet_parser_tpu_torch as port
from duckdb_parquet_parser_tpu_torch.utils import tracing


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
