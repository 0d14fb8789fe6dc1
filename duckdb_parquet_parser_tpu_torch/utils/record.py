"""The arguments a path gives the kernels' wrappers, kept so that each
kernel can be held against its plain version on exactly those inputs.

`recorded_calls(module, name)` replaces a wrapper by one that notes its
arguments and calls on, so the launches, the counts and the results stay
the path's own (every caller reaches a wrapper through its module, as
`dict_lookup.dict_lookup(...)`).  `hold_recorded(calls, device)` calls each
noted wrapper again on `device` beside its plain version and compares the
two exactly.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops.kernels import dict_lookup, stream_matcher

# the wrappers of the kernels that the sharded paths launch, by name
KERNEL_WRAPPERS = {
    "stream_matcher.match_stream": (stream_matcher, "match_stream"),
    "dict_lookup.dict_lookup": (dict_lookup, "dict_lookup"),
    "dict_lookup.dict_count": (dict_lookup, "dict_count"),
}


def _moved(value, device):
    """`value` with every tensor in it (also inside lists, tuples and
    dicts) on `device`, a copy of its own."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    if isinstance(value, (list, tuple)):
        return type(value)(_moved(v, device) for v in value)
    if isinstance(value, dict):
        return {k: _moved(v, device) for k, v in value.items()}
    return value


@contextlib.contextmanager
def recorded_calls(module, name: str, to_host: bool = False):
    """Notes the (args, kwargs) of every call of `module.name` made inside
    the block, in a list it yields; with `to_host`, a host copy of each
    tensor argument, taken at the call (a saved record outlives the card's
    buffers)."""
    calls = []
    real = getattr(module, name)

    def noting(*args, **kwargs):
        calls.append(_moved((args, kwargs), "cpu") if to_host
                     else (args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, noting)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _plain_match_stream(chunked, plen, nn, irs, steps=None):
    chunks = chunked.shape[0]
    steps = (chunks * stream_matcher.CHUNK if steps is None
             else min(int(steps), chunks * stream_matcher.CHUNK))
    return stream_matcher.match_stream_plain(
        stream_matcher.unchunk_stream(chunked, steps), plen, nn, tuple(irs),
        steps)


_PLAIN = {
    "stream_matcher.match_stream": _plain_match_stream,
    "dict_lookup.dict_lookup": dict_lookup.dict_lookup_plain,
    "dict_lookup.dict_count": dict_lookup.dict_count_plain,
}


def _flat(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


def hold_recorded(calls: dict, device) -> dict:
    """Each call of `calls` ({wrapper name: [(args, kwargs)]}, as the
    dry run saves them) made again on `device`: the wrapper (on a card,
    its kernel) beside its plain version on the same tensors.  Returns
    {name: {"calls": n, "max_abs_err": e}}; any difference in shape or
    type raises."""
    out = {}
    for name, noted in calls.items():
        module, attr = KERNEL_WRAPPERS[name]
        wrapper = getattr(module, attr)
        err = 0
        for args, kwargs in noted:
            args, kwargs = _moved((args, kwargs), device)
            got = _flat(wrapper(*args, **kwargs))
            want = _flat(_PLAIN[name](*args, **kwargs))
            if [(g.shape, g.dtype) for g in got] != [
                    (w.shape, w.dtype) for w in want]:
                raise AssertionError(f"{name}: the wrapper gave "
                                     f"{[tuple(g.shape) for g in got]}, the "
                                     "plain version "
                                     f"{[tuple(w.shape) for w in want]}")
            for g, w in zip(got, want):
                if g.numel():
                    err = max(err, int((g.long() - w.long()).abs().max()))
        out[name] = {"calls": len(noted), "max_abs_err": err}
    return out
