"""The port's own copy of `duckdb_parquet_parser_tpu/utils/checkpoints.py`
(same file names and contents, so a checkpoint written by one package loads
in the other).

Checkpoint/resume for the inverted-index build — the engine's only
long-running stateful op (SURVEY.md §5).  State is tiny (chunk boundaries +
row->chunk map), so checkpoints are atomic npz snapshots keyed by
(file fingerprint, column, chunk_size); a restarted build reuses a finished
snapshot wholesale (resume is all-or-nothing — per-shard partial resume is
not implemented; a stale fingerprint simply recomputes)."""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np


def _fingerprint(path: str) -> str:
    st = os.stat(path)
    return f"{os.path.basename(path)}-{st.st_size}-{int(st.st_mtime)}"


def checkpoint_path(ckpt_dir: str, file_path: str, column: str,
                    chunk_size: int) -> Path:
    return Path(ckpt_dir) / f"index-{_fingerprint(file_path)}-{column}-{chunk_size}.npz"


def save_index(ckpt_dir: str, file_path: str, column: str, index) -> Path:
    out = checkpoint_path(ckpt_dir, file_path, column, index.chunk_size)
    out.parent.mkdir(parents=True, exist_ok=True)
    # np.savez appends .npz to names lacking it — keep the temp name compliant
    tmp = out.with_name(out.name + ".tmp.npz")
    np.savez_compressed(
        tmp,
        meta=json.dumps(
            {"num_rows": index.num_rows, "chunk_size": index.chunk_size}
        ),
        positions=index.positions,
        lens=index.lens,
        chunk_of_entry=index.chunk_of_entry,
        tuple_to_chunk=index.tuple_to_chunk,
        chunk_starts=index.chunk_starts,
    )
    os.replace(tmp, out)
    return out


def load_index(ckpt_dir: str, file_path: str, column: str, chunk_size: int):
    """Returns the checkpointed ChunkedIndex or None."""
    from ..ops.index import ChunkedIndex

    p = checkpoint_path(ckpt_dir, file_path, column, chunk_size)
    if not p.exists():
        return None
    with np.load(p, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        return ChunkedIndex(
            num_rows=meta["num_rows"],
            chunk_size=meta["chunk_size"],
            positions=z["positions"],
            lens=z["lens"],
            chunk_of_entry=z["chunk_of_entry"],
            tuple_to_chunk=z["tuple_to_chunk"],
            chunk_starts=z["chunk_starts"],
        )


# ── per-block (row-group) emission checkpoints ───────────────────────────────
# A build killed mid-way resumes from the finished row groups instead of
# recomputing everything (the round-2 all-or-nothing limitation).  Block
# state is the (row, len) emission stream of one row group — tiny, and the
# boundary plan over the concatenated stream is cheap to recompute.


def block_path(ckpt_dir: str, file_path: str, column: str, rg: int) -> Path:
    return Path(ckpt_dir) / (
        f"emit-{_fingerprint(file_path)}-{column}-rg{rg}.npz"
    )


def save_block(ckpt_dir: str, file_path: str, column: str, rg: int,
               pos: np.ndarray, lens: np.ndarray) -> Path:
    out = block_path(ckpt_dir, file_path, column, rg)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp.npz")
    np.savez_compressed(tmp, pos=pos, lens=lens)
    os.replace(tmp, out)
    return out


def load_block(ckpt_dir: str, file_path: str, column: str, rg: int):
    """Returns the checkpointed (pos, lens) emission block or None."""
    p = block_path(ckpt_dir, file_path, column, rg)
    if not p.exists():
        return None
    with np.load(p, allow_pickle=False) as z:
        return z["pos"], z["lens"]
