"""One rank of the port's dry run (duckdb_parquet_parser_tpu_torch/dryrun.py)
on the CPU over gloo: a child process of tests/test_torch_dryrun.py.  It
blocks JAX and the JAX package, joins the group through the file store it
is given and runs the dry run as a rank that `dryrun.spawn` starts runs it:
rank 0 prints the line; a failing check ends the rank with its traceback.
An alarm ends a rank that hangs.

Usage: python tests/torch_dist_dryrun.py RANK SIZE STORE
"""

from __future__ import annotations

import signal
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIFETIME_S = 400  # a rank that outlives this is killed by its own alarm


def main(argv) -> int:
    rank, size, store = int(argv[0]), int(argv[1]), argv[2]
    signal.alarm(LIFETIME_S)
    sys.path.insert(0, str(ROOT))
    from tests.torch_dist_worker import _Block

    sys.meta_path.insert(0, _Block())
    import torch

    from duckdb_parquet_parser_tpu_torch import dryrun

    torch.set_num_threads(1)
    rc = dryrun.main([str(size), "--device", "cpu", "--backend", "gloo",
                      "--rank", str(rank), "--store", store])
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
