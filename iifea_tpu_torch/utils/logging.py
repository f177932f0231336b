"""Logging (port of ``log_info`` in ``iifea_tpu/utils/logging.py``): the
reference gates its output on MPI rank 0; the port is one process, so a
message is a flushed line on standard output."""
from __future__ import annotations

import sys


def log_info(msg: str) -> None:
    print(msg, file=sys.stdout, flush=True)
