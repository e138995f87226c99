"""Structured metrics: JSONL records per eval/epoch with loss, accuracy,
step time and throughput, echoed to stderr (counterpart of
``ggnn_tpu/train/metrics.py``, the same record format)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: dict[str, Any]) -> None:
        record = dict(record, ts=time.time())
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()
        if self.echo:
            keys = [f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in record.items() if k != "ts"]
            print("  ".join(keys), file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
