"""Metrics logging: stdout and a JSONL event stream.

Counterpart of ``tpu_diinn/train/logging.py``: one JSON line per event with
step, epoch and wall time, under ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, stdout: bool = True):
        self.stdout = stdout
        self.path = None
        self._f = None
        if log_dir:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self.path = Path(log_dir) / "metrics.jsonl"
            self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, payload: dict, epoch: Optional[int] = None
            ) -> None:
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        if epoch is not None:
            rec["epoch"] = int(epoch)
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in payload.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self.stdout:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k not in ("t",))
            print(f"[{rec['t']:9.1f}s] {body}", flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
