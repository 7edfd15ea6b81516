"""Per-step scalar metrics: JSONL writer + console summary.

Counterpart of `parallelnbody_tpu/utils/metrics.py` (pure Python, kept as
the port's own copy): every run can emit energy / momentum / throughput
records, one JSON object a line, for any dashboard.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, path=None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        self._t0 = time.perf_counter()

    def log(self, record: dict):
        record = {"wall_time": time.perf_counter() - self._t0, **record}
        line = json.dumps({k: _jsonable(v) for k, v in record.items()})
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            step = record.get("step", "?")
            e = record.get("energy")
            sps = record.get("steps_per_sec")
            msg = f"step {step}"
            if e is not None:
                msg += f"  E={e:+.6e}"
            if "energy_drift" in record:
                msg += f"  drift={record['energy_drift']:+.2e}"
            if sps is not None:
                msg += f"  {sps:.1f} steps/s"
            print(msg, file=sys.stderr)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
