"""Telemetry egress: periodic JSONL stream + optional Prometheus text.

The JSONL stream is the canonical artifact — one self-describing line
per record, two kinds::

    {"kind": "metrics", "schema": "repro.obs/v1", "seq": ..,
     "ts": .., "metrics": {...}}
    {"kind": "span", "trace": .., "span": .., "parent": .., ...}

The lines are the reference package's, so its ``launch/obs.py``
(``tail`` live, ``report`` offline span trees and latency waterfalls)
reads this stream too; this package has no CLI of its own yet. The
exporter runs on its own daemon thread on a fixed interval, drains the
tracer's ring buffer each tick (so spans are spilled to disk before
the ring can overwrite them), and always writes one final tick on
``stop()`` — short runs still get their telemetry.

The Prometheus-style exposition is opt-in (stdlib ``http.server``
only, no client library): :class:`PromExporter` serves the current
registry snapshot at ``/metrics`` in the text format scrapers expect.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import Tracer


class JsonlExporter:
    """Background writer: registry snapshot + drained spans per tick."""

    def __init__(self, path: str, registry: MetricsRegistry,
                 tracer: Optional[Tracer] = None,
                 interval_s: float = 1.0):
        self.path = path
        self.registry = registry
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self.lines_written = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._io_lock = threading.Lock()

    def tick(self) -> int:
        """One export round (also callable inline, e.g. from tests)."""
        lines = [json.dumps({"kind": "metrics",
                             **self.registry.snapshot()})]
        if self.tracer is not None:
            lines += [json.dumps({"kind": "span", **rec})
                      for rec in self.tracer.recorder.drain()]
        with self._io_lock:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
            self.lines_written += len(lines)
        return len(lines)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                pass                    # telemetry must never crash serving

    def start(self) -> "JsonlExporter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-jsonl-exporter", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.tick()                 # final flush: snapshot + spans
        except Exception:
            pass

    def __enter__(self) -> "JsonlExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ----------------------------------------------------------- prometheus
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def to_prometheus(snapshot: dict) -> str:
    """Registry snapshot -> Prometheus text exposition (flat keys
    sanitized to metric-name charset, dots become underscores)."""
    lines = []
    for key in sorted(snapshot.get("metrics", {})):
        val = snapshot["metrics"][key]
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        lines.append(f"{_NAME_RE.sub('_', key.replace('.', '_'))} "
                     f"{float(val):g}")
    lines.append(f"obs_snapshot_seq {snapshot.get('seq', 0)}")
    return "\n".join(lines) + "\n"


class PromExporter:
    """Opt-in ``/metrics`` endpoint over stdlib http.server."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "127.0.0.1"):
        self.registry = registry
        registry_ref = registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 - stdlib interface
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = to_prometheus(registry_ref.snapshot()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # pragma: no cover - quiet server
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-prom-exporter",
            daemon=True)

    def start(self) -> "PromExporter":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
