"""Serving observability: engine metrics + honest health in Prometheus style
(port of ``tone_tpu/runtime/metrics.py``; pure Python, so a copy).

The reference deployment exposes Triton's built-in Prometheus endpoint and a
liveness contract (`/v2/health/ready`, scripts/docker-compose.yml:24-31) that
reflects actual server state.  Here the engine's counters are rendered in the
same exposition format, and readiness is derived from a ``HealthState`` the
tick-loop supervisor keeps current: not ready until warmup, unhealthy when
the loop died or stopped beating.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


@dataclass
class HealthState:
    """Shared between the tick-loop supervisor (writer) and the health
    endpoint (reader).  ``status()`` is the single source of truth for
    readiness:

    * 503 until warmup completes (``warmed``);
    * 503 forever once the loop has FAILED (``fail(reason)`` — repeated tick
      exceptions; the server closes client sockets at the same time);
    * 503 once the server is DRAINING (graceful shutdown: live streams are
      flushing, new connections are refused — an orchestrator should route
      traffic elsewhere while the grace period runs);
    * 503 when the loop stopped beating for ``stale_after`` seconds (a wedged
      device step or a dead task that never reached ``fail``);
    * 200 otherwise.

    A successful tick implies the serving program compiled and ran, so
    ``record_success`` also flips ``warmed`` — embedders that drive
    ``tick_loop`` directly (without ``serve()``'s explicit warmup) become
    ready on the first good tick.
    """

    stale_after: float = 30.0  # generous: heavy flush ticks can take seconds
    warmed: bool = False
    failed: bool = False
    draining: bool = False
    failed_reason: str = ""
    consecutive_failures: int = 0
    tick_failures_total: int = 0
    last_beat: float | None = field(default=None, repr=False)

    def record_success(self) -> None:
        self.consecutive_failures = 0
        self.last_beat = time.monotonic()
        self.warmed = True

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        self.tick_failures_total += 1

    def fail(self, reason: str) -> None:
        self.failed = True
        self.failed_reason = reason

    def status(self) -> tuple[int, str]:
        """(http_status, body) for /healthz and /v2/health/ready."""
        if self.failed:
            return 503, f"failed: {self.failed_reason}\n"
        if self.draining:
            return 503, "draining: graceful shutdown in progress\n"
        if not self.warmed:
            return 503, "starting: warmup in progress\n"
        if self.last_beat is not None and \
                time.monotonic() - self.last_beat > self.stale_after:
            return 503, (f"stalled: no successful tick for "
                         f"{time.monotonic() - self.last_beat:.0f}s\n")
        return 200, "ok\n"


def _process_rss_bytes() -> int:
    """Resident set size via /proc/self/statm (no psutil dependency), so
    host-memory growth of a long-running server is visible.  Returns 0 on
    platforms without procfs.
    """
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf")
                        else 4096)
    except (OSError, ValueError, IndexError):
        return 0


def render_metrics(engine, health: HealthState | None = None) -> str:
    s = engine.stats
    lines = [
        "# HELP tone_ticks_total Batched device steps executed.",
        "# TYPE tone_ticks_total counter",
        f"tone_ticks_total {s.ticks}",
        "# HELP tone_chunks_processed_total 300ms audio chunks processed.",
        "# TYPE tone_chunks_processed_total counter",
        f"tone_chunks_processed_total {s.chunks_processed}",
        "# HELP tone_phrases_decoded_total Finalized phrases decoded.",
        "# TYPE tone_phrases_decoded_total counter",
        f"tone_phrases_decoded_total {s.phrases_decoded}",
        "# HELP tone_active_streams Streams currently holding a slot.",
        "# TYPE tone_active_streams gauge",
        f"tone_active_streams {s.active_streams}",
        "# HELP tone_slots_total Stream slot capacity of the arena.",
        "# TYPE tone_slots_total gauge",
        f"tone_slots_total {engine.arena.n_slots}",
        "# HELP tone_pending_streams Candidate streams queued for a slot.",
        "# TYPE tone_pending_streams gauge",
        f"tone_pending_streams {s.pending_streams}",
        "# HELP tone_last_tick_seconds Wall time of the last tick.",
        "# TYPE tone_last_tick_seconds gauge",
        f"tone_last_tick_seconds {s.last_tick_seconds:.6f}",
        "# HELP tone_process_rss_bytes Resident set size of the serving process.",
        "# TYPE tone_process_rss_bytes gauge",
        f"tone_process_rss_bytes {_process_rss_bytes()}",
    ]
    if health is not None:
        lines += [
            "# HELP tone_tick_failures_total Tick-loop exceptions caught.",
            "# TYPE tone_tick_failures_total counter",
            f"tone_tick_failures_total {health.tick_failures_total}",
            "# HELP tone_ready 1 when /v2/health/ready returns 200.",
            "# TYPE tone_ready gauge",
            f"tone_ready {1 if health.status()[0] == 200 else 0}",
        ]
    return "\n".join(lines) + "\n"


def start_metrics_server(engine, host: str = "0.0.0.0", port: int = 8002,
                         health: HealthState | None = None) -> ThreadingHTTPServer:
    """Serve /metrics on a daemon thread; returns the server (call shutdown()).

    With ``health`` (the serving path always passes one), /healthz and
    /v2/health/ready reflect tick-loop liveness and return 503 during
    warmup, on a stalled loop, or after a permanent failure.  Without it
    (engine embedded directly, no tick loop to supervise) they degrade to
    plain process liveness and always return 200.
    """

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            if self.path in ("/healthz", "/v2/health/ready"):
                code, body = (200, "ok\n") if health is None else health.status()
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                return
            if self.path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = render_metrics(engine, health).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence access logs
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="tone-metrics").start()
    return server
