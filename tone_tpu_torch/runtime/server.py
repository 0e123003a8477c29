"""WebSocket transcription server over the multi-stream engine (port of
``tone_tpu/runtime/server.py``).

Speaks the reference demo protocol:

* client connects to ``/api/ws`` and receives ``{"event": "ready"}``;
* client sends binary PCM16LE 8 kHz mono frames (any size — the server
  buffers and re-chunks to 300 ms), an *empty* binary message means
  end-of-stream;
* server pushes ``{"event": "transcript", "text", "start_time", "end_time"}``
  per finalized phrase (with ``words`` and ``nbest`` when the engine gives
  them) and closes after the flush.

Every connection maps to a slot in the shared device arena and all live
connections advance together in one batched step per tick.  A JSON text
frame sets per-request hotwords and n-best; an engine that cannot serve
them (n-best on a greedy engine) answers with the JAX server's error event.  A plain
HTTP GET of ``/`` (or ``/index.html``) returns the bundled browser client
(``static/index.html``, a copy of the JAX package's page).  ``websockets`` is
imported inside the functions that need it, so the engine and this module
load without it.

Run:  python -m tone_tpu_torch serve [--port 8080]
"""

from __future__ import annotations

import asyncio
import json
import logging
from pathlib import Path

import numpy as np

from tone_tpu_torch.runtime.engine import MultiStreamEngine, UnknownStreamError
from tone_tpu_torch.runtime.metrics import HealthState

logger = logging.getLogger("tone_tpu_torch.server")

_EOS = object()      # end-of-stream marker through a session's phrase queue
_EVICTED = object()  # slot reclaimed (idle timeout / pressure) marker
_FAILED = object()   # server entered FAILED state: close the socket
_DRAIN = object()    # graceful shutdown: finalize the stream with what we have

# Close codes (4xxx = application-defined per RFC 6455, mirroring HTTP)
CLOSE_EVICTED = 4408  # idle timeout / slot reclaimed — reconnect to resume
CLOSE_FAILED = 4500   # server failure: transcription stopped, do not retry here
CLOSE_SHUTDOWN = 4503  # graceful shutdown: transcript delivered in full first

TICK_SECONDS = 0.06  # poll faster than real-time so queued chunks drain


class TranscriptionServer:
    """Asyncio server: one engine, one tick loop, N websocket sessions.

    The tick loop is SUPERVISED (the reference's Triton liveness contract,
    scripts/docker-compose.yml:24-31): a tick exception is caught, logged,
    and retried with backoff — transient device hiccups lose at most a few
    ticks.  ``max_tick_failures`` consecutive failures flip the server to a
    permanent FAILED state: every connected client's socket closes with
    code 4500 (instead of hanging to its flush timeout), new connections
    are refused with the same code, and ``health.status()`` — what
    /v2/health/ready serves — turns 503 so an orchestrator restarts the
    process.
    """

    def __init__(self, engine: MultiStreamEngine, tick_seconds: float = TICK_SECONDS,
                 health: HealthState | None = None,
                 max_tick_failures: int = 5,
                 failure_backoff: float = 0.25):
        self.engine = engine
        self.tick_seconds = tick_seconds
        self.health = health if health is not None else HealthState()
        self.max_tick_failures = max_tick_failures
        self.failure_backoff = failure_backoff
        self._queues: dict[int, asyncio.Queue] = {}
        self._loop: asyncio.AbstractEventLoop | None = None
        self._drain_event = asyncio.Event()

    # -- graceful drain ------------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._drain_event.is_set()

    def begin_drain(self) -> None:
        """Start a graceful shutdown (the crash path's clean twin — Triton
        drains in-flight sequences on exit, the liveness contract of the
        reference's scripts/docker-compose.yml:24-31):

        * ``health`` flips to 503 so an orchestrator routes traffic away;
        * new connections are refused with 1013 (try again later — against a
          healthy replica, unlike the permanent 4500 of the FAILED path);
        * every live session stops reading audio, finalizes its stream with
          the chunks it already buffered (exactly as if the client had sent
          its end-of-stream frame), delivers the remaining final phrases,
          and closes the socket with ``CLOSE_SHUTDOWN`` (4503).

        The tick loop must keep running until the flush completes — use
        ``wait_drained`` (``serve()`` bounds it with ``drain_grace``).
        """
        if self._drain_event.is_set():
            return
        self.health.draining = True
        logger.info("draining: refusing new connections, flushing %d live "
                    "stream(s)", len(self._queues))
        self._drain_event.set()

    async def wait_drained(self) -> None:
        """Resolve once every live session has flushed and unregistered."""
        while self._queues:
            await asyncio.sleep(0.05)

    # -- tick loop ---------------------------------------------------------

    async def tick_loop(self) -> None:
        self._loop = asyncio.get_running_loop()
        while True:
            try:
                await self._tick_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — supervised: contain, retry
                self.health.record_failure()
                n = self.health.consecutive_failures
                logger.exception("tick failed (%d/%d consecutive)",
                                 n, self.max_tick_failures)
                if n >= self.max_tick_failures:
                    self._enter_failed_state(f"{type(e).__name__}: {e}")
                    return
                await asyncio.sleep(
                    min(self.failure_backoff * 2 ** (n - 1), 2.0))
                continue
            self.health.record_success()
            if self.engine.has_backlog():
                await asyncio.sleep(0)  # keep draining at device speed
            else:
                await asyncio.sleep(self.tick_seconds)

    async def _tick_once(self) -> None:
        results = await asyncio.to_thread(self.engine.tick)
        for sid, futures in results.items():
            queue = self._queues.get(sid)
            if queue is None:
                continue
            for fut in futures:
                queue.put_nowait(fut)
        # Partial (in-progress phrase) text, when the engine produces it.
        for sid, text in self.engine.last_interims.items():
            queue = self._queues.get(sid)
            if queue is not None:
                queue.put_nowait(("interim", text))
        # Deliver EOS markers strictly after that stream's final phrases.
        for sid in self.engine.pop_finished():
            queue = self._queues.get(sid)
            if queue is not None:
                queue.put_nowait(_EOS)
        # Tell evicted clients their session ended (Triton's idle reaping
        # is silent; here the socket closes with a distinct code instead
        # of the next feed erroring out).
        for sid in self.engine.pop_evicted():
            queue = self._queues.get(sid)
            if queue is not None:
                queue.put_nowait(_EVICTED)

    def _enter_failed_state(self, reason: str) -> None:
        """Repeated tick failures: stop lying to clients.  Health turns 503
        and every open session is told to close NOW with code 4500 — a
        hung-until-timeout websocket over a dead engine is the failure mode
        this exists to prevent."""
        self.health.fail(reason)
        logger.error("tick loop FAILED permanently (%s) — closing %d client(s)",
                     reason, len(self._queues))
        for queue in self._queues.values():
            queue.put_nowait(_FAILED)

    # -- one websocket session --------------------------------------------

    async def handle(self, websocket) -> None:
        path = getattr(getattr(websocket, "request", None), "path", "/api/ws")
        if not path.startswith("/api/ws"):
            await websocket.close(code=4404, reason="unknown path")
            return
        if self.health.failed:
            await websocket.close(code=CLOSE_FAILED, reason="server failed")
            return
        if self.draining:
            # 1013 (try again later): the deployment's other replicas are
            # healthy — unlike the FAILED path's do-not-retry 4500.
            await websocket.close(code=1013, reason="server draining")
            return

        from websockets.exceptions import ConnectionClosed

        engine = self.engine
        config = engine.config
        chunk_samples = config.audio_chunk_samples
        try:
            sid = engine.open_stream()
        except RuntimeError:
            # All slots busy and nothing evictable: ask the client to retry.
            await websocket.close(code=1013, reason="server at capacity")
            return
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[sid] = queue
        sender = asyncio.create_task(self._send_loop(websocket, queue))

        try:
            await websocket.send(json.dumps({"event": "ready"}))
            # Inject the leading "magic padding" (reference website.py:84).
            buffer = np.zeros(config.padding, np.int16)
            pending = [buffer]
            buffered = len(buffer)

            def flush_full_chunks(final: bool = False):
                nonlocal pending, buffered
                data = np.concatenate(pending) if len(pending) > 1 else pending[0]
                offset = 0
                while len(data) - offset >= chunk_samples:
                    engine.feed(sid, data[offset:offset + chunk_samples].astype(np.int32))
                    offset += chunk_samples
                data = data[offset:]
                if final:
                    engine.feed(sid, data.astype(np.int32), is_last=False)
                    pending, buffered = [np.zeros(0, np.int16)], 0
                else:
                    pending, buffered = [data], len(data)

            drained_by_server = False
            try:
                while True:
                    message = await self._recv_or_drain(websocket)
                    if message is _DRAIN:
                        # Graceful shutdown: stop reading audio and finalize
                        # with what is already buffered, exactly as if the
                        # client had sent its end-of-stream frame — the
                        # engine then flushes this stream's final phrases.
                        pending.append(np.zeros(config.padding, np.int16))
                        flush_full_chunks(final=True)
                        engine.close_stream(sid)
                        drained_by_server = True
                        break
                    if message is None:
                        # Clean client close WITHOUT the protocol's empty
                        # end-of-stream frame: nothing more can be delivered
                        # (the close handshake already completed), so drop
                        # the stream now — the reference does the same when
                        # its receive raises on disconnect (demo/website.py
                        # get_chunk_stream).  Waiting on the sender here
                        # would hold the slot for the full flush timeout
                        # waiting for an EOS marker that never comes.
                        return
                    if isinstance(message, str):
                        # Optional extension over the reference protocol
                        # (whose clients send binary only): a JSON text
                        # frame configures per-REQUEST options — hotword
                        # biasing ('hotwords' list + 'hotword_weight') and/or
                        # n-best ('nbest').  Every text frame gets a reply
                        # (config or error); an empty hotword list / nbest 0
                        # clears an earlier override, and an engine without
                        # a beam decoder answers with an error event.
                        try:
                            cfg_msg = json.loads(message)
                            if not isinstance(cfg_msg, dict) or not (
                                    {"hotwords", "nbest"} & cfg_msg.keys()):
                                raise ValueError(
                                    "expected a JSON object with a "
                                    "'hotwords' list and/or an 'nbest' int")
                            applied = {"event": "config"}
                            if "hotwords" in cfg_msg:
                                hw = cfg_msg["hotwords"]
                                if not isinstance(hw, list) or \
                                        not all(isinstance(x, str) for x in hw):
                                    raise ValueError(
                                        "'hotwords' must be a list of strings")
                                # building the automaton tables is host
                                # work: keep it off the event loop
                                await asyncio.to_thread(
                                    engine.set_stream_hotwords, sid, hw,
                                    float(cfg_msg.get("hotword_weight", 10.0)))
                                applied["hotwords"] = len(hw)
                            if "nbest" in cfg_msg:
                                n = cfg_msg["nbest"]
                                if not isinstance(n, int) or isinstance(n, bool):
                                    raise ValueError("'nbest' must be an int")
                                engine.set_stream_nbest(sid, n)
                                applied["nbest"] = n
                            await websocket.send(json.dumps(applied))
                        except UnknownStreamError:
                            await websocket.close(code=CLOSE_EVICTED,
                                                  reason="stream evicted")
                            return
                        except Exception as e:  # noqa: BLE001 — bad config
                            await websocket.send(json.dumps(
                                {"event": "error",
                                 "error": f"bad config: {e}"}))
                        continue
                    if len(message) == 0:
                        # End of stream: trailing padding then flush.
                        pending.append(np.zeros(config.padding, np.int16))
                        flush_full_chunks(final=True)
                        engine.close_stream(sid)
                        break
                    samples = np.frombuffer(message, dtype="<i2")
                    pending.append(samples)
                    buffered += len(samples)
                    if buffered >= chunk_samples:
                        flush_full_chunks()
            except UnknownStreamError:
                # Evicted between the tick-loop notice and this feed.
                await websocket.close(code=CLOSE_EVICTED, reason="stream evicted")
                return
            except ConnectionClosed:
                # Client vanished mid-stream, or the sender loop closed the
                # socket (eviction / server failure) while we were reading.
                return

            # The sender exits once the engine's EOS marker (queued after the
            # final phrases) is delivered.
            try:
                await asyncio.wait_for(sender, timeout=120)
            except asyncio.TimeoutError:
                logger.warning("timed out flushing stream %d", sid)
            if drained_by_server:
                # Distinct close code: the transcript above is COMPLETE; the
                # client should reconnect to another replica for new audio.
                try:
                    await websocket.close(
                        code=CLOSE_SHUTDOWN,
                        reason="server shutting down: transcript complete")
                except ConnectionClosed:
                    pass
        finally:
            engine.close(sid)
            self._queues.pop(sid, None)
            sender.cancel()

    async def _recv_or_drain(self, websocket):
        """One message from the socket, ``None`` on clean client close, or
        ``_DRAIN`` the moment a graceful shutdown begins (a session mid-recv
        must not wait for its client's next frame to notice the drain).
        Abnormal closes raise ``ConnectionClosed`` like ``recv()`` does."""
        from websockets.exceptions import ConnectionClosedOK

        if self._drain_event.is_set():
            return _DRAIN
        recv = asyncio.ensure_future(websocket.recv())
        drain = asyncio.ensure_future(self._drain_event.wait())
        try:
            await asyncio.wait({recv, drain},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            drain.cancel()
        if recv.done():
            try:
                return recv.result()
            except ConnectionClosedOK:
                return None
        recv.cancel()
        try:
            await recv
        except asyncio.CancelledError:
            pass
        except Exception:  # noqa: BLE001 — a close racing the cancel
            pass
        return _DRAIN

    async def _send_loop(self, websocket, queue: asyncio.Queue) -> None:
        while True:
            fut = await queue.get()
            try:
                if fut is _EOS:
                    return
                if fut is _EVICTED:
                    await websocket.close(code=CLOSE_EVICTED,
                                          reason="idle timeout: slot reclaimed")
                    return
                if fut is _FAILED:
                    await websocket.close(code=CLOSE_FAILED,
                                          reason="server failure: "
                                                 "transcription stopped")
                    return
                if isinstance(fut, tuple) and fut[0] == "interim":
                    await websocket.send(json.dumps(
                        {"event": "interim", "text": fut[1]}, ensure_ascii=False))
                    continue
                phrase = await asyncio.wrap_future(fut)
                event = {
                    "event": "transcript",
                    "text": phrase.text,
                    "start_time": phrase.start_time,
                    "end_time": phrase.end_time,
                }
                if phrase.words is not None:
                    event["words"] = [vars(w) for w in phrase.words]
                if phrase.nbest is not None:
                    event["nbest"] = [{"text": t, "score": s} for t, s in phrase.nbest]
                await websocket.send(json.dumps(event, ensure_ascii=False))
            except Exception:  # noqa: BLE001 — never kill the sender loop
                logger.exception("failed to deliver phrase")
            finally:
                queue.task_done()


def _static_page_handler():
    """Serve the bundled browser client for plain-HTTP GETs (the websockets
    library hands non-upgrade requests to process_request)."""
    from websockets.datastructures import Headers
    from websockets.http11 import Response

    page = (Path(__file__).parent / "static" / "index.html").read_bytes()

    def process_request(connection, request):
        if "Upgrade" in request.headers.get("Connection", "") or \
                request.headers.get("Upgrade", "").lower() == "websocket":
            return None  # continue with the websocket handshake
        if request.path in ("/", "/index.html"):
            return Response(200, "OK", Headers([
                ("Content-Type", "text/html; charset=utf-8"),
                ("Content-Length", str(len(page))),
            ]), page)
        return Response(404, "Not Found", Headers([("Content-Length", "0")]), b"")

    return process_request


async def serve(engine: MultiStreamEngine, host: str = "0.0.0.0", port: int = 8080,
                metrics_port: int | None = 8002, drain_grace: float = 10.0,
                on_started=None):
    """Run the websocket server until SIGTERM/SIGINT, then drain gracefully.

    The first signal starts a DRAIN (TranscriptionServer.begin_drain):
    readiness flips 503, new connections are refused with 1013, and every
    live stream flushes its buffered audio and final phrases before its
    socket closes with 4503 — bounded by ``drain_grace`` seconds, after
    which the server exits with whatever remains unflushed (logged).  A
    second signal skips the rest of the grace period and exits immediately.

    ``on_started`` (optional) is called with the bound port once the server
    is accepting connections — embedders and tests bind port 0 and learn
    the real port here.
    """
    import signal as _signal

    import websockets

    health = HealthState()
    metrics_server = None
    if metrics_port:
        from tone_tpu_torch.runtime.metrics import start_metrics_server

        try:
            metrics_server = start_metrics_server(engine, host, metrics_port,
                                                  health=health)
            logger.info("metrics at http://%s:%d/metrics", host, metrics_port)
        except OSError as e:
            logger.warning("metrics server disabled: %s", e)

    server = TranscriptionServer(engine, health=health)
    logger.info("warming up (building the kernels, one %d-slot tick)...",
                engine.arena.n_slots)
    await asyncio.to_thread(engine.warmup)
    health.warmed = True  # /v2/health/ready flips 503 -> 200 here
    tick_task = asyncio.create_task(server.tick_loop())

    stop = asyncio.Event()

    async def _drain_then_stop() -> None:
        try:
            await asyncio.wait_for(server.wait_drained(), timeout=drain_grace)
            logger.info("drain complete: every live stream flushed")
        except asyncio.TimeoutError:
            logger.warning("drain grace (%.0fs) expired with %d stream(s) "
                           "unflushed", drain_grace, len(server._queues))
        stop.set()

    def _on_signal(signame: str) -> None:
        if server.draining or stop.is_set():
            logger.warning("second %s during drain: exiting now", signame)
            stop.set()
            return
        logger.info("%s: draining %d live stream(s), grace %.0fs "
                    "(send again to skip)", signame, len(server._queues),
                    drain_grace)
        server.begin_drain()
        asyncio.get_running_loop().create_task(_drain_then_stop())

    loop = asyncio.get_running_loop()
    handled_signals = []
    for sig in (_signal.SIGINT, _signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, _on_signal, sig.name)
            handled_signals.append(sig)
        except (NotImplementedError, RuntimeError, ValueError):
            pass  # non-main thread or platform without signal support

    async with websockets.serve(server.handle, host, port, max_size=2**22,
                                process_request=_static_page_handler()) as ws:
        bound_port = ws.sockets[0].getsockname()[1]
        logger.info("listening on ws://%s:%d/api/ws (browser client at /)", host, bound_port)
        if on_started is not None:
            on_started(bound_port)
        try:
            await stop.wait()
        finally:
            for sig in handled_signals:
                try:
                    loop.remove_signal_handler(sig)
                except (NotImplementedError, RuntimeError, ValueError):
                    pass
            tick_task.cancel()
            if metrics_server is not None:
                metrics_server.shutdown()


def main() -> None:
    """Alias of ``python -m tone_tpu_torch serve`` (port of
    ``tone_tpu/runtime/server.py main``): the flags live in one place,
    ``tone_tpu_torch/__main__.py``, and this entry point forwards to it
    verbatim."""
    import sys

    from tone_tpu_torch.__main__ import main as cli_main

    cli_main(["serve", *sys.argv[1:]])


if __name__ == "__main__":
    main()
