"""Serving load test (port of ``dev/load_test.py``): the perf_analyzer-like
sweep against the port's websocket server.

N concurrent clients each stream audio at real-time pace (one 300 ms chunk
per 300 ms) or as fast as they can (``--firehose``) and measure
end-of-stream flush latency and transcript arrival lag, against a running
server (``--url``).  ``--soak`` and ``--shutdown-mid-load`` spawn their own
``python -m tone_tpu_torch serve`` on the card (``--device cpu`` spawns it on
the CPU):

    python -m tone_tpu_torch.dev.load_test --url ws://localhost:8080/api/ws \\
        --streams 64 --utterance-seconds 6 --rounds 2
    python -m tone_tpu_torch.dev.load_test --soak 60 --streams 64
    python -m tone_tpu_torch.dev.load_test --shutdown-mid-load --streams 64

The spawned server's standard error goes to a file, whose end is printed
when the server dies before it is ready.  A round against ``--url`` prints
``"device": null``: the client cannot see the card of the server it
measures.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from tone_tpu_torch.device import resolve_device
from tone_tpu_torch.profiling import device_label

REPO = Path(__file__).resolve().parents[2]  # the directory holding tone_tpu_torch/
CHUNK_BYTES = 2400 * 2
DRAIN_GRACE = 30.0
CLOSE_NORMAL = 1000
STDERR_TAIL_BYTES = 4000


def percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if xs else float("nan")


def tone_audio(i: int, seconds: float) -> np.ndarray:
    """Stream ``i``'s audio: a tone of 200 + 20·(i mod 8) Hz."""
    t = np.arange(int(seconds * 8000)) / 8000
    return (8000 * np.sin(2 * np.pi * (200 + 20 * (i % 8)) * t)).astype(np.int16)


async def one_stream(url: str, audio: np.ndarray, realtime: bool,
                     results: dict, config: dict | None = None) -> None:
    import websockets

    pcm = audio.astype("<i2").tobytes()
    t_start = time.monotonic()
    first_transcript = None
    async with websockets.connect(url, max_size=2**22) as ws:
        ready = json.loads(await ws.recv())
        if ready.get("event") != "ready":
            raise RuntimeError(f"expected the ready event, got {ready}")
        if config:
            await ws.send(json.dumps(config))
            ack = json.loads(await ws.recv())
            if ack.get("event") != "config":
                raise RuntimeError(f"config refused: {ack}")

        async def sender():
            for i in range(0, len(pcm), CHUNK_BYTES):
                await ws.send(pcm[i:i + CHUNK_BYTES])
                if realtime:
                    await asyncio.sleep(0.3)
            await ws.send(b"")

        send_task = asyncio.create_task(sender())
        n_phrases = 0
        close_code = None
        try:
            while True:
                msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=60))
                if msg.get("event") == "transcript":
                    n_phrases += 1
                    if first_transcript is None:
                        first_transcript = time.monotonic() - t_start
        except asyncio.TimeoutError:
            pass  # no clean end-of-stream: counted as not delivered
        except websockets.ConnectionClosed as e:
            # 1000 = the server closed the socket after the final phrase;
            # 4408 (evicted) and 4500 (server failure) end it unflushed
            close_code = e.rcvd.code if e.rcvd else None
        await send_task
    t_end = time.monotonic()
    audio_seconds = len(audio) / 8000
    results.setdefault("flush_latency", []).append(
        t_end - t_start - (audio_seconds if realtime else 0))
    results.setdefault("phrases", []).append(n_phrases)
    results.setdefault("audio_seconds", []).append(audio_seconds)
    results.setdefault("completed", []).append(close_code == CLOSE_NORMAL)
    if first_transcript is not None:
        results.setdefault("first_transcript", []).append(first_transcript)


HOTWORD_POOL = ["абонент", "договор", "тариф", "платеж", "адрес",
                "фамилия", "паспорт", "баланс"]


async def run_round(url: str, n_streams: int, utterance_seconds: float,
                    realtime: bool, nbest: int = 0,
                    hotword_streams: int = 0) -> dict:
    """One round of ``n_streams`` concurrent streams; the JAX script's report,
    plus ``completed``: the streams whose socket the server closed with the
    normal code (1000) after their last phrase."""
    results: dict = {}
    t0 = time.monotonic()
    tasks = []
    for i in range(n_streams):
        # mix tone bursts and silence so the splitter emits phrases
        audio = tone_audio(i, utterance_seconds)
        n = len(audio)
        audio[n // 3: n // 2] = 0  # mid silence -> phrase boundary
        config: dict = {}
        if nbest:
            config["nbest"] = nbest
        if i < hotword_streams:
            # 3 words per request, rotated per stream — the realistic
            # per-call contact-list shape (same-size lists share one
            # stacked-table node bucket)
            config["hotwords"] = [HOTWORD_POOL[(i + k) % len(HOTWORD_POOL)]
                                  for k in range(3)]
        tasks.append(one_stream(url, audio, realtime, results, config or None))
    await asyncio.gather(*tasks)
    wall = time.monotonic() - t0
    total_audio = sum(results.get("audio_seconds", []))
    return {
        "streams": n_streams,
        "nbest": nbest,
        "hotword_streams": hotword_streams,
        "delivered": len(results.get("flush_latency", [])),
        "completed": int(sum(results.get("completed", []))),
        "wall_seconds": round(wall, 2),
        "aggregate_rtfx": round(total_audio / wall, 1),
        "flush_latency_p50": round(percentile(results.get("flush_latency", []), 50), 3),
        "flush_latency_p95": round(percentile(results.get("flush_latency", []), 95), 3),
        "flush_latency_p99": round(percentile(results.get("flush_latency", []), 99), 3),
        "first_transcript_p50": round(percentile(results.get("first_transcript", []), 50), 3),
        "phrases_total": int(sum(results.get("phrases", []))),
    }


def _rss_mb(pid: int) -> float:
    with open(f"/proc/{pid}/status", encoding="ascii") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError(f"no VmRSS for pid {pid}")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _tail(path: Path) -> str:
    data = path.read_bytes()
    return data[-STDERR_TAIL_BYTES:].decode("utf-8", "replace")


async def _wait_ready(proc, url: str, stderr: Path, timeout: float = 600.0) -> None:
    """Poll until the spawned server accepts a websocket (its warmup builds
    the kernels and runs a tick of every slot).  A server that exits first
    fails the run with the end of its standard error."""
    import websockets

    deadline = time.monotonic() + timeout
    while True:
        try:
            async with websockets.connect(url) as ws:
                json.loads(await ws.recv())
            return
        except (OSError, websockets.WebSocketException, asyncio.TimeoutError):
            if proc.poll() is not None:
                raise RuntimeError(f"server died during startup (exit {proc.returncode}); "
                                   f"its stderr ends:\n{_tail(stderr)}") from None
            if time.monotonic() > deadline:
                raise RuntimeError(f"server never became ready; its stderr ends:\n"
                                   f"{_tail(stderr)}") from None
            await asyncio.sleep(2.0)


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@contextlib.asynccontextmanager
async def spawned_server(slots: int, device: str = "cuda", serve_args=()):
    """``python -m tone_tpu_torch serve --slots N --device D [serve_args]``
    on a free port, ready; yields (process, url, stderr path) and stops the
    process on exit (SIGTERM, then SIGKILL after 20 s)."""
    port = _free_port()
    cmd = [sys.executable, "-m", "tone_tpu_torch", "serve", "--host", "127.0.0.1",
           "--port", str(port), "--metrics-port", "0", "--slots", str(slots),
           "--device", device, *serve_args]
    with tempfile.TemporaryDirectory(prefix="tone_load_test_") as tmp:
        stderr = Path(tmp) / "serve.stderr"
        with open(stderr, "wb") as err:
            proc = subprocess.Popen(cmd, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=err)
        try:
            url = f"ws://127.0.0.1:{port}/api/ws"
            await _wait_ready(proc, url, stderr)
            yield proc, url, stderr
        finally:
            _stop(proc)


async def soak(streams: int, seconds: float, utterance_seconds: float = 6.0, nbest: int = 0,
               hotword_streams: int = 0, device: str = "cuda", serve_args=()) -> dict:
    """Run a spawned server under continuous stream churn for ``seconds``,
    sampling its RSS after each round of ``streams`` firehose streams.

    Verdict contract: open/stream/close cycles at fixed concurrency must
    leave the server's RSS flat — slot leaks, splitter-carry leaks, or
    future leaks all show up as monotonic growth here.  Returns the report
    (``flat``) and the per-round RSS."""
    async with spawned_server(streams, device, serve_args) as (proc, url, _):
        samples: list[float] = []
        delivered = phrases = 0
        t_end = time.monotonic() + seconds
        while time.monotonic() < t_end:
            report = await run_round(url, streams, min(utterance_seconds, 3.0),
                                     realtime=False, nbest=nbest,
                                     hotword_streams=hotword_streams)
            delivered += report["completed"]
            phrases += report["phrases_total"]
            samples.append(_rss_mb(proc.pid))
            print(json.dumps({"soak_round": len(samples),
                              "rss_mb": round(samples[-1], 1)}), flush=True)
    # Flat check: the last quarter's median must not exceed the first
    # quarter's by more than 10% + 64 MB (allocator slack, decode-pool
    # arenas).
    q = max(1, len(samples) // 4)
    first, last = float(np.median(samples[:q])), float(np.median(samples[-q:]))
    return {"soak_seconds": seconds, "rounds": len(samples),
            "rss_first_mb": round(first, 1), "rss_last_mb": round(last, 1),
            "flat": last <= first * 1.10 + 64.0, "completed": delivered,
            "phrases_total": phrases,
            "streams_total": streams * len(samples), "exit_code": proc.returncode,
            "rss_mb": samples}


async def _shutdown_client(url: str, audio: np.ndarray, out: list) -> None:
    """Stream audio in real time and NEVER send the end-of-stream frame —
    the server's drain must finalize for us.  Records the transcripts
    delivered and the close code received."""
    import websockets

    pcm = audio.astype("<i2").tobytes()
    record = {"transcripts": 0, "close_code": None}
    out.append(record)
    try:
        async with websockets.connect(url, max_size=2**22) as ws:
            ready = json.loads(await ws.recv())
            if ready.get("event") != "ready":
                raise RuntimeError(f"expected the ready event, got {ready}")

            async def sender():
                try:
                    for i in range(0, len(pcm), CHUNK_BYTES):
                        await ws.send(pcm[i:i + CHUNK_BYTES])
                        await asyncio.sleep(0.3)
                except websockets.ConnectionClosed:
                    pass  # drain closed us mid-send: expected

            send_task = asyncio.create_task(sender())
            try:
                while True:
                    msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=120))
                    if msg.get("event") == "transcript":
                        record["transcripts"] += 1
            except websockets.ConnectionClosed as e:
                record["close_code"] = e.rcvd.code if e.rcvd else None
            finally:
                send_task.cancel()
                with contextlib.suppress(asyncio.CancelledError):
                    await send_task
    except Exception as e:  # noqa: BLE001 — a failed stream is a reported row
        record["error"] = repr(e)


async def shutdown_mid_load(streams: int, utterance_seconds: float = 6.0,
                            device: str = "cuda", serve_args=()) -> dict:
    """Spawn a server, put ``streams`` real-time streams on it, SIGTERM it
    mid-stream, and check that every client received its flushed transcript
    plus the 4503 shutdown close before the process exited (the
    graceful-drain contract of ``runtime.server.serve``).  Returns the
    report (``ok``)."""
    async with spawned_server(streams, device, ["--drain-grace", str(DRAIN_GRACE),
                                                *serve_args]) as (proc, url, stderr):
        records: list = []
        tasks = [asyncio.create_task(_shutdown_client(
            url, tone_audio(i, utterance_seconds), records)) for i in range(streams)]
        # SIGTERM mid-load: every stream has audio buffered, none has sent
        # its end-of-stream frame.
        await asyncio.sleep(max(1.0, utterance_seconds / 2))
        t_sig = time.monotonic()
        os.kill(proc.pid, signal.SIGTERM)
        await asyncio.gather(*tasks)
        try:
            rc = await asyncio.to_thread(proc.wait, DRAIN_GRACE + 30)
        except subprocess.TimeoutExpired:
            return {"shutdown_mid_load": True, "streams": streams, "ok": False,
                    "error": "server did not exit after drain", "stderr": _tail(stderr)}
        exit_latency = time.monotonic() - t_sig
    flushed = sum(1 for r in records if r["transcripts"] > 0)
    clean = sum(1 for r in records if r["close_code"] == 4503)
    return {
        "shutdown_mid_load": True,
        "streams": streams,
        "flushed": flushed,
        "closed_4503": clean,
        "close_codes": sorted({r["close_code"] for r in records}, key=str),
        "errors": sorted({r["error"] for r in records if "error" in r}),
        "exit_code": rc,
        "exit_after_signal_s": round(exit_latency, 2),
        "ok": flushed == streams and clean == streams and rc == 0,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--url", default="ws://127.0.0.1:8080/api/ws")
    parser.add_argument("--streams", type=int, nargs="+", default=[16, 64])
    parser.add_argument("--utterance-seconds", type=float, default=6.0)
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--firehose", action="store_true",
                        help="send as fast as possible instead of real-time pace")
    parser.add_argument("--nbest", type=int, default=0,
                        help="per-stream n-best config frame sent at connect")
    parser.add_argument("--hotword-streams", type=int, default=0,
                        help="first K streams send a per-request hotword list")
    parser.add_argument("--soak", type=float, default=0.0, metavar="SECONDS",
                        help="spawn a server and churn streams for N seconds, "
                             "asserting flat RSS (exit 1 on growth)")
    parser.add_argument("--shutdown-mid-load", action="store_true",
                        help="spawn a server, SIGTERM it under live streams, "
                             "and assert every client got its full transcript "
                             "+ a 4503 close before exit (exit 1 otherwise)")
    parser.add_argument("--serve-args", nargs=argparse.REMAINDER, default=[],
                        help="extra args for the spawned server (--soak and "
                             "--shutdown-mid-load)")
    parser.add_argument("--device", default=None,
                        help="torch device of the spawned server (--soak and "
                             "--shutdown-mid-load; default cuda, 'cpu' to serve on "
                             "the CPU)")
    args = parser.parse_args(argv)
    if args.soak or args.shutdown_mid_load:
        label = device_label(resolve_device(args.device))
    else:
        # the server at --url runs elsewhere: this client cannot name its card
        label = {"device": None, "power_limit": None}

    if args.soak:
        report = asyncio.run(soak(max(args.streams), args.soak, args.utterance_seconds,
                                  args.nbest, args.hotword_streams,
                                  args.device or "cuda", args.serve_args))
        del report["rss_mb"]
        print(json.dumps({**report, **label}), flush=True)
        sys.exit(0 if report["flat"] else 1)
    if args.shutdown_mid_load:
        report = asyncio.run(shutdown_mid_load(max(args.streams), args.utterance_seconds,
                                               args.device or "cuda", args.serve_args))
        print(json.dumps({**report, **label}), flush=True)
        sys.exit(0 if report["ok"] else 1)

    for n in args.streams:
        for _ in range(args.rounds):
            report = asyncio.run(run_round(
                args.url, n, args.utterance_seconds,
                realtime=not args.firehose, nbest=args.nbest,
                hotword_streams=args.hotword_streams))
            print(json.dumps({**report, **label}))


if __name__ == "__main__":
    main()
