"""The voice-bot traffic: its open-loop schedule and the websocket clients
that play it (numpy and websockets only: this file runs in the client
processes, which load neither torch nor the program).

Turns arrive as a Poisson process at the rate that keeps ``concurrency``
turns open on average, and last a clipped lognormal time
(``turn_seconds``).  The run starts in the steady state: ``concurrency``
turns already under way open over the first ``stagger_seconds``, each for
the rest of a turn (a length drawn in proportion to its size, times a
uniform share); fresh arrivals follow from 0 s.  Every turn streams its
audio in frames of one chunk, each sent when its audio is complete (due at
the turn's start plus the frame's end), then the empty end-of-stream frame
at the turn's end.  The lengths, the gaps between arrivals and the
remainders are drawn once from ``base_seed``, so every run's seed gives
the same sizes and arrivals in another order; the audio (cut from a
speech-like pool at offsets and gains) is the run's seed's.

    python3 voicebot_client.py <json: params, seed, seconds, frame samples, shard, shards>

A client prints ``ready`` once its audio is made, waits for one line on
its standard input (``{"t0": <monotonic start>, "port": n}``), plays its
share of the turns (every ``shards``-th) and prints one JSON line per turn,
then a line of frame lateness, and exits.  Times are on the machine's
monotonic clock, relative to ``t0``.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from harness import audio  # noqa: E402

CLOSE_NORMAL = 1000
MEAN_SAMPLES = 400_000


@dataclass
class Turn:
    index: int
    start: float          # s after t0
    samples: int
    offset: int           # into the pool
    gain: float

    @property
    def seconds(self) -> float:
        return self.samples / audio.SAMPLE_RATE

    @property
    def end(self) -> float:
        """When its end-of-stream frame is due."""
        return self.start + self.seconds


@dataclass
class Schedule:
    turns: list
    window: tuple         # (start, end) s after t0
    rate: float           # arrivals per second
    mean_seconds: float


def _lognormal(rng, spec: dict, n: int) -> np.ndarray:
    return np.clip(rng.lognormal(np.log(spec["median"]), spec["sigma"], n),
                   spec["min"], spec["max"])


def schedule(p: dict, seed: int, seconds: float, pool_len: int) -> Schedule:
    base = np.random.default_rng(p["base_seed"])
    run = np.random.default_rng([int(seed), 11])
    spec = p["turn_seconds"]
    mean = float(_lognormal(base, spec, MEAN_SAMPLES).mean())
    conc = float(p["concurrency"])
    rate = conc / mean
    start_w = float(p["ramp_seconds"])
    end_w = start_w + seconds
    # The turns under way at 0 s: the rest of a turn, its length drawn in
    # proportion to its size (the length-biased law), opening over the stagger.
    n0 = int(round(conc))
    lengths = _lognormal(base, spec, 64 * n0 + 64)
    biased = base.choice(lengths, size=n0, p=lengths / lengths.sum())
    rest = np.maximum(biased * base.uniform(0, 1, n0), 0.3)
    opens = np.sort(base.uniform(0, p["stagger_seconds"], n0))
    # Fresh arrivals to the window's end.
    gaps = base.exponential(1 / rate, int(rate * end_w * 1.2) + 64)
    gaps = gaps[: int(np.searchsorted(np.cumsum(gaps), end_w)) + 1]
    durations = _lognormal(base, spec, len(gaps))
    arrivals = np.cumsum(run.permutation(gaps))
    starts = np.concatenate([opens, arrivals[arrivals < end_w]])
    secs = np.concatenate([run.permutation(rest), run.permutation(durations)[: int((arrivals < end_w).sum())]])
    turns = [Turn(i, float(t), int(d * audio.SAMPLE_RATE),
                  int(run.integers(pool_len)), float(run.uniform(0.3, 1.0)))
             for i, (t, d) in enumerate(zip(starts, secs))]
    return Schedule(turns=turns, window=(start_w, end_w), rate=rate, mean_seconds=mean)


def turn_audio(speech: np.ndarray, turn: Turn) -> np.ndarray:
    return audio.cut(speech, turn.offset, turn.samples, turn.gain)


@dataclass
class Played:
    index: int
    status: str = "pending"     # ok, refused (no slot), failed (closed otherwise), dropped
    close: float | None = None  # s after t0 when the server closed the socket
    code: int | None = None
    texts: list = field(default_factory=list)


async def play(url: str, t0: float, turn: Turn, pcm: bytes, frame: int, stop_at: float,
               lateness: list) -> Played:
    """One turn: connect at its start, send each frame when due, the empty
    frame at its end, and wait for the server to close after the final
    phrase.  A turn not closed by ``stop_at`` is dropped."""
    import websockets

    out = Played(turn.index)
    loop = time.monotonic

    async def until(t: float) -> None:
        delay = t0 + t - loop()
        if delay > 0:
            await asyncio.sleep(delay)

    await until(turn.start)
    try:
        async with websockets.connect(url, max_size=2**22, open_timeout=30,
                                      ping_interval=None) as ws:
            first = json.loads(await ws.recv())
            if first.get("event") != "ready":
                out.status = "refused"
                return out

            async def send() -> None:
                n = len(pcm) // 2
                try:
                    for a in range(0, n, frame):
                        due = turn.start + min(a + frame, n) / audio.SAMPLE_RATE
                        await until(due)
                        lateness.append(loop() - (t0 + due))
                        await ws.send(pcm[2 * a: 2 * min(a + frame, n)])
                    await ws.send(b"")
                except websockets.ConnectionClosed:
                    pass

            async def receive() -> None:
                try:
                    async for message in ws:
                        event = json.loads(message)
                        if event.get("event") == "transcript":
                            out.texts.append(event["text"])
                except websockets.ConnectionClosed:
                    pass
                out.close = loop() - t0
                out.code = ws.close_code

            sender = asyncio.ensure_future(send())
            receiver = asyncio.ensure_future(receive())
            try:
                await asyncio.wait_for(asyncio.shield(receiver),
                                       timeout=max(0.0, t0 + stop_at - loop()))
            except asyncio.TimeoutError:
                out.status = "dropped"
                sender.cancel()
                receiver.cancel()
                return out
            if not sender.done():
                sender.cancel()
            out.status = "ok" if out.code == CLOSE_NORMAL else "failed"
            return out
    except (OSError, asyncio.TimeoutError, websockets.WebSocketException):
        out.status = "refused" if out.close is None else "failed"
        return out


def stop_time(turn: Turn, sched: Schedule, p: dict) -> float:
    """A turn that ends in the window is waited for up to ``tail_seconds``
    past the window; one still streaming at the window's end is dropped
    ``abandon_grace_seconds`` after it."""
    end_w = sched.window[1]
    return end_w + (p["tail_seconds"] if turn.end <= end_w else p["abandon_grace_seconds"])


async def play_all(url: str, t0: float, turns: list, pcms: list, stops: list, frame: int,
                   ) -> tuple[list, list]:
    lateness: list = []
    tasks = [asyncio.ensure_future(play(url, t0, turn, pcm, frame, stop, lateness))
             for turn, pcm, stop in zip(turns, pcms, stops)]
    return await asyncio.gather(*tasks), lateness


def main() -> int:
    args = json.loads(sys.argv[1])
    p = args["params"]
    speech = audio.pool(args["seed"], p["pool_seconds"])
    sched = schedule(p, args["seed"], args["seconds"], len(speech))
    turns = sched.turns[args["shard"]::args["shards"]]
    pcms = [turn_audio(speech, t).astype("<i2").tobytes() for t in turns]
    stops = [stop_time(t, sched, p) for t in turns]
    print("ready", flush=True)
    go = json.loads(sys.stdin.readline())
    url = f"ws://127.0.0.1:{go['port']}/api/ws"
    played, lateness = asyncio.run(play_all(url, go["t0"], turns, pcms, stops, args["frame"]))
    for p in played:
        print(json.dumps({"i": p.index, "status": p.status, "close": p.close, "code": p.code,
                          "texts": p.texts}, ensure_ascii=False))
    late = np.asarray(lateness) if lateness else np.zeros(1)
    print(json.dumps({"lateness": {"frames": len(lateness), "p50": float(np.percentile(late, 50)),
                                   "p99": float(np.percentile(late, 99)), "max": float(late.max())}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
