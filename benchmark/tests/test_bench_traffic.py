"""The voice-bot traffic's arithmetic: the open-loop schedule's arrivals
against its concurrency, the same sizes and arrivals for every seed, the
frames sent when due, the latency timed from the due time, and a turn
that did not complete sorting as missing."""

import asyncio
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from traffic import voicebot_client as client  # noqa: E402

PARAMS = json.loads((BENCH / "workloads" / "t-one-300ms.voicebot-1024.json").read_text())["params"]


def test_concurrency_and_rate():
    p = dict(PARAMS, concurrency=400)
    sched = client.schedule(p, 2**31 + 17, 30.0, 8000 * 60)
    assert sched.window == (p["ramp_seconds"], p["ramp_seconds"] + 30.0)
    assert sched.rate == pytest.approx(400 / sched.mean_seconds)
    # a clipped lognormal of median 4 s and sigma 0.6 has a mean near 4 e^0.18
    assert sched.mean_seconds == pytest.approx(4 * np.exp(0.18), rel=0.02)
    starts = np.array([t.start for t in sched.turns])
    ends = np.array([t.end for t in sched.turns])
    grid = np.linspace(*sched.window, 301)
    open_now = [np.sum((starts <= g) & (ends > g)) for g in grid]
    assert np.mean(open_now) == pytest.approx(400, rel=0.06)
    assert min(open_now) > 340 and max(open_now) < 460
    fresh = starts[starts >= p["stagger_seconds"]]
    assert len(fresh) == pytest.approx(sched.rate * sched.window[1], rel=0.05)


def test_every_seed_has_the_same_sizes_and_arrivals():
    a = client.schedule(PARAMS, 1, 20.0, 8000 * 60)
    b = client.schedule(PARAMS, 2**32 + 5, 20.0, 8000 * 60)
    n0 = int(round(PARAMS["concurrency"]))
    assert sorted(t.samples for t in a.turns[:n0]) == sorted(t.samples for t in b.turns[:n0])
    assert [t.start for t in a.turns[:n0]] == [t.start for t in b.turns[:n0]]
    assert [t.samples for t in a.turns] != [t.samples for t in b.turns]
    assert abs(len(a.turns) - len(b.turns)) <= 2
    assert [t.offset for t in a.turns[:5]] != [t.offset for t in b.turns[:5]]


def test_frames_are_sent_when_due():
    websockets = pytest.importorskip("websockets")

    async def main():
        got = []

        async def handler(ws):
            await ws.send(json.dumps({"event": "ready"}))
            async for message in ws:
                got.append((time.monotonic(), len(message)))
                if len(message) == 0:
                    await ws.send(json.dumps({"event": "transcript", "text": "да"}))
                    await asyncio.sleep(0.05)
                    return

        async with websockets.serve(handler, "127.0.0.1", 0) as server:
            port = server.sockets[0].getsockname()[1]
            t0 = time.monotonic() + 0.1
            turn = client.Turn(0, 0.05, 9200, 0, 1.0)   # 1.15 s: 3 full frames and 2,000 samples
            pcm = np.zeros(turn.samples, "<i2").tobytes()
            lateness = []
            played = await client.play(f"ws://127.0.0.1:{port}", t0, turn, pcm, 2400,
                                       turn.end + 5, lateness)
        return t0, turn, got, played, lateness

    t0, turn, got, played, lateness = asyncio.run(main())
    assert [n for _, n in got] == [4800, 4800, 4800, 2 * (9200 - 7200), 0]
    due = [turn.start + 0.3, turn.start + 0.6, turn.start + 0.9, turn.end, turn.end]
    for (at, _), d in zip(got, due):
        assert 0 <= at - (t0 + d) < 0.05
    assert played.status == "ok" and played.texts == ["да"]
    assert played.close - turn.end == pytest.approx(0.05, abs=0.04)
    assert len(lateness) == 4 and max(lateness) < 0.05


def test_latency_from_the_due_time_and_missing_turns_last():
    from traffic.voicebot import final_latencies, nearest_rank

    p = dict(PARAMS, concurrency=20)
    sched = client.schedule(p, 9, 10.0, 8000 * 60)
    start_w, end_w = sched.window
    turns = [t for t in sched.turns if start_w <= t.end < end_w][:20]
    played = {t.index: {"status": "ok", "close": t.end + 0.1 + 0.01 * k}
              for k, t in enumerate(turns)}
    played[turns[3].index] = {"status": "refused", "close": None}
    lat = final_latencies(turns, played, sched, p)
    assert lat[0] == pytest.approx(0.1) and lat[5] == pytest.approx(0.15)
    assert lat[3] > p["tail_seconds"] > lat.max(initial=0, where=np.arange(20) != 3)
    ordered = np.sort(lat)
    assert nearest_rank(ordered, 0.95) == ordered[18]      # 19 of 20 at or below it
    assert nearest_rank(ordered, 1.0) == lat[3]
