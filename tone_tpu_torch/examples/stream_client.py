"""Minimal streaming client for the websocket server (port of
``examples/stream_client.py``; the protocol is the same for both packages'
servers).

Shows the full client-side protocol — open ``/api/ws``, wait for
``{"event": "ready"}``, stream PCM16LE 8 kHz mono in real-time-ish frames,
send one empty binary frame as end-of-stream, print transcript events (plus
``interim`` events when the server runs with ``--interim``) until the server
closes.

    # terminal 1 (random weights are fine for a protocol demo):
    python -m tone_tpu_torch serve --port 8080
    # terminal 2:
    python -m tone_tpu_torch.examples.stream_client audio.flac --url ws://localhost:8080/api/ws
    python -m tone_tpu_torch.examples.stream_client --example   # bundled sample audio

The client runs no model, so it has no ``--device`` flag.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from pathlib import Path


async def stream(url: str, pcm16: bytes, frame_ms: int = 300,
                 realtime: bool = False) -> list[dict]:
    """Stream ``pcm16`` to the server at ``url``; returns the events
    received after ``ready``, in order."""
    import websockets

    frame_bytes = 2 * 8000 * frame_ms // 1000
    events = []
    async with websockets.connect(url, max_size=2**22) as ws:
        msg = json.loads(await ws.recv())
        if msg.get("event") != "ready":
            raise RuntimeError(f"expected the server's ready event, got {msg}")

        async def sender() -> None:
            for off in range(0, len(pcm16), frame_bytes):
                await ws.send(pcm16[off:off + frame_bytes])
                if realtime:
                    await asyncio.sleep(frame_ms / 1000)
            await ws.send(b"")  # end-of-stream

        send_task = asyncio.create_task(sender())
        try:
            async for raw in ws:
                event = json.loads(raw)
                events.append(event)
                if event.get("event") == "transcript":
                    print(f"[final  ] {event['start_time']:7.2f}-"
                          f"{event['end_time']:7.2f}  {event['text']}")
                elif event.get("event") == "interim":
                    print(f"[interim]                    {event['text']}")
        finally:
            await send_task
    return events


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("files", nargs="*", type=Path)
    parser.add_argument("--example", action="store_true",
                        help="use the bundled example audio")
    parser.add_argument("--url", default="ws://localhost:8080/api/ws")
    parser.add_argument("--realtime", action="store_true",
                        help="pace frames at real time instead of flooding")
    args = parser.parse_args(argv)

    from tone_tpu_torch.audio import read_audio, read_example_audio

    if args.example or not args.files:
        audios = [read_example_audio()]
    else:
        audios = [read_audio(p) for p in args.files]
    for audio in audios:
        pcm16 = audio.astype("<i2").tobytes()
        asyncio.run(stream(args.url, pcm16, realtime=args.realtime))


if __name__ == "__main__":
    main()
