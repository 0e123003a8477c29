"""Corpus evaluation: streaming WER over JSONL manifests (a copy of
``tone_tpu/eval.py`` over the port's audio reader and WER).

The capability of the reference's de-facto integration test
(dev/triton/client_wer.py): run the full streaming pipeline over a manifest
of ``{"audio_filepath": ..., "text": ...}`` lines, compute corpus WER with
the reference text normalization, and report throughput.  Two backends:

* a local pipeline (any object with ``forward_offline``: the port's
  ``StreamingCTCPipeline`` or ``OfflineTranscriber``), or
* a remote websocket server (``ws://host:port/api/ws``) of either package,
  the duck-typing seam the reference exploits with its Triton client.
  ``websockets`` is imported only here.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

import numpy as np

from tone_tpu_torch.audio import read_audio
from tone_tpu_torch.training.wer import word_error_rate


@dataclass
class EvalResult:
    wer: float
    n_utterances: int
    audio_seconds: float
    wall_seconds: float

    @property
    def rtfx(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0


def read_manifest(path: str | Path) -> list[dict]:
    items = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


def evaluate_pipeline(pipeline, manifest: str | Path | Iterable[dict],
                      limit: int | None = None) -> EvalResult:
    """WER of ``pipeline.forward_offline`` over a manifest."""
    items = read_manifest(manifest) if isinstance(manifest, (str, Path)) else list(manifest)
    if limit is not None:
        items = items[:limit]
    hyps, refs = [], []
    audio_seconds = 0.0
    t0 = time.monotonic()
    for item in items:
        audio = item.get("audio")
        if audio is None:
            audio = read_audio(item["audio_filepath"])
        audio_seconds += len(audio) / 8000
        phrases = pipeline.forward_offline(np.asarray(audio, np.int32))
        hyps.append(" ".join(p.text for p in phrases if p.text))
        refs.append(item["text"])
    wall = time.monotonic() - t0
    return EvalResult(word_error_rate(hyps, refs), len(items), audio_seconds, wall)


async def _transcribe_ws(url: str, audio: np.ndarray) -> str:
    import asyncio

    import websockets

    async with websockets.connect(url, max_size=2**22) as ws:
        ready = json.loads(await ws.recv())
        assert ready.get("event") == "ready", ready
        pcm = np.asarray(audio, np.int16).astype("<i2").tobytes()
        for i in range(0, len(pcm), 48000):
            await ws.send(pcm[i:i + 48000])
        await ws.send(b"")
        texts = []
        try:
            while True:
                msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=60))
                if msg.get("event") == "transcript" and msg.get("text"):
                    texts.append(msg["text"])
        except (asyncio.TimeoutError, websockets.ConnectionClosed):
            pass
    return " ".join(texts)


def evaluate_server(url: str, manifest: str | Path, limit: int | None = None,
                    concurrency: int = 8) -> EvalResult:
    """WER against a running websocket server (end-to-end,
    including the serving stack — the client_wer.py equivalent)."""
    import asyncio

    items = read_manifest(manifest)
    if limit is not None:
        items = items[:limit]

    async def run():
        sem = asyncio.Semaphore(concurrency)

        async def one(item):
            audio = read_audio(item["audio_filepath"])
            async with sem:
                hyp = await _transcribe_ws(url, audio)
            return hyp, item["text"], len(audio) / 8000

        return await asyncio.gather(*(one(it) for it in items))

    t0 = time.monotonic()
    results = asyncio.run(run())
    wall = time.monotonic() - t0
    hyps = [r[0] for r in results]
    refs = [r[1] for r in results]
    seconds = sum(r[2] for r in results)
    return EvalResult(word_error_rate(hyps, refs), len(items), seconds, wall)
