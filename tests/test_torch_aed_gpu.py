"""The attention encoder-decoder on the card (marker ``gpu``; skips without a
CUDA device).  The graphed loop (``core/aed.py GraphedDecoder``) against
the eager one, token for token; and at Canary-1B-v2's published widths
(``config.canary_config``) windows through
``OfflineTranscriber(use_offline_forward=True)`` in bf16, each window's
steps held to the plain float32 reference (``benchmark/reference/aed.py``)
teacher-forced on the program's own tokens, by the limits of the
benchmark's cell ``canary-1b-v2.bulk-calls`` (its ``logit_rms``,
``choices_off`` and ``stops_invalid``, the margin of a choice its
``choice_margin``); the reference computed in fp8 e4m3 in the program's
place fails them.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_aed_gpu.py
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
from tone_tpu_torch.config import canary_config
from tone_tpu_torch.core import aed as AED
from tone_tpu_torch.offline import OfflineTranscriber

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "benchmark/workloads/canary-1b-v2.bulk-calls.json").read_text())


def _load(name: str, path: Path, package: bool = False):
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, path, submodule_search_locations=[str(path.parent)] if package else None)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The benchmark's reference package, which imports nothing of the port."""
    _load("reference", ROOT / "benchmark/reference/__init__.py", package=True)
    import reference.aed as module

    return module


def _calls(seconds, seed: int) -> list[np.ndarray]:
    """Speech-like int16 calls at 16 kHz: harmonics under a syllabic
    envelope over noise."""
    rng = np.random.default_rng(seed)
    out = []
    for sec in seconds:
        t = np.arange(int(sec * 16000)) / 16000
        f0 = rng.uniform(100, 250)
        x = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * t)
        out.append(np.clip(6000 * x + rng.normal(0, 300, len(t)), -32768, 32767).astype(np.int16))
    return out


def _numbers(ref, sd, s, windows, margin) -> dict:
    """logit_rms, choices_off and stops_invalid of the given (window audio,
    its steps' tokens, live flags and logits) against the float32
    reference teacher-forced on each window's tokens."""
    squares = count = off = invalid = 0
    for wav, tokens, live, z in windows:
        n = int(live.sum())
        invalid += ref.stop_errors(live, tokens, s.cap(len(wav)), s.eos)
        enc = ref.encode(sd, s, torch.from_numpy(wav.astype(np.float32) / 32767.0).to(sd[
            "log_softmax.mlp.layer0.bias"].device))
        forced = ref.teacher_forced(sd, s, enc, tokens[:n]).double().cpu().numpy()
        z = z[:n].double().cpu().numpy()
        squares += float(np.square(z - forced).sum())
        count += forced.size
        chosen = forced[np.arange(n), tokens[:n]]
        off += int((forced.max(1) - chosen > margin).sum())
    return {"logit_rms": (squares / count) ** 0.5, "choices_off": off, "stops_invalid": invalid}


@pytest.mark.gpu
def test_published_width_windows_within_the_cells_limits_and_fp8_outside(cuda, ref):
    weights = _load("weights_aed", ROOT / "benchmark/harness/weights_aed.py")
    cfg = canary_config()
    model = json.loads(json.dumps(cfg.to_dict()))
    s = ref.sizes(model)
    sd = weights.make_state_dict(model, 2**31 + 17, cuda)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=2, device=cuda)
    records, kept = {}, {}
    wait = tr._wait

    def keeping(launched):
        idx, windows, record = wait(launched)
        for row, key in enumerate(windows.keys):
            records[key] = np.array(record[row])
        kept.update((key, z.float()) for key, (z, _) in windows.kept.items())
        return idx, windows, record
    tr._wait = keeping
    audio = _calls((46.0, 12.5), seed=4)          # windows of 40, 6 and 12.5 s
    tr.keep_logits = {(0, 0), (0, 1), (1, 0)}
    out = tr.transcribe(audio)
    assert [len(p) for p in out] == [2, 1] and sorted(records) == [(0, 0), (0, 1), (1, 0)]
    del tr
    torch.cuda.empty_cache()
    limits, margin = CELL["limits"], CELL["params"]["choice_margin"]
    windows = []
    for (i, k), record in sorted(records.items()):
        wav = ref.windows(audio[i], s)[k]
        windows.append((wav, record[:, AED.TOKEN].astype(np.int64), record[:, AED.LIVE] > 0,
                        kept[(i, k)]))
    assert int(windows[0][2].sum()) == s.cap(640_000) == 160
    with ref.float32_exactly(), torch.no_grad():
        sound = _numbers(ref, sd, s, windows, margin)
        fp8 = ref.Precision("fp8")
        low = []
        for wav, _, _, _ in windows:
            w = torch.from_numpy(wav.astype(np.float32) / 32767.0).to(cuda)
            tokens, z = ref.greedy(sd, s, ref.encode(sd, s, w, fp8), s.cap(len(wav)), fp8)
            low.append((wav, np.array(tokens, np.int64), np.ones(len(tokens), bool), z))
        control = _numbers(ref, sd, s, low, margin)
    assert all(sound[k] <= limits[k] for k in sound), (sound, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)


@pytest.mark.gpu
def test_graphed_decoder_against_eager_loop(cuda):
    """``GraphedDecoder`` replays the eager loop's steps: on the same encoder
    outputs (three batches of other shapes, so that it captures again and
    reuses) the replayed graph and the same steps run eagerly at the same
    shapes choose the same tokens with the same logits; against the loop
    without a graph (whose cache and frames are the batch's own, so that
    its sums over keys run in another order) the first step's logits
    agree within bf16 rounding."""
    class Eager:                      # the captured steps, launched one by one
        def __init__(self, steps, device):
            self.replay = steps

    cfg = canary_config()
    params = AED.init_aed_params(torch.Generator().manual_seed(5), cfg)
    v = {"params": _served(params, cuda)}
    graphed, stepped = AED.GraphedDecoder(v, cfg), AED.GraphedDecoder(v, cfg)
    stepped._graph = Eager
    gen = torch.Generator(device=cuda).manual_seed(6)
    for frames, caps in (([130, 77, 9, 100], [40, 20, 3, 33]), ([501, 490], [160, 157]),
                         ([40, 12, 33], [10, 4, 9])):
        enc = torch.randn(len(frames), max(frames), 1024, device=cuda, generator=gen)
        enc = enc.to(torch.bfloat16)
        keep = list(range(len(frames)))
        replayed, replayed_z, _ = AED.greedy_aed(v, cfg, enc, frames, caps, keep, graphed)
        eager, eager_z, _ = AED.greedy_aed(v, cfg, enc, frames, caps, keep, stepped)
        plain, plain_z, _ = AED.greedy_aed(v, cfg, enc, frames, caps, keep)
        assert torch.equal(eager, replayed), frames
        for b, n in enumerate(caps):
            assert int(replayed[b, :, AED.LIVE].sum()) == int(plain[b, :, AED.LIVE].sum())
            torch.testing.assert_close(eager_z[b][:n], replayed_z[b][:n], atol=0, rtol=0)
            torch.testing.assert_close(plain_z[b][:1], replayed_z[b][:1], atol=0.02, rtol=0)
    assert graphed.rows == 4 and graphed.frames == 512


def _served(tree, device):
    """The matrices in bf16 on ``device``, as the transcriber serves them."""
    if isinstance(tree, dict):
        return {k: v.to(device, torch.bfloat16) if k == "w" else _served(v, device)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_served(v, device) for v in tree)
    return tree.to(device)
