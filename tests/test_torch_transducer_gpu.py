"""The token-and-duration transducer on the card (marker ``gpu``; skips
without a CUDA device), at Parakeet-TDT-0.6B-v3's published widths
(``config.parakeet_tdt_config``): two calls through
``OfflineTranscriber(use_offline_forward=True)`` in bf16, each call's
record of the greedy TDT loop held to the plain float32 reference
(``benchmark/reference/transducer.py``) replayed along the program's own
path, by the limits of the benchmark's cell
``parakeet-tdt-0.6b-v3.bulk-calls`` (its ``path_rms``, ``choices_off`` and
``path_invalid``, the margin of a choice its ``choice_margin``); the
reference computed in fp8 e4m3 in the program's place fails them.  Run on
the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_transducer_gpu.py
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
from tone_tpu_torch.config import parakeet_tdt_config
from tone_tpu_torch.core import transducer as TD
from tone_tpu_torch.offline import OfflineTranscriber

ROOT = Path(__file__).resolve().parents[1]
CELL = json.loads((ROOT / "benchmark/workloads/parakeet-tdt-0.6b-v3.bulk-calls.json").read_text())


def _load(name: str, path: Path, package: bool = False):
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=[str(path.parent)] if package else None)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (none here)")
    return torch.device("cuda")


@pytest.fixture
def ref():
    """The benchmark's reference package, which imports nothing of the port."""
    if "reference" not in sys.modules:
        _load("reference", ROOT / "benchmark/reference/__init__.py", package=True)
    import reference.transducer as module

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


def _numbers(ref, sd, s, enc, paths, margin) -> dict:
    """path_rms, choices_off and path_invalid of the given (steps, frames)
    paths against the float32 reference's replay of each."""
    squares = count = off = invalid = 0
    for e, (steps, n) in zip(enc, paths):
        frames, tokens = steps[:, 0].astype(np.int64), steps[:, 1].astype(np.int64)
        durs = steps[:, 2].astype(np.int64)
        invalid += ref.path_errors(frames, tokens, durs, n, s)
        z = ref.replay(sd, s, e, frames, tokens).double().cpu().numpy()
        tok, dur = z[:, :s.blank + 1], z[:, s.blank + 1:]
        at = np.arange(len(steps))
        chosen = np.stack([tok[at, tokens], dur[at, durs]], axis=1)
        squares += float(np.square(steps[:, 3:5] - chosen).sum())
        count += chosen.size
        off += int(((tok.max(1) - chosen[:, 0] > margin)
                    | (dur.max(1) - chosen[:, 1] > margin)).sum())
    return {"path_rms": (squares / count) ** 0.5, "choices_off": off, "path_invalid": invalid}


@pytest.mark.gpu
def test_published_width_loop_within_the_cells_limits_and_fp8_outside(cuda, ref):
    weights = _load("weights_transducer", ROOT / "benchmark/harness/weights_transducer.py")
    cfg = parakeet_tdt_config()
    model = json.loads(json.dumps(cfg.to_dict()))
    s = ref.sizes(model)
    sd = weights.make_state_dict(model, 2**31 + 11, cuda)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(sd, cfg), cfg,
                            use_offline_forward=True, batch_size=2, device=cuda)
    kept = {}
    wait = tr._wait

    def keeping(launched):
        idx, row_frames, record = wait(launched)
        for row, i in enumerate(idx):
            steps = record[row].astype(np.float64)
            kept[int(i)] = (steps[steps[:, TD.ACTIVE] > 0], int(row_frames[row]))
        return idx, row_frames, record
    tr._wait = keeping
    audio = _calls((31.0, 12.5), seed=4)
    out = tr.transcribe(audio)
    assert all(out) and sorted(kept) == [0, 1]
    del tr
    torch.cuda.empty_cache()
    limits, margin = CELL["limits"], CELL["params"]["choice_margin"]
    paths = [kept[i] for i in range(len(audio))]
    with ref.float32_exactly(), torch.no_grad():
        wavs = [torch.from_numpy(a.astype(np.float32) / 32767.0).to(cuda) for a in audio]
        enc = [ref.encode(sd, s, w) for w in wavs]
        sound = _numbers(ref, sd, s, enc, paths, margin)
        fp8 = ref.Precision("fp8")
        low_paths = [(ref.greedy(sd, s, ref.encode(sd, s, w, fp8), fp8), n)
                     for w, (_, n) in zip(wavs, paths)]
        control = _numbers(ref, sd, s, enc, low_paths, margin)
    assert all(sound[k] <= limits[k] for k in sound), (sound, limits)
    assert any(control[k] > limits[k] for k in control), (control, limits)


@pytest.mark.gpu
def test_graphed_loop_against_eager_loop(cuda):
    """``GraphedLoop`` replays the eager loop's steps: on the same encoder
    outputs (three batches of other shapes, so that it captures again and
    reuses) both loops give the same records."""
    from tone_tpu_torch.core.transducer import init_transducer_params

    def served(tree):   # the matrices in bf16, as the transcriber serves them
        if isinstance(tree, dict):
            return {k: v.to(cuda, torch.bfloat16) if k == "w" else served(v)
                    for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(served(v) for v in tree)
        return tree.to(cuda)

    cfg = parakeet_tdt_config()
    v = {"params": served(init_transducer_params(torch.Generator().manual_seed(5), cfg))}
    graphed = TD.GraphedLoop(v, cfg)
    gen = torch.Generator(device=cuda).manual_seed(6)
    for rows, lengths in ((4, [130, 77, 9, 100]), (2, [300, 290]), (3, [40, 12, 33])):
        enc = torch.randn(rows, max(lengths), 1024, device=cuda, generator=gen).to(torch.bfloat16)
        eager = TD.greedy_tdt(v, cfg, enc, lengths)
        replayed = TD.greedy_tdt(v, cfg, enc, lengths, graphed)
        n = min(eager.shape[1], replayed.shape[1])
        diff = (eager[:, :n] - replayed[:, :n]).abs()
        assert torch.equal(eager[..., TD.ACTIVE].sum(1), replayed[..., TD.ACTIVE].sum(1)), \
            (lengths, float(diff.max()))
        live = eager[:, :n, TD.ACTIVE] > 0
        assert torch.equal(eager[:, :n][live], replayed[:, :n][live]), float(diff.max())
    assert graphed.rows == 4 and graphed.frames == 512
