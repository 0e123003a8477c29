"""Traffic kind ``bulk_aed``: bulk transcription of recorded calls by a
FastConformer attention encoder-decoder (``configs/<config>.json``'s
``model`` is a ``FastConformerConfig`` with an ``aed`` decoder).

The jobs, the 16 kHz pool, the window and the end-to-end metric are
``bulk_fastconformer``'s: jobs of ``job_calls`` recordings (lengths drawn
once from ``base_seed``) go to ``OfflineTranscriber.transcribe`` one after
the other, closed loop; the transcriber cuts each call into consecutive
windows of at most the configuration's ``window_seconds`` and batches the
windows.  Set-up makes the weights on the card as NeMo's ``state_dict``
(``harness/weights_aed.py``), loads them through the program's converter
and runs one job, which warms every batch shape and captures the decode
loop's CUDA graph.

The reference checks ``sample_windows`` windows of the window's first job,
the first window of its longest call among them.  The transcriber keeps
their steps' float32 logits and the cross-attention keys and values the
steps read on the device (``keep_logits``), and a wrapper on its wait
takes them, with their loop records (each step's token and whether the
row was live), from each batch's windows.  The plain float32
reference (``reference/aed.py``) encodes each window alone and runs its
decoder's full forward teacher-forced on the prompt and the program's own
tokens:

* ``logit_rms``: the RMS over every class of every live step of the
  program's logits minus the reference's;
* ``cross_rms``: the RMS over every layer, frame and feature of the
  cross-attention keys and values the program's steps read minus the
  reference's projections of the window's own encoding
  (``reference/aed.py cross_memory``), as a share of the reference's RMS;
  a window whose keys and values span another number of frames than its
  encoding counts as a share of 1;
* ``choices_off``: steps where the reference's logit of the program's
  token lies more than ``choice_margin`` below the reference's best (a flip
  within the margin is a near-tie);
* ``stops_invalid``: windows whose live steps are not the first ones, or
  that stop before ``<|endoftext|>`` and before their cap, or run past
  either;
* ``texts_mismatched``: windows whose returned phrase differs from the
  plain joining of the program's own tokens (a window with no text gives
  no phrase).

The control (``--control``) puts the reference in fp8 e4m3 in the
program's place: its own greedy decoding of each sampled window, checked
the same way.  A traced run traces one job of the window and reads the
program's ``aed.*`` spans and counters (``metrics/*.aed_bulk.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, program
from harness.report import Outcome
from harness.trace import DeviceTrace
from reference import aed as ref
from traffic.bulk import call_lengths, job_calls
from traffic.bulk_fastconformer import RATE, _per_layer, speech_pool

# The columns of the program's record of a step (core/aed.py FIELDS).
TOKEN, LIVE = range(2)


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.offline import OfflineTranscriber

    from harness.weights_aed import make_state_dict

    faults = faults or {}
    p = c.params
    dev = torch.device(device)
    cfg = FastConformerConfig.from_dict(c.model)
    s = ref.sizes(c.model)
    lengths = call_lengths(p) * (RATE // 8000)
    speech = speech_pool(seed, p["pool_seconds"])
    state_dict = make_state_dict(c.model, seed, dev)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(state_dict, cfg), cfg, device=dev,
                            **p["transcriber"])
    _break(tr, faults, s.eos)

    # The first job's sampled windows (call, window), the longest call's first among them.
    owners = [(i, k) for i, n in enumerate(lengths) for k in range(max(-(-int(n) // s.window), 1))]
    rng = np.random.default_rng([seed, 6])
    sampled = {(int(np.argmax(lengths)), 0)}
    while len(sampled) < min(p["sample_windows"], len(owners)):
        sampled.add(owners[int(rng.integers(0, len(owners)))])
    recorded: dict = {}
    job_now = [-1]
    wait = tr._wait

    def recording_wait(launched):
        idx, windows, record = wait(launched)
        for row, key in enumerate(windows.keys):
            if job_now[0] == 0 and key in sampled:
                recorded[key] = (np.array(record[row]), int(windows.frames[row]),
                                 windows.kept.get(key, (None, None)))
        return idx, windows, record
    tr._wait = recording_wait

    program.start_memory(dev)
    tr.transcribe(job_calls(speech, lengths, seed, -1))   # warm-up: every shape
    dtrace = DeviceTrace() if trace and dev.type == "cuda" else None
    if dtrace is not None:
        dtrace.prime()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_window = time.monotonic()
    setup_s = t_window - started
    trace_at = t_window + max(0.0, (seconds - p["trace_seconds"]) / 2)
    jobs, audio_s, traced, results, trace_cost = 0, 0.0, False, {}, {}
    spans = {"transcribe (host)": []}
    job_s = float(lengths.sum()) / RATE
    while True:
        calls = job_calls(speech, lengths, seed, jobs)
        job_now[0] = jobs
        tr.keep_logits = sampled if jobs == 0 else set()
        tracing = dtrace is not None and not traced and time.monotonic() >= trace_at
        if tracing:
            a = time.monotonic()
            dtrace.start()
            trace_cost["start_s"] = time.monotonic() - a
        a = time.monotonic_ns()
        out = tr.transcribe(calls)
        spans["transcribe (host)"].append((a, time.monotonic_ns()))
        if tracing:
            a = time.monotonic()
            dtrace.stop()
            trace_cost["stop_s"] = time.monotonic() - a
            traced = True
        if jobs == 0:
            results = out
        jobs += 1
        audio_s += job_s
        if time.monotonic() - t_window >= seconds:
            break
    window = time.monotonic() - t_window
    peak = program.memory_peak(dev)

    per_layer, busy, wsec, brk, loop = {}, None, None, None, {}
    if dtrace is not None and dtrace.t1:
        per_layer, busy, wsec, brk = _per_layer(
            c, s.enc, dev, dtrace, program.clip_spans(spans, dtrace.t0, dtrace.t1), {})
        loop = _loop_counts(dtrace)

    recorded = {key: (record, frames, None if z is None else z.float().cpu(),
                      None if memory is None else memory.cpu())
                for key, (record, frames, (z, memory)) in recorded.items()}
    del tr
    program.release(dev)
    compared, notes = _check(c, s, state_dict, speech, lengths, seed, recorded, results, dev,
                             control)
    return Outcome(attempted=jobs * len(lengths), failed=0,
                   end_to_end={"setup_s": setup_s, "bulk_audio_s_per_s": audio_s / window},
                   compared=compared, memory_peak_bytes=peak,
                   device_kind=program.device_kind(dev), per_layer=per_layer, busy_s=busy,
                   window_s=wsec, breakdown=brk,
                   notes={"jobs": jobs, "window_s": window, "trace_cost_s": trace_cost,
                          "traced_loop": loop, **notes})


def _loop_counts(dtrace) -> dict:
    """The program's ``aed.*`` counts over the traced job (empty where the
    program records none)."""
    try:
        from tone_tpu_torch.profiling import events
    except ImportError:
        return {}
    out: dict = {}
    for e in events(dtrace.t0, dtrace.t1):
        if hasattr(e, "t_ns") and e.name.startswith("aed."):
            out[e.name] = out.get(e.name, 0) + e.n
    return out


def _break(tr, faults: dict, eos: int) -> None:
    """Faults the tests plant under the timed path: each row of a batch
    decoded over the next row's encoder frames (its cross-attention reads
    another row's); each row's first emitted token altered where the loop
    produced it."""
    from tone_tpu_torch.core import aed
    from tone_tpu_torch.core.fastconformer import encode_fastconformer

    def broken(variables, batch):
        audio, lengths, windows = batch
        enc, frames = encode_fastconformer(variables, tr.config, audio, lengths)
        if faults.get("cross_rows"):
            enc, frames = enc.roll(-1, 0), frames[1:] + frames[:1]
        record, logits, memory = aed.greedy_aed(variables, tr.config, enc, frames,
                                                windows.caps, windows.keep, tr._graphed)
        windows.rows = tr._graphed.rows if tr._graphed is not None else len(frames)
        windows.kept = {windows.keys[row]: kept
                        for row, kept in zip(windows.keep, zip(logits, memory))}
        if faults.get("token_altered"):
            first = torch.zeros_like(record[..., LIVE], dtype=torch.bool)
            first[:, 0] = record[:, 0, LIVE] > 0
            altered = (record[..., TOKEN] + 1) % len(tr.config.vocabulary)
            record[..., TOKEN] = torch.where(first, altered, record[..., TOKEN])
        return record
    if faults.get("cross_rows") or faults.get("token_altered"):
        tr._aed_forward = broken


def _numbers(s, z_ref: np.ndarray, tokens: np.ndarray, margin: float) -> tuple[int, float]:
    """(steps whose token's reference logit lies more than ``margin`` below
    the reference's best, the widest such gap) of one window."""
    if not len(tokens):
        return 0, 0.0
    gap = z_ref.max(1) - z_ref[np.arange(len(tokens)), tokens]
    return int((gap > margin).sum()), float(gap.max())


class _Share:
    """The RMS of the program's side minus the reference's as a share of
    the reference's RMS, over every element added; a side that is missing,
    or of another shape, counts the reference's whole square as its gap."""

    def __init__(self):
        self.gap = self.total = 0.0

    def add(self, program, reference) -> None:
        reference = reference.double()
        square = float(reference.square().sum())
        self.total += square
        if program is None or program.shape != reference.shape:
            self.gap += square
        else:
            self.gap += float((program.double() - reference).square().sum())

    def share(self) -> float | None:
        return (self.gap / self.total) ** 0.5 if self.total else None


def _check(c, s, sd, speech, lengths, seed, recorded, results, dev, control):
    """Each sampled window's logits against the float32 reference's,
    teacher-forced on the program's tokens, and its cross-attention memory
    against the reference's; its stop against the rules, and its phrase
    against the plain joining of its tokens; with ``control``, the fp8
    reference's own decoding likewise."""
    margin = c.params["choice_margin"]
    err, low_err = compare.SquaredError(), compare.SquaredError()
    cross, low_cross = _Share(), _Share()
    off = invalid = low_off = mismatched = steps_n = 0
    gap = low_gap = 0.0
    calls = job_calls(speech, lengths, seed, 0)
    for (i, k), (record, n_frames, z, memory) in sorted(recorded.items()):
        piece = ref.windows(calls[i], s)[k]
        cap = s.cap(len(piece))
        live = record[:, LIVE] > 0
        tokens = record[live, TOKEN].astype(np.int64)
        invalid += ref.stop_errors(live, record[:, TOKEN], cap, s.eos)
        wav = torch.from_numpy(piece.astype(np.float32) / 32767.0).to(dev)
        with ref.float32_exactly(), torch.no_grad():
            enc = ref.encode(sd, s, wav)
            z_ref = ref.teacher_forced(sd, s, enc, tokens).double().cpu().numpy()
            memory_ref = ref.cross_memory(sd, s, enc)
            cross.add(None if memory is None else memory.to(dev).float(), memory_ref)
            if control:
                fp8 = ref.Precision("fp8")
                low_enc = ref.encode(sd, s, wav, fp8)
                low_cross.add(ref.cross_memory(sd, s, low_enc, fp8), memory_ref)
                low_tokens, low_z = ref.greedy(sd, s, low_enc, cap, fp8)
                low_ref = ref.teacher_forced(sd, s, enc, low_tokens).double().cpu().numpy()
                low_err.add(low_z.double().cpu().numpy(), low_ref)
                o, g = _numbers(s, low_ref, np.asarray(low_tokens, np.int64), margin)
                low_off, low_gap = low_off + o, max(low_gap, g)
            del enc, memory_ref
        if z is not None and len(z) >= len(tokens):
            err.add(z[:len(tokens)].double().numpy(), z_ref)
        else:
            invalid += 1                  # the loop kept no logits of this window's steps
        o, g = _numbers(s, z_ref, tokens, margin)
        off, gap, steps_n = off + o, max(gap, g), steps_n + len(tokens)
        want = ref.window_text(tokens, s.enc.pieces, s.eos)
        start = round(k * s.window / s.enc.sample_rate, 2)
        got = [ph.text for ph in results[i] if ph.start_time == start] if results else None
        mismatched += got != ([want] if want else [])
    compared = {"logit_rms": err.rms(), "cross_rms": cross.share(),
                "choices_off": off if recorded else None,
                "stops_invalid": invalid if recorded else None,
                "texts_mismatched": mismatched if recorded and results else None}
    notes = {"windows_compared": len(recorded), "steps_compared": steps_n,
             "frames_compared": int(sum(r[1] for r in recorded.values())), "choice_gap": gap}
    if control:
        notes["control"] = {"logit_rms": low_err.rms(), "cross_rms": low_cross.share(),
                            "choices_off": low_off}
        notes["control_choice_gap"] = low_gap
    return compared, notes
