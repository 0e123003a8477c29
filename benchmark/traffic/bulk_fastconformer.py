"""Traffic kind ``bulk_fastconformer``: bulk transcription of recorded calls
by a FastConformer CTC model (``configs/<config>.json``'s ``model`` is a
``FastConformerConfig``).

The jobs of kind ``bulk`` (its ``call_lengths`` and ``job_calls``): jobs of
``job_calls`` recordings go to ``OfflineTranscriber.transcribe`` one after
the other, closed loop, with the transcriber's options from
``transcriber``; the calls' lengths are drawn once from ``base_seed``.
The model takes 16 kHz audio, so set-up resamples the 8 kHz speech-like
pool to 16 kHz once (the port's polyphase resampler), as an operator feeds
telephony calls to a 16 kHz model, and every length doubles.  Set-up also
makes the weights on the card as NeMo's ``state_dict``
(``harness/weights_fastconformer.py``), loads them through the program's
converter, builds the transcriber and runs one job, which warms every batch
shape the window uses.  The window runs jobs until ``--seconds`` have
passed and closes when the last of them returns its transcripts.  End to
end: the unpadded audio seconds transcribed per second of the window.

The reference checks ``sample_calls`` calls of the window's first jobs,
the longest of the first job among them: their logprobs as the timed path
produced them (a wrapper on the transcriber's wait for each batch) against
the plain float32 forward of each call alone
(``reference/fastconformer.py``), and the texts the transcriber returned
against the plain splitter and greedy decoding of those logprobs.

A traced run traces one job of the window and reads the program's
``fastconformer.*`` spans and counters (``metrics/*.fc_bulk.py``); the
useful operations of the traced job are counted by
``harness/flops_fastconformer.py``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import audio, compare, flops, program, trace
from harness.flops_fastconformer import call_flops
from harness.report import Outcome
from harness.trace import DeviceTrace
from reference import fastconformer as ref
from traffic.bulk import call_lengths, job_calls

RATE = 16000


def speech_pool(seed: int, seconds: float) -> np.ndarray:
    """The bulk kind's 8 kHz pool of ``seed``, resampled to 16 kHz int16."""
    from tone_tpu_torch.audio.io import _resample_to

    pool8 = audio.pool(seed, seconds).astype(np.float64)
    return np.clip(np.round(_resample_to(pool8, audio.SAMPLE_RATE, RATE)),
                   -32768, 32767).astype(np.int16)


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.offline import OfflineTranscriber

    from harness.weights_fastconformer import make_state_dict

    faults = faults or {}
    p = c.params
    dev = torch.device(device)
    cfg = FastConformerConfig.from_dict(c.model)
    s = ref.sizes(c.model)
    lengths = call_lengths(p) * (RATE // audio.SAMPLE_RATE)
    speech = speech_pool(seed, p["pool_seconds"])
    state_dict = make_state_dict(c.model, seed, dev)
    tr = OfflineTranscriber(convert_fastconformer_state_dict(state_dict, cfg), cfg, device=dev,
                            **p["transcriber"])
    _break(tr, faults)

    # The wrapper on each batch's wait: the logprobs of the sampled calls.
    rng = np.random.default_rng([seed, 6])
    sampled = {(0, int(np.argmax(lengths)))}
    while len(sampled) < p["sample_calls"]:
        sampled.add((int(rng.integers(0, 2)), int(rng.integers(0, len(lengths)))))
    recorded: dict = {}
    job_now = [-1]
    wait = tr._wait

    def recording_wait(launched):
        idx, row_frames, logprobs = wait(launched)
        for row, i in enumerate(idx):
            if (job_now[0], int(i)) in sampled:
                recorded[(job_now[0], int(i))] = np.array(logprobs[row, :row_frames[row]])
        return idx, row_frames, logprobs
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
        if jobs < 2:
            results[jobs] = out
        jobs += 1
        audio_s += job_s
        if time.monotonic() - t_window >= seconds:
            break
    window = time.monotonic() - t_window
    peak = program.memory_peak(dev)

    per_layer, busy, wsec, brk = {}, None, None, None
    if dtrace is not None and dtrace.t1:
        counters = {"flops": sum(call_flops(s, int(n)) for n in lengths)}
        per_layer, busy, wsec, brk = _per_layer(
            c, s, dev, dtrace, program.clip_spans(spans, dtrace.t0, dtrace.t1), counters)

    del tr
    program.release(dev)
    compared, notes = _check(c, s, state_dict, speech, lengths, seed, recorded, results, dev,
                             control)
    return Outcome(attempted=jobs * len(lengths), failed=0,
                   end_to_end={"setup_s": setup_s, "bulk_audio_s_per_s": audio_s / window},
                   compared=compared, memory_peak_bytes=peak,
                   device_kind=program.device_kind(dev), per_layer=per_layer, busy_s=busy,
                   window_s=wsec, breakdown=brk,
                   notes={"jobs": jobs, "window_s": window, "trace_cost_s": trace_cost, **notes})


def _per_layer(c, s, device, dtrace, spans: dict, counters: dict):
    """(metrics, busy_s, window_s, breakdown) of the traced job, as
    ``program.per_layer`` reads them, with the FastConformer's sizes."""
    reading = trace.Reading(cell=c, sizes=s, peaks=flops.peak(program.device_kind(device)),
                            trace=dtrace, spans=spans, counters=counters)
    values = {}
    for m in c.per_layer:
        value = trace.read_metric(m["name"], reading)
        if value is not None:
            values[m["name"]] = value
    return (values, dtrace.busy_ns() / 1e9, dtrace.window_s,
            trace.breakdown(reading, trace.span_label(spans, "between jobs")))


def _break(tr, faults: dict) -> None:
    """Faults the tests plant under the timed path."""
    if faults.get("half_batch"):
        forward = tr._fastconformer_forward

        def half(variables, batch):
            wav, lengths = batch
            out = forward(variables, batch)
            n = out.shape[0] - out.shape[0] // 2
            out[out.shape[0] // 2:] = forward(variables, (wav[:n], lengths[:n]))
            return out
        tr._fastconformer_forward = half
    if faults.get("token_altered"):
        decoder = tr.decoder
        forward = decoder.forward

        class Altered:
            def forward(self, logprobs):
                return forward(logprobs) + "a"
        tr.decoder = Altered()
        del decoder


def _check(c, s, state_dict, speech, lengths, seed, recorded, results, dev, control):
    """Each sampled call: the RMS of its logprobs' gap to the reference's,
    and its texts against the reference's decoding of the program's
    logprobs."""
    pieces = s.pieces
    gaps, low_gaps, mismatched, checked = [], [], 0, 0
    err, low_err = compare.SquaredError(), compare.SquaredError()
    for (job, i), lp in sorted(recorded.items()):
        call = job_calls(speech, lengths, seed, job)[i]
        wav = torch.from_numpy(call.astype(np.float32) / 32767.0).to(dev)
        with ref.float32_exactly(), torch.no_grad():
            reference = ref.forward(state_dict, s, wav).cpu().numpy()
            if control:
                low = ref.forward(state_dict, s, wav, ref.Precision("fp8")).cpu().numpy()
                low_gaps.append(compare.token_gap(low, reference))
                low_err.add(low, reference)
        gaps.append(compare.token_gap(lp, reference))
        err.add(lp, reference)
        if job in results:
            checked += 1
            texts = [ph.text for ph in results[job][i]]
            mismatched += texts != ref.phrase_texts(lp, pieces)
    compared = {"logprob_rms": err.rms(),
                "texts_mismatched": mismatched if checked == len(recorded) and checked else None}
    notes = {"calls_compared": len(gaps), "token_gap": max(gaps) if gaps else None,
             "frames_compared": int(sum(len(v) for v in recorded.values()))}
    if control:
        notes["control"] = {"logprob_rms": low_err.rms()}
        notes["control_token_gap"] = max(low_gaps) if low_gaps else None
    return compared, notes
