"""Traffic kind ``bulk``: bulk transcription of recorded calls.

Jobs of ``job_calls`` recordings go to ``OfflineTranscriber.transcribe``
one after the other, with the transcriber's options from ``transcriber``
(the full-sequence forward, its batch).  The calls' lengths (a clipped
lognormal: ``call_seconds``) are drawn once from ``base_seed``, so every
job and every run's seed holds the same lengths; the audio of each call
is cut from a speech-like pool of ``pool_seconds`` at an offset drawn from
the run's seed and the job.  Set-up builds the pool, the weights and the
transcriber and runs one job, which warms every batch shape the window
uses (the transcriber sorts a job by length, so each job's batches are
alike).  The window runs jobs until ``--seconds`` have passed and closes
when the last of them returns its transcripts.  End to end: the unpadded
audio seconds transcribed per second of the window.

The reference checks ``sample_calls`` calls of the window's first jobs,
the longest of the first job among them: their logprobs as the timed path
produced them (a wrapper on the transcriber's wait for each batch) against
the plain offline forward in float32, and the texts the transcriber
returned against the plain splitter and greedy decoding of those logprobs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import audio, compare, program
from harness.flops import chunk_flops
from harness.report import Outcome
from harness.trace import B1_KERNEL, DeviceTrace
from reference import decode as ref_decode
from reference import model as ref_model


def call_lengths(p: dict) -> np.ndarray:
    u = p["call_seconds"]
    rng = np.random.default_rng(p["base_seed"])
    secs = np.clip(rng.lognormal(np.log(u["median"]), u["sigma"], p["job_calls"]), u["min"], u["max"])
    return (secs * audio.SAMPLE_RATE).astype(np.int64)


def job_calls(speech: np.ndarray, lengths: np.ndarray, seed: int, job: int) -> list[np.ndarray]:
    """Job ``job``'s recordings: views of the pool at offsets of the seed."""
    rng = np.random.default_rng([seed, 5, job + 1])   # the warm-up is job -1
    return [speech[o:o + n] for n, o in
            ((int(n), int(rng.integers(0, len(speech) - n + 1))) for n in lengths)]


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.core import encoder as port_encoder
    from tone_tpu_torch.offline import OfflineTranscriber

    from harness.weights import make_variables

    faults = faults or {}
    p = c.params
    dev = torch.device(device)
    cfg = program.tone_config(c.model)
    lengths = call_lengths(p)
    speech = audio.pool(seed, p["pool_seconds"])
    variables = make_variables(c.model, seed, dev)
    tr = OfflineTranscriber(variables, cfg, device=dev, **p["transcriber"])
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
        idx, row_chunks, logprobs = wait(launched)
        for row, i in enumerate(idx):
            if (job_now[0], int(i)) in sampled:
                n = row_chunks[row] * cfg.encoder.chunk_size
                recorded[(job_now[0], int(i))] = np.array(logprobs[row, :n])
        return idx, row_chunks, logprobs
    tr._wait = recording_wait

    # B1's row counts, in launch order, while the device is traced.
    b1_rows: list = []
    glu = port_encoder.glu_ff2
    tracing = [False]

    def counted_glu(av, p2, dtype=torch.bfloat16):
        if tracing[0]:
            b1_rows.append((av.numel() // av.shape[-1], p2["w"].shape[0], p2["w"].shape[1]))
        return glu(av, p2, dtype)
    port_encoder.glu_ff2 = counted_glu

    try:
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
        jobs, audio_s, traced, results, trace_cost = 0, 0.0, None, {}, {}
        spans = {"transcribe (host)": []}
        while True:
            calls = job_calls(speech, lengths, seed, jobs)
            job_now[0] = jobs
            if dtrace is not None and traced is None and time.monotonic() >= trace_at:
                a = time.monotonic()
                dtrace.start()
                trace_cost["start_s"] = time.monotonic() - a
                tracing[0] = True
                traced = float(lengths.sum()) / audio.SAMPLE_RATE
            a = time.monotonic_ns()
            out = tr.transcribe(calls)
            spans["transcribe (host)"].append((a, time.monotonic_ns()))
            if tracing[0]:
                a = time.monotonic()
                dtrace.stop()
                trace_cost["stop_s"] = time.monotonic() - a
                tracing[0] = False
            if jobs < 2:
                results[jobs] = out
            jobs += 1
            audio_s += float(lengths.sum()) / audio.SAMPLE_RATE
            if time.monotonic() - t_window >= seconds:
                break
        window = time.monotonic() - t_window
        peak = program.memory_peak(dev)
    finally:
        port_encoder.glu_ff2 = glu

    per_layer, busy, wsec, brk = {}, None, None, None
    if dtrace is not None and dtrace.t1:
        s = ref_model.sizes(c.model)
        counters = {"audio_s": traced, "b1_rows": b1_rows, "b1_kernel": B1_KERNEL,
                    "flops_per_audio_s": chunk_flops(s) / (cfg.audio_chunk_samples
                                                           / cfg.frontend.sample_rate)}
        per_layer, busy, wsec, brk = program.per_layer(
            c, dev, dtrace, program.clip_spans(spans, dtrace.t0, dtrace.t1), counters,
            "between jobs")

    del tr
    program.release(dev)
    compared, notes = _check(c, variables, speech, lengths, seed, recorded, results, dev, control)
    return Outcome(attempted=jobs * len(lengths), failed=0,
                   end_to_end={"setup_s": setup_s, "bulk_audio_s_per_s": audio_s / window},
                   compared=compared, memory_peak_bytes=peak,
                   device_kind=program.device_kind(dev), per_layer=per_layer, busy_s=busy,
                   window_s=wsec, breakdown=brk,
                   notes={"jobs": jobs, "window_s": window, "trace_cost_s": trace_cost, **notes})


def _break(tr, faults: dict) -> None:
    """Faults the tests plant under the timed path."""
    if faults.get("half_batch"):
        forward = tr._offline_forward

        def half(variables, chunks):
            out = forward(variables, chunks)
            out[out.shape[0] // 2:] = forward(variables, chunks[: out.shape[0] - out.shape[0] // 2])
            return out
        tr._offline_forward = half
    if faults.get("token_altered"):
        decoder = tr.decoder
        forward = decoder.forward

        class Altered:
            def forward(self, logprobs):
                return forward(logprobs) + "а"
        tr.decoder = Altered()
        del decoder


def _check(c, variables, speech, lengths, seed, recorded, results, dev, control):
    """Each sampled call: the logprobs' widest token gap against the
    reference, and its texts against the reference's decoding of the
    program's logprobs."""
    s = ref_model.sizes(c.model)
    labels = c.model["labels"]
    gaps, low_gaps, mismatched, checked = [], [], 0, 0
    err, low_err = compare.SquaredError(), compare.SquaredError()
    for (job, i), lp in sorted(recorded.items()):
        call = job_calls(speech, lengths, seed, job)[i]
        padded = np.pad(call.astype(np.float32), (s.padding, s.padding))
        padded = np.pad(padded, (0, -len(padded) % s.chunk_samples))
        wav = torch.from_numpy(padded / 32767.0).to(dev, torch.float32)[None]
        with ref_model.float32_exactly(), torch.no_grad():
            ref = ref_model.offline_forward(variables, s, wav)[0][0].cpu().numpy()
            if control:
                low = ref_model.offline_forward(variables, s, wav, pr=ref_model.Precision("fp8"))
                low = low[0][0].cpu().numpy()
                low_gaps.append(compare.token_gap(low, ref))
                low_err.add(low, ref)
        gaps.append(compare.token_gap(lp, ref))
        err.add(lp, ref)
        if job in results:
            checked += 1
            texts = [ph.text for ph in results[job][i]]
            mismatched += texts != ref_decode.phrase_texts(lp, labels)
    compared = {"logprob_rms": err.rms(),
                "texts_mismatched": mismatched if checked == len(recorded) and checked else None}
    notes = {"calls_compared": len(gaps), "token_gap": max(gaps) if gaps else None,
             "frames_compared": int(sum(len(v) for v in recorded.values()))}
    if control:
        notes["control"] = {"logprob_rms": low_err.rms()}
        notes["control_token_gap"] = max(low_gaps) if low_gaps else None
    return compared, notes
