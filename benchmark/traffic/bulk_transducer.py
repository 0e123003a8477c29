"""Traffic kind ``bulk_transducer``: bulk transcription of recorded calls
by a FastConformer token-and-duration transducer (``configs/<config>.json``'s
``model`` is a ``FastConformerConfig`` with a ``transducer``).

The jobs, the 16 kHz pool, the window and the end-to-end metric are
``bulk_fastconformer``'s: jobs of ``job_calls`` recordings (lengths drawn
once from ``base_seed``) go to ``OfflineTranscriber.transcribe`` one after
the other, closed loop; set-up makes the weights on the card as NeMo's
``state_dict`` (``harness/weights_transducer.py``), loads them through the
program's converter and runs one job, which warms every batch shape.

The reference checks ``sample_calls`` calls of the window's first jobs,
the longest of the first job among them.  A wrapper on the transcriber's
wait keeps each sampled call's record of the greedy TDT loop as the timed
path produced it: each step's frame, best token and duration and their raw
logits.  The plain float32 reference (``reference/transducer.py``) encodes
each call alone and replays the program's path (teacher forcing: each step
at its frame, the prediction network fed the program's emitted tokens):

* ``path_rms``: the RMS over every step of the program's two raw logits
  minus the reference's logits of the same token and duration;
* ``choices_off``: steps where the reference's logit of the program's
  token, or duration, lies more than ``choice_margin`` below the
  reference's best (a flip within the margin is a near-tie);
* ``path_invalid``: steps whose frame does not follow from the step before
  it by the decoding rules, and paths that stop short of the call's end;
* ``texts_mismatched``: calls whose returned texts differ from the plain
  splitting and joining of the program's own tokens.

The control (``--control``) puts the reference in fp8 e4m3 in the
program's place: its own greedy decoding of each sampled call, checked the
same way.  A traced run traces one job of the window and reads the
program's ``transducer.*`` spans and counters (``metrics/*.tdt_bulk.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, program
from harness.report import Outcome
from harness.trace import DeviceTrace
from reference import transducer as ref
from traffic.bulk import call_lengths, job_calls
from traffic.bulk_fastconformer import RATE, _per_layer, speech_pool

# The columns of the program's record of a step (core/transducer.py FIELDS).
FRAME, TOKEN, DURATION, TOKEN_LOGIT, DURATION_LOGIT, ACTIVE = range(6)


def run(c, *, seed, seconds, trace, device, started, control=False, faults=None):
    from tone_tpu_torch.checkpoint import convert_fastconformer_state_dict
    from tone_tpu_torch.config import FastConformerConfig
    from tone_tpu_torch.offline import OfflineTranscriber

    from harness.weights_transducer import make_state_dict

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
    _break(tr, faults, s.blank)

    # The wrapper on each batch's wait: the loop's record of the sampled calls.
    rng = np.random.default_rng([seed, 6])
    sampled = {(0, int(np.argmax(lengths)))}
    while len(sampled) < p["sample_calls"]:
        sampled.add((int(rng.integers(0, 2)), int(rng.integers(0, len(lengths)))))
    recorded: dict = {}
    job_now = [-1]
    wait = tr._wait

    def recording_wait(launched):
        idx, row_frames, record = wait(launched)
        for row, i in enumerate(idx):
            if (job_now[0], int(i)) in sampled:
                steps = record[row]
                recorded[(job_now[0], int(i))] = (np.array(steps[steps[:, ACTIVE] > 0]),
                                                  int(row_frames[row]))
        return idx, row_frames, record
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

    per_layer, busy, wsec, brk, loop = {}, None, None, None, {}
    if dtrace is not None and dtrace.t1:
        per_layer, busy, wsec, brk = _per_layer(
            c, s, dev, dtrace, program.clip_spans(spans, dtrace.t0, dtrace.t1), {})
        loop = _loop_counts(dtrace)

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
    """The program's ``transducer.*`` counts over the traced job (empty
    where the program records none)."""
    try:
        from tone_tpu_torch.profiling import events
    except ImportError:
        return {}
    out: dict = {}
    for e in events(dtrace.t0, dtrace.t1):
        if hasattr(e, "t_ns") and e.name.startswith("transducer."):
            out[e.name] = out.get(e.name, 0) + e.n
    return out


def _break(tr, faults: dict, blank: int) -> None:
    """Faults the tests plant under the timed path: half of a batch's rows
    given the other half's records; each row's first emitted token altered
    where the loop produced it."""
    forward = tr._transducer_forward

    def broken(variables, batch):
        out = forward(variables, batch)
        if faults.get("half_batch"):
            wav, lengths = batch
            n = out.shape[0] - out.shape[0] // 2
            half = forward(variables, (wav[:n], lengths[:n]))
            steps = min(out.shape[1], half.shape[1])
            out[out.shape[0] // 2:] = 0.0
            out[out.shape[0] // 2:, :steps] = half[:out.shape[0] - out.shape[0] // 2, :steps]
        if faults.get("token_altered"):
            emitted = (out[..., ACTIVE] > 0) & (out[..., TOKEN] != blank)
            first = emitted & (emitted.cumsum(dim=1) == 1)
            out[..., TOKEN] = torch.where(first, (out[..., TOKEN] + 1) % blank, out[..., TOKEN])
        return out
    if faults.get("half_batch") or faults.get("token_altered"):
        tr._transducer_forward = broken


def _path_numbers(sd, s, enc, steps, n_frames, margin, err: compare.SquaredError):
    """(steps off, path errors, the widest gap of a choice below the
    reference's best, the narrowest lead of the chosen duration over the
    others) of one call's path, its logits' gap to the reference's added
    to ``err``."""
    frames, tokens = steps[:, FRAME].astype(np.int64), steps[:, TOKEN].astype(np.int64)
    durs = steps[:, DURATION].astype(np.int64)
    invalid = ref.path_errors(frames, tokens, durs, n_frames, s)
    z = ref.replay(sd, s, enc, frames, tokens).double().cpu().numpy()
    tok_z, dur_z = z[:, :s.blank + 1], z[:, s.blank + 1:]
    rows = np.arange(len(steps))
    tokens_c = np.clip(tokens, 0, s.blank)
    durs_c = np.clip(durs, 0, len(s.durations) - 1)
    err.add(steps[:, [TOKEN_LOGIT, DURATION_LOGIT]],
            np.stack([tok_z[rows, tokens_c], dur_z[rows, durs_c]], axis=1))
    gap = np.maximum(tok_z.max(1) - tok_z[rows, tokens_c], dur_z.max(1) - dur_z[rows, durs_c])
    others = dur_z.copy()
    others[rows, durs_c] = -np.inf
    lead = float((dur_z[rows, durs_c] - others.max(1)).min(initial=np.inf))
    return int((gap > margin).sum()), invalid, float(gap.max(initial=0.0)), lead


def _check(c, s, sd, speech, lengths, seed, recorded, results, dev, control):
    """Each sampled call's recorded path against the float32 reference's
    replay of it, and its texts against the plain splitting and joining of
    its tokens; with ``control``, the fp8 reference's own paths likewise."""
    margin = c.params["choice_margin"]
    err, low_err = compare.SquaredError(), compare.SquaredError()
    off = invalid = low_off = low_invalid = mismatched = checked = steps_n = 0
    gap = low_gap = 0.0
    lead = np.inf
    for (job, i), (steps, n_frames) in sorted(recorded.items()):
        call = job_calls(speech, lengths, seed, job)[i]
        wav = torch.from_numpy(call.astype(np.float32) / 32767.0).to(dev)
        with ref.float32_exactly(), torch.no_grad():
            enc = ref.encode(sd, s, wav)
            o, v, g, d = _path_numbers(sd, s, enc, steps, n_frames, margin, err)
            off, invalid, steps_n, gap = off + o, invalid + v, steps_n + len(steps), max(gap, g)
            lead = min(lead, d)
            if control:
                fp8 = ref.Precision("fp8")
                low_steps = ref.greedy(sd, s, ref.encode(sd, s, wav, fp8), fp8)
                o, v, g, _ = _path_numbers(sd, s, enc, low_steps, n_frames, margin, low_err)
                low_off, low_invalid, low_gap = low_off + o, low_invalid + v, max(low_gap, g)
            del enc
        if job in results:
            checked += 1
            emitted = (steps[:, TOKEN] != s.blank)
            texts = [ph.text for ph in results[job][i]]
            mismatched += texts != ref.phrase_texts(steps[emitted, TOKEN].astype(np.int64),
                                                     steps[emitted, FRAME].astype(np.int64),
                                                     n_frames, s.enc.pieces)
    complete = checked == len(recorded) and checked
    compared = {"path_rms": err.rms(), "choices_off": off if recorded else None,
                "path_invalid": invalid if recorded else None,
                "texts_mismatched": mismatched if complete else None}
    notes = {"calls_compared": len(recorded), "steps_compared": steps_n,
             "frames_compared": int(sum(n for _, n in recorded.values())), "choice_gap": gap,
             "duration_lead": lead,
             "durations_chosen": np.bincount(
                 np.concatenate([st[:, DURATION] for st, _ in recorded.values()]).astype(np.int64),
                 minlength=len(s.durations)).tolist() if recorded else []}
    if control:
        notes["control"] = {"path_rms": low_err.rms(), "choices_off": low_off,
                            "path_invalid": low_invalid}
        notes["control_choice_gap"] = low_gap
    return compared, notes
