"""Command-line interface of the PyTorch/CUDA port (port of
``tone_tpu/__main__.py``): the ``serve``, ``transcribe``, ``eval``, ``align``,
``lm`` and ``export`` subcommands, with the flags the port supports.

  python -m tone_tpu_torch serve [--port 8080] [--slots 256] [--data-parallel] [...]
  python -m tone_tpu_torch serve --decoder device-beam --lm lm.arpa [--fused-lm] [...]
  python -m tone_tpu_torch serve --decoder beam [--lm lm.arpa] [--interim-beam] [...]
  python -m tone_tpu_torch transcribe AUDIO... [--batch-size N [--offline-forward] [--data-parallel]] [--json]
  python -m tone_tpu_torch eval MANIFEST [--batch-size N [--data-parallel]] [--server ws://...]
  python -m tone_tpu_torch align MANIFEST [--out words.jsonl] [--batch-size 16]
  python -m tone_tpu_torch lm CORPUS OUT [--order 3] [--binary probing|trie] [--native]
  python -m tone_tpu_torch export DIR [--batch-sizes 1 8 64] [--nemo]
  python -m tone_tpu_torch download DIR [--only-acoustic]

The model comes from ``--checkpoint`` (default ``$TONE_TPU_MODEL_DIR``): the
port's checkpoint directory, a reference torch checkpoint (.safetensors,
.bin, .pt) or the reference's ``model.onnx``; the same file serves the same
model in the JAX CLI.  Without one the model takes random weights from
``torch.Generator().manual_seed(0)``, which differ from the JAX CLI's
(``jax.random.PRNGKey(0)``).  ``--chunk-ms`` sets the streaming chunk,
``--compile-cache`` (default ``$TONE_TPU_COMPILE_CACHE``) the directory the
kernels build into.  ``--data-parallel`` splits the bulk batch rows
(``transcribe``/``eval`` with ``--batch-size``) or the serving slots
(``serve``) over every GPU, one process driving them all
(``parallel/mesh.py``).  ``download`` fetches the released model and LM of
``t-tech/T-one`` from ``$HF_ENDPOINT`` through the Hub cache (``hub.py``)
into DIR; where it cannot, it exits non-zero with the client's message.
Everything runs on the GPU; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path


def _add_model_args(p: argparse.ArgumentParser) -> None:
    """The model and decoder flags shared by every subcommand."""
    # TONE_TPU_MODEL_DIR mirrors the reference demo's LOAD_FROM_FOLDER env
    # var (reference tone/demo/website.py:25-33) for container deployments.
    env_dir = os.environ.get("TONE_TPU_MODEL_DIR")
    p.add_argument("--checkpoint", type=Path,
                   default=Path(env_dir) if env_dir else None,
                   help="the port's checkpoint dir, a torch checkpoint file "
                        "(.safetensors/.bin/.pt) or model.onnx (default: "
                        "$TONE_TPU_MODEL_DIR, else random weights from seed 0 "
                        "for smoke testing)")
    p.add_argument("--decoder", choices=["greedy", "beam", "device-beam"],
                   default="greedy",
                   help="beam = host CTC prefix beam search with LM shallow "
                        "fusion (width 200); device-beam = beam search on the "
                        "device, the LM fused (--fused-lm) or rescoring the "
                        "n-best list on the host")
    p.add_argument("--lm", type=Path, default=None,
                   help="LM for beam search (ARPA text or KenLM binary)")
    p.add_argument("--fused-lm", action="store_true",
                   help="with --decoder device-beam: fuse the LM into the "
                        "device search (full shallow fusion) instead of "
                        "n-best rescoring")
    p.add_argument("--hotwords", type=str, default=None,
                   help="with --decoder beam or device-beam: comma-separated "
                        "words/phrases (or @file, one per line) to bias "
                        "the search toward")
    p.add_argument("--hotword-weight", type=float, default=10.0)
    p.add_argument("--beam-width", type=int, default=None,
                   help="beam width override (default 200 for beam, 32 for "
                        "device-beam)")
    p.add_argument("--chunk-ms", type=int, default=300)
    env_cache = os.environ.get("TONE_TPU_COMPILE_CACHE")
    p.add_argument("--compile-cache", type=Path,
                   default=Path(env_cache) if env_cache else None,
                   help="directory the CUDA kernels and C++ libraries build "
                        "into (default: $TONE_TPU_COMPILE_CACHE), so repeat "
                        "runs and server restarts skip the builds")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tone_tpu_torch",
                                     description="streaming ASR on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
    p_dl = sub.add_parser("download", help="download artifacts from HF Hub")
    p_dl.add_argument("download_dir", type=Path)
    p_dl.add_argument("--only-acoustic", action="store_true")

    p_srv = sub.add_parser("serve", help="websocket ASR server")
    p_srv.add_argument("--host", default="0.0.0.0")
    p_srv.add_argument("--port", type=int, default=8080)
    p_srv.add_argument("--metrics-port", type=int, default=8002)
    p_srv.add_argument("--slots", type=int, default=256)
    p_srv.add_argument("--interim", action="store_true",
                       help="stream in-progress phrase partials")
    p_srv.add_argument("--interim-beam", action="store_true",
                       help="partials from a carried host beam search per "
                            "stream (needs --decoder beam)")
    p_srv.add_argument("--interim-device-beam", action="store_true",
                       help="partials from a carried beam search on the device")
    p_srv.add_argument("--interim-beam-width", type=int, default=8)
    p_srv.add_argument("--interim-beam-max-len", type=int, default=2048)
    p_srv.add_argument("--idle-evict-seconds", type=float, default=None,
                       help="idle stream reap timeout (default 15 s, Triton parity)")
    p_srv.add_argument("--word-times", action="store_true",
                       help="transcript events carry per-word times + "
                            "confidences (CTC forced alignment)")
    p_srv.add_argument("--force-evict-grace", type=float, default=None,
                       help="min quiet seconds before slot steal under pressure")
    p_srv.add_argument("--data-parallel", action="store_true",
                       help="split the stream slots over every GPU (--slots a "
                            "multiple of the device count)")
    p_srv.add_argument("--nbest", type=int, default=0,
                       help="transcript events carry up to N scored "
                            "alternatives for every stream (needs a beam "
                            "decoder; clients can instead opt in per stream "
                            "with a JSON config frame {'nbest': N})")
    p_srv.add_argument("--hotword-warmup-buckets", type=int, nargs="*",
                       default=[32], metavar="NODES",
                       help="hotword-table node buckets (powers of two) whose "
                            "per-request-biased finals call runs during warmup "
                            "(default 32; nothing to skip)")
    p_srv.add_argument("--max-candidates", type=int, default=4096,
                       help="streams accepted beyond --slots: they queue as "
                            "candidates and bind oldest-first as slots free "
                            "(0 rejects at capacity)")
    p_srv.add_argument("--drain-grace", type=float, default=10.0,
                       help="graceful-shutdown budget in seconds: on SIGTERM/"
                            "SIGINT live streams flush before the server exits")
    _add_model_args(p_srv)

    p_tr = sub.add_parser("transcribe", help="transcribe audio files")
    p_tr.add_argument("files", nargs="+", type=Path)
    p_tr.add_argument("--json", action="store_true", help="JSON output")
    p_tr.add_argument("--word-times", action="store_true",
                      help="word-level timestamps + confidences via CTC "
                           "forced alignment")
    p_tr.add_argument("--batch-size", type=int, default=0,
                      help=">0: batch files through the bulk transcriber "
                           "(device-batched acoustics, decodes and alignment)")
    p_tr.add_argument("--nbest", type=int, default=0,
                      help="phrases carry up to N scored alternative "
                           "transcripts (needs a beam decoder; shown with "
                           "--json)")
    p_tr.add_argument("--offline-forward", action="store_true",
                      help="with --batch-size: the full-sequence (blocked-"
                           "attention) forward instead of the streaming chunk "
                           "scan")
    p_tr.add_argument("--data-parallel", action="store_true",
                      help="with --batch-size: split batch rows over every GPU")
    _add_model_args(p_tr)

    p_ev = sub.add_parser("eval", help="corpus WER over a JSONL manifest")
    p_ev.add_argument("manifest", type=Path)
    p_ev.add_argument("--limit", type=int, default=None)
    p_ev.add_argument("--server", default=None,
                      help="evaluate against ws://host:port/api/ws instead of locally")
    p_ev.add_argument("--batch-size", type=int, default=0,
                      help=">0: through the bulk transcriber")
    p_ev.add_argument("--offline-forward", action="store_true",
                      help="the full-sequence (blocked-attention) forward instead "
                           "of the streaming chunk scan for batched eval")
    p_ev.add_argument("--data-parallel", action="store_true",
                      help="split batched eval rows over every GPU (--batch-size a "
                           "multiple of the device count)")
    _add_model_args(p_ev)

    p_al = sub.add_parser(
        "align", help="force-align given transcripts to audio (word times + "
                      "confidences; subtitle/relabeling workflows)")
    p_al.add_argument("manifest", type=Path, help="JSONL of {audio_filepath, text}")
    p_al.add_argument("--out", type=Path, default=None,
                      help="output JSONL (default: stdout)")
    p_al.add_argument("--batch-size", type=int, default=16)
    _add_model_args(p_al)

    p_lm = sub.add_parser(
        "lm", help="estimate an n-gram LM (modified Kneser-Ney, lmplz-style)")
    p_lm.add_argument("corpus", type=Path,
                      help="text corpus, one sentence per line")
    p_lm.add_argument("out", type=Path,
                      help="output LM: .arpa/.arpa.gz text or KenLM binary")
    p_lm.add_argument("--order", type=int, default=3)
    p_lm.add_argument("--binary", choices=["probing", "trie"], default="probing",
                      help="binary flavor when out is not .arpa")
    p_lm.add_argument("--quant", type=int, nargs=2, metavar=("PROB", "BACKOFF"),
                      default=None,
                      help="with --binary trie: quantize probs/backoffs to "
                           "this many bits (build_binary -q/-b)")
    p_lm.add_argument("--bhiksha", type=int, default=None,
                      help="with --binary trie: Bhiksha pointer compression "
                           "up to this many bits (build_binary -a)")
    p_lm.add_argument("--prune", type=int, nargs="+", default=None,
                      help="per-order count thresholds (lmplz --prune)")
    p_lm.add_argument("--ppl", type=Path, default=None,
                      help="held-out text file: report perplexity of the "
                           "built model")
    p_lm.add_argument("--native", action="store_true",
                      help="estimate with the C++ estimator (the scale choice "
                           "for 10M+-token corpora; the same model up to float "
                           "rounding)")

    p_ex = sub.add_parser("export", help="torch.export artifacts of the streaming step")
    p_ex.add_argument("out_dir", type=Path)
    p_ex.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 8, 64])
    p_ex.add_argument("--nemo", action="store_true",
                      help="also write a NeMo-restorable .nemo archive "
                           "(reference tone/scripts/export.py:528-549)")
    _add_model_args(p_ex)
    return parser


def build_model(args):
    """(variables, config, decoder) from the model flags: the checkpoint's
    weights on ``--device``, or random weights from seed 0 (float32 on the
    CPU); the decoder on ``--device``."""
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.decoder import build_decoder, parse_hotwords

    if args.compile_cache is not None:
        from tone_tpu_torch.export import enable_compilation_cache

        enable_compilation_cache(args.compile_cache)
    decoder = build_decoder(args.decoder, lm=args.lm, fused_lm=args.fused_lm,
                            beam_width=args.beam_width,
                            hotwords=parse_hotwords(args.hotwords),
                            hotword_weight=args.hotword_weight, device=args.device)
    if args.checkpoint is not None:
        from tone_tpu_torch.acoustic import StreamingCTCModel

        model = StreamingCTCModel.from_local(args.checkpoint, device=args.device)
        variables, config = model.variables, model.config
    else:
        from tone_tpu_torch.core.model import init_model_params

        print("warning: no checkpoint given — using RANDOM weights")
        config = ToneConfig()
        variables = init_model_params(torch.Generator().manual_seed(0), config)
    if args.chunk_ms != 300:
        config = config.with_chunk_duration_ms(args.chunk_ms)
    return variables, config, decoder


def _data_mesh(args):
    """The data-parallel mesh of ``--data-parallel`` over every GPU (or, with
    ``--device``, that device alone), else None."""
    if not getattr(args, "data_parallel", False):
        return None
    from tone_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[args.device] if args.device else None)


def build_engine(args):
    """The ``serve`` subcommand's engine from its parsed arguments (the
    model of ``build_model``; not warmed up).  ``--data-parallel`` checks
    the slot count against the device count before the model loads."""
    from tone_tpu_torch.parallel.mesh import DATA_AXIS, arena_shardings
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    mesh = _data_mesh(args)
    if mesh is not None and args.slots % mesh.shape[DATA_AXIS]:
        raise SystemExit(f"--data-parallel: --slots ({args.slots}) must be a "
                         f"multiple of the device count ({mesh.shape[DATA_AXIS]})")
    variables, config, decoder = build_model(args)
    sharding = None if mesh is None else arena_shardings(mesh, config, args.slots)
    return MultiStreamEngine(
        variables, config, n_slots=args.slots, decoder=decoder,
        device=None if mesh is not None else args.device, sharding=sharding,
        interim_transcripts=args.interim, interim_beam=args.interim_beam,
        interim_device_beam=args.interim_device_beam,
        interim_beam_width=args.interim_beam_width,
        interim_beam_max_len=args.interim_beam_max_len,
        idle_evict_seconds=args.idle_evict_seconds,
        force_evict_grace=args.force_evict_grace,
        word_timestamps=args.word_times, nbest=args.nbest,
        max_candidates=args.max_candidates,
        hotword_warmup_buckets=args.hotword_warmup_buckets)


def build_pipeline(args):
    """The streaming pipeline of ``transcribe``, ``eval`` and ``align`` from
    their parsed arguments; a flag the decoder refuses exits with its
    message."""
    from tone_tpu_torch.acoustic import StreamingCTCModel
    from tone_tpu_torch.pipeline import StreamingCTCPipeline

    try:
        variables, config, decoder = build_model(args)
        return StreamingCTCPipeline(
            StreamingCTCModel(variables, config, device=args.device), decoder=decoder,
            word_timestamps=getattr(args, "word_times", False),
            nbest=getattr(args, "nbest", 0))
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _transcriber(pipeline, args, **kwargs):
    """The bulk transcriber over ``pipeline``'s model and decoder."""
    from tone_tpu_torch.offline import OfflineTranscriber

    model = pipeline.model
    mesh = _data_mesh(args)
    try:
        return OfflineTranscriber(model.variables, model.config, batch_size=args.batch_size,
                                  device=None if mesh is not None else model.device,
                                  mesh=mesh, **kwargs)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def _run_transcribe(args) -> None:
    from tone_tpu_torch.audio import read_audio

    if args.batch_size <= 0 and (args.offline_forward or args.data_parallel):
        raise SystemExit(
            "--offline-forward/--data-parallel apply to the bulk "
            "transcriber only: pass --batch-size N")
    if args.batch_size > 0 and args.nbest > 0:
        raise SystemExit(
            "--nbest decodes per phrase and is not supported on the "
            "batched bulk path; drop --batch-size")

    def phrase_dict(p):
        d = {"text": p.text, "start_time": p.start_time, "end_time": p.end_time}
        if p.words is not None:
            d["words"] = [vars(w) for w in p.words]
        if p.nbest is not None:
            d["nbest"] = [{"text": t, "score": s} for t, s in p.nbest]
        return d

    pipeline = build_pipeline(args)
    all_phrases = None
    if args.batch_size > 0:
        transcriber = _transcriber(pipeline, args, decoder=pipeline.decoder,
                                   use_offline_forward=args.offline_forward,
                                   word_timestamps=args.word_times)
        all_phrases = transcriber.transcribe([read_audio(p) for p in args.files])
    for k, path in enumerate(args.files):
        phrases = (all_phrases[k] if all_phrases is not None
                   else pipeline.forward_offline(read_audio(path)))
        if args.json:
            print(json.dumps({"file": str(path), "phrases": [phrase_dict(p) for p in phrases]},
                             ensure_ascii=False))
        else:
            print(f"== {path}")
            for p in phrases:
                print(f"  [{p.start_time:7.2f} – {p.end_time:7.2f}] {p.text}")
                for w in p.words or ():
                    print(f"      [{w.start_time:7.2f} – {w.end_time:7.2f}]"
                          f" ({w.confidence:.2f}) {w.word}")


def _run_eval(args) -> None:
    from tone_tpu_torch.eval import evaluate_pipeline, evaluate_server

    if args.server and (args.batch_size > 0 or args.offline_forward or args.data_parallel):
        raise SystemExit(
            "--server evaluates a remote deployment; "
            "--batch-size/--offline-forward/--data-parallel only "
            "apply to local batched eval")
    if args.batch_size <= 0 and (args.offline_forward or args.data_parallel):
        raise SystemExit(
            "--offline-forward/--data-parallel apply to batched eval "
            "only: pass --batch-size N")
    if args.server:
        result = evaluate_server(args.server, args.manifest, limit=args.limit)
    elif args.batch_size > 0:
        pipeline = build_pipeline(args)
        transcriber = _transcriber(pipeline, args, decoder=pipeline.decoder,
                                   use_offline_forward=args.offline_forward)
        result = evaluate_pipeline(transcriber, args.manifest, limit=args.limit)
    else:
        result = evaluate_pipeline(build_pipeline(args), args.manifest, limit=args.limit)
    print(json.dumps({
        "wer": round(result.wer, 4),
        "utterances": result.n_utterances,
        "audio_seconds": round(result.audio_seconds, 1),
        "wall_seconds": round(result.wall_seconds, 2),
        "rtfx": round(result.rtfx, 1),
    }))


def _run_align(args) -> None:
    import sys

    import numpy as np

    from tone_tpu_torch.align import spans_to_word_timings
    from tone_tpu_torch.audio import read_audio
    from tone_tpu_torch.config import LABELS
    from tone_tpu_torch.eval import read_manifest
    from tone_tpu_torch.ops.align_device import align_words_batch

    pipeline = build_pipeline(args)
    cfg = pipeline.model.config
    transcriber = _transcriber(pipeline, args)
    items = read_manifest(args.manifest)
    bias = cfg.mean_time_bias + cfg.padding / cfg.frontend.sample_rate
    alphabet = set(LABELS) - {" "}

    def norm_word(word: str) -> str:
        # real transcripts carry punctuation, digits and Latin the model's
        # alphabet lacks: align what is representable, keep the ORIGINAL
        # word in the output
        return "".join(c for c in word.lower() if c in alphabet)

    def align_one(it, lp):
        orig = str(it["text"]).split()
        norm = [norm_word(w) for w in orig]
        text = " ".join(w for w in norm if w)
        spans = (align_words_batch([lp], [text], device=transcriber.device)[0]
                 if text else [])
        timed = iter(spans_to_word_timings(spans, 0, cfg.frame_size, bias))
        words = []
        for w, nw in zip(orig, norm):
            if nw:
                t = next(timed)
                words.append({"word": w, "start_time": t.start_time,
                              "end_time": t.end_time, "confidence": t.confidence})
            else:  # nothing alignable in this word (e.g. "—")
                words.append({"word": w, "start_time": None, "end_time": None,
                              "confidence": None})
        return {"audio_filepath": it.get("audio_filepath"), "text": it["text"],
                "words": words}

    out_f = open(args.out, "w", encoding="utf-8") if args.out else sys.stdout
    n_done = n_failed = 0
    try:
        # batch by batch, so memory is bounded and the output incremental
        for start in range(0, len(items), args.batch_size):
            chunk = items[start:start + args.batch_size]
            audios = [np.asarray(it.get("audio") if it.get("audio") is not None
                                 else read_audio(it["audio_filepath"]), np.int32)
                      for it in chunk]
            for it, lp in zip(chunk, transcriber.logprobs(audios)):
                try:
                    record = align_one(it, lp)
                    n_done += 1
                except ValueError as e:  # e.g. a text longer than its audio
                    record = {"audio_filepath": it.get("audio_filepath"),
                              "text": it["text"], "error": str(e)}
                    n_failed += 1
                out_f.write(json.dumps(record, ensure_ascii=False) + "\n")
            out_f.flush()
    finally:
        if args.out:
            out_f.close()
    if args.out:
        print(json.dumps({"out": str(args.out), "utterances": n_done, "failed": n_failed}))


def _run_lm(args) -> None:
    import re

    from tone_tpu_torch.decoding.estimate import estimate_from_text, perplexity, write_arpa
    from tone_tpu_torch.decoding.lm import ArpaLM

    name = args.out.name
    is_arpa = name.endswith(".arpa") or name.endswith(".arpa.gz")
    if (args.quant or args.bhiksha) and (args.binary != "trie" or is_arpa):
        # a pure argument error: fail before the (possibly minutes-long)
        # corpus counting, not after
        raise SystemExit("--quant/--bhiksha require --binary trie and a "
                         "binary output path")
    if args.native:
        from tone_tpu_torch.decoding.native.estimate import (
            estimate_arpa_native,
            native_available,
        )

        if not native_available():
            raise SystemExit("--native: no C++ toolchain available")
        if is_arpa and not name.endswith(".gz"):
            # native writes the final ARPA directly — no Python tables
            estimate_arpa_native(args.corpus, args.out, order=args.order, prune=args.prune)
            tables = None
        else:
            # native ARPA to a sibling temp, then convert to the requested
            # artifact through the standard readers and writers
            import tempfile

            with tempfile.NamedTemporaryFile(suffix=".arpa", dir=args.out.parent,
                                             delete=False) as tf:
                tmp_arpa = Path(tf.name)
            try:
                estimate_arpa_native(args.corpus, tmp_arpa, order=args.order,
                                     prune=args.prune)
                tables = ArpaLM.from_file(tmp_arpa)._ngrams
            finally:
                tmp_arpa.unlink(missing_ok=True)
    else:
        with open(args.corpus, encoding="utf-8") as f:
            tables = estimate_from_text(f, order=args.order, prune=args.prune)
    if tables is None:
        pass  # already written (native direct-ARPA path)
    elif is_arpa:
        write_arpa(tables, args.out)
    elif args.binary == "trie":
        from tone_tpu_torch.decoding.kenlm_trie import write_kenlm_trie

        write_kenlm_trie(tables, args.out,
                         quant_bits=tuple(args.quant) if args.quant else None,
                         bhiksha_bits=args.bhiksha)
    else:
        from tone_tpu_torch.decoding.kenlm_binary import write_kenlm_binary

        write_kenlm_binary(tables, args.out)
    if tables is None and args.ppl is not None:
        tables = ArpaLM.from_file(args.out)._ngrams
    if tables is None:
        # native direct-ARPA path without --ppl: counts from the header
        with open(args.out, encoding="utf-8") as f:
            head = f.read(4096)
        counts = [int(m) for m in re.findall(r"ngram \d+=(\d+)", head)]
        report = {"out": str(args.out), "order": args.order, "ngrams": counts}
    else:
        report = {"out": str(args.out), "order": args.order,
                  "ngrams": [len(t) for t in tables]}
    if args.ppl is not None:
        with open(args.ppl, encoding="utf-8") as f:
            held_out = [line.split() for line in (ln.strip().lower() for ln in f) if line]
        report["ppl"] = round(perplexity(ArpaLM(tables), held_out), 3)
    print(json.dumps(report))


def _run_export(args) -> None:
    from tone_tpu_torch.export import export_streaming

    pipeline = build_pipeline(args)
    model = pipeline.model
    written = export_streaming(model.variables, model.config, args.batch_sizes, args.out_dir)
    if args.nemo:
        from tone_tpu_torch.interop import save_nemo_archive

        nemo_path = args.out_dir / "model.nemo"
        save_nemo_archive(nemo_path, model.variables, model.config)
        written = [*written, nemo_path]
    for p in written:
        print(p)


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "download":
        from tone_tpu_torch.hub import HubError
        from tone_tpu_torch.pipeline import StreamingCTCPipeline

        args.download_dir.mkdir(exist_ok=True)
        try:
            StreamingCTCPipeline.download_from_hugging_face(
                args.download_dir, only_acoustic=args.only_acoustic)
        except HubError as e:
            raise SystemExit(f"download: {e}") from None
    elif args.command == "serve":
        import asyncio
        import logging

        from tone_tpu_torch.runtime.server import serve

        engine = build_engine(args)
        logging.basicConfig(level=logging.INFO)
        try:
            asyncio.run(serve(engine, args.host, args.port,
                              metrics_port=args.metrics_port,
                              drain_grace=args.drain_grace))
        finally:
            engine.shutdown()
    elif args.command == "transcribe":
        _run_transcribe(args)
    elif args.command == "eval":
        _run_eval(args)
    elif args.command == "align":
        _run_align(args)
    elif args.command == "lm":
        _run_lm(args)
    elif args.command == "export":
        _run_export(args)


if __name__ == "__main__":
    main()
