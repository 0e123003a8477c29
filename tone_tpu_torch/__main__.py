"""Command-line interface of the PyTorch/CUDA port: the ``serve`` subcommand
(port of ``tone_tpu/__main__.py:29-44, :142-192, :318``, with the flags the
port's engine supports).

  python -m tone_tpu_torch serve [--port 8080] [--slots 256] [...]
  python -m tone_tpu_torch serve --decoder device-beam --lm lm.arpa [--fused-lm] [...]
  python -m tone_tpu_torch serve --decoder beam [--lm lm.arpa] [--interim-beam] [...]

With no ``--checkpoint`` the model takes random weights from
``torch.Generator().manual_seed(0)``; the JAX CLI draws its random weights
from ``jax.random.PRNGKey(0)``, so the two CLIs serve different weights and
transcripts.  Loading a checkpoint waits for the interop slice (ROADMAP
A14).  The server runs on the GPU; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tone_tpu_torch",
                                     description="streaming ASR on PyTorch/CUDA")
    sub = parser.add_subparsers(dest="command", required=True)
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
    p_srv.add_argument("--checkpoint", type=Path, default=None,
                       help="not supported yet (ROADMAP A14); default: random "
                            "weights from seed 0")
    p_srv.add_argument("--decoder", choices=["greedy", "beam", "device-beam"],
                       default="greedy",
                       help="beam = host CTC prefix beam search with LM shallow "
                            "fusion (width 200); device-beam = beam search on the "
                            "device, the LM fused (--fused-lm) or rescoring the "
                            "n-best list on the host")
    p_srv.add_argument("--lm", type=Path, default=None,
                       help="LM for beam search (ARPA text or KenLM binary)")
    p_srv.add_argument("--fused-lm", action="store_true",
                       help="with --decoder device-beam: fuse the LM into the "
                            "device search (full shallow fusion) instead of "
                            "n-best rescoring")
    p_srv.add_argument("--hotwords", type=str, default=None,
                       help="with --decoder beam or device-beam: comma-separated "
                            "words/phrases (or @file, one per line) to bias "
                            "the search toward")
    p_srv.add_argument("--hotword-weight", type=float, default=10.0)
    p_srv.add_argument("--beam-width", type=int, default=None,
                       help="beam width override (default 200 for beam, 32 for "
                            "device-beam)")
    p_srv.add_argument("--device", default=None,
                       help="torch device (default cuda; 'cpu' to run on the CPU)")
    return parser


def build_engine(args):
    """The ``serve`` subcommand's engine from its parsed arguments (random
    weights from seed 0; not warmed up)."""
    import torch

    from tone_tpu_torch.config import ToneConfig
    from tone_tpu_torch.core.model import init_model_params
    from tone_tpu_torch.decoder import build_decoder, parse_hotwords
    from tone_tpu_torch.runtime.engine import MultiStreamEngine

    if args.checkpoint is not None:
        raise NotImplementedError(
            "--checkpoint: loading checkpoints is not ported to "
            "tone_tpu_torch yet (ROADMAP queue A14)")
    decoder = build_decoder(args.decoder, lm=args.lm, fused_lm=args.fused_lm,
                            beam_width=args.beam_width,
                            hotwords=parse_hotwords(args.hotwords),
                            hotword_weight=args.hotword_weight, device=args.device)
    config = ToneConfig()
    print("warning: no checkpoint given — using RANDOM weights")
    variables = init_model_params(torch.Generator().manual_seed(0), config)
    return MultiStreamEngine(
        variables, config, n_slots=args.slots, decoder=decoder, device=args.device,
        interim_transcripts=args.interim, interim_beam=args.interim_beam,
        interim_device_beam=args.interim_device_beam,
        interim_beam_width=args.interim_beam_width,
        interim_beam_max_len=args.interim_beam_max_len,
        idle_evict_seconds=args.idle_evict_seconds,
        force_evict_grace=args.force_evict_grace,
        word_timestamps=args.word_times, nbest=args.nbest,
        max_candidates=args.max_candidates,
        hotword_warmup_buckets=args.hotword_warmup_buckets)


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
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


if __name__ == "__main__":
    main()
