"""Command-line interface of the PyTorch/CUDA port: the ``serve`` subcommand
(port of ``tone_tpu/__main__.py:142-192, :318``, with the flags the greedy
engine supports).

  python -m tone_tpu_torch serve [--port 8080] [--slots 256] [...]

With no ``--checkpoint`` the model takes random weights from seed 0, as the
JAX CLI does; loading a checkpoint waits for the interop slice (ROADMAP
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
    p_srv.add_argument("--idle-evict-seconds", type=float, default=None,
                       help="idle stream reap timeout (default 15 s, Triton parity)")
    p_srv.add_argument("--force-evict-grace", type=float, default=None,
                       help="min quiet seconds before slot steal under pressure")
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
    p_srv.add_argument("--device", default=None,
                       help="torch device (default cuda; 'cpu' to run on the CPU)")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "serve":
        import asyncio
        import logging

        import torch

        from tone_tpu_torch.config import ToneConfig
        from tone_tpu_torch.core.model import init_model_params
        from tone_tpu_torch.runtime.engine import MultiStreamEngine
        from tone_tpu_torch.runtime.server import serve

        if args.checkpoint is not None:
            raise NotImplementedError(
                "--checkpoint: loading checkpoints is not ported to "
                "tone_tpu_torch yet (ROADMAP queue A14)")
        logging.basicConfig(level=logging.INFO)
        config = ToneConfig()
        print("warning: no checkpoint given — using RANDOM weights")
        variables = init_model_params(torch.Generator().manual_seed(0), config)
        engine = MultiStreamEngine(
            variables, config, n_slots=args.slots, device=args.device,
            interim_transcripts=args.interim,
            idle_evict_seconds=args.idle_evict_seconds,
            force_evict_grace=args.force_evict_grace,
            max_candidates=args.max_candidates)
        try:
            asyncio.run(serve(engine, args.host, args.port,
                              metrics_port=args.metrics_port,
                              drain_grace=args.drain_grace))
        finally:
            engine.shutdown()


if __name__ == "__main__":
    main()
