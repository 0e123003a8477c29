"""Publish the port's artifacts to a Hugging Face Hub repo (port of
``dev/push_hf.py``): the port's checkpoint directory, a torch-naming
``model.safetensors`` (what ``StreamingCTCModel.from_hugging_face`` and the
reference toolchain load), and optionally an LM, a ``.nemo`` archive made
from the checkpoint, a VAD onnx (the reference bundles silero_vad.onnx at
``onnx/silero_vad.onnx``) and the ``export`` subcommand's programs.

    HF_TOKEN=... python -m tone_tpu_torch.dev.push_hf --repo your-org/your-model \\
        --checkpoint artifacts/model [--lm lm.arpa.gz] [--nemo] \\
        [--vad silero_vad.onnx] [--exported exported_dir]

Two departures from the JAX script: the checkpoint folder goes to
``tone_tpu_torch_checkpoint/``, and ``--stablehlo`` is ``--exported DIR``
(``python -m tone_tpu_torch export DIR``), uploaded under ``torch_export/``.
It uploads through ``tone_tpu_torch.hub`` (``$HF_ENDPOINT``, ``$HF_TOKEN``).
The script runs no model, so it has no ``--device`` flag.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m tone_tpu_torch.dev.push_hf")
    parser.add_argument("--repo", required=True)
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="the port's checkpoint dir (config.json + variables.safetensors)")
    parser.add_argument("--lm", type=Path, default=None)
    parser.add_argument("--nemo", action="store_true",
                        help="also generate + upload a reference-restorable "
                             ".nemo archive (interop.save_nemo_archive)")
    parser.add_argument("--vad", type=Path, default=None,
                        help="VAD onnx to bundle at onnx/silero_vad.onnx "
                             "(reference repo layout; the port itself uses "
                             "the logprob splitter for segmentation)")
    parser.add_argument("--exported", type=Path, default=None,
                        help="dir of export_streaming programs to upload under "
                             "torch_export/ (the TensorRT model.plan slot)")
    parser.add_argument("--private", action="store_true")
    parser.add_argument("--dry-run", action="store_true",
                        help="assemble the upload set and print it without "
                             "network access or credentials")
    return parser


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    from tone_tpu_torch.checkpoint import load_checkpoint
    from tone_tpu_torch.interop import save_torch_checkpoint

    variables, config = load_checkpoint(args.checkpoint)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # torch-naming safetensors so the reference toolchain can load it too
        save_torch_checkpoint(tmp / "model.safetensors", variables, config)
        uploads = [
            (str(args.checkpoint), "tone_tpu_torch_checkpoint/ (folder)"),
            (str(tmp / "model.safetensors"), "model.safetensors"),
        ]
        if args.lm:
            uploads.append((str(args.lm), args.lm.name))
        if args.nemo:
            from tone_tpu_torch.interop import save_nemo_archive

            save_nemo_archive(tmp / "model.nemo", variables, config)
            uploads.append((str(tmp / "model.nemo"), "model.nemo"))
        if args.vad:
            if not args.vad.exists():
                raise FileNotFoundError(f"missing VAD onnx: {args.vad}")
            uploads.append((str(args.vad), "onnx/silero_vad.onnx"))
        if args.exported:
            uploads.append((str(args.exported), "torch_export/ (folder)"))
        if args.dry_run:
            for src, dest in uploads:
                print(f"would upload {src} -> {args.repo}:{dest}")
            return

        from tone_tpu_torch.hub import HubApi

        api = HubApi()
        api.create_repo(args.repo, exist_ok=True, private=args.private)
        for src, dest in uploads:
            if dest.endswith("/ (folder)"):
                api.upload_folder(repo_id=args.repo, folder_path=src,
                                  path_in_repo=dest.split("/")[0])
            else:
                api.upload_file(repo_id=args.repo, path_or_fileobj=src, path_in_repo=dest)
    print(f"published to {api.endpoint}/{args.repo}")


if __name__ == "__main__":
    main()
