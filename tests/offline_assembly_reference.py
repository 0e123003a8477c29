"""The bulk transcriber's batch assembly as the host used to do it, kept as
the reference for ``OfflineTranscriber``'s staged assembly: every row
widened to int32 and padded on the host (the call between ``padding`` zeros
for T-one, alone for FastConformer), the padded batch copied to the device
whole, without overlap.  Imports neither JAX nor the JAX package, so the
card's tests use it too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tone_tpu_torch.config import FastConformerConfig


def assemble_chunks(tr, idx, audios) -> tuple[list[int], list[torch.Tensor]]:
    """T-one: (row_chunks, each device's (rows, chunks, chunk) int32 rows)."""
    cfg = tr.config
    pad = cfg.padding
    chunk = cfg.audio_chunk_samples
    bucket_chunks = max(tr.bucket_samples // chunk, 1)
    batch_audios = [np.pad(np.asarray(audios[i], np.int32), (pad, pad)) for i in idx]
    row_chunks = [-(-len(a) // chunk) for a in batch_audios]
    n_chunks = -(-max(row_chunks) // bucket_chunks) * bucket_chunks
    n_rows = -(-len(idx) // len(tr._shards)) * len(tr._shards)
    per = n_rows // len(tr._shards)
    audio_arr = np.zeros((n_rows, n_chunks * chunk), np.int32)
    for row, a in enumerate(batch_audios):
        audio_arr[row, :len(a)] = a
    chunks = torch.from_numpy(audio_arr.reshape(n_rows, n_chunks, chunk))
    return row_chunks, [chunks[k * per:(k + 1) * per].to(dev)
                        for k, (dev, _) in enumerate(tr._shards)]


def assemble_calls(tr, idx, audios) -> tuple[list[int], list[tuple]]:
    """FastConformer: (row_frames, [((rows, samples) int32 rows, lengths)])."""
    cfg = tr.config
    unit = cfg.frame_samples
    bucket_units = max(tr.bucket_samples // unit, 1)
    lengths = np.array([len(audios[i]) for i in idx], np.int64)
    units = max(-(-int(lengths.max()) // unit), 1)
    n_units = -(-units // bucket_units) * bucket_units
    audio_arr = np.zeros((len(idx), n_units * unit), np.int32)
    for row, i in enumerate(idx):
        audio_arr[row, :lengths[row]] = audios[i]
    row_frames = [cfg.output_frames(int(n)) for n in lengths]
    return row_frames, [(torch.from_numpy(audio_arr).to(tr.device), lengths)]


def assemble(tr, idx, audios):
    """The reference assembly of ``tr``'s architecture."""
    fastconformer = isinstance(tr.config, FastConformerConfig)
    return (assemble_calls if fastconformer else assemble_chunks)(tr, idx, audios)


def use_reference_assembly(tr):
    """``tr`` with its batches assembled by the reference; returns ``tr``."""
    tr._model = dataclasses.replace(
        tr._model, assemble=lambda idx, audios, batch: assemble(tr, idx, audios))
    return tr


def batches(tr, audios) -> list[np.ndarray]:
    """The rows of each batch, as ``OfflineTranscriber`` orders them."""
    order = np.argsort([len(a) for a in audios], kind="stable")
    return [order[s:s + tr.batch_size] for s in range(0, len(order), tr.batch_size)]
