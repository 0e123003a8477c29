"""The bulk transcriber's staged batch assembly (``OfflineTranscriber``'s
``_assemble_chunks`` and ``_assemble_calls`` over ``_rows_on_devices``)
against the host-padded assembly it replaced
(``offline_assembly_reference.py``), on the CPU with tiny models:

* each batch's rows, shape and row units equal the reference's, for int16
  and int32 calls, a one-row batch, a call on a bucket's edge, the shortest
  call, a batch that grows a staging buffer, and two data devices;
* ``transcribe`` and ``logprobs`` give the reference's results bit for bit;
* the staging ring is allocated or grown only when a batch needs more room,
  and waits for the device's last copy from a buffer before reusing it.
"""

import functools
import time

import numpy as np
import pytest
import torch
from offline_assembly_reference import assemble, batches, use_reference_assembly

from tone_tpu_torch import profiling
from tone_tpu_torch.config import (
    EncoderConfig,
    FastConformerConfig,
    FastConformerEncoderConfig,
    ToneConfig,
    stand_in_vocabulary,
)
from tone_tpu_torch.core.fastconformer import init_fastconformer_params
from tone_tpu_torch.core.model import init_model_params
from tone_tpu_torch.offline import OfflineTranscriber, _HostRing
from tone_tpu_torch.parallel.mesh import make_mesh

TINY = dict(n_layers=2, d_model=32, n_heads=2, rope_dim=8, ff_expansion_factor=2,
            conv_kernel_size=7, subsampling_conv_channels=(4, 8), mhsa_stateless_layers=1,
            reduction_position=1, upsample_position=1,
            should_recompute_att_scores=(True, True))

# T-one's tiny rows: 2,400-sample chunks, 2,400 zeros each side, buckets of
# 8 chunks (14,400 samples fill one exactly).  FastConformer's: 1,280-sample
# frames in buckets of 15 (19,200 samples fill one exactly).
LENGTHS = {
    "one_row": (9000,),
    "bucket_edge": (14400, 14401, 19200, 19201),
    "shortest": (1, 2, 5000),
    "grows": (1000, 3000, 20000, 26000, 70000, 41000, 7000),
}


@functools.lru_cache(maxsize=None)
def _model(arch):
    gen = torch.Generator().manual_seed(4)
    if arch == "tone":
        cfg = ToneConfig(encoder=EncoderConfig(**TINY))
        return cfg, init_model_params(gen, cfg)
    cfg = FastConformerConfig(
        encoder=FastConformerEncoderConfig(n_layers=2, d_model=32, n_heads=2,
                                           subsampling_conv_channels=8),
        vocabulary=stand_in_vocabulary(32))
    return cfg, init_fastconformer_params(gen, cfg)


def _transcriber(arch, batch_size=2, **kw):
    cfg, variables = _model(arch)
    if arch == "fastconformer":
        kw["use_offline_forward"] = True
    if "mesh" not in kw:
        kw["device"] = "cpu"
    return OfflineTranscriber(variables, cfg, batch_size=batch_size, **kw)


def _calls(lengths, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, n).astype(dtype) for n in lengths]


def _rows(assembled):
    """(row units, each device's rows) of an assembly of either kind."""
    units, per_device = assembled
    return units, [x[0] if isinstance(x, tuple) else x for x in per_device]


@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
@pytest.mark.parametrize("arch, devices", [("tone", 1), ("tone", 2), ("fastconformer", 1)])
def test_assembly_equals_the_host_padded_layout(arch, devices, dtype, lengths):
    mesh = {"mesh": make_mesh(devices=["cpu"] * devices)} if devices > 1 else {}
    tr = _transcriber(arch, batch_size=2 * devices, **mesh)
    audios = _calls(LENGTHS[lengths], dtype)
    for _ in range(2):   # the second pass reuses the staging buffers
        for batch, idx in enumerate(batches(tr, audios)):
            units, rows = _rows(tr._model.assemble(idx, audios, batch))
            want_units, want_rows = _rows(assemble(tr, idx, audios))
            assert units == want_units
            assert len(rows) == len(want_rows) == devices
            for got, want in zip(rows, want_rows):
                assert got.dtype == (torch.int16 if dtype == np.int16 else torch.int32)
                assert got.shape == want.shape
                assert torch.equal(got.to(torch.int32), want)
            if arch == "fastconformer":
                lengths_sent = tr._model.assemble(idx, audios, batch)[1][0][1]
                np.testing.assert_array_equal(lengths_sent,
                                              assemble(tr, idx, audios)[1][0][1])


def test_other_integer_and_mixed_calls_are_staged_as_int32():
    tr = _transcriber("tone", batch_size=3)
    audios = [np.arange(-5, 4000, dtype=np.int64), _calls((3000,), np.int16)[0],
              np.full(2000, -7, np.int32)]
    (rows,) = _rows(tr._model.assemble(np.arange(3), audios, 0))[1]
    (want,) = _rows(assemble(tr, np.arange(3), audios))[1]
    assert rows.dtype == torch.int32 and torch.equal(rows, want)


@pytest.mark.parametrize("arch, forward", [("tone", "offline"), ("tone", "scan"),
                                           ("fastconformer", "offline")])
@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_results_bit_identical_to_the_host_padded_assembly(arch, forward, dtype):
    kw = {"use_offline_forward": True} if forward == "offline" else {}
    new, old = (_transcriber(arch, **kw), use_reference_assembly(_transcriber(arch, **kw)))
    audios = _calls(LENGTHS["grows"][:5], dtype, seed=1)
    for _ in range(2):
        for a, b in zip(new.logprobs(audios), old.logprobs(audios)):
            np.testing.assert_array_equal(a, b)
        texts = [[(p.text, p.start_time, p.end_time) for p in u] for u in new.transcribe(audios)]
        assert texts == [[(p.text, p.start_time, p.end_time) for p in u]
                         for u in old.transcribe(audios)]


def _counts(name, run):
    with profiling.record():
        t0 = time.monotonic_ns()
        run()
    return sum(e.n for e in profiling.events(t0) if isinstance(e, profiling.Count)
               and e.name == name)


def test_staging_is_allocated_or_grown_only_when_a_batch_needs_more_room():
    tr = _transcriber("tone")
    audios = _calls(LENGTHS["grows"], np.int16)
    # Batches of 2 in length order hold 4,000, 27,000, 67,000 and 70,000
    # samples: slot 0 takes batches 0 and 2 (grown), slot 1 batches 1 and 3
    # (grown): 4 allocations.
    assert _counts("offline.staging_allocs", lambda: tr.transcribe(audios)) == 4
    assert _counts("offline.staging_allocs", lambda: tr.transcribe(audios)) == 0
    assert _counts("offline.staging_allocs", lambda: tr.logprobs(audios[:3])) == 0


class _Event:
    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append("synchronized")


def test_ring_waits_for_the_last_copy_before_a_buffer_is_written_again():
    ring, log = _HostRing(pinned=False), []
    first = ring.take(0, 6, torch.int16)
    first.copy_(torch.arange(6, dtype=torch.int16))
    ring.guard(0, [_Event(log)])
    ring.take(1, 4, torch.int16)
    assert log == []                                   # the other slot
    again = ring.take(0, 3, torch.int32)               # same 12 bytes, no growth
    assert log == ["synchronized"]
    assert again.data_ptr() == first.data_ptr() and again.dtype == torch.int32
    ring.take(0, 3, torch.int32)
    assert log == ["synchronized"]                     # each event waited on once
    assert ring.take(0, 0, torch.int16).numel() == 0
