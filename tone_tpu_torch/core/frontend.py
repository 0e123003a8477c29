"""Log-mel filterbank frontend as a matmul-STFT (port of
``tone_tpu/core/frontend.py``).

The STFT is one float32 matmul of the (B, T, 160) frames against a
precomputed windowed, pre-emphasized DFT basis, then the power spectrum, a
float32 mel matmul and ``log(mel + guard)``.  The numpy builders of the
basis and the filterbank are copies of the reference's, computed in
float64 and stored as float32.  Features are time-major ``(B, T, n_mels)``.

``log_mel_centered`` is the FastConformer's frontend (NeMo's
``AudioToMelSpectrogramPreprocessor``): pre-emphasis over the signal, a
window centred in a longer FFT over centred frames (``torch.stft``'s
``center=True`` with zero padding), the same power-spectrum, mel and log
steps in float32, then each mel normalized over the row's own frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tone_tpu_torch.config import FastConformerFrontendConfig, FrontendConfig

__all__ = [
    "compute_centered_basis",
    "compute_forward_basis",
    "compute_mel_filterbanks",
    "FrontendConstants",
    "get_frontend_constants",
    "log_mel_centered",
    "log_mel_offline",
    "log_mel_streaming",
]


def _hann_window(win_length: int) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, matching torch.hann_window."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (win_length - 1)))


def compute_forward_basis(config: FrontendConfig) -> np.ndarray:
    """Windowed + pre-emphasized DFT matrix, shape (win_length, 2 * n_freqs),
    laid out for a right-matmul:
    ``spectrum[b, t, o] = sum_k frames[b, t, k] * basis[k, o]``.
    """
    n_fft = config.n_fft
    window = _hann_window(config.win_length)
    fourier = np.fft.fft(np.eye(n_fft, dtype=np.float64))
    fourier = fourier[: n_fft // 2 + 1]
    # (2 * n_freqs, n_fft): real rows then imaginary rows.
    basis = np.concatenate([fourier.real, fourier.imag], axis=0)
    # (n_fft, 2 * n_freqs), windowed along the time-in-window axis.
    basis = basis.T * window[:, None]

    coeff = config.preemphasis_coefficient
    if coeff != 0.0:
        # y[t] = x[t] - coeff * x[t + 1] applied inside the window, with the
        # first tap also attenuated: P = I - coeff * superdiag; P[0,0] -= coeff.
        pre = np.eye(config.win_length, dtype=np.float64)
        pre -= coeff * np.diag(np.ones(config.win_length - 1, dtype=np.float64), k=1)
        pre[0, 0] -= coeff
        basis = pre @ basis

    return np.ascontiguousarray(basis, dtype=np.float32)


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = f_sp * mels
    log_region = mels >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


def compute_mel_filterbanks(config: FrontendConfig) -> np.ndarray:
    """Slaney-scale, slaney-normalized mel filterbank, shape (n_freqs, n_mels)."""
    n_freqs = config.n_freqs
    all_freqs = np.linspace(0.0, config.sample_rate / 2.0, n_freqs)
    m_min = _hz_to_mel_slaney(np.array(0.0))
    m_max = _hz_to_mel_slaney(np.array(config.sample_rate / 2.0))
    m_pts = np.linspace(float(m_min), float(m_max), config.n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))

    # Slaney area normalization.
    enorm = 2.0 / (f_pts[2 : config.n_mels + 2] - f_pts[: config.n_mels])
    fb = fb * enorm[None, :]
    return np.ascontiguousarray(fb, dtype=np.float32)


def compute_centered_basis(config: FastConformerFrontendConfig) -> np.ndarray:
    """The DFT of ``n_fft`` points over a Hann window of ``win_length``
    centred in them (``torch.stft`` pads a shorter window on both sides),
    shape (win_length, 2 * n_freqs): the samples outside the window take no
    part, so a frame is the window's ``win_length`` samples alone."""
    n_fft, win = config.n_fft, config.win_length
    offset = (n_fft - win) // 2
    fourier = np.fft.fft(np.eye(n_fft, dtype=np.float64))[: n_fft // 2 + 1]
    basis = np.concatenate([fourier.real, fourier.imag], axis=0).T[offset:offset + win]
    return np.ascontiguousarray(basis * _hann_window(win)[:, None], dtype=np.float32)


class FrontendConstants:
    """The basis and filterbank as float32 tensors on one device."""

    def __init__(self, config: FrontendConfig | FastConformerFrontendConfig,
                 device: torch.device):
        self.config = config
        basis = (compute_centered_basis(config) if isinstance(config, FastConformerFrontendConfig)
                 else compute_forward_basis(config))
        self.forward_basis = torch.from_numpy(basis).to(device)
        self.filterbanks = torch.from_numpy(compute_mel_filterbanks(config)).to(device)


@functools.lru_cache(maxsize=8)
def get_frontend_constants(config: FrontendConfig | FastConformerFrontendConfig,
                           device: torch.device) -> FrontendConstants:
    return FrontendConstants(config, device)


def _frame(waveform: torch.Tensor, win_length: int, hop_length: int) -> torch.Tensor:
    """(B, T_samples) -> (B, n_frames, win_length) overlapping frames."""
    return waveform.unfold(-1, win_length, hop_length)


def _log_mel_from_frames(frames: torch.Tensor, constants: FrontendConstants) -> torch.Tensor:
    cfg = constants.config
    frames = frames.to(torch.float32)
    # (B, T, win) @ (win, 2 * n_freqs) -> (B, T, 2 * n_freqs)
    spectrum = frames @ constants.forward_basis
    b, t, _ = spectrum.shape
    spectrum = spectrum.reshape(b, t, 2, cfg.n_freqs)
    power = spectrum.square().sum(dim=2)  # (B, T, n_freqs)
    mel = power @ constants.filterbanks
    return torch.log(mel + cfg.log_zero_guard_value)


def log_mel_offline(
    waveform: torch.Tensor,
    waveform_lens: torch.Tensor | None,
    constants: FrontendConstants,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Offline features for a padded batch.

    Left-pads by ``state_size`` (80) zeros, so that the offline features
    line up with the streaming path's zero-initialised carry.

    Args:
        waveform: float32 waveform in [-1, 1], shape (B, T_samples).
        waveform_lens: optional lengths in samples, shape (B,).

    Returns:
        (features (B, T_frames, n_mels) float32, frame lengths (B,) or None).
    """
    cfg = constants.config
    waveform = torch.nn.functional.pad(waveform, (cfg.state_size, 0))
    frames = _frame(waveform, cfg.win_length, cfg.hop_length)
    feats = _log_mel_from_frames(frames, constants)
    lens = (None if waveform_lens is None
            else torch.div(waveform_lens, cfg.hop_length, rounding_mode="floor"))
    return feats, lens


def log_mel_streaming(
    waveform: torch.Tensor,
    state: torch.Tensor,
    constants: FrontendConstants,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming features for one chunk with an 80-sample carry state.

    Args:
        waveform: float32 chunk in [-1, 1], shape (B, chunk_samples).
        state: the previous chunk's last ``state_size`` samples, (B, state_size).

    Returns:
        (features (B, chunk_frames, n_mels) float32, next state).
    """
    cfg = constants.config
    waveform = torch.cat([state.to(waveform.dtype), waveform], dim=1)
    state_next = waveform[:, -cfg.state_size:]
    frames = _frame(waveform, cfg.win_length, cfg.hop_length)
    return _log_mel_from_frames(frames, constants), state_next


def log_mel_centered(
    waveform: torch.Tensor,
    lengths: torch.Tensor,
    constants: FrontendConstants,
) -> torch.Tensor:
    """The FastConformer's features of a padded batch, each row as if it
    were alone (``constants`` of a ``FastConformerFrontendConfig``).

    Pre-emphasis ``y[0] = x[0]``, ``y[n] = x[n] - c * x[n - 1]``, zero at
    and past each row's length; frame ``t`` is centred on sample
    ``t * hop`` (zeros before the signal); the power spectrum, slaney mels
    and ``log(mel + guard)`` in float32; then each mel of a row minus its
    mean over the row's ``length // hop + 1`` frames, over their standard
    deviation (``n - 1`` in its denominator) plus 1e-5, and 0 past them.

    Args:
        waveform: float32 waveform in [-1, 1], shape (B, T_samples).
        lengths: (B,) valid samples, on the waveform's device.

    Returns:
        (features (B, T_samples // hop + 1, n_mels) float32, each row's
        frames (B,)).
    """
    cfg = constants.config
    b, n = waveform.shape
    n_frames = cfg.frames(n)
    c = cfg.preemphasis_coefficient
    pre = torch.cat([waveform[:, :1], waveform[:, 1:] - c * waveform[:, :-1]], dim=1)
    pre = pre.masked_fill(torch.arange(n, device=pre.device)[None] >= lengths[:, None], 0.0)
    left = cfg.n_fft // 2 - (cfg.n_fft - cfg.win_length) // 2
    pre = torch.nn.functional.pad(pre, (left, cfg.win_length - left))
    frames = _frame(pre, cfg.win_length, cfg.hop_length)[:, :n_frames]
    feats = _log_mel_from_frames(frames, constants)                     # (B, T, n_mels)
    frame_lens = torch.div(lengths, cfg.hop_length, rounding_mode="floor") + 1
    valid = (torch.arange(n_frames, device=feats.device)[None] < frame_lens[:, None])[..., None]
    count = frame_lens[:, None].to(torch.float32)
    mean = torch.where(valid, feats, 0.0).sum(dim=1) / count
    centred = feats - mean[:, None]
    var = torch.where(valid, centred, 0.0).square().sum(dim=1) / (count - 1.0).clamp(min=1.0)
    normed = centred / (var.sqrt() + 1e-5)[:, None]
    return normed.masked_fill(~valid, 0.0), frame_lens
