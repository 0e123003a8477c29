"""Log-mel filterbank frontend as a matmul-STFT (port of
``tone_tpu/core/frontend.py``).

The STFT is one float32 matmul of the (B, T, 160) frames against a
precomputed windowed, pre-emphasized DFT basis, then the power spectrum, a
float32 mel matmul and ``log(mel + guard)``.  The numpy builders of the
basis and the filterbank are copies of the reference's, computed in
float64 and stored as float32.  Features are time-major ``(B, T, n_mels)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tone_tpu_torch.config import FrontendConfig

__all__ = [
    "compute_forward_basis",
    "compute_mel_filterbanks",
    "FrontendConstants",
    "get_frontend_constants",
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


class FrontendConstants:
    """The basis and filterbank as float32 tensors on one device."""

    def __init__(self, config: FrontendConfig, device: torch.device):
        self.config = config
        self.forward_basis = torch.from_numpy(compute_forward_basis(config)).to(device)
        self.filterbanks = torch.from_numpy(compute_mel_filterbanks(config)).to(device)


@functools.lru_cache(maxsize=8)
def get_frontend_constants(config: FrontendConfig, device: torch.device) -> FrontendConstants:
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
