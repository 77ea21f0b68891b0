"""Batched STFT + mel spectrogram as torch ops.

The reference ships only the Slaney mel filter bank as public API
(reference: src/audio.rs:684-748, exercised by tests/test_audio.rs:35-39);
its spectrogram is never computed.  Here the full pipeline runs on a
device:

  frames  = window(hann) * strided frames of the padded waveform
  spec    = |rfft(frames)|^2                      (torch.fft, batched)
  mel     = spec @ mel_filter_bank                (float32 matmul, no TF32)
  logmel  = log10(max(mel, eps)), whisper-style dynamic-range clamp

Shapes follow the reference's convention: the filter bank is
(num_frequency_bins, num_mel_bins) so the matmul right-multiplies
(reference: src/audio.rs:718-737 "to match Python").
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..audio import AudioSpectrogramConfig, mel_filter_bank


def hann_window(window_size: int) -> np.ndarray:
    """Periodic Hann window (the STFT convention used by torch/whisper)."""
    n = np.arange(window_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / window_size))).astype(
        np.float32)


def _signal(waveform, device):
    """(batch, n) float32 tensor on ``device`` (the waveform's own for a
    tensor, else "cuda")."""
    if device is None:
        device = (waveform.device if isinstance(waveform, torch.Tensor)
                  else "cuda")
    x = torch.as_tensor(waveform, dtype=torch.float32, device=device)
    return x[None, :] if x.ndim == 1 else x


def frame_signal(waveform, window_size: int, hop_length: int,
                 center: bool = True, device=None):
    """Split (batch, n) waveforms into (batch, n_frames, window_size) frames.

    With ``center=True`` the signal is reflect-padded by window_size//2 on
    both sides (the standard STFT convention), giving
    n_frames = n // hop_length + 1.
    """
    x = _signal(waveform, device)
    n = x.shape[-1]
    if center:
        pad = window_size // 2
        x = torch.nn.functional.pad(x[:, None, :], (pad, pad),
                                    mode="reflect")[:, 0]
        n_frames = n // hop_length + 1
    else:
        n_frames = max(0, (n - window_size) // hop_length + 1)
    if n_frames == 0:
        return x.new_zeros(x.shape[0], 0, window_size)
    need = (n_frames - 1) * hop_length + window_size
    if need > x.shape[-1]:
        # an odd window's last centered frame runs one sample past the
        # padding; the reference's gather clamps it to the last sample
        x = torch.cat([x, x[:, -1:].expand(-1, need - x.shape[-1])], dim=1)
    return x[:, :need].unfold(-1, window_size, hop_length)


def stft_power(waveform, window_size: int, hop_length: int,
               center: bool = True, device=None):
    """Power spectrogram |STFT|^2: (batch, n_frames, n_freq_bins) with
    n_freq_bins = window_size//2 + 1."""
    frames = frame_signal(waveform, window_size, hop_length, center, device)
    win = torch.from_numpy(hann_window(window_size)).to(frames.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)


@functools.lru_cache(maxsize=8)
def _fb_cached(num_freq: int, num_mel: int, min_f: float, max_f: float,
               sr: int):
    return mel_filter_bank(num_freq, num_mel, min_f, max_f, sr).astype(
        np.float32)


@contextlib.contextmanager
def _full_fp32_matmul():
    """Full float32 matmuls on CUDA (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mel_spectrogram(
    waveform,
    config: AudioSpectrogramConfig,
    sampling_rate: int,
    min_frequency: float = 0.0,
    max_frequency: float | None = None,
    center: bool = True,
    log: bool = True,
    device=None,
):
    """Batched (log-)mel spectrogram: (batch, n_frames, num_mel_bins).

    The mel projection is one float32 matmul against the Slaney filter
    bank (audio.mel_filter_bank, reference: src/audio.rs:684-748), with
    TF32 off.  ``log=True`` applies the whisper-style log10 + 8-decade
    dynamic range clamp and (x+4)/4 normalization.
    """
    if max_frequency is None:
        max_frequency = sampling_rate / 2.0
    spec = stft_power(waveform, config.window_size, config.hop_length, center,
                      device)
    # drop the trailing frame like whisper (frames fully determined by hops)
    spec = spec[:, :-1, :] if center else spec
    fb = torch.from_numpy(_fb_cached(config.window_size // 2 + 1,
                                     config.num_mel_bins,
                                     float(min_frequency), float(max_frequency),
                                     int(sampling_rate))).to(spec.device)
    with _full_fp32_matmul():
        mel = torch.matmul(spec, fb)
    if not log:
        return mel
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    peak = logmel.amax(dim=(-2, -1), keepdim=True)
    logmel = torch.maximum(logmel, peak - 8.0)
    return (logmel + 4.0) / 4.0
