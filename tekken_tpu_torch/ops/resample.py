"""Polyphase windowed-sinc resampling.

The reference's ``Audio::resample`` is a stub that errors whenever rates
differ (reference: src/audio.rs:415-424).  This is rational-ratio
resampling (upsample by L via zero stuffing, windowed-sinc low-pass,
decimate by M), with a host numpy path and a batched torch path.

The batched path never builds the zero-stuffed signal (at 44.1 kHz -> 16
kHz, L = 160, and one 10 s clip would stuff to 70.6 M samples).  Output k
sits at stuffed position t_k = half + k*M; only the taps at stuffed
positions of real samples count, so with q_k = t_k // L and p_k = t_k % L

    y[k] = sum_j x[q_k - j] * h[p_k + j*L]

over the ceil(n_taps / L) taps of phase p_k (177 at 44.1 -> 16 kHz, of
28,225), read from an (L, ceil(n_taps / L)) phase table.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (batch x outputs x taps) elements gathered at once by the batched path
_CHUNK_ELEMS = 1 << 25


def _gcd_ratio(orig_rate: int, target_rate: int) -> tuple[int, int]:
    g = math.gcd(int(orig_rate), int(target_rate))
    return int(target_rate) // g, int(orig_rate) // g  # (up L, down M)


def design_kernel(up: int, down: int, half_width: int = 32,
                  beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at cutoff min(1/up, 1/down) (normalized),
    scaled by ``up`` to preserve amplitude after zero-stuffing."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate  # in units of the upsampled Nyquist
    n_taps = 2 * half_width * max_rate + 1
    t = np.arange(n_taps, dtype=np.float64) - (n_taps - 1) / 2.0
    kern = cutoff * np.sinc(cutoff * t)
    kern *= np.kaiser(n_taps, beta)
    kern *= up
    return kern.astype(np.float64)


def resample_poly_host(x: np.ndarray, orig_rate: int, target_rate: int) -> np.ndarray:
    """Resample a 1-D waveform on host (numpy). Matches scipy's
    ``resample_poly`` output-length convention: ceil(len * L / M)."""
    x = np.asarray(x, dtype=np.float64)
    if orig_rate == target_rate or x.size == 0:
        return x.astype(np.float32)
    up, down = _gcd_ratio(orig_rate, target_rate)
    kern = design_kernel(up, down)
    n_taps = len(kern)
    half = (n_taps - 1) // 2

    # zero-stuff
    n_up = x.size * up
    upsampled = np.zeros(n_up, dtype=np.float64)
    upsampled[::up] = x

    # FFT convolution (host path); 'same'-aligned so output sample k
    # corresponds to upsampled position k*down
    n_out = -(-x.size * up // down)  # ceil
    n_fft = 1
    while n_fft < n_up + n_taps:
        n_fft <<= 1
    conv = np.fft.irfft(np.fft.rfft(upsampled, n_fft) * np.fft.rfft(kern, n_fft),
                        n_fft)
    # centered alignment: y[j] = sum_i x_up[i] * kern[half + j - i]
    centered = conv[half:half + n_up]
    out = centered[::down][:n_out]
    if out.size < n_out:
        out = np.pad(out, (0, n_out - out.size))
    return out.astype(np.float32)


def resample_poly_batched(x, orig_rate: int, target_rate: int, device=None):
    """Batched resample: x of shape (batch, n) -> (batch, ceil(n*L/M))
    float32, on ``device`` (x's own for a tensor, else "cuda"), in the
    polyphase form of the module docstring (float32 taps, as the JAX
    package's conv takes them)."""
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cuda"
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if orig_rate == target_rate:
        return x
    up, down = _gcd_ratio(orig_rate, target_rate)
    kern = design_kernel(up, down).astype(np.float32)
    n_taps = len(kern)
    half = (n_taps - 1) // 2
    L = -(-n_taps // up)
    phases = np.zeros(up * L, np.float32)
    phases[:n_taps] = kern
    # phases[p, j] = h[p + j*up]
    phases = torch.from_numpy(phases.reshape(L, up).T.copy()).to(device)

    batch, n_in = x.shape
    n_out = -(-n_in * up // down)
    t = half + torch.arange(n_out, dtype=torch.int64, device=device) * down
    q, p = t // up, t % up
    # x with L-1 zeros before it and zeros after the last sample any
    # output reads: x[q - j] is xp[q - j + L - 1]
    q_hi = (half + (n_out - 1) * down) // up if n_out else 0
    xp = torch.nn.functional.pad(x, (L - 1, max(0, q_hi + 1 - n_in)))
    j = torch.arange(L, dtype=torch.int64, device=device)
    out = torch.empty(batch, n_out, dtype=torch.float32, device=device)
    step = max(1, _CHUNK_ELEMS // max(1, batch * L))
    for lo in range(0, n_out, step):
        idx = q[lo:lo + step, None] - j[None, :] + (L - 1)   # (k, L)
        taps = phases[p[lo:lo + step]]                        # (k, L)
        out[:, lo:lo + step] = (xp[:, idx] * taps).sum(-1)
    return out
