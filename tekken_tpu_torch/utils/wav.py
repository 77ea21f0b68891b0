"""Minimal RIFF/WAV parser with reference-parity sample semantics.

The reference uses the ``hound`` crate (reference: src/audio.rs:268-288):
- Float-format samples are taken as-is (f32).
- Int-format samples are scaled ``v as f32 / i32::MAX`` where ``v`` is the
  raw integer at its native bit depth (so 16-bit audio lands near ±1.5e-5 —
  a quirk reproduced exactly; token counts only depend on length).
- Multi-channel audio is reduced to mono by per-frame channel average
  (reference: src/audio.rs:294-307).

This parser handles PCM 8/16/24/32-bit int and IEEE float32, any channel
count, and tolerates extra RIFF chunks before/after ``data``.
"""

from __future__ import annotations

import struct

import numpy as np

from ..errors import AudioError

_I32_MAX = float(2**31 - 1)


def parse_wav(data: bytes) -> tuple[np.ndarray, int]:
    """Parse WAV bytes -> (mono float32 waveform, sampling_rate)."""
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioError("Failed to parse audio bytes: not a RIFF/WAVE file")

    fmt = None
    raw = None
    pos = 12
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos:pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8: pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise AudioError("Failed to parse audio bytes: short fmt chunk")
            (audio_format, channels, sample_rate, _byte_rate, _block_align,
             bits_per_sample) = struct.unpack_from("<HHIIHH", body, 0)
            if audio_format == 0xFFFE and len(body) >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format, channels, sample_rate, bits_per_sample)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise AudioError("Failed to parse audio bytes: missing fmt/data chunk")

    audio_format, channels, sample_rate, bits = fmt
    if channels == 0:
        raise AudioError("Failed to parse audio bytes: zero channels")

    if audio_format == 3:  # IEEE float
        if bits != 32:
            raise AudioError(f"Unsupported float bit depth: {bits}")
        samples = np.frombuffer(raw[: len(raw) // 4 * 4], dtype="<f4").astype(np.float32)
    elif audio_format == 1:  # PCM int
        if bits == 16:
            ints = np.frombuffer(raw[: len(raw) // 2 * 2], dtype="<i2").astype(np.float32)
        elif bits == 32:
            ints = np.frombuffer(raw[: len(raw) // 4 * 4], dtype="<i4").astype(np.float32)
        elif bits == 8:
            # WAV stores 8-bit as unsigned; signed value = u - 128
            ints = (np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128).astype(np.float32)
        elif bits == 24:
            b = np.frombuffer(raw[: len(raw) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
            ints = vals.astype(np.float32)
        else:
            raise AudioError(f"Unsupported PCM bit depth: {bits}")
        samples = ints / np.float32(_I32_MAX)
    else:
        raise AudioError(f"Unsupported WAV format code: {audio_format}")

    if channels > 1:
        usable = len(samples) // channels * channels
        samples = samples[:usable].reshape(-1, channels).mean(axis=1).astype(np.float32)

    return samples, int(sample_rate)


def write_wav(path, samples: np.ndarray, sample_rate: int, bits: int = 16) -> None:
    """Write a mono int-PCM WAV file (test helper)."""
    samples = np.asarray(samples)
    if bits == 16:
        ints = np.clip(samples, -1.0, 1.0)
        data = (ints * 32767.0).astype("<i2").tobytes()
        block_align, fmt_bits = 2, 16
    elif bits == 32 and samples.dtype.kind == "f":
        data = samples.astype("<f4").tobytes()
        block_align, fmt_bits = 4, 32
    else:
        raise AudioError(f"write_wav supports 16-bit PCM or float32, got {bits}")
    audio_format = 3 if (bits == 32) else 1
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, audio_format, 1, sample_rate,
                                sample_rate * block_align, block_align, fmt_bits)
    dat = b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(hdr + fmt + dat)
