"""Audio configuration types (the part of the audio layer that model-file
parsing needs).

Parity with the reference (reference: src/audio.rs):
- ``AudioSpectrogramConfig`` {num_mel_bins, hop_length, window_size}, all > 0
  (src/audio.rs:18-72)
- ``AudioConfig`` {sampling_rate, frame_rate, audio_encoding_config,
  chunk_length_s?} with ``chunk_frames`` and ``audio_length_per_tok``
  (src/audio.rs:86-200)

The waveform container, the encoder, the mel features and resampling are
ported with the audio slice (ROADMAP.md, "Modules to port").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .errors import InvalidConfigError


@dataclass(frozen=True)
class AudioSpectrogramConfig:
    """Spectrogram parameters (reference: src/audio.rs:18-72)."""

    num_mel_bins: int
    hop_length: int
    window_size: int

    def __post_init__(self):
        if self.num_mel_bins <= 0:
            raise InvalidConfigError("num_mel_bins must be > 0")
        if self.hop_length <= 0:
            raise InvalidConfigError("hop_length must be > 0")
        if self.window_size <= 0:
            raise InvalidConfigError("window_size must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "AudioSpectrogramConfig":
        return cls(num_mel_bins=int(d["num_mel_bins"]),
                   hop_length=int(d["hop_length"]),
                   window_size=int(d["window_size"]))

    def to_dict(self) -> dict:
        return {"num_mel_bins": self.num_mel_bins, "hop_length": self.hop_length,
                "window_size": self.window_size}


@dataclass(frozen=True)
class AudioConfig:
    """Audio processing configuration (reference: src/audio.rs:86-200)."""

    sampling_rate: int
    frame_rate: float
    audio_encoding_config: AudioSpectrogramConfig
    chunk_length_s: Optional[float] = None

    def __post_init__(self):
        if self.sampling_rate <= 0:
            raise InvalidConfigError("sampling_rate must be > 0")
        if self.frame_rate <= 0.0:
            raise InvalidConfigError("frame_rate must be > 0")
        if self.chunk_length_s is not None and self.chunk_length_s <= 0.0:
            raise InvalidConfigError("chunk_length_s must be > 0")

    @classmethod
    def from_dict(cls, d: dict) -> "AudioConfig":
        return cls(
            sampling_rate=int(d["sampling_rate"]),
            frame_rate=float(d["frame_rate"]),
            audio_encoding_config=AudioSpectrogramConfig.from_dict(
                d["audio_encoding_config"]),
            chunk_length_s=(float(d["chunk_length_s"])
                            if d.get("chunk_length_s") is not None else None),
        )

    def to_dict(self) -> dict:
        return {
            "sampling_rate": self.sampling_rate,
            "frame_rate": self.frame_rate,
            "audio_encoding_config": self.audio_encoding_config.to_dict(),
            "chunk_length_s": self.chunk_length_s,
        }

    def chunk_frames(self) -> int:
        """Frames per chunk (reference: src/audio.rs:157-172); errors when
        chunk_length_s is unset; f64 multiply then truncation."""
        if self.chunk_length_s is None:
            raise InvalidConfigError("chunk_length_s not set")
        return int(self.chunk_length_s * float(self.sampling_rate))

    def audio_length_per_tok(self) -> int:
        """Samples-per-token downsample factor, truncating
        (reference: src/audio.rs:188-199)."""
        downsample_factor = float(self.sampling_rate) / self.frame_rate
        downsample_factor /= float(self.audio_encoding_config.hop_length)
        return int(downsample_factor)
