"""Audio subsystem: configs, waveform container, encoder, mel filter bank.

Parity map against the reference audio layer (reference: src/audio.rs):
- ``AudioSpectrogramConfig`` {num_mel_bins, hop_length, window_size}, all > 0
  (src/audio.rs:18-72)
- ``AudioConfig`` {sampling_rate, frame_rate, audio_encoding_config,
  chunk_length_s?} with ``chunk_frames`` and ``audio_length_per_tok``
  (src/audio.rs:86-200)
- ``Audio`` waveform container with from_file/from_base64/from_bytes/duration/
  resample/pad (src/audio.rs:213-464).  The reference's ``resample`` is a stub
  that errors on differing rates (src/audio.rs:415-424); this one resamples
  (polyphase windowed-sinc on the host, ops/resample.py).
- ``AudioEncoding`` {tokens, audio} (src/audio.rs:476-479)
- ``AudioEncoder`` frame math and [BEGIN_AUDIO] + N x [AUDIO] emission
  (src/audio.rs:498-592) — including the reference's exact
  ``ceil(len/hop - 1)`` branch when len % hop != 0 (src/audio.rs:565-577).
- ``hertz_to_mel`` / ``mel_to_hertz`` Slaney scale (src/audio.rs:611-646)
- ``mel_filter_bank`` shape (num_frequency_bins, num_mel_bins), Slaney energy
  norm (src/audio.rs:684-748)

Everything here runs on the host in numpy but ``AudioEncoder.mel_spectrogram``,
which runs the batched torch op of ops/mel.py on the encoder's device.
"""

from __future__ import annotations

import base64
import binascii
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .errors import AudioError, Base64Error, InvalidConfigError
from .utils.wav import parse_wav


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


@dataclass
class Audio:
    """Mono waveform + metadata (reference: src/audio.rs:213-217)."""

    audio_array: np.ndarray
    sampling_rate: int
    format: str = "wav"

    @classmethod
    def new(cls, audio_array, sampling_rate: int, format: str = "wav") -> "Audio":
        return cls(np.asarray(audio_array, dtype=np.float32), int(sampling_rate), format)

    @classmethod
    def from_file(cls, path) -> "Audio":
        """Load a WAV file (reference: src/audio.rs:267-310)."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise AudioError(f"Failed to open audio file: {e}") from e
        samples, rate = parse_wav(data)
        return cls(samples, rate, "wav")

    @classmethod
    def from_base64(cls, data: str) -> "Audio":
        """Decode base64 then parse (reference: src/audio.rs:325-328)."""
        try:
            audio_bytes = base64.b64decode(data, validate=True)
        except (binascii.Error, ValueError) as e:
            raise Base64Error(str(e)) from e
        return cls.from_bytes(audio_bytes)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Audio":
        """Parse WAV bytes (reference: src/audio.rs:344-386)."""
        samples, rate = parse_wav(data)
        return cls(samples, rate, "wav")

    def duration(self) -> float:
        """Seconds (reference: src/audio.rs:395-400)."""
        return len(self.audio_array) / float(self.sampling_rate)

    def resample(self, target_rate: int) -> None:
        """Resample in place to ``target_rate`` on the host (polyphase
        windowed-sinc, ops/resample.py; the reference stubs this out and
        errors on a rate mismatch, src/audio.rs:415-424)."""
        if self.sampling_rate == target_rate:
            return
        from .ops.resample import resample_poly_host
        self.audio_array = resample_poly_host(
            self.audio_array, self.sampling_rate, target_rate)
        self.sampling_rate = int(target_rate)

    def pad(self, config: AudioConfig) -> None:
        """Zero-pad per the reference's rules (reference: src/audio.rs:439-463):
        to the next chunk multiple when chunk_length_s is set, else up to
        window_size when shorter, else no-op."""
        current_length = len(self.audio_array)
        if config.chunk_length_s is not None:
            chunk_frames = config.chunk_frames()
            target_length = -(-current_length // chunk_frames) * chunk_frames
        elif current_length < config.audio_encoding_config.window_size:
            target_length = config.audio_encoding_config.window_size
        else:
            return
        if target_length > current_length:
            padded = np.zeros(target_length, dtype=np.float32)
            padded[:current_length] = self.audio_array
            self.audio_array = padded


@dataclass
class AudioEncoding:
    """Tokenization result pair (reference: src/audio.rs:476-479)."""

    tokens: list
    audio: Audio


@dataclass
class AudioEncoder:
    """Waveform -> placeholder-token encoder (reference: src/audio.rs:492-592).
    ``device`` is where ``mel_spectrogram`` runs."""

    config: AudioConfig
    audio_token_id: int
    begin_audio_token_id: int
    device: str = "cuda"

    def encode(self, audio: Audio) -> AudioEncoding:
        """Resample -> pad -> frame math -> tokens
        (reference: src/audio.rs:555-591)."""
        audio.resample(self.config.sampling_rate)
        audio.pad(self.config)

        signal_length = len(audio.audio_array)
        hop = self.config.audio_encoding_config.hop_length
        if signal_length % hop != 0:
            # the reference's quirky ceil(len/hop - 1) branch
            # (reference: src/audio.rs:565-574)
            signal_length = math.ceil(signal_length / hop - 1.0)
        else:
            signal_length = signal_length // hop

        num_audio_tokens = math.ceil(
            signal_length / float(self.config.audio_length_per_tok()))

        tokens = [self.begin_audio_token_id] + [self.audio_token_id] * num_audio_tokens
        return AudioEncoding(tokens=tokens, audio=audio)

    def encode_batch(self, audios: list) -> list:
        """Batched encode: the framing math is per clip, on the host; the
        heavy spectrogram is the batched op ``mel_spectrogram``."""
        return [self.encode(a) for a in audios]

    def mel_spectrogram(self, waveforms, log: bool = True):
        """Batched (log-)mel spectrogram of already-resampled waveforms
        (batch, n) -> (batch, n_frames, num_mel_bins), float32 on
        ``device`` (ops/mel.py)."""
        from .ops.mel import mel_spectrogram as _mel

        return _mel(waveforms, self.config.audio_encoding_config,
                    self.config.sampling_rate, log=log, device=self.device)


def hertz_to_mel(freq: float) -> float:
    """Slaney-style Hz -> mel (reference: src/audio.rs:611-621)."""
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / math.log(6.4)
    if freq >= min_log_hertz:
        return min_log_mel + math.log(freq / min_log_hertz) * logstep
    return 3.0 * freq / 200.0


def mel_to_hertz(mel: float) -> float:
    """Slaney-style mel -> Hz (reference: src/audio.rs:636-646)."""
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = math.log(6.4) / 27.0
    if mel >= min_log_mel:
        return min_log_hertz * math.exp((mel - min_log_mel) * logstep)
    return 200.0 * mel / 3.0


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_bins: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """Slaney mel filter bank, shape (num_frequency_bins, num_mel_bins)
    (reference: src/audio.rs:684-748). float64, host-side; the batched mel
    op (ops/mel.py) consumes it as a matmul operand."""
    if num_frequency_bins < 2:
        raise InvalidConfigError(
            f"num_frequency_bins must be >= 2, got {num_frequency_bins}")
    if min_frequency > max_frequency:
        raise InvalidConfigError(
            f"min_frequency ({min_frequency}) must be <= max_frequency "
            f"({max_frequency})")

    mel_min = hertz_to_mel(min_frequency)
    mel_max = hertz_to_mel(max_frequency)
    mel_freqs = [mel_min + (mel_max - mel_min) * i / (num_mel_bins + 1)
                 for i in range(num_mel_bins + 2)]
    filter_freqs = np.array([mel_to_hertz(m) for m in mel_freqs])

    fft_freqs = (np.arange(num_frequency_bins, dtype=np.float64)
                 * sampling_rate / 2.0 / (num_frequency_bins - 1))

    left = filter_freqs[:-2][None, :]     # (1, n_mel)
    center = filter_freqs[1:-1][None, :]
    right = filter_freqs[2:][None, :]
    f = fft_freqs[:, None]                # (n_freq, 1)

    up = (f - left) / (center - left)
    down = (right - f) / (right - center)
    fb = np.where((f >= left) & (f <= center), up,
                  np.where((f > center) & (f <= right), down, 0.0))
    fb = np.maximum(fb, 0.0)

    # Slaney energy normalization (reference: src/audio.rs:739-745)
    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    return fb * enorm[None, :]
