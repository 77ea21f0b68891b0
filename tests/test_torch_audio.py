"""PyTorch port: audio.  The host layer (WAV I/O, ``Audio``, padding, host
resampling, the mel filter bank, ``encode_audio``) equals the JAX
package's bit for bit; the torch ops (framing, STFT power, mel
spectrogram, batched resampling) equal its XLA ops exactly (framing) or
within the tolerances stated at each test, on the CPU."""

import base64
import struct

import numpy as np
import pytest
import torch

import tekken_tpu_torch as tt
from tekken_tpu_torch.audio import (Audio, hertz_to_mel, mel_filter_bank,
                                    mel_to_hertz)
from tekken_tpu_torch.ops import mel as tmel
from tekken_tpu_torch.ops.resample import (resample_poly_batched,
                                           resample_poly_host)
from tekken_tpu_torch.utils.wav import parse_wav, write_wav


def _port(tok):
    md = tt.ModelData.from_json(tok.to_model_data().to_json())
    return tt.Tekkenizer.from_model_data(md, device="cpu")


def _wav_bytes(ints, fmt, bits, channels, sr=8000, extra_chunk=False):
    data = ints.tobytes()
    fmt_chunk = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, sr,
                                      sr * channels * bits // 8,
                                      channels * bits // 8, bits)
    body = fmt_chunk
    if extra_chunk:
        body += b"LIST" + struct.pack("<I", 3) + b"abc\0"   # odd: padded
    body += b"data" + struct.pack("<I", len(data)) + data
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _wav_cases():
    g = np.random.default_rng(0)
    i16 = g.integers(-32768, 32767, 600).astype("<i2")
    i32 = g.integers(-2**31, 2**31 - 1, 300).astype("<i4")
    u8 = g.integers(0, 255, 300).astype(np.uint8)
    i24 = g.integers(0, 255, 900).astype(np.uint8)
    f32 = g.standard_normal(300).astype("<f4")
    return [
        _wav_bytes(i16, 1, 16, 1), _wav_bytes(i16, 1, 16, 2),
        _wav_bytes(i16, 1, 16, 3, extra_chunk=True),
        _wav_bytes(i32, 1, 32, 1), _wav_bytes(u8, 1, 8, 2),
        _wav_bytes(i24, 1, 24, 1), _wav_bytes(f32, 3, 32, 2),
    ]


def test_wav_matches_jax(tmp_path):
    from tekken_tpu.errors import AudioError as JAudioError
    from tekken_tpu.utils.wav import parse_wav as jparse
    from tekken_tpu.utils.wav import write_wav as jwrite

    for data in _wav_cases():
        got, want = parse_wav(data), jparse(data)
        assert got[1] == want[1]
        assert got[0].dtype == want[0].dtype == np.float32
        assert np.array_equal(got[0], want[0])
    x = np.sin(np.arange(1000) / 7.0) * 1.2
    for bits, samples in ((16, x), (32, x.astype(np.float32))):
        jwrite(tmp_path / "j.wav", samples, 16000, bits=bits)
        write_wav(tmp_path / "p.wav", samples, 16000, bits=bits)
        assert (tmp_path / "j.wav").read_bytes() == \
            (tmp_path / "p.wav").read_bytes()
    for bad in (b"not a wav", _wav_cases()[0][:12],
                _wav_bytes(np.zeros(4, "<i2"), 7, 16, 1)):
        with pytest.raises(tt.AudioError):
            parse_wav(bad)
        with pytest.raises(JAudioError):
            jparse(bad)


def test_audio_container_matches_jax(tmp_path):
    from tekken_tpu.audio import Audio as JAudio
    from tekken_tpu.audio import AudioConfig as JConfig
    from tekken_tpu.audio import AudioSpectrogramConfig as JSpec

    sr = 16000
    t = np.arange(int(sr * 1.5)) / sr
    write_wav(tmp_path / "tone.wav", 0.5 * np.sin(2 * np.pi * 440.0 * t), sr)
    raw = (tmp_path / "tone.wav").read_bytes()
    b64 = base64.b64encode(raw).decode()
    pairs = [(Audio.from_file(tmp_path / "tone.wav"),
              JAudio.from_file(tmp_path / "tone.wav")),
             (Audio.from_bytes(raw), JAudio.from_bytes(raw)),
             (Audio.from_base64(b64), JAudio.from_base64(b64))]
    for a, j in pairs:
        assert np.array_equal(a.audio_array, j.audio_array)
        assert (a.sampling_rate, a.format, a.duration()) == \
            (j.sampling_rate, j.format, j.duration())
    with pytest.raises(tt.Base64Error):
        Audio.from_base64("not base64!")
    with pytest.raises(tt.AudioError):
        Audio.from_file(tmp_path / "missing.wav")

    spec = tt.AudioSpectrogramConfig(80, 160, 400)
    jspec = JSpec(80, 160, 400)
    for n, chunk in ((20000, 1.0), (100, None), (5000, None), (32000, 1.0)):
        a = Audio.new(np.ones(n, np.float32), sr)
        j = JAudio.new(np.ones(n, np.float32), sr)
        a.pad(tt.AudioConfig(sr, 12.5, spec, chunk))
        j.pad(JConfig(sr, 12.5, jspec, chunk))
        assert np.array_equal(a.audio_array, j.audio_array)
    for f in (0.0, 100.0, 999.0, 1000.0, 4000.0, 8000.0):
        from tekken_tpu.audio import hertz_to_mel as jh2m
        from tekken_tpu.audio import mel_to_hertz as jm2h
        assert hertz_to_mel(f) == jh2m(f)
        assert mel_to_hertz(hertz_to_mel(f)) == jm2h(jh2m(f))


def test_host_resample_and_filter_bank_match_jax():
    from tekken_tpu.audio import mel_filter_bank as jfb
    from tekken_tpu.ops.resample import design_kernel as jdesign
    from tekken_tpu.ops.resample import resample_poly_host as jres

    from tekken_tpu_torch.ops.resample import design_kernel

    g = np.random.default_rng(1)
    x = g.standard_normal(4410).astype(np.float32) * 0.3
    for orig, target in ((44100, 16000), (8000, 16000), (24000, 16000),
                         (16000, 16000)):
        got = resample_poly_host(x, orig, target)
        assert got.dtype == np.float32
        assert np.array_equal(got, jres(x, orig, target))
    assert np.array_equal(design_kernel(160, 441), jdesign(160, 441))
    for args in ((201, 80, 0.0, 8000.0, 16000), (257, 128, 20.0, 7600.0,
                                                 16000)):
        assert np.array_equal(mel_filter_bank(*args), jfb(*args))
    with pytest.raises(tt.InvalidConfigError):
        mel_filter_bank(1, 80, 0.0, 8000.0, 16000)
    with pytest.raises(tt.InvalidConfigError):
        mel_filter_bank(201, 80, 9000.0, 8000.0, 16000)


def test_encode_audio_matches_jax(audio_tokenizer, merged_tokenizer):
    """Tokens and the encoded waveform equal, on a hop multiple, on the
    reference's ceil(len/hop - 1) branch, and on a clip resampled from
    44.1 kHz; without audio support both raise 'not configured'."""
    from tekken_tpu.audio import Audio as JAudio

    port = _port(audio_tokenizer)
    assert port.has_audio_support()
    g = np.random.default_rng(2)
    clips = [(np.zeros(16000, np.float32), 16000),
             (np.zeros(16001, np.float32), 16000),
             (g.standard_normal(100).astype(np.float32), 16000),
             (g.standard_normal(4410).astype(np.float32) * 0.1, 44100)]
    got = port.encode_audio_batch([Audio.new(x, sr) for x, sr in clips])
    want = audio_tokenizer.encode_audio_batch([JAudio.new(x, sr)
                                               for x, sr in clips])
    for (x, sr), a, j in zip(clips, got, want):
        assert a.tokens == j.tokens
        assert np.array_equal(a.audio.audio_array, j.audio.audio_array)
        assert a.audio.sampling_rate == j.audio.sampling_rate == 16000
        single = port.encode_audio(Audio.new(x, sr))
        assert single.tokens == j.tokens
    assert len(got[0].tokens) == 1 + 13 and len(got[1].tokens) == 1 + 13
    begin = port.get_control_token("[BEGIN_AUDIO]")
    audio = port.get_control_token("[AUDIO]")
    assert all(e.tokens[0] == begin and set(e.tokens[1:]) == {audio}
               for e in got)
    plain = _port(merged_tokenizer)
    with pytest.raises(tt.AudioError, match="not configured"):
        plain.encode_audio(Audio.new(np.zeros(100, np.float32), 16000))
    with pytest.raises(tt.AudioError, match="not configured"):
        plain.encode_audio_batch([])


@pytest.fixture(scope="module")
def signals():
    sr = 16000
    t = np.arange(sr) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    g = np.random.default_rng(3)
    noise = (g.standard_normal(sr + 77) * 0.2).astype(np.float32)
    return tone, noise, sr


@pytest.mark.parametrize("window,hop,center", [(400, 160, True),
                                               (400, 160, False),
                                               (401, 160, True),
                                               (64, 16, True)])
def test_frame_signal_exact(signals, window, hop, center):
    from tekken_tpu.ops.mel import frame_signal as jframe

    tone, noise, _ = signals
    for x in (tone, np.stack([noise[:16000], tone])):
        got = tmel.frame_signal(x, window, hop, center, device="cpu")
        want = np.asarray(jframe(x, window, hop, center))
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want)


# rtol 1e-4 on the power spectrum (plus 1e-6 of its peak, for the bins at
# the float32 rounding floor); atol 1e-4 on the log-mel, 1e-4 relative on
# the linear mel.  Max errors seen on the CPU: printed by -s.
POWER_RTOL, LOGMEL_ATOL, MEL_RTOL = 1e-4, 1e-4, 1e-4


def test_stft_and_mel_within_tolerance(signals):
    from tekken_tpu.audio import AudioSpectrogramConfig as JSpec
    from tekken_tpu.ops.mel import mel_spectrogram as jmel
    from tekken_tpu.ops.mel import stft_power as jstft

    tone, noise, sr = signals
    batch = np.stack([tone, noise[:sr] * 0.1, np.zeros(sr, np.float32)])
    for center in (True, False):
        got = tmel.stft_power(batch, 400, 160, center, device="cpu").numpy()
        want = np.asarray(jstft(batch, 400, 160, center))
        assert got.shape == want.shape and got.dtype == np.float32
        atol = 1e-6 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=POWER_RTOL, atol=atol)
        print("stft max rel err",
              float((np.abs(got - want) / (np.abs(want) + atol)).max()))
    cfg, jcfg = tt.AudioSpectrogramConfig(80, 160, 400), JSpec(80, 160, 400)
    for log in (True, False):
        got = tmel.mel_spectrogram(batch, cfg, sr, log=log,
                                   device="cpu").numpy()
        want = np.asarray(jmel(batch, jcfg, sr, log=log))
        assert got.shape == want.shape == (3, sr // 160, 80)
        if log:
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGMEL_ATOL)
            print("log-mel max abs err", float(np.abs(got - want).max()))
        else:
            atol = 1e-6 * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=MEL_RTOL, atol=atol)


def test_encoder_mel_on_tokenizer_device(audio_tokenizer, signals):
    tone, _, sr = signals
    port = _port(audio_tokenizer)
    out = port._audio_encoder.mel_spectrogram(np.stack([tone, tone]))
    assert out.device.type == "cpu" and out.shape == (2, sr // 160, 80)
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("orig,target", [(32000, 16000), (44100, 16000),
                                         (8000, 16000), (24000, 16000)])
def test_resample_batched_matches_jax(orig, target):
    """The polyphase form against the JAX package's dilated conv, atol
    2e-5 (float32 sums of up to 177 taps in another order), and against
    the host path, atol 2e-4 as the JAX package's own test holds it."""
    from tekken_tpu.ops.resample import resample_poly_batched as jres

    rng = np.random.RandomState(0)
    x = rng.randn(3, orig).astype(np.float32) * 0.3
    got = resample_poly_batched(x, orig, target, device="cpu")
    want = np.asarray(jres(x, orig, target))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    host = np.stack([resample_poly_host(r, orig, target) for r in x])
    np.testing.assert_allclose(got.numpy(), host, rtol=0, atol=2e-4)


def test_resample_batched_identity_and_chunks(monkeypatch):
    import tekken_tpu_torch.ops.resample as tres

    x = np.ones((2, 100), np.float32)
    assert torch.equal(resample_poly_batched(x, 16000, 16000, device="cpu"),
                       torch.from_numpy(x))
    g = np.random.default_rng(4)
    y = g.standard_normal((2, 3000)).astype(np.float32)
    whole = resample_poly_batched(y, 44100, 16000, device="cpu")
    monkeypatch.setattr(tres, "_CHUNK_ELEMS", 2 * 177 * 7)  # 7 outputs a step
    assert torch.equal(resample_poly_batched(y, 44100, 16000, device="cpu"),
                       whole)
