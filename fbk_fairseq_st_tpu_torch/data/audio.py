"""Self-contained audio frontend: WAV reading + Kaldi-style log-mel
filterbanks in NumPy.

Replaces the reference's runtime ``torchaudio.compliance.kaldi.fbank``
dependency (reference examples/speech_recognition/data/asr_dataset.py:68-86)
with a dependency-free implementation following Kaldi conventions:
25ms/10ms povey-windowed frames with snip-edges (``1 + (n - win) // hop``
frames, matching the reference's duration->frame-count formula in
tasks/speech_recognition.py:63), preemphasis 0.97, DC removal, 1127*ln(1 +
f/700) mel scale. Feature extraction is host-side data-pipeline work; the
card's work starts at the collated fbank batch.

The port's copy of ``fbk_fairseq_st_tpu/data/audio.py`` (numpy and the
``wave`` module only).
"""

from __future__ import annotations

import wave

import numpy as np

MEL_BREAK_FREQ = 700.0
MEL_HIGH_FREQ_Q = 1127.0


def read_wav(path: str):
    """Read a (mono or first-channel) PCM WAV file -> (float32 samples in
    [-32768, 32767] Kaldi scaling, sample_rate)."""
    with wave.open(path, "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported WAV sample width: {sampwidth}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels)[:, 0]
    return data, rate


def _hz_to_mel(hz):
    return MEL_HIGH_FREQ_Q * np.log(1.0 + np.asarray(hz) / MEL_BREAK_FREQ)


def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def mel_banks(num_bins: int, fft_size: int, sample_rate: float,
              low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Triangular mel filterbank matrix (num_bins, fft_size // 2 + 1)."""
    nyquist = sample_rate / 2.0
    if high_freq <= 0:
        high_freq = nyquist + high_freq
    mel_low, mel_high = _hz_to_mel(low_freq), _hz_to_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_freqs = np.arange(fft_size // 2 + 1) * sample_rate / fft_size
    mel_freqs = _hz_to_mel(fft_freqs)  # (F,)
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_freqs[None, :] - left) / mel_delta
    down = (right - mel_freqs[None, :]) / mel_delta
    return np.clip(np.minimum(up, down), 0.0, None)


def logmel_fbank(
    waveform: np.ndarray,
    sample_rate: float,
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    preemphasis: float = 0.97,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    remove_dc_offset: bool = True,
    eps: float = 1.1920929e-07,
) -> np.ndarray:
    """(T_samples,) -> (T_frames, num_mel_bins) log-mel features."""
    win = int(sample_rate * frame_length / 1000.0)
    hop = int(sample_rate * frame_shift / 1000.0)
    waveform = np.asarray(waveform, dtype=np.float32)
    if len(waveform) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    num_frames = 1 + (len(waveform) - win) // hop  # snip-edges
    idx = np.arange(win)[None, :] + hop * np.arange(num_frames)[:, None]
    frames = waveform[idx].astype(np.float64)
    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        frames = np.concatenate(
            [
                (frames[:, :1] - preemphasis * frames[:, :1]),
                frames[:, 1:] - preemphasis * frames[:, :-1],
            ],
            axis=1,
        )
    frames = frames * _povey_window(win)[None, :]
    fft_size = 1 << (win - 1).bit_length()  # round up to power of 2
    spectrum = np.abs(np.fft.rfft(frames, n=fft_size)) ** 2  # (T, F)
    banks = mel_banks(num_mel_bins, fft_size, sample_rate, low_freq, high_freq)
    mel = spectrum @ banks.T  # (T, num_mel_bins)
    return np.log(np.maximum(mel, eps)).astype(np.float32)


def apply_mv_norm(features: np.ndarray) -> np.ndarray:
    """Per-utterance mean/variance normalization (reference
    data/data_utils.py:34-41)."""
    mean = features.mean(axis=0, keepdims=True)
    std = features.std(axis=0, keepdims=True)
    return ((features - mean) / np.maximum(std, 1e-8)).astype(np.float32)
