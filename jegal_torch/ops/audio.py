"""Audio front end: wav -> log-mel filterbanks, with the JAX package's
ops/audio.py's reference contract (utils/audio_utils.py:11-66):

  * sr 16 kHz, n_fft 512, periodic Hann of 320 zero-padded to 512, hop 160;
  * torch.stft semantics: center=True with reflect padding of n_fft // 2;
  * the LAST STFT frame is dropped, so mel_T = num_samples // hop;
  * magnitude mel with librosa Slaney filters (fmin 0, fmax sr/2, Slaney
    area norm), log(mel + 1e-20), out (B, T, 80);
  * samples at raw int16 amplitude, not rescaled.

`wav2filterbanks_np` is the host (numpy) copy that the engine's prep runs
per sample, as the JAX engine does. `wav2filterbanks` (with
`frame_signal`, `stft_magnitude`, `stft_mag_phase`) computes the same in
torch on the wav's device: reflect pad, the padded Hann window,
`torch.fft.rfft`, the float32 Slaney matrix. `reconstruct_wav` inverts an
STFT on the host with scipy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from jegal_torch.config import (
    HOP_LENGTH,
    LOG_OFFSET,
    N_FFT,
    N_MELS,
    SAMPLE_RATE,
    WIN_LENGTH,
)


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f_safe = np.maximum(f, 1e-12)
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(f_safe / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = N_FFT,
                   n_mels: int = N_MELS, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular Slaney filters, area-normalized."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _padded_hann(win_length: int = WIN_LENGTH, n_fft: int = N_FFT
                 ) -> np.ndarray:
    """Periodic Hann of win_length, zero-padded symmetrically to n_fft (as
    torch.stft pads a short window)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[left:left + win_length] = w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device):
    """The padded Hann window and the mel matrix on `device`, copied once
    (a forward captured into a CUDA graph may not copy from the host)."""
    return (torch.from_numpy(_padded_hann()).to(device),
            torch.from_numpy(mel_filterbank()).to(device))


def frame_signal(wav, n_fft: int = N_FFT, hop: int = HOP_LENGTH):
    """Center-pad (reflect) and slice into overlapping frames: wav (B, S)
    -> (B, 1 + S // hop, n_fft)."""
    pad = n_fft // 2
    x = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)


def _spectrum(wav):
    """(B, S) float32 -> the windowed one-sided STFT (B, F, T + 1)."""
    window, _ = _device_constants(wav.device)
    frames = frame_signal(wav.to(torch.float32)) * window
    return torch.fft.rfft(frames, dim=-1).transpose(1, 2)


def stft_magnitude(wav):
    """|STFT| with torch.stft(center=True, reflect) semantics: (B, F, T +
    1); the last frame is still there (`wav2filterbanks` drops it)."""
    return _spectrum(wav).abs()


def wav2filterbanks(wav):
    """wav (B, S) float32 tensor (raw int16 scale) -> log-mel (B, S // 160,
    80) on its device; the last STFT frame is dropped."""
    _, mel_basis = _device_constants(wav.device)
    mel = torch.matmul(mel_basis, stft_magnitude(wav)[:, :, :-1])
    return torch.log(mel + LOG_OFFSET).transpose(1, 2)


def stft_mag_phase(wav):
    """|STFT| and phase, (B, F, T) each, the last frame dropped (the
    reference's wav2filterbanks also returns them, utils/audio_utils.py:
    50-51,66)."""
    spec = _spectrum(wav)[:, :, :-1]
    return spec.abs(), spec.angle()


def reconstruct_wav(mag, phase) -> np.ndarray:
    """Inverse STFT of magnitude and phase (B, F, T) on the host (scipy),
    the reference's librosa istft helpers (utils/audio_utils.py:69-97)."""
    from scipy.signal import istft

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    spec = host(mag) * np.exp(1j * host(phase))
    _, wav = istft(spec, fs=SAMPLE_RATE,
                   window=np.asarray(_padded_hann(), dtype=np.float64),
                   nperseg=N_FFT, noverlap=N_FFT - HOP_LENGTH, nfft=N_FFT,
                   input_onesided=True, boundary=True)
    # scipy's overlap-add normalization differs from the analysis
    # convention by the hop length
    return (wav / HOP_LENGTH).astype(np.float32)


def audio_token_mask(mel_t: int) -> np.ndarray:
    """ones(mel_T // 4): one entry per 25 Hz audio token (reference
    inference_embs.py:470)."""
    return np.ones((mel_t // 4,), dtype=np.float32)


def wav2filterbanks_np(wav, mel_basis: np.ndarray | None = None
                       ) -> np.ndarray:
    """wav (S,) or (B, S) float32 -> (B, S // 160, 80) float32 log-mel."""
    if mel_basis is None:
        mel_basis = mel_filterbank()
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 1:
        wav = wav[None]
    pad = N_FFT // 2
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    num_frames = 1 + wav.shape[-1] // HOP_LENGTH
    idx = np.arange(num_frames)[:, None] * HOP_LENGTH + np.arange(N_FFT)
    frames = x[:, idx] * _padded_hann()
    spec = np.fft.rfft(frames.astype(np.float32), axis=-1)
    mag = np.abs(spec).astype(np.float32).transpose(0, 2, 1)[:, :, :-1]
    feats = np.log(mel_basis @ mag + LOG_OFFSET)
    return feats.transpose(0, 2, 1).astype(np.float32)


def load_wav(path: str) -> np.ndarray:
    """A wav file as float32 at raw int16 amplitude scale, first channel
    only (reference utils/audio_utils.py:20-25: scipy read, no
    rescaling)."""
    from scipy.io import wavfile

    _, wav = wavfile.read(path)
    if wav.ndim > 1:
        wav = wav[:, 0]
    return np.asarray(wav, dtype=np.float32)
