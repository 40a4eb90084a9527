"""Text to speech: the OuteTTS voice LM, then the WavTokenizer decoder.

Counterpart of the JAX package's ``tools/tts.py`` (the reference's
tools/tts/tts.cpp): the prompt's formatting, the voice LM's greedy decode on
the port's ``Context``, the audio codes among its ids (from the code offset
151,672), ``models/wavtokenizer.py``'s frames, then ``embd_to_audio``
(each frame's magnitude ∥ phase spectrum through the reference's inverse
DFT, out[k] = Re Σ X_m e^{i2πkm/n} / N, a Hann window and an overlap-add
with envelope normalization) in numpy on the host, as in JAX, and a 24 kHz
mono 16-bit WAV.
"""

from __future__ import annotations

import re
import struct

import numpy as np
import torch

N_FFT = 1280
N_HOP = 320
SAMPLE_RATE = 24000
CODE_OFFSET = 151672  # OuteTTS's audio-code vocab base


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    off = 0 if periodic else -1
    i = np.arange(n)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (n + off)))).astype(np.float32)


def embd_to_audio(embd: np.ndarray, n_fft: int = N_FFT, n_hop: int = N_HOP) -> np.ndarray:
    """(n_codes, n_embd) magnitude ∥ phase frames → mono float32 audio."""
    embd = np.asarray(embd, np.float32)
    n_codes, n_embd = embd.shape
    half = n_embd // 2
    assert half == n_fft // 2 + 1, (half, n_fft)

    mag = np.minimum(np.exp(embd[:, :half]), 1e2)        # clamped, as tts.cpp does
    phi = embd[:, half:]
    spec = mag * (np.cos(phi) + 1j * np.sin(phi))         # (n_codes, half)

    # the reference's inverse DFT: out[k] = Re(Σ_m X_m e^{+i2πkm/n}) / N, no
    # hermitian doubling; n·ifft(X zero-padded).real / N
    pad = np.zeros((n_codes, n_fft - half), np.complex64)
    frames = (n_fft * np.fft.ifft(np.concatenate([spec, pad], axis=1),
                                  axis=1).real / half).astype(np.float32)

    hann = hann_window(n_fft)
    frames *= hann
    n_pad = (n_fft - n_hop) // 2
    n_out = (n_codes - 1) * n_hop + n_fft

    audio = np.zeros(n_out, np.float32)
    env = np.zeros(n_out, np.float32)
    h2 = hann * hann
    for i in range(n_codes):   # overlap-add (offset −pad, trimmed below)
        start = i * n_hop - n_pad
        lo = max(0, -start)
        hi = min(n_fft, n_out - start)
        audio[start + lo:start + hi] += frames[i, lo:hi]
        env[start + lo:start + hi] += h2[lo:hi]
    audio = audio[: n_out - 2 * n_pad]
    env = env[: n_out - 2 * n_pad]
    return audio / np.maximum(env, 1e-8)


def save_wav(path: str, audio: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    """16-bit PCM mono WAV."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    data = (pcm * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)


def process_text(text: str) -> str:
    """OuteTTS's text preprocessing: lowercase, non-alphanumerics stripped,
    whitespace collapsed, words joined with <|text_sep|>."""
    t = text.lower()
    t = re.sub(r"[-_/,\.\\]", " ", t)
    t = re.sub(r"[^a-z0-9 ]", "", t)
    t = re.sub(r"\s+", " ", t).strip()
    return "<|text_sep|>".join(t.split(" "))


def tts_prompt(text: str) -> str:
    return ("<|im_start|>\n<|text_start|>" + process_text(text)
            + "<|text_end|>\n<|audio_start|>\n")


def extract_codes(tokens: list[int], code_offset: int = CODE_OFFSET,
                  n_codebook: int = 4096) -> list[int]:
    """The voice LM's ids → WavTokenizer codebook indices."""
    return [t - code_offset for t in tokens if code_offset <= t < code_offset + n_codebook]


def tts_generate(ttc_model, cts_model, text: str, n_predict: int = 1024) -> np.ndarray:
    """The whole pipeline on the voice LM's device: voice LM → audio codes →
    WavTokenizer → audio (empty when no code came)."""
    from ..models.wavtokenizer import wavtokenizer_decode
    from ..runtime.context import Context, model_device

    tok = ttc_model.tokenizer
    ids = tok.encode(tts_prompt(text), add_special=True, parse_special=True)
    dev = model_device(ttc_model)
    ctx = Context(ttc_model, n_ctx=len(ids) + n_predict + 8, device=dev)
    out = ctx.greedy_generate(ids, n_predict)
    codes = extract_codes(out[len(ids):])
    if not codes:
        return np.zeros(0, np.float32)
    with torch.no_grad():
        embd = wavtokenizer_decode(cts_model.params, cts_model.hparams,
                                   torch.tensor([codes], device=model_device(cts_model)))
    return embd_to_audio(embd[0].to(torch.float32).cpu().numpy())
