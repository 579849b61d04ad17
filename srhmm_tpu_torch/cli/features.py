"""Feature-extraction CLI: WAV -> MFCC written as reference-compatible
``.perfil`` files (counterpart of ``srhmm_tpu/cli/features.py``; same
arguments, same files, same output lines).

Usage:
    python -m srhmm_tpu_torch.cli.features wav_list out_dir
        [--n-mfcc 13] [--n-mels 26] [--frame-length 400] [--frame-shift 160]
        [--fused] [--device cuda|cpu]

wav_list: one 16-bit PCM WAV path per line; each produces
out_dir/<stem>.perfil holding float64 MFCC frames.

--device cuda (the default) runs every file through the hand-written MFCC
kernel (csrc/mfcc.cu, float32); without a CUDA device it exits 2 instead
of falling back.  --device cpu runs the float64 frontend, or with --fused
the kernel's float32 twin.

A deliberate difference from the JAX CLI, whose default is the float64
frontend (--fused selects its float32 kernel there): here the default
device runs the float32 kernel whether or not --fused is given, since a
CUDA tensor always reaches the kernel.  The gap is that of float32
rounding: on tests/test_torch_features_cli.py's four WAVs (a tone in
noise, 300 samples, stereo noise, 8 kHz), --device cpu --fused writes
values within 7.3e-6 of the JAX CLI's float64 default (6.9e-6 relative to
max(|x|, 1); MFCCs up to 22 in magnitude), held by that file's tests.
Noise-free synthetic speech under a hann window or 128 mels can move
further, 2e-3 to 2e-2 between any two float32 summation orders.

Files are read in list order into chunks of consecutive files of one
sample rate holding at most CHUNK_SAMPLES samples (a longer file is a
chunk of its own); each chunk is one kernel launch, and its .perfil files
are written before the next chunk is read, so host and device memory stay
bounded whatever the length of the list.
"""

from __future__ import annotations

import argparse
import sys
import wave
from pathlib import Path

import numpy as np

from .device import add_device_argument, resolve_device

# samples a chunk may hold: 2**26 is ~70 min of 16 kHz audio, 256 MiB of
# float32 samples on the device
CHUNK_SAMPLES = 1 << 26


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """16-bit PCM WAV -> (float waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: only 16-bit PCM supported")
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype="<i2").astype(np.float64)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
        return data / 32768.0, w.getframerate()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("wav_list")
    ap.add_argument("out_dir")
    ap.add_argument("--n-mfcc", type=int, default=13)
    ap.add_argument("--n-mels", type=int, default=26)
    ap.add_argument("--frame-length", type=int, default=400)
    ap.add_argument("--frame-shift", type=int, default=160)
    ap.add_argument("--fused", action="store_true",
                    help="float32 MFCC kernel (its plain twin with --device cpu)")
    add_device_argument(ap)
    ns = ap.parse_args(argv)
    device = resolve_device(ns.device, "features")
    if device is None:
        return 2

    import torch

    from ..features import FrontendConfig, mfcc
    from ..io import read_list, write_perfil
    from ..ops.kernels.mfcc import mfcc_fused, pack_waves, split_frames

    out_dir = Path(ns.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    fused = device.type == "cuda" or ns.fused

    def flush(chunk: list, cfg) -> None:
        """Featurize one chunk (files of one sample rate, in list order),
        write its .perfil files and print their lines."""
        if fused:
            samples, offsets = pack_waves([x for _, x in chunk], device)
            feats = split_frames(mfcc_fused(samples, offsets, cfg).cpu().numpy(), offsets, cfg)
        else:
            feats = [mfcc(torch.as_tensor(x), cfg).numpy() for _, x in chunk]
        for (wav_path, _), f in zip(chunk, feats):
            out = out_dir / (Path(wav_path).stem + ".perfil")
            write_perfil(out, f.astype(np.float64))
            print(f"{wav_path} -> {out} ({f.shape[0]} frames x {f.shape[1]})")

    chunk, chunk_cfg, chunk_samples = [], None, 0
    for wav_path in read_list(ns.wav_list):
        x, sr = read_wav(wav_path)
        cfg = FrontendConfig(
            sample_rate=sr,
            frame_length=ns.frame_length,
            frame_shift=ns.frame_shift,
            n_mels=ns.n_mels,
            n_mfcc=ns.n_mfcc,
        )
        if chunk and (cfg != chunk_cfg or chunk_samples + len(x) > CHUNK_SAMPLES):
            flush(chunk, chunk_cfg)
            chunk, chunk_samples = [], 0
        chunk.append((wav_path, x))
        chunk_cfg, chunk_samples = cfg, chunk_samples + len(x)
    if chunk:
        flush(chunk, chunk_cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
