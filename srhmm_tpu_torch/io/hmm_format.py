"""Reference-compatible ``.hmm`` model codec (counterpart of
``srhmm_tpu/io/hmm_format.py``; the files are byte-identical).

Binary layout (little-endian), per ``writing_model`` / ``reading_model``
(reference hmm_continuous_full_fs.c:2286-2399, 590-710):

    size_t  word_length          <- the platform's native size_t; the
    char    word[word_length]       committed fixtures use 4 bytes
    int32   states_number
    int32   param_number
    int32   mixture_number[param_number]
    int32   coef_number[param_number]
    float64 transition_probab[states][states]        (row-major)
    for p in range(param_number):
      for s in range(states_number):
        float64 mix_coef[mixture_number[p]]
        for m in range(mixture_number[p]):
          float64 mean[coef_number[p]]
          float64 det                  (determinant of the ORIGINAL covariance)
          float64 inv_cov[coef][coef]  (full variant)
          float64 inv_cov[coef]        (diag variant)

The covariance block stores the INVERSE covariance.  Whether it is a matrix
or a vector is not recorded in the file; ``read_hmm`` auto-detects both the
size_t width and the covariance layout from the total file size.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..models.gmm_hmm import DIAG, FULL, GmmHmm, GmmStream


def _expected_size(
    word_len: int, S: int, P: int, mix: list[int], coef: list[int],
    size_t_width: int, cov_type: str,
) -> int:
    n = size_t_width + word_len + 8 + 4 * P * 2 + 8 * S * S
    for p in range(P):
        cov = coef[p] * coef[p] if cov_type == FULL else coef[p]
        n += S * (8 * mix[p] + mix[p] * (8 * coef[p] + 8 + 8 * cov))
    return n


def _parse_header(data: bytes, size_t_width: int):
    fmt = "<I" if size_t_width == 4 else "<Q"
    (word_len,) = struct.unpack_from(fmt, data, 0)
    off = size_t_width
    if word_len > 10_000 or off + word_len + 8 > len(data):
        raise ValueError("implausible word length")
    word = data[off : off + word_len].decode("latin-1")
    off += word_len
    S, P = struct.unpack_from("<ii", data, off)
    off += 8
    if not (0 < S <= 10_000 and 0 < P <= 1_000):
        raise ValueError("implausible header")
    mix = list(struct.unpack_from(f"<{P}i", data, off))
    off += 4 * P
    coef = list(struct.unpack_from(f"<{P}i", data, off))
    off += 4 * P
    return word, word_len, S, P, mix, coef, off


def read_hmm(
    path: str | Path,
    cov_type: str | None = None,
    size_t_width: int | None = None,
) -> GmmHmm:
    """Read a reference ``.hmm`` file into a float64 CPU GmmHmm.

    With cov_type/size_t_width None, both are auto-detected by matching the
    total file size against the four possible layouts.
    """
    data = Path(path).read_bytes()
    widths = [size_t_width] if size_t_width else [4, 8]
    cov_types = [cov_type] if cov_type else [FULL, DIAG]
    last_err: Exception | None = None
    for w in widths:
        try:
            word, word_len, S, P, mix, coef, off = _parse_header(data, w)
        except (ValueError, struct.error) as e:
            last_err = e
            continue
        for ct in cov_types:
            if _expected_size(word_len, S, P, mix, coef, w, ct) == len(data):
                return _read_body(data, off, word, S, P, mix, coef, ct)
        last_err = ValueError(
            f"{path}: size {len(data)} matches no layout for header "
            f"(S={S}, P={P}, mix={mix}, coef={coef}, size_t={w})"
        )
    raise ValueError(f"{path}: cannot decode .hmm: {last_err}")


def _read_body(data, off, word, S, P, mix, coef, cov_type) -> GmmHmm:
    def take(count):
        nonlocal off
        out = np.frombuffer(data, dtype="<f8", count=count, offset=off)
        off += 8 * count
        return out

    trans = take(S * S).reshape(S, S)
    streams = []
    for p in range(P):
        M, D = mix[p], coef[p]
        cov_n = D * D if cov_type == FULL else D
        weights = np.empty((S, M))
        means = np.empty((S, M, D))
        det = np.empty((S, M))
        inv_cov = np.empty((S, M, D, D) if cov_type == FULL else (S, M, D))
        for s in range(S):
            weights[s] = take(M)
            for m in range(M):
                means[s, m] = take(D)
                det[s, m] = take(1)[0]
                icv = take(cov_n)
                inv_cov[s, m] = icv.reshape(D, D) if cov_type == FULL else icv
        streams.append(
            GmmStream(
                weights=weights,
                means=means,
                inv_cov=inv_cov,
                det=det,
                cov_type=cov_type,
                # log|det| on the host in float64: real determinants (up to
                # ~6.7e40) overflow float32
                log_det=np.log(np.abs(det)),
            )
        )
    return GmmHmm(trans=trans.copy(), streams=streams, word=word)


def write_hmm(path: str | Path, model: GmmHmm, size_t_width: int = 4) -> None:
    """Write a GmmHmm to the reference binary layout.

    size_t_width=4 matches the committed fixtures; pass 8 for files
    interchangeable with a 64-bit build of the reference C code.
    """

    def f8(t) -> np.ndarray:
        return np.asarray(t.detach().cpu().numpy(), dtype="<f8")

    word = str(model.word)
    S = model.num_states
    P = model.num_streams
    parts = [
        struct.pack("<I" if size_t_width == 4 else "<Q", len(word)),
        word.encode("latin-1"),
        struct.pack("<ii", S, P),
        struct.pack(f"<{P}i", *model.mixture_numbers),
        struct.pack(f"<{P}i", *model.coef_numbers),
        np.ascontiguousarray(f8(model.trans)).tobytes(),
    ]
    for stream in model.streams:
        w = f8(stream.weights)
        mu = f8(stream.means)
        dt = f8(stream.det)
        ic = f8(stream.inv_cov)
        M = stream.num_mixtures
        for s in range(S):
            parts.append(np.ascontiguousarray(w[s]).tobytes())
            for m in range(M):
                parts.append(np.ascontiguousarray(mu[s, m]).tobytes())
                parts.append(struct.pack("<d", dt[s, m]))
                parts.append(np.ascontiguousarray(ic[s, m]).tobytes())
    Path(path).write_bytes(b"".join(parts))


def read_vocabulary(
    model_list: str | Path, relative_to: str | Path | None = None, **kw
) -> list[GmmHmm]:
    """Read every model named in a model-list file (R2:201-245).

    List entries resolve against the current working directory (the
    reference CLI contract), or against ``relative_to`` when given.
    """
    from .lists import read_list

    base = Path(relative_to) if relative_to is not None else None
    paths = [Path(p) if base is None else base / p for p in read_list(model_list)]
    return [read_hmm(p, **kw) for p in paths]
