"""Native runtime bindings: the C++ word-synchronous beam-search decoder.

Counterpart of ``b2txt_tpu/runtime/__init__.py``, with the same ctypes
surface (``train_ngram_native``, ``NativeLexiconBeamSearch``, ``_parse``) over
the same sources: ``decoder.cc`` and ``ngram_train.cc`` are verbatim copies,
compiled with the same ``g++`` flags, so both packages' libraries compute the
same floats. The build differs: the library lands in the port's gitignored
``b2txt_tpu_torch/_build/`` under a name keyed by a hash of both sources and
the flags, written under a per-process name and moved into place, so
concurrent processes never load half a file. It is built at first use (the
first ``NativeLexiconBeamSearch`` or ``train_ngram_native``). There is no
fallback: without ``g++``, or if the build fails, the call raises.

The searcher runs on the host CPU (it is the reference's host-side decoder);
``DecoderService(searcher_backend="native")`` builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..decode.lmbeam import DecodeResult
from ..ops._build import BUILD_DIR
from ..utils.config import DecodeConfig
from ..utils.phonemes import LOGIT_TO_PHONEME
from ..utils.profiling import span

_DIR = Path(__file__).resolve().parent
_SRCS = [_DIR / "decoder.cc", _DIR / "ngram_train.cc"]
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in _SRCS) + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"native_decoder-{digest}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native decoder is built from "
                           "runtime/decoder.cc and runtime/ngram_train.cc with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, *map(str, _SRCS), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on the native decoder:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load half a file
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.b2t_create.restype = ctypes.c_void_p
    lib.b2t_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.b2t_destroy.argtypes = [ctypes.c_void_p]
    lib.b2t_reset.argtypes = [ctypes.c_void_p]
    lib.b2t_set_opt.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.b2t_set_lattice_opt.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ]
    lib.b2t_decode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.b2t_finalize.restype = ctypes.c_int
    lib.b2t_finalize.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.b2t_partial.restype = ctypes.c_int
    lib.b2t_partial.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.b2t_train_ngram.restype = ctypes.c_int
    lib.b2t_train_ngram.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double,
        ctypes.c_char_p,
    ]
    lib.b2t_set_rescore_lm.restype = ctypes.c_int
    lib.b2t_set_rescore_lm.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.b2t_lm_entries.restype = ctypes.c_longlong
    lib.b2t_lm_entries.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def train_ngram_native(
    corpus_path: str,
    out_arpa: str,
    order: int = 3,
    discount: float = 0.75,
    vocab_path: Optional[str] = None,
) -> None:
    """Train an interpolated-KN n-gram from a one-sentence-per-line corpus file
    and write ARPA — the native counterpart of lm.train_ngram, same estimator
    (parity-tested)."""
    lib = _load()
    rc = lib.b2t_train_ngram(
        corpus_path.encode(), (vocab_path or "").encode(), order, discount,
        out_arpa.encode(),
    )
    if rc != 0:
        raise RuntimeError(f"native n-gram training failed (code {rc})")


def write_lexicon(lexicon, path: str) -> None:
    """Write a ``lm.Lexicon`` (every pronunciation of every word) as the
    text the native loader reads: ``WORD  PH1 PH2 ...`` per line."""
    with open(path, "w") as f:
        for w, wid in lexicon.word_ids.items():
            for pron in lexicon.prons[wid]:
                f.write(f"{w.upper()}  {' '.join(LOGIT_TO_PHONEME[p] for p in pron)}\n")


def _parse(buf: bytes) -> List[DecodeResult]:
    out = []
    for line in buf.decode().splitlines():
        parts = line.split("\t")
        if len(parts) == 3:
            out.append(DecodeResult(parts[0], float(parts[1]), float(parts[2])))
    return out


class NativeLexiconBeamSearch:
    """ctypes wrapper with the same reset/decode/finalize protocol as the
    Python searchers (usable as DecoderService.searcher)."""

    def __init__(
        self,
        arpa_path: str,
        lexicon_path: str,
        config: Optional[DecodeConfig] = None,
        max_homophones: int = 4,
        rescore_arpa: Optional[str] = None,
        state_key: str = "history",
    ):
        lib = _load()
        self._lib = lib
        self._h = lib.b2t_create(arpa_path.encode(), lexicon_path.encode())
        if not self._h:
            raise RuntimeError(
                f"native decoder failed to load {arpa_path} / {lexicon_path}"
            )
        self.max_homophones = max_homophones
        # "ngram" = Kaldi token-passing state space (LM-context truncated);
        # required for deep lattice n-best (decode/lattice.py design).
        # Viterbi-only: merging different histories under log-sum would pool
        # distinct sentences' path mass.
        if state_key not in ("history", "ngram"):
            raise ValueError(f"state_key must be history|ngram: {state_key}")
        self.state_key = state_key
        self.n_frames = 0
        self.config = config or DecodeConfig()
        self.set_opt(self.config)
        if rescore_arpa:
            self.set_rescore_lm(rescore_arpa)
        self._buf = ctypes.create_string_buffer(1 << 22)

    def set_rescore_lm(self, arpa_path: Optional[str]) -> None:
        """Load (or clear) the unpruned LM used to rescore the n-best at
        finalize (reference: G_no_prune + BrainSpeechDecoder::Rescore)."""
        rc = self._lib.b2t_set_rescore_lm(
            self._h, (arpa_path or "").encode()
        )
        if rc != 0:
            raise RuntimeError(f"failed to load rescore LM {arpa_path}")

    @property
    def lm_entries(self) -> int:
        """Total packed n-gram records across orders (16 bytes each)."""
        return int(self._lib.b2t_lm_entries(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.b2t_destroy(self._h)
            self._h = None

    def set_opt(self, config: DecodeConfig) -> None:
        if config.sum_mode and (self.state_key == "ngram"
                                or config.lattice_nbest):
            raise ValueError(
                "ngram state keying / lattice_nbest require sum_mode=False"
            )
        self.config = config
        self._lib.b2t_set_opt(
            self._h, config.acoustic_scale, config.blank_penalty,
            config.ctc_blank_skip_threshold, config.length_penalty,
            config.nbest, config.beam_width, config.beam, self.max_homophones,
            config.first_beam_size, int(config.sum_mode),
        )
        self._lib.b2t_set_lattice_opt(
            self._h, int(self.state_key == "ngram"),
            int(getattr(config, "lattice_nbest", False)),
            config.lattice_beam,
        )

    def reset(self) -> None:
        self._lib.b2t_reset(self._h)
        self.n_frames = 0
        self._final = None

    def decode(self, log_probs: np.ndarray) -> None:
        lp = np.ascontiguousarray(log_probs, np.float32)
        T, C = lp.shape
        with span("native.decode"):
            self._lib.b2t_decode(
                self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, C
            )
        self.n_frames += T
        self._final = None

    def decoded_something(self) -> bool:
        return self.n_frames > 0

    def finish_decoding(self) -> List[DecodeResult]:
        with span("native.finish"):
            n = self._lib.b2t_finalize(self._h, self._buf, len(self._buf))
            self._final = _parse(self._buf.raw[:n])
        return self._final

    def result(self) -> List[DecodeResult]:
        if self._final is not None:
            return self._final
        with span("native.partial"):
            n = self._lib.b2t_partial(self._h, self._buf, len(self._buf))
            res = _parse(self._buf.raw[:n])
        return [r for r in res if r.sentence] or ([] if not res else res[:0])
