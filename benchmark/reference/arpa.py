"""Frozen copy of b2txt_tpu_torch/lm/arpa.py, kept for the
benchmark's plain reference: it does not follow later changes to the program.

ARPA n-gram file reading and writing.

Replaces the SRILM/Kaldi ARPA path (``lmbin/arpa2fst.cc``, ``lm/arpa-file-parser``)
— in the TPU design the ARPA model is used directly by the fused beam search
instead of being compiled into G.fst. Files store log10 probabilities (ARPA
convention); in memory we keep natural-log, matching the lattice-weight domain
the reference's ac/lm scores live in.
"""

from __future__ import annotations

import gzip
import math
from typing import Dict, List, Optional, Tuple

LOG10 = math.log(10.0)

# ARPA "no backoff possible" sentinel (-99 log10) → treat as -inf-ish.
NO_PROB = -99.0 * LOG10


def _open(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_arpa(path: str) -> List[Dict[Tuple[str, ...], Tuple[float, float]]]:
    """Parse an ARPA file.

    Returns a list indexed by (order-1): dict mapping word tuples →
    (log_prob, backoff_weight), both in natural log. Missing backoff = 0.0.
    """
    tables: List[Dict[Tuple[str, ...], Tuple[float, float]]] = []
    counts: List[int] = []
    with _open(path) as f:
        # header
        for line in f:
            if line.strip() == "\\data\\":
                break
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("ngram "):
                counts.append(int(line.split("=")[1]))
            else:
                break
        tables = [dict() for _ in counts]
        order = None
        # `line` currently holds "\1-grams:" (or similar) from the loop above
        while True:
            if line is None:
                break
            stripped = line.strip()
            if stripped.startswith("\\") and stripped.endswith("-grams:"):
                order = int(stripped[1:].split("-")[0])
            elif stripped == "\\end\\":
                break
            elif stripped and order is not None:
                parts = stripped.split("\t")
                if len(parts) == 1:
                    parts = stripped.split()
                    logp = float(parts[0])
                    words = tuple(parts[1 : 1 + order])
                    bow = float(parts[1 + order]) if len(parts) > 1 + order else 0.0
                else:
                    logp = float(parts[0])
                    words = tuple(parts[1].split())
                    bow = float(parts[2]) if len(parts) > 2 else 0.0
                tables[order - 1][words] = (logp * LOG10, bow * LOG10)
            line = f.readline()
            if line == "":
                break
    return tables


def write_arpa(
    path: str,
    tables: List[Dict[Tuple[str, ...], Tuple[float, float]]],
) -> None:
    """Write tables (natural log) to an ARPA file (log10)."""
    with _open(path, "wt") as f:
        f.write("\n\\data\\\n")
        for i, t in enumerate(tables):
            f.write(f"ngram {i + 1}={len(t)}\n")
        for i, t in enumerate(tables):
            f.write(f"\n\\{i + 1}-grams:\n")
            highest = i == len(tables) - 1
            for words in sorted(t.keys()):
                logp, bow = t[words]
                p10 = logp / LOG10
                if p10 < -98.9:
                    p10 = -99.0
                line = f"{p10:.7f}\t{' '.join(words)}"
                if not highest and abs(bow) > 1e-12:
                    line += f"\t{bow / LOG10:.7f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
