"""Loaders for the reference's REAL on-disk assets.

The rebuild's synthetic worlds (data/synthetic.py, data/adversarial.py)
regenerate the reference's *statistics*; this module consumes the actual
artifacts when a reference checkout is present, so the trie build, homophone
caps, probe-row economics, g2p held-out accuracy and golden-CSV parsing are
exercised on the production data:

  * ``dict.txt`` — the 125k-word CMUdict lexicon the production graphs are
    built from (language_model/examples/speech/s0/dict.txt; stress-strip per
    local/remove_stress_marker.py, first-pronunciation dedup per
    local/prepare_dict_ctc.sh:28).
  * ``rnn_baseline_submission_file_valsplit.csv`` — the de-facto golden
    end-to-end fixture (model_training/README.md:42; 1,426 id,text rows).
  * ``t15_copyTaskData_description.csv`` — the per-block corpus/split table
    joined by evaluate_model_helpers.py:61-65.

Everything here is skip-if-absent: ``have_real_assets()`` gates tests and
bench modes so the repo works without the reference checkout.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

REFERENCE_ROOT = os.environ.get("B2TXT_REFERENCE_ROOT", "reference")

DICT_TXT = os.path.join(
    REFERENCE_ROOT, "language_model", "examples", "speech", "s0", "dict.txt"
)
VALSPLIT_CSV = os.path.join(
    REFERENCE_ROOT, "model_training",
    "rnn_baseline_submission_file_valsplit.csv",
)
DESCRIPTION_CSV = os.path.join(
    REFERENCE_ROOT, "data", "t15_copyTaskData_description.csv"
)


def have_real_dict() -> bool:
    return os.path.isfile(DICT_TXT)


def have_real_csvs() -> bool:
    return os.path.isfile(VALSPLIT_CSV) and os.path.isfile(DESCRIPTION_CSV)


def have_real_assets() -> bool:
    return have_real_dict() and have_real_csvs()


_STRESS = re.compile(r"[0-9]")


def load_real_dict(
    path: Optional[str] = None,
    first_pron_only: bool = True,
    words_only: bool = False,
) -> Dict[str, List[List[str]]]:
    """Parse dict.txt the way the reference's graph build does.

    Mirrors local/remove_stress_marker.py (strip trailing digit from the 15
    stressable vowels — equivalently strip all digits, ARPAbet stress only
    ever suffixes vowels) followed by prepare_dict_ctc.sh:28's perl dedup,
    which keeps only the FIRST pronunciation seen per word token. Word tokens
    are kept verbatim apart from lowercasing (the reference lexicon includes
    punctuation-named entries like !EXCLAMATION-POINT; they are legal words
    in words.txt). ``words_only=True`` filters to purely alphabetic words
    (with optional apostrophes/periods/hyphens), the subset that can appear
    in a normalized text corpus (local/format_lm_data.py strips the rest).
    """
    path = path or DICT_TXT
    out: Dict[str, List[List[str]]] = {}
    word_ok = re.compile(r"^[a-z][a-z'.\-]*$")
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";;;"):
                continue
            parts = line.split()
            word = parts[0].lower()
            # CMUdict alternates WORD(2) collapse onto WORD; the reference's
            # first-seen dedup then drops them
            word = re.sub(r"\(\d+\)$", "", word)
            phones = [_STRESS.sub("", p) for p in parts[1:]]
            if not phones:
                continue
            if words_only and not word_ok.match(word):
                continue
            if word in out:
                if not first_pron_only and phones not in out[word]:
                    out[word].append(phones)
                continue
            out[word] = [phones]
    return out


def real_lexicon(
    max_words: Optional[int] = None,
    first_pron_only: bool = True,
    words_only: bool = True,
    seed: int = 0,
):
    """Compile the real dict.txt into the search trie (lm/lexicon.py).

    ``max_words`` subsamples deterministically (for fast tests); None = the
    full production vocabulary. Returns (Lexicon, {word: [prons]}).
    Pronunciations whose phones fall outside the model's 39-phone inventory
    (none in practice for dict.txt) are dropped by Lexicon.build's mapping.
    """
    from ..lm.lexicon import PHONE_TO_ID, Lexicon

    prons = load_real_dict(first_pron_only=first_pron_only,
                           words_only=words_only)
    prons = {
        w: [p for p in ps if all(ph in PHONE_TO_ID for ph in p)]
        for w, ps in prons.items()
    }
    prons = {w: ps for w, ps in prons.items() if ps}
    if max_words is not None and len(prons) > max_words:
        import numpy as np

        words = sorted(prons.keys())
        keep = np.random.default_rng(seed).choice(
            len(words), size=max_words, replace=False
        )
        prons = {words[i]: prons[words[i]] for i in sorted(keep)}
    return Lexicon.from_words(prons), prons


def write_lexicon_file(prons: Dict[str, List[List[str]]], path: str) -> None:
    """Write 'WORD  P1 P2 ...' lines (the native decoder's input format;
    one line per pronunciation, reference lexicon.txt layout)."""
    with open(path, "w") as f:
        for w in sorted(prons):
            for p in prons[w]:
                f.write(f"{w.upper()}  {' '.join(p)}\n")
