"""Golden-output regression + corpus metadata join.

Parity targets: the de-facto end-to-end fixture
``model_training/rnn_baseline_submission_file_valsplit.csv`` (id,text rows for
the pretrained checkpoint + 1-gram pipeline — SURVEY.md §4), and the
block→corpus join against ``data/t15_copyTaskData_description.csv``
(evaluate_model_helpers.py:61-65) used by the figure-2 vocabulary-condition
analysis.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import calculate_aggregate_error_rate
from ..utils.phonemes import remove_punctuation


def read_submission_csv(path: str) -> List[str]:
    """Read an 'id,text' competition CSV → list of sentences ordered by id."""
    rows: List[Tuple[int, str]] = []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        for row in reader:
            if len(row) >= 2:
                rows.append((int(row[0]), row[1]))
    rows.sort()
    return [text for _, text in rows]


def compare_to_golden(
    predictions: Sequence[str],
    golden_csv_path: str,
    n_resamples: int = 2000,
) -> Dict:
    """Sentence-level agreement + WER of predictions against a golden
    submission CSV (e.g. the reference's val-split baseline file)."""
    golden = read_submission_csv(golden_csv_path)
    n = min(len(predictions), len(golden))
    exact = sum(
        remove_punctuation(predictions[i]) == remove_punctuation(golden[i])
        for i in range(n)
    )
    refs = [remove_punctuation(g).split() for g in golden[:n]]
    hyps = [remove_punctuation(p).split() for p in list(predictions)[:n]]
    wer, lo, hi, _ = calculate_aggregate_error_rate(
        refs, hyps, n_resamples=n_resamples, seed=0
    )
    return {
        "n": n,
        "n_golden": len(golden),
        "n_predictions": len(predictions),
        "exact_match_rate": exact / max(n, 1),
        "wer_vs_golden": wer,
        "wer_ci": (lo, hi),
    }


def load_corpus_map(description_csv_path: str) -> Dict[Tuple[str, int], str]:
    """(date 'YYYY-MM-DD', block_num) → corpus name from the copy-task
    description CSV."""
    out: Dict[Tuple[str, int], str] = {}
    with open(description_csv_path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            try:
                out[(row["Date"], int(row["Block number"]))] = row["Corpus"]
            except (KeyError, ValueError):
                continue
    return out


def corpus_for_session_block(
    corpus_map: Dict[Tuple[str, int], str], session: str, block_num: int
) -> Optional[str]:
    """Session name 't15.2023.08.11' + block → corpus
    (evaluate_model_helpers.py:61-65 date munging)."""
    parts = session.split(".")
    if len(parts) < 4:
        return None
    date = f"{parts[1]}-{parts[2]}-{parts[3]}"
    return corpus_map.get((date, block_num))
