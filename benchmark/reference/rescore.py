"""Frozen copy of the program's n-best post-processing
(``decode/rescore.py``: ``get_string_differences``, ``augment_nbest``,
``_clean_text``), kept for the benchmark's plain reference: it does not follow
later changes to the program. Parity targets in the reference's
``language-model-standalone.py``: :273-310, :327-411, :165-199."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def get_string_differences(cue: str, decoder_output: str):
    """Word-level minimum-edit alignment of decoder_output against cue.

    Returns (cost, path, indices_to_highlight) with path entries 'I'/'D'/'R'
    or the matched word index — same contract and tie-breaking
    (insertion ≼ deletion ≼ substitution) as the reference (:273-310), but an
    iterative DP instead of the memoized recursion (the recursive path
    concatenation is quadratic and dominated finalize profiles).
    """
    h = decoder_output.split()  # rows
    r = cue.split()             # columns
    I, J = len(h), len(r)

    dp = np.empty((I + 1, J + 1), dtype=np.int32)
    dp[0, :] = np.arange(J + 1)
    dp[:, 0] = np.arange(I + 1)
    for i in range(1, I + 1):
        row = dp[i]
        prev = dp[i - 1]
        hi = h[i - 1]
        for j in range(1, J + 1):
            if hi == r[j - 1]:
                row[j] = prev[j - 1]
            else:
                row[j] = 1 + min(row[j - 1], prev[j], prev[j - 1])

    cost = int(dp[I, J])
    # Forward path reconstruction == the recursion's choice order: at (i, j)
    # the recursion prefers match, then insertion (j-1), deletion (i-1),
    # substitution (i-1, j-1) — walk backward applying the same preferences.
    rev = []
    i, j = I, J
    while i > 0 or j > 0:
        if i > 0 and j > 0 and h[i - 1] == r[j - 1] and dp[i, j] == dp[i - 1, j - 1]:
            rev.append(i - 1)
            i -= 1
            j -= 1
            continue
        ins_c = dp[i, j - 1] if j > 0 else np.iinfo(np.int32).max
        del_c = dp[i - 1, j] if i > 0 else np.iinfo(np.int32).max
        sub_c = dp[i - 1, j - 1] if (i > 0 and j > 0) else np.iinfo(np.int32).max
        if ins_c <= del_c and ins_c <= sub_c:
            rev.append("I")
            j -= 1
        elif del_c <= ins_c and del_c <= sub_c:
            rev.append("D")
            i -= 1
        else:
            rev.append("R")
            i -= 1
            j -= 1
    path = [p for p in reversed(rev) if p != "I"]

    indices = []
    cur = 0
    for label, word in zip(path, h):
        if label in ("R", "D"):
            indices.append((cur, cur + len(word)))
        cur += len(word) + 1
    return cost, list(path), indices


NBest = List[Tuple[str, float, float]]  # (sentence, ac_score, lm_score)




NBest = List[Tuple[str, float, float]]


def augment_nbest(
    nbest: NBest,
    top_candidates_to_augment: int = 20,
    acoustic_scale: float = 0.3,
    score_penalty_percent: float = 0.01,
) -> NBest:
    """Generate extra candidates by swapping substituted words between
    equal-length candidate pairs (reference :327-411)."""
    sentences = [s.strip() for s, _, _ in nbest]
    ac = [a for _, a, _ in nbest]
    lm = [l for _, _, l in nbest]
    total = [acoustic_scale * a + l for _, a, l in nbest]

    order = np.argsort(total)[::-1]
    sentences = [sentences[i] for i in order]
    ac = [ac[i] for i in order]
    lm = [lm[i] for i in order]
    total = [total[i] for i in order]

    new_s: List[str] = []
    new_ac: List[float] = []
    new_lm: List[float] = []
    new_total: List[float] = []

    top = top_candidates_to_augment
    for i1 in range(min(len(sentences) - 1, top)):
        w1 = sentences[i1].split()
        for i2 in range(i1 + 1, min(len(sentences), top)):
            w2 = sentences[i2].split()
            if len(w1) != len(w2):
                continue
            _, path1, _ = get_string_differences(sentences[i1], sentences[i2])
            _, path2, _ = get_string_differences(sentences[i2], sentences[i1])
            r1 = [i for i, p in enumerate(path2) if p == "R"]
            r2 = [i for i, p in enumerate(path1) if p == "R"]
            for a, b in zip(r1, r2):
                for nw1, nw2 in (
                    (w1[:a] + [w2[b]] + w1[a + 1:], None),
                    (None, w2[:b] + [w1[a]] + w2[b + 1:]),
                ):
                    cand = " ".join(nw1 if nw1 is not None else nw2)
                    if cand in sentences or cand in new_s:
                        continue
                    mean_ac = float(np.mean([ac[i1], ac[i2]]))
                    mean_lm = float(np.mean([lm[i1], lm[i2]]))
                    pa = mean_ac - score_penalty_percent * abs(mean_ac)
                    pl = mean_lm - score_penalty_percent * abs(mean_lm)
                    new_s.append(cand)
                    new_ac.append(pa)
                    new_lm.append(pl)
                    new_total.append(acoustic_scale * pa + pl)

    sentences += new_s
    ac += new_ac
    lm += new_lm
    total += new_total
    order = np.argsort(total)[::-1]
    return [(sentences[i], ac[i], lm[i]) for i in order]



def _clean_text(t: str) -> str:
    return (
        t.replace(">", "").replace("  ", " ").replace(" ,", ",")
        .replace(" .", ".").replace(" ?", "?")
    )

