"""Frozen copy of b2txt_tpu_torch/lm/lexicon.py, kept for the
benchmark's plain reference: it does not follow later changes to the program.

Pronunciation lexicon + phoneme trie.

Replaces the reference's L.fst construction (``prepare_dict_ctc.sh`` +
``ctc_compile_dict_token.sh``): a CMUdict-style lexicon (word → ARPAbet
pronunciation, stress markers stripped — local/remove_stress_marker.py) is
compiled into a flat-array phoneme trie that the fused beam search walks
directly. SIL (the word separator emitted by the acoustic model at word ends,
evaluate_model_helpers.py:19) plays the role of the optional-silence arcs.

Trie arrays (gatherable on TPU for the device-resident search):
  next[node, phone]   → child node id or -1
  word_offsets[node]  → CSR start into word_list (words ending exactly here)
  word_list[i]        → word id
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .phonemes import LOGIT_TO_PHONEME, SIL_ID_MODEL

# phoneme string -> model output channel (BLANK=0 excluded; SIL=40)
PHONE_TO_ID: Dict[str, int] = {
    p: i for i, p in enumerate(LOGIT_TO_PHONEME) if 0 < i < SIL_ID_MODEL
}


def strip_stress(phones: Sequence[str]) -> List[str]:
    return [re.sub(r"[0-9]", "", p) for p in phones]


def parse_lexicon_line(line: str) -> Optional[Tuple[str, List[str]]]:
    """One CMUdict line: 'WORD  P1 P2 ...'; comments (;;;) and alternate
    pronunciation markers WORD(2) are handled."""
    line = line.strip()
    if not line or line.startswith(";;;") or line.startswith("#"):
        return None
    parts = line.split()
    word = parts[0]
    word = re.sub(r"\(\d+\)$", "", word)
    return word.lower(), strip_stress(parts[1:])


def load_lexicon_file(path: str) -> Dict[str, List[List[str]]]:
    lex: Dict[str, List[List[str]]] = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            parsed = parse_lexicon_line(line)
            if parsed is None:
                continue
            word, phones = parsed
            if not phones or any(p not in PHONE_TO_ID for p in phones):
                continue
            lex.setdefault(word, [])
            if phones not in lex[word]:
                lex[word].append(phones)
    return lex


@dataclass
class Lexicon:
    """Word list + pronunciations + compiled trie."""

    words: List[str]                      # id -> word string
    word_ids: Dict[str, int]              # word -> id
    prons: Dict[int, List[List[int]]]     # word id -> pronunciations (phone ids)
    next: np.ndarray                      # (n_nodes, n_phones+?) int32
    word_offsets: np.ndarray              # (n_nodes+1,) int32 CSR
    word_list: np.ndarray                 # (total,) int32

    @property
    def n_nodes(self) -> int:
        return self.next.shape[0]

    def node_words(self, node: int) -> List[int]:
        return self.word_list[
            self.word_offsets[node] : self.word_offsets[node + 1]
        ].tolist()

    def phones_of(self, word: str) -> List[List[int]]:
        return self.prons[self.word_ids[word]]

    @classmethod
    def build(
        cls,
        pronunciations: Dict[str, List[List[str]]],
        n_phones: int = 41,
    ) -> "Lexicon":
        """Compile word→pronunciations into the flat trie."""
        words = sorted(pronunciations.keys())
        word_ids = {w: i for i, w in enumerate(words)}
        prons: Dict[int, List[List[int]]] = {}

        next_rows: List[Dict[int, int]] = [dict()]  # node -> {phone: child}
        words_at: List[List[int]] = [[]]

        for w in words:
            wid = word_ids[w]
            prons[wid] = []
            for pron in pronunciations[w]:
                ids = [PHONE_TO_ID[p] for p in pron]
                prons[wid].append(ids)
                node = 0
                for pid in ids:
                    child = next_rows[node].get(pid)
                    if child is None:
                        child = len(next_rows)
                        next_rows.append(dict())
                        words_at.append([])
                        next_rows[node][pid] = child
                    node = child
                if wid not in words_at[node]:
                    words_at[node].append(wid)

        n_nodes = len(next_rows)
        nxt = np.full((n_nodes, n_phones), -1, np.int32)
        for node, row in enumerate(next_rows):
            for pid, child in row.items():
                nxt[node, pid] = child
        offsets = np.zeros(n_nodes + 1, np.int32)
        flat: List[int] = []
        for node, ws in enumerate(words_at):
            offsets[node] = len(flat)
            flat.extend(sorted(ws))
        offsets[n_nodes] = len(flat)
        return cls(
            words=words,
            word_ids=word_ids,
            prons=prons,
            next=nxt,
            word_offsets=offsets,
            word_list=np.asarray(flat, np.int32),
        )

    @classmethod
    def from_file(cls, path: str, vocab: Optional[Iterable[str]] = None) -> "Lexicon":
        lex = load_lexicon_file(path)
        if vocab is not None:
            vocab_set = {w.lower() for w in vocab}
            lex = {w: p for w, p in lex.items() if w in vocab_set}
        return cls.build(lex)

    @classmethod
    def from_words(
        cls, word_prons: Dict[str, List[str]] | Dict[str, List[List[str]]]
    ) -> "Lexicon":
        """Build from {word: pronunciation} or {word: [pronunciations]}."""
        norm: Dict[str, List[List[str]]] = {}
        for w, p in word_prons.items():
            if p and isinstance(p[0], str):
                norm[w.lower()] = [strip_stress(p)]  # type: ignore[arg-type]
            else:
                norm[w.lower()] = [strip_stress(x) for x in p]  # type: ignore[union-attr]
        return cls.build(norm)

    @classmethod
    def letters(cls) -> "Lexicon":
        """Letter-spelling lexicon (the reference's spelling_lm /
        handwriting-style recipes): each 'word' is a letter, pronounced as
        its spoken name."""
        names = {
            "a": ["EY"], "b": ["B", "IY"], "c": ["S", "IY"], "d": ["D", "IY"],
            "e": ["IY"], "f": ["EH", "F"], "g": ["JH", "IY"],
            "h": ["EY", "CH"], "i": ["AY"], "j": ["JH", "EY"],
            "k": ["K", "EY"], "l": ["EH", "L"], "m": ["EH", "M"],
            "n": ["EH", "N"], "o": ["OW"], "p": ["P", "IY"],
            "q": ["K", "Y", "UW"], "r": ["AA", "R"], "s": ["EH", "S"],
            "t": ["T", "IY"], "u": ["Y", "UW"], "v": ["V", "IY"],
            "w": ["D", "AH", "B", "AH", "L", "Y", "UW"],
            "x": ["EH", "K", "S"], "y": ["W", "AY"], "z": ["Z", "IY"],
        }
        return cls.build({w: [p] for w, p in names.items()})

    def lookahead_scores(self, unigram_logp) -> np.ndarray:
        """Per-node LM lookahead: la[node] = best unigram log-prob of any word
        reachable at/below the node (the weight-pushing of G scores along L
        arcs that TLG composition performs in the reference — without it,
        partial-word hypotheses ride free of LM cost and flood the beam).

        ``unigram_logp``: callable word-string → log P(word). Vectorized
        bottom-up propagation (level-synchronous maximum.at sweeps over the
        edge list) — the per-node python loop cost ~2 min at the 125k-word
        production scale."""
        word_lp = np.array(
            [float(unigram_logp(w)) for w in self.words], np.float64
        )
        la = np.full(self.n_nodes, -np.inf, np.float64)
        # seed word-final nodes with their words' best unigram (CSR scatter)
        counts = np.diff(self.word_offsets)
        node_of_entry = np.repeat(np.arange(self.n_nodes), counts)
        np.maximum.at(la, node_of_entry, word_lp[self.word_list])
        # propagate child→parent along trie edges to a fixed point — each
        # round lifts values one level, so it converges within the longest
        # pronunciation length (~14 rounds over the edge list)
        parents, phones = np.nonzero(self.next >= 0)
        children = self.next[parents, phones]
        changed = True
        while changed:
            before = la[parents]
            np.maximum.at(la, parents, la[children])
            changed = bool(np.any(la[parents] > before))
        return la.astype(np.float32)

    def sentence_to_phonemes(self, sentence: str) -> Optional[List[int]]:
        """Lexicon-based text→phoneme-ids with SIL after each word
        (the in-vocabulary replacement for g2p_en at general_utils.py:51-74;
        returns None when a word is out of lexicon)."""
        out: List[int] = []
        for w in sentence.lower().split():
            wid = self.word_ids.get(w)
            if wid is None:
                return None
            out.extend(self.prons[wid][0])
            out.append(SIL_ID_MODEL)
        return out
