"""Byte-level BPE tokenizer (GPT-2 style) — the OPT rescorer's text frontend.

The reference tokenizes rescoring hypotheses with the HF GPT2-BPE tokenizer
loaded alongside facebook/opt-6.7b (language-model-standalone.py:115-123).
This is a from-scratch implementation of the same scheme so the TPU OPT
rescorer (decode/opt_lm.py) runs without the `tokenizers` Rust runtime:

  * every byte maps to a printable unicode proxy character (the GPT-2
    bytes↔unicode table), so arbitrary UTF-8 round-trips losslessly;
  * text pre-tokenizes with GPT-2's contraction/word/number/punct/space
    pattern, then each pre-token is merged bottom-up by BPE rank;
  * OPT additionally prepends BOS (</s>, id 2) to every sequence —
    ``encode`` takes ``add_bos`` for that.

Loads standard ``vocab.json`` + ``merges.txt`` files (the artifacts HF
publishes for gpt2/opt checkpoints). Parity vs transformers' slow GPT2Tokenizer
on the same files is tested (tests/test_bpe.py).
"""

from __future__ import annotations

import json
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

# GPT-2's pre-tokenization pattern. The `regex` module (a transformers
# dependency, always present here) supports the \p{L}/\p{N} classes.
_PAT_STR = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""


@lru_cache(maxsize=1)
def _pattern():
    import regex

    return regex.compile(_PAT_STR)


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte → printable-unicode-proxy table: visible latin-1 bytes
    map to themselves; the rest shift up into 0x100+ so no token string ever
    contains control/whitespace bytes."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteBPE:
    """vocab: token-string → id; merges: ordered (left, right) pairs."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Iterable[Tuple[str, str]],
        bos_id: Optional[int] = None,
        unk_id: int = 0,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = {c: b for b, c in self.byte_enc.items()}
        self.bos_id = bos_id
        self.unk_id = unk_id
        self._cache: Dict[str, List[str]] = {}

    # ------------------------------------------------------------------ load
    @classmethod
    def from_files(
        cls, vocab_json: str, merges_txt: str, bos_id: Optional[int] = None
    ) -> "ByteBPE":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                if b:
                    merges.append((a, b))
        return cls(vocab, merges, bos_id=bos_id)

    @classmethod
    def for_opt(cls, vocab_json: str, merges_txt: str) -> "ByteBPE":
        """OPT convention: BOS = </s> = id 2 prepended to every sequence
        (what AutoTokenizer does for facebook/opt-* — standalone :115-123)."""
        return cls.from_files(vocab_json, merges_txt, bos_id=2)

    # ------------------------------------------------------------------- bpe
    def _bpe(self, token: str) -> List[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 60))
            if best not in self.ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        self._cache[token] = word
        return word

    # ---------------------------------------------------------------- encode
    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        if add_bos is None:
            add_bos = self.bos_id is not None
        ids: List[int] = [self.bos_id] if (add_bos and self.bos_id is not None) else []
        for pre in _pattern().findall(text):
            proxied = "".join(self.byte_enc[b] for b in pre.encode("utf-8"))
            for piece in self._bpe(proxied):
                ids.append(self.vocab.get(piece, self.unk_id))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        chars = "".join(
            self.inv_vocab.get(int(i), "") for i in ids if int(i) != self.bos_id
        )
        data = bytes(self.byte_dec[c] for c in chars if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")

    # a tokenizer is also an OPTRescorer ``encode`` callable (text, max_len)
    def __call__(self, text: str, max_len: int) -> List[int]:
        return self.encode(text)[:max_len]
