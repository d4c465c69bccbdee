"""LM corpus normalization.

Parity target: ``examples/speech/s0/local/format_lm_data.py`` — abbreviation
joining, link/hashtag de-wording, unicode punctuation normalization, digit and
punctuation stripping, stray-apostrophe cleanup, single-character-word
filtering, lexicon-closed filtering, uppercase output. Sentence splitting uses
a lightweight regex instead of nltk (not in this image).
"""

from __future__ import annotations

import re
from typing import Iterable, Iterator, List, Optional, Set

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    return [s for s in _SENT_SPLIT.split(text) if s.strip()]


def join_abbreviation(text: str) -> str:
    return re.sub(
        r"\b([a-zA-Z]\.){2,}",
        lambda m: "".join(m.group(0).split(".")).upper(),
        text,
    )


def handle_links(text: str) -> str:
    return re.sub(
        r"(http\S+|www\S+|https\S+|\S+@\S+|#\S+|@\S+|\b\w+://\S+|\b(\w+\.)+\w{2,})",
        lambda m: re.sub(r"[^\w]", "", m.group(0)) * 2,
        text,
    )


def formalize_punctuation(text: str) -> str:
    for k, v in {
        "“": '"', "”": '"', "‘": "'", "’": "'",
        "…": "...", "–": "-", "—": "-",
        " +": " ", " .": ".", " ,": ",", ", ": ",",
    }.items():
        text = text.replace(k, v)
    return text


def clean_sentence(sent: str) -> Optional[str]:
    sent = sent.strip()
    if not sent:
        return None
    sent = handle_links(sent)
    sent = join_abbreviation(sent)
    sent = formalize_punctuation(sent)
    sent = re.sub(r"\:", " ", sent)
    sent = re.sub(r"[^a-zA-Z\s']", " ", sent)
    sent = re.sub(r"\d+([\.,]\d+)?", " ", sent)
    sent = re.sub(r"(?:(?:^|\s)\')|\'$|\s\'\s|([^s])\'\s", r"\1 ", sent.strip()).strip()
    sent = re.sub(r"\s+", " ", sent).strip().lower()
    if not sent:
        return None
    if any(len(w) == 1 and w not in ("i", "a") for w in sent.split()):
        return None
    return sent


def clean_text(text: str) -> Iterator[str]:
    for sent in split_sentences(text):
        cleaned = clean_sentence(sent)
        if cleaned:
            yield cleaned


_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [(10**9, "billion"), (10**6, "million"), (1000, "thousand"), (100, "hundred")]


def number_to_words(n: int) -> str:
    """Integer → English words (the num2words dependency of the reference's
    convert_number_to_words.py, reimplemented for the corpus pipeline)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = number_to_words(major) + " " + name
            if rem:
                out += " " + number_to_words(rem)
            return out
    return _ONES[0]


def convert_numbers_to_words(text: str) -> str:
    """Replace standalone integers in text with their word form
    (convert_number_to_words.py equivalent; floats/comma groups are split)."""
    def repl(m):
        return " " + number_to_words(int(m.group(0))) + " "

    text = re.sub(r"(?<=\d),(?=\d)", "", text)  # 1,000 -> 1000
    text = re.sub(r"\d+", repl, text)
    return re.sub(r"\s+", " ", text).strip()


def format_corpus(
    lines: Iterable[str],
    lexicon_words: Optional[Set[str]] = None,
    allow_unk: bool = False,
) -> Iterator[str]:
    """Normalize raw text lines → uppercase training sentences, dropping
    sentences with out-of-lexicon words unless allow_unk."""
    lex = {w.lower() for w in lexicon_words} if lexicon_words is not None else None
    for line in lines:
        for sub in re.split(r"\n+", line):
            for sent in clean_text(sub.strip()):
                if lex is not None and not allow_unk:
                    if any(w not in lex for w in sent.split()):
                        continue
                yield sent.upper()
