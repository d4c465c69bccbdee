"""Grapheme-to-phoneme conversion for arbitrary text.

The TPU framework's replacement for the reference's g2p_en dependency
(``nejm_b2txt_utils/general_utils.py:51-74``): ``sentence_to_phonemes`` cleans
a transcript, converts each word to ARPAbet phonemes with SIL at word ends,
and returns (phonemes, cleaned_text) — the exact output contract of the
reference function.

Like g2p_en, conversion is dictionary-first with a letter-to-sound fallback
for out-of-vocabulary words: a built-in exception dictionary covers frequent
irregular English words, an optional CMUdict-style lexicon extends it, and a
context-sensitive rule engine (longest-match grapheme rules with vowel /
consonant / front-vowel / boundary context classes, in the tradition of
classic text-to-speech letter-to-sound systems) handles everything else. The
rules don't reach neural-G2P accuracy on hard OOV words, but every output is a
valid decoder phoneme, so PER references and OOV lexicon entries can always be
built (reference use sites: PER targets in evaluate_model.py and lexicon
construction for new vocabulary).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .phonemes import LOGIT_TO_PHONEME, SIL_ID_MODEL, remove_punctuation

VOWELS = set("aeiouy")
CONSONANTS = set("bcdfghjklmnpqrstvwxz")
FRONT = set("eiy")  # soften c/g

# ---------------------------------------------------------------------------
# Exception dictionary: frequent English words with irregular spellings.
# Pronunciations are standard General-American ARPAbet (stress stripped).
# ---------------------------------------------------------------------------
EXCEPTIONS: Dict[str, List[str]] = {
    "a": ["AH"], "an": ["AH", "N"], "the": ["DH", "AH"],
    "of": ["AH", "V"], "to": ["T", "UW"], "and": ["AE", "N", "D"],
    "in": ["IH", "N"], "is": ["IH", "Z"], "it": ["IH", "T"],
    "you": ["Y", "UW"], "that": ["DH", "AE", "T"], "he": ["HH", "IY"],
    "was": ["W", "AH", "Z"], "for": ["F", "AO", "R"], "on": ["AA", "N"],
    "are": ["AA", "R"], "with": ["W", "IH", "DH"], "as": ["AE", "Z"],
    "i": ["AY"], "his": ["HH", "IH", "Z"], "they": ["DH", "EY"],
    "be": ["B", "IY"], "at": ["AE", "T"], "one": ["W", "AH", "N"],
    "have": ["HH", "AE", "V"], "this": ["DH", "IH", "S"],
    "from": ["F", "R", "AH", "M"], "or": ["AO", "R"],
    "had": ["HH", "AE", "D"], "by": ["B", "AY"], "but": ["B", "AH", "T"],
    "not": ["N", "AA", "T"], "what": ["W", "AH", "T"],
    "all": ["AO", "L"], "were": ["W", "ER"], "we": ["W", "IY"],
    "when": ["W", "EH", "N"], "your": ["Y", "AO", "R"],
    "can": ["K", "AE", "N"], "said": ["S", "EH", "D"],
    "there": ["DH", "EH", "R"], "their": ["DH", "EH", "R"],
    "use": ["Y", "UW", "Z"], "each": ["IY", "CH"],
    "which": ["W", "IH", "CH"], "she": ["SH", "IY"],
    "do": ["D", "UW"], "how": ["HH", "AW"], "if": ["IH", "F"],
    "will": ["W", "IH", "L"], "up": ["AH", "P"],
    "other": ["AH", "DH", "ER"], "about": ["AH", "B", "AW", "T"],
    "out": ["AW", "T"], "many": ["M", "EH", "N", "IY"],
    "then": ["DH", "EH", "N"], "them": ["DH", "EH", "M"],
    "these": ["DH", "IY", "Z"], "so": ["S", "OW"],
    "some": ["S", "AH", "M"], "her": ["HH", "ER"],
    "would": ["W", "UH", "D"], "make": ["M", "EY", "K"],
    "like": ["L", "AY", "K"], "him": ["HH", "IH", "M"],
    "into": ["IH", "N", "T", "UW"], "time": ["T", "AY", "M"],
    "has": ["HH", "AE", "Z"], "look": ["L", "UH", "K"],
    "two": ["T", "UW"], "more": ["M", "AO", "R"],
    "write": ["R", "AY", "T"], "go": ["G", "OW"],
    "see": ["S", "IY"], "number": ["N", "AH", "M", "B", "ER"],
    "no": ["N", "OW"], "way": ["W", "EY"],
    "could": ["K", "UH", "D"], "people": ["P", "IY", "P", "AH", "L"],
    "my": ["M", "AY"], "than": ["DH", "AE", "N"],
    "first": ["F", "ER", "S", "T"], "water": ["W", "AO", "T", "ER"],
    "been": ["B", "IH", "N"], "who": ["HH", "UW"],
    "its": ["IH", "T", "S"], "now": ["N", "AW"],
    "find": ["F", "AY", "N", "D"], "long": ["L", "AO", "NG"],
    "down": ["D", "AW", "N"], "day": ["D", "EY"],
    "did": ["D", "IH", "D"], "get": ["G", "EH", "T"],
    "come": ["K", "AH", "M"], "made": ["M", "EY", "D"],
    "may": ["M", "EY"], "part": ["P", "AA", "R", "T"],
    "over": ["OW", "V", "ER"], "new": ["N", "UW"],
    "sound": ["S", "AW", "N", "D"], "take": ["T", "EY", "K"],
    "only": ["OW", "N", "L", "IY"], "little": ["L", "IH", "T", "AH", "L"],
    "work": ["W", "ER", "K"], "know": ["N", "OW"],
    "place": ["P", "L", "EY", "S"], "year": ["Y", "IH", "R"],
    "live": ["L", "IH", "V"], "me": ["M", "IY"],
    "back": ["B", "AE", "K"], "give": ["G", "IH", "V"],
    "most": ["M", "OW", "S", "T"], "very": ["V", "EH", "R", "IY"],
    "after": ["AE", "F", "T", "ER"], "thing": ["TH", "IH", "NG"],
    "our": ["AW", "ER"], "just": ["JH", "AH", "S", "T"],
    "name": ["N", "EY", "M"], "good": ["G", "UH", "D"],
    "sentence": ["S", "EH", "N", "T", "AH", "N", "S"],
    "man": ["M", "AE", "N"], "think": ["TH", "IH", "NG", "K"],
    "say": ["S", "EY"], "great": ["G", "R", "EY", "T"],
    "where": ["W", "EH", "R"], "help": ["HH", "EH", "L", "P"],
    "through": ["TH", "R", "UW"], "much": ["M", "AH", "CH"],
    "before": ["B", "IH", "F", "AO", "R"], "line": ["L", "AY", "N"],
    "right": ["R", "AY", "T"], "too": ["T", "UW"],
    "mean": ["M", "IY", "N"], "old": ["OW", "L", "D"],
    "any": ["EH", "N", "IY"], "same": ["S", "EY", "M"],
    "tell": ["T", "EH", "L"], "boy": ["B", "OY"],
    "follow": ["F", "AA", "L", "OW"], "came": ["K", "EY", "M"],
    "want": ["W", "AA", "N", "T"], "show": ["SH", "OW"],
    "also": ["AO", "L", "S", "OW"], "around": ["ER", "AW", "N", "D"],
    "form": ["F", "AO", "R", "M"], "three": ["TH", "R", "IY"],
    "small": ["S", "M", "AO", "L"], "set": ["S", "EH", "T"],
    "put": ["P", "UH", "T"], "end": ["EH", "N", "D"],
    "does": ["D", "AH", "Z"], "another": ["AH", "N", "AH", "DH", "ER"],
    "well": ["W", "EH", "L"], "large": ["L", "AA", "R", "JH"],
    "must": ["M", "AH", "S", "T"], "big": ["B", "IH", "G"],
    "even": ["IY", "V", "AH", "N"], "such": ["S", "AH", "CH"],
    "because": ["B", "IH", "K", "AO", "Z"], "turn": ["T", "ER", "N"],
    "here": ["HH", "IY", "R"], "why": ["W", "AY"],
    "ask": ["AE", "S", "K"], "went": ["W", "EH", "N", "T"],
    "men": ["M", "EH", "N"], "read": ["R", "IY", "D"],
    "need": ["N", "IY", "D"], "land": ["L", "AE", "N", "D"],
    "different": ["D", "IH", "F", "ER", "AH", "N", "T"],
    "home": ["HH", "OW", "M"], "us": ["AH", "S"],
    "move": ["M", "UW", "V"], "try": ["T", "R", "AY"],
    "kind": ["K", "AY", "N", "D"], "hand": ["HH", "AE", "N", "D"],
    "picture": ["P", "IH", "K", "CH", "ER"],
    "again": ["AH", "G", "EH", "N"], "change": ["CH", "EY", "N", "JH"],
    "off": ["AO", "F"], "play": ["P", "L", "EY"],
    "spell": ["S", "P", "EH", "L"], "air": ["EH", "R"],
    "away": ["AH", "W", "EY"], "animal": ["AE", "N", "AH", "M", "AH", "L"],
    "house": ["HH", "AW", "S"], "point": ["P", "OY", "N", "T"],
    "page": ["P", "EY", "JH"], "letter": ["L", "EH", "T", "ER"],
    "mother": ["M", "AH", "DH", "ER"], "father": ["F", "AA", "DH", "ER"],
    "answer": ["AE", "N", "S", "ER"], "found": ["F", "AW", "N", "D"],
    "study": ["S", "T", "AH", "D", "IY"], "still": ["S", "T", "IH", "L"],
    "learn": ["L", "ER", "N"], "should": ["SH", "UH", "D"],
    "world": ["W", "ER", "L", "D"], "high": ["HH", "AY"],
    "every": ["EH", "V", "ER", "IY"], "near": ["N", "IH", "R"],
    "add": ["AE", "D"], "food": ["F", "UW", "D"],
    "between": ["B", "IH", "T", "W", "IY", "N"],
    "own": ["OW", "N"], "below": ["B", "IH", "L", "OW"],
    "country": ["K", "AH", "N", "T", "R", "IY"],
    "plant": ["P", "L", "AE", "N", "T"],
    "last": ["L", "AE", "S", "T"], "school": ["S", "K", "UW", "L"],
    "keep": ["K", "IY", "P"], "tree": ["T", "R", "IY"],
    "never": ["N", "EH", "V", "ER"], "start": ["S", "T", "AA", "R", "T"],
    "city": ["S", "IH", "T", "IY"], "earth": ["ER", "TH"],
    "eye": ["AY"], "light": ["L", "AY", "T"],
    "thought": ["TH", "AO", "T"], "head": ["HH", "EH", "D"],
    "under": ["AH", "N", "D", "ER"], "story": ["S", "T", "AO", "R", "IY"],
    "saw": ["S", "AO"], "left": ["L", "EH", "F", "T"],
    "don't": ["D", "OW", "N", "T"], "few": ["F", "Y", "UW"],
    "while": ["W", "AY", "L"], "along": ["AH", "L", "AO", "NG"],
    "might": ["M", "AY", "T"], "close": ["K", "L", "OW", "S"],
    "something": ["S", "AH", "M", "TH", "IH", "NG"],
    "seem": ["S", "IY", "M"], "next": ["N", "EH", "K", "S", "T"],
    "hard": ["HH", "AA", "R", "D"], "open": ["OW", "P", "AH", "N"],
    "example": ["IH", "G", "Z", "AE", "M", "P", "AH", "L"],
    "begin": ["B", "IH", "G", "IH", "N"], "life": ["L", "AY", "F"],
    "always": ["AO", "L", "W", "EY", "Z"], "those": ["DH", "OW", "Z"],
    "both": ["B", "OW", "TH"], "paper": ["P", "EY", "P", "ER"],
    "together": ["T", "AH", "G", "EH", "DH", "ER"],
    "got": ["G", "AA", "T"], "group": ["G", "R", "UW", "P"],
    "often": ["AO", "F", "AH", "N"], "run": ["R", "AH", "N"],
    "important": ["IH", "M", "P", "AO", "R", "T", "AH", "N", "T"],
    "until": ["AH", "N", "T", "IH", "L"], "children": ["CH", "IH", "L", "D", "R", "AH", "N"],
    "side": ["S", "AY", "D"], "feet": ["F", "IY", "T"],
    "car": ["K", "AA", "R"], "mile": ["M", "AY", "L"],
    "night": ["N", "AY", "T"], "walk": ["W", "AO", "K"],
    "white": ["W", "AY", "T"], "sea": ["S", "IY"],
    "began": ["B", "IH", "G", "AE", "N"], "grow": ["G", "R", "OW"],
    "took": ["T", "UH", "K"], "river": ["R", "IH", "V", "ER"],
    "four": ["F", "AO", "R"], "carry": ["K", "AE", "R", "IY"],
    "state": ["S", "T", "EY", "T"], "once": ["W", "AH", "N", "S"],
    "book": ["B", "UH", "K"], "hear": ["HH", "IY", "R"],
    "stop": ["S", "T", "AA", "P"], "without": ["W", "IH", "TH", "AW", "T"],
    "second": ["S", "EH", "K", "AH", "N", "D"],
    "later": ["L", "EY", "T", "ER"], "miss": ["M", "IH", "S"],
    "idea": ["AY", "D", "IY", "AH"], "enough": ["IH", "N", "AH", "F"],
    "eat": ["IY", "T"], "face": ["F", "EY", "S"],
    "watch": ["W", "AA", "CH"], "far": ["F", "AA", "R"],
    "really": ["R", "IH", "L", "IY"], "almost": ["AO", "L", "M", "OW", "S", "T"],
    "let": ["L", "EH", "T"], "above": ["AH", "B", "AH", "V"],
    "girl": ["G", "ER", "L"], "sometimes": ["S", "AH", "M", "T", "AY", "M", "Z"],
    "mountain": ["M", "AW", "N", "T", "AH", "N"],
    "cut": ["K", "AH", "T"], "young": ["Y", "AH", "NG"],
    "talk": ["T", "AO", "K"], "soon": ["S", "UW", "N"],
    "list": ["L", "IH", "S", "T"], "song": ["S", "AO", "NG"],
    "being": ["B", "IY", "IH", "NG"], "leave": ["L", "IY", "V"],
    "family": ["F", "AE", "M", "AH", "L", "IY"],
    "it's": ["IH", "T", "S"], "i'm": ["AY", "M"],
    "i'll": ["AY", "L"], "i've": ["AY", "V"],
    "you're": ["Y", "UH", "R"], "won't": ["W", "OW", "N", "T"],
    "can't": ["K", "AE", "N", "T"], "didn't": ["D", "IH", "D", "AH", "N", "T"],
    "doesn't": ["D", "AH", "Z", "AH", "N", "T"],
    "isn't": ["IH", "Z", "AH", "N", "T"],
    "wasn't": ["W", "AH", "Z", "AH", "N", "T"],
    "that's": ["DH", "AE", "T", "S"], "there's": ["DH", "EH", "R", "Z"],
    "what's": ["W", "AH", "T", "S"], "he's": ["HH", "IY", "Z"],
    "she's": ["SH", "IY", "Z"], "we're": ["W", "IH", "R"],
    "they're": ["DH", "EH", "R"], "i'd": ["AY", "D"],
    "one's": ["W", "AH", "N", "Z"],
}

# ---------------------------------------------------------------------------
# Letter-to-sound rules. Each rule is (left, grapheme, right, phones) and
# applies when `grapheme` matches at the cursor with both context patterns
# satisfied. Context pattern characters:
#   '#'  one or more vowel letters        '^'  exactly one consonant letter
#   ':'  zero or more consonant letters   '+'  one front vowel (e, i, y)
#   '_'  word boundary
# other characters match literally. First matching rule wins; rules for each
# first letter are tried in order (longest/most-specific first).
# ---------------------------------------------------------------------------
RULES: List[Tuple[str, str, str, List[str]]] = [
    # --- a ---
    ("", "ation", "_", ["EY", "SH", "AH", "N"]),
    ("#:", "able", "_", ["AH", "B", "AH", "L"]),  # suffix only (comfortable)
    ("", "able", "_", ["EY", "B", "AH", "L"]),    # table, cable
    ("", "augh", "", ["AO"]),
    ("", "air", "", ["EH", "R"]),
    ("", "aw", "", ["AO"]),
    ("", "au", "", ["AO"]),
    ("", "ai", "", ["EY"]),
    ("", "ay", "", ["EY"]),
    ("", "alk", "", ["AO", "K"]),
    ("", "all", "", ["AO", "L"]),
    ("", "ar", "", ["AA", "R"]),
    ("", "a", "^e_", ["EY"]),          # magic e: make, late
    ("", "a", "^+", ["EY"]),           # open syllable before front vowel: basic
    ("_", "a", "_", ["AH"]),
    ("", "a", "_", ["AH"]),            # final a: sofa
    ("", "a", "", ["AE"]),             # default closed: cat
    # --- b ---
    ("", "bb", "", ["B"]),
    ("m", "b", "_", []),               # lamb/comb: silent b after m
    ("", "b", "", ["B"]),
    # --- c ---
    ("", "ch", "", ["CH"]),
    ("", "ck", "", ["K"]),
    ("", "cc", "+", ["K", "S"]),       # accident
    ("", "cc", "", ["K"]),
    ("", "cial", "", ["SH", "AH", "L"]),
    ("", "cious", "", ["SH", "AH", "S"]),
    ("", "c", "+", ["S"]),             # soft c: city, cent
    ("", "c", "", ["K"]),
    # --- d ---
    ("", "dge", "", ["JH"]),
    ("", "dd", "", ["D"]),
    ("", "d", "", ["D"]),
    # --- e ---
    ("", "eigh", "", ["EY"]),
    ("", "ear", "", ["IY", "R"]),
    ("", "ee", "", ["IY"]),
    ("", "ea", "", ["IY"]),
    ("", "ew", "", ["UW"]),
    ("", "ey", "_", ["IY"]),
    ("", "ei", "", ["IY"]),
    ("", "er", "_", ["ER"]),
    ("", "er", "", ["ER"]),
    ("", "ed", "_", ["D"]),            # past tense (walked→ K T handled ok-ish)
    ("^", "e", "_", []),               # final silent e
    ("", "e", "_", ["IY"]),            # be-like (mostly exceptions anyway)
    ("", "e", "", ["EH"]),
    # --- f ---
    ("", "ff", "", ["F"]),
    ("", "f", "", ["F"]),
    # --- g ---
    ("", "gh", "t", []),               # light, thought: silent gh
    ("i", "gh", "", []),               # high, sigh
    ("", "gh", "", ["G"]),
    ("", "gg", "", ["G"]),
    ("", "g", "e_", ["JH"]),           # age
    ("", "g", "+", ["JH"]),            # gem, giant (imperfect: get is exception)
    ("", "g", "", ["G"]),
    # --- h ---
    ("", "h", "", ["HH"]),
    # --- i ---
    ("", "igh", "", ["AY"]),
    ("", "ing", "_", ["IH", "NG"]),
    ("", "ion", "_", ["AH", "N"]),
    ("", "ious", "_", ["IY", "AH", "S"]),
    ("", "ir", "", ["ER"]),
    ("", "ie", "_", ["AY"]),           # tie, die
    ("", "i", "^e_", ["AY"]),          # magic e: time, line
    ("", "i", "nd_", ["AY"]),          # find, kind
    ("_", "i", "_", ["AY"]),
    ("", "i", "", ["IH"]),
    # --- j ---
    ("", "j", "", ["JH"]),
    # --- k ---
    ("_", "kn", "", ["N"]),            # knee, know
    ("", "k", "", ["K"]),
    # --- l ---
    ("", "ll", "", ["L"]),
    ("", "le", "_", ["AH", "L"]),      # table, little
    ("", "l", "", ["L"]),
    # --- m ---
    ("", "mb", "_", ["M"]),            # comb, lamb: silent b
    ("", "mm", "", ["M"]),
    ("", "m", "", ["M"]),
    # --- n ---
    ("", "ng", "_", ["NG"]),
    ("", "ng", "", ["NG"]),
    ("", "nk", "", ["NG", "K"]),
    ("", "nn", "", ["N"]),
    ("", "n", "", ["N"]),
    # --- o ---
    ("", "ought", "", ["AO", "T"]),
    ("", "ough", "_", ["OW"]),         # though (rough/enough via exceptions)
    ("", "oo", "k", ["UH"]),           # book, look
    ("", "oo", "", ["UW"]),
    ("", "oa", "", ["OW"]),
    ("", "oi", "", ["OY"]),
    ("", "oy", "", ["OY"]),
    ("", "ou", "", ["AW"]),
    ("", "ow", "_", ["OW"]),           # show, low
    ("", "ow", "", ["AW"]),            # down, how
    ("", "or", "", ["AO", "R"]),
    ("", "o", "^e_", ["OW"]),          # magic e: bone, home
    ("", "o", "_", ["OW"]),            # go, no
    ("", "o", "ld", ["OW"]),           # old, cold
    ("", "o", "", ["AA"]),             # default: hot, cot
    # --- p ---
    ("", "ph", "", ["F"]),
    ("", "pp", "", ["P"]),
    ("", "p", "", ["P"]),
    # --- q ---
    ("", "qu", "", ["K", "W"]),
    ("", "q", "", ["K"]),
    # --- r ---
    ("", "rr", "", ["R"]),
    ("", "r", "", ["R"]),
    # --- s ---
    ("", "ssion", "", ["SH", "AH", "N"]),
    ("", "sion", "", ["ZH", "AH", "N"]),
    ("", "sh", "", ["SH"]),
    ("", "ss", "", ["S"]),
    ("#", "s", "_", ["Z"]),            # plural after vowel: trees, days
    ("#", "s", "#", ["Z"]),            # intervocalic: easy, visit
    ("", "s", "", ["S"]),
    # --- t ---
    ("", "tion", "", ["SH", "AH", "N"]),
    ("", "ture", "_", ["CH", "ER"]),
    ("", "th", "", ["TH"]),
    ("", "tch", "", ["CH"]),
    ("", "tt", "", ["T"]),
    ("", "t", "", ["T"]),
    # --- u ---
    ("", "ur", "", ["ER"]),
    ("", "u", "^e_", ["UW"]),          # magic e: tune, rule
    ("_", "u", "", ["Y", "UW"]),       # unit, use
    ("", "u", "", ["AH"]),             # default: cup, sun
    # --- v ---
    ("", "v", "", ["V"]),
    # --- w ---
    ("_", "wr", "", ["R"]),            # write, wrong
    ("", "wh", "o", ["HH"]),           # who (mostly exceptions)
    ("", "wh", "", ["W"]),
    ("", "w", "", ["W"]),
    # --- x ---
    ("_", "x", "", ["Z"]),             # xylophone
    ("", "x", "", ["K", "S"]),
    # --- y ---
    ("_", "y", "", ["Y"]),             # initial: yes
    ("", "y", "_", ["IY"]),            # final: happy
    ("^", "y", "^", ["IH"]),           # medial: system
    ("", "y", "", ["AY"]),             # my-like leftovers
    # --- z ---
    ("", "zz", "", ["Z"]),
    ("", "z", "", ["Z"]),
]

_RULES_BY_LETTER: Dict[str, List[Tuple[str, str, str, List[str]]]] = {}
for rule in RULES:
    _RULES_BY_LETTER.setdefault(rule[1][0], []).append(rule)

_VALID_PHONES = set(LOGIT_TO_PHONEME[1:40])
for _rule in RULES:
    assert all(p in _VALID_PHONES for p in _rule[3]), _rule


def _match_context(pattern: str, word: str, pos: int, forward: bool) -> bool:
    """Match a context pattern against the word starting at pos.

    forward=True matches rightward from pos; forward=False matches leftward
    (pattern is written left-to-right in both cases; for the left context the
    pattern's END must touch the grapheme, so we match it reversed).
    """
    items = list(pattern) if forward else list(reversed(pattern))
    i = pos
    step = 1 if forward else -1
    for it in items:
        if it == "_":
            if forward:
                if i != len(word):
                    return False
            else:
                if i != -1:
                    return False
            continue
        if it == ":":
            while 0 <= i < len(word) and word[i] in CONSONANTS:
                i += step
            continue
        if not (0 <= i < len(word)):
            return False
        ch = word[i]
        if it == "#":
            if ch not in VOWELS:
                return False
            # one-or-more: consume the run
            while 0 <= i < len(word) and word[i] in VOWELS:
                i += step
            continue
        if it == "^":
            if ch not in CONSONANTS:
                return False
        elif it == "+":
            if ch not in FRONT:
                return False
        elif ch != it:
            return False
        i += step
    return True


def letters_to_phonemes(word: str) -> List[str]:
    """Rule-based letter-to-sound for one lowercase word (OOV fallback)."""
    word = "".join(c for c in word.lower() if c.isalpha())
    out: List[str] = []
    pos = 0
    while pos < len(word):
        matched = False
        for left, graph, right, phones in _RULES_BY_LETTER.get(word[pos], []):
            if word[pos : pos + len(graph)] != graph:
                continue
            if not _match_context(left, word, pos - 1, forward=False):
                continue
            if not _match_context(right, word, pos + len(graph), forward=True):
                continue
            out.extend(phones)
            pos += len(graph)
            matched = True
            break
        if not matched:
            pos += 1  # unpronounceable character: skip
    return out


class G2p:
    """Dictionary-first grapheme-to-phoneme converter (g2p_en stand-in).

    Word lookup order: user lexicon → built-in exceptions → suffix analysis
    of dictionary stems ('s, s, ed, ing) → trained letter-to-sound model →
    context rules. The trained LTS (utils/lts.py, a CMUdict-trained context
    decision list packaged at assets/lts_cmudict.json.gz; held-out phoneme
    error 9.4% — the g2p_en-class OOV path) loads lazily by default; pass
    ``lts=False`` to force the rule engine, or a LetterToSound instance to
    override.
    """

    def __init__(
        self,
        lexicon: Optional[Dict[str, Sequence[str]]] = None,
        lts=None,
    ):
        self.lexicon: Dict[str, List[str]] = {}
        if lexicon:
            for w, p in lexicon.items():
                self.lexicon[w.lower()] = list(p)
        self._lts = lts  # None = lazy default; False = disabled; or a model

    @property
    def lts(self):
        if self._lts is None:
            from .lts import LetterToSound

            self._lts = LetterToSound.load_pretrained() or False
        return self._lts or None

    def _oov(self, word: str) -> List[str]:
        """OOV fallback: trained LTS when available, else context rules."""
        lts = self.lts
        if lts is not None:
            out = lts.predict(word)
            if out:
                return out
        return letters_to_phonemes(word)

    def _lookup(self, word: str) -> Optional[List[str]]:
        if word in self.lexicon:
            return list(self.lexicon[word])
        if word in EXCEPTIONS:
            return list(EXCEPTIONS[word])
        return None

    @staticmethod
    def _plural(base: List[str]) -> List[str]:
        if base and base[-1] in ("S", "Z", "SH", "CH", "JH", "ZH"):
            return base + ["IH", "Z"]
        if base and base[-1] in ("P", "T", "K", "F", "TH"):
            return base + ["S"]
        return base + ["Z"]

    @staticmethod
    def _past(base: List[str]) -> List[str]:
        if base and base[-1] in ("T", "D"):
            return base + ["IH", "D"]
        if base and base[-1] in ("P", "K", "F", "S", "SH", "CH", "TH"):
            return base + ["T"]
        return base + ["D"]

    def word_to_phonemes(self, word: str) -> List[str]:
        word = word.lower()
        hit = self._lookup(word)
        if hit is not None:
            return hit

        # Regular inflections of *dictionary* stems get the suffix attached
        # with English voicing assimilation; unknown stems fall through to the
        # whole-word rules (with an 'ed'-voicing post-fix below).
        if word.endswith("'s") and len(word) > 2:
            base = self._lookup(word[:-2])
            if base is None:
                base = self._oov(word[:-2])
            return self._plural(base)
        if word.endswith("ing") and len(word) > 4:
            base = self._lookup(word[:-3]) or self._lookup(word[:-3] + "e")
            if base is None and len(word) > 5 and word[-4] == word[-5]:
                base = self._lookup(word[:-4])  # doubled consonant: running
            if base is not None:
                return base + ["IH", "NG"]
        if word.endswith("ed") and len(word) > 3:
            base = self._lookup(word[:-2]) or self._lookup(word[:-1])
            if base is not None:
                return self._past(base)
        if word.endswith("s") and not word.endswith("ss") and len(word) > 2:
            base = self._lookup(word[:-1])
            if base is not None:
                return self._plural(base)

        out = self._oov(word)
        # devoice a rule-produced past-tense D after an unvoiced consonant
        if (word.endswith("ed") and len(out) >= 2 and out[-1] == "D"
                and out[-2] in ("P", "K", "F", "S", "SH", "CH", "TH")):
            out[-1] = "T"
        return out

    def __call__(self, text: str) -> List[str]:
        """g2p_en-style interface: phones for the whole text with ' ' tokens
        between words (general_utils.py:63-64 converts those to SIL)."""
        out: List[str] = []
        for i, w in enumerate(text.split()):
            if i > 0:
                out.append(" ")
            out.extend(self.word_to_phonemes(w))
        return out


_DEFAULT_G2P: Optional[G2p] = None


def sentence_to_phonemes(
    transcription: str, g2p: Optional[G2p] = None
) -> Tuple[List[str], str]:
    """Text → (phoneme strings incl. SIL word separators, cleaned text).

    Exact output contract of the reference ``sentence_to_phonemes``
    (general_utils.py:51-74): punctuation removed, SIL between words and one
    SIL appended at the end; empty text → ['SIL'].
    """
    global _DEFAULT_G2P
    if g2p is None:
        if _DEFAULT_G2P is None:
            _DEFAULT_G2P = G2p()
        g2p = _DEFAULT_G2P

    transcription = remove_punctuation(transcription)
    if len(transcription) == 0:
        return ["SIL"], transcription
    phonemes: List[str] = []
    for p in g2p(transcription):
        if p == " ":
            phonemes.append("SIL")
            continue
        p = re.sub(r"[0-9]", "", p)
        if re.match(r"[A-Z]+", p):
            phonemes.append(p)
    phonemes.append("SIL")
    return phonemes, transcription


_PHONE_TO_MODEL_ID = {p: i for i, p in enumerate(LOGIT_TO_PHONEME)}
_PHONE_TO_MODEL_ID["SIL"] = SIL_ID_MODEL


def sentence_to_phoneme_ids(transcription: str, g2p: Optional[G2p] = None) -> List[int]:
    """Text → model-channel phoneme ids ([BLANK, phones..., SIL] order) —
    the PER-reference path for arbitrary transcripts."""
    phones, _ = sentence_to_phonemes(transcription, g2p)
    return [_PHONE_TO_MODEL_ID[p] for p in phones]
