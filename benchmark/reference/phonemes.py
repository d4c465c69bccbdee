"""The model's output channel order, copied from the program's
``utils/phonemes.py``: [BLANK, 39 ARPAbet phones, SIL]."""

from __future__ import annotations

from typing import List

LOGIT_TO_PHONEME: List[str] = [
    "BLANK",
    "AA", "AE", "AH", "AO", "AW",
    "AY", "B", "CH", "D", "DH",
    "EH", "ER", "EY", "F", "G",
    "HH", "IH", "IY", "JH", "K",
    "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH",
    "T", "TH", "UH", "UW", "V",
    "W", "Y", "Z", "ZH",
    " | ",
]
N_CLASSES = 41
BLANK_ID = 0
SIL_ID_MODEL = 40
