"""The decode options the reference searcher reads, copied from the
program's ``utils/config.DecodeConfig`` (same names and defaults)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass
class DecodeConfig:
    max_active: int = 7000
    min_active: int = 200
    beam: float = 17.0
    lattice_beam: float = 8.0
    acoustic_scale: float = 0.325
    ctc_blank_skip_threshold: float = 1.0
    length_penalty: float = 0.0
    nbest: int = 100
    blank_penalty: float = 90.0
    alpha: float = 0.55
    do_opt: bool = False
    rescore: bool = False
    top_candidates_to_augment: int = 20
    score_penalty_percent: float = 0.01
    beam_width: int = 128
    first_beam_size: int = 0
    sum_mode: bool = True
    lattice_nbest: bool = False

    def replace(self, **kw) -> "DecodeConfig":
        return dataclasses.replace(self, **kw)
