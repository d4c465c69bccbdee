"""The plain reference's second stage: the python lexicon beam search over
the pruned n-gram, then the unpruned n-gram's rescore of its n-best, as the
reference's language-model process does (``brain_speech_decoder.cc:61-101``).
Everything is rebuilt from the world's raw files."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from .decode_config import DecodeConfig
from .lexicon import Lexicon
from .ngram import NGramLM
from .searcher import LexiconBeamSearch


class RefDecoder:
    def __init__(self, world_dir: str, decode: Dict):
        self.lm = NGramLM.from_arpa(os.path.join(world_dir, "lm.arpa"))
        self.unpruned = NGramLM.from_arpa(os.path.join(world_dir, "lm_unpruned.arpa"))
        self.lexicon = Lexicon.from_file(os.path.join(world_dir, "lexicon.txt"),
                                         vocab=self.lm.vocab)
        names = {f.name for f in dataclasses.fields(DecodeConfig)}
        self.config = DecodeConfig(**{k: v for k, v in decode.items() if k in names})
        # the lattice n-best runs in Kaldi's state space, where hypotheses
        # that share the LM context merge and the merged-away ones become
        # the lattice's alternatives
        state_key = "ngram" if self.config.lattice_nbest else "history"
        self.searcher = LexiconBeamSearch(self.lexicon, self.lm, self.config,
                                          state_key=state_key)

    def nbest(self, log_probs: np.ndarray) -> List[Tuple[str, float, float]]:
        """(sentence, acoustic, unpruned n-gram) rows, best first by the
        searcher, for (P, C) log-probs in the model's channel order."""
        s = self.searcher
        s.reset()
        s.decode(np.asarray(log_probs, np.float64))
        rows = [(r.sentence.strip(), r.ac_score, self.unpruned.sentence_logp(r.sentence.split()))
                for r in s.finish_decoding()]
        scale = self.config.acoustic_scale
        return sorted(rows, key=lambda r: -(scale * r[1] + r[2]))
