#!/usr/bin/env python
"""Quality-max finalize: deep lattice n-best through the standard service.

Counterpart of ``examples/lattice_demo.py``. The reference extracts a
100-deep n-best from its determinized Kaldi lattice and feeds it to the OPT
rescorer (language-model-standalone.py:567-660). This demo shows the
rebuild's equivalent on ambiguous (soft-posterior) utterances: the pool
finalize collapses to a handful of candidates, while
``DecodeConfig(lattice_nbest=True)`` with the native (C++) backend returns a
deep, exactly scored candidate list, which often fixes the top-1 outright.
Both searchers are the native one, on the host.

    python -m b2txt_tpu_torch.examples.lattice_demo
"""

import numpy as np


def main(n_utts: int = 6, seed: int = 0, verbose: bool = True):
    from ..data.synthetic import ctc_logprobs
    from ..lm import Lexicon, train_ngram
    from ..serve.service import DecoderService
    from ..utils.config import DecodeConfig
    from ..utils.metrics import edit_distance
    from ..utils.phonemes import LOGIT_TO_PHONEME

    rng = np.random.default_rng(seed)
    phones = LOGIT_TO_PHONEME[1:40]
    words = {}
    while len(words) < 800:
        L = rng.integers(3, 8)
        pron = [phones[i] for i in rng.integers(0, 39, L)]
        words["w" + "".join(p.lower() for p in pron)] = pron
    wl = list(words)
    lex = Lexicon.from_words(words)
    sents = [" ".join(wl[i] for i in rng.integers(0, 800, 4))
             for _ in range(60)]
    lm = train_ngram([s.split() for s in sents], order=3)

    base = dict(acoustic_scale=0.325, blank_penalty=90.0, nbest=50,
                first_beam_size=8, sum_mode=False)
    pool_svc = DecoderService(
        lex, lm, DecodeConfig(beam_width=48, **base),
        searcher_backend="native", channel_order="model")
    lat_svc = DecoderService(
        lex, lm, DecodeConfig(beam_width=512, lattice_beam=12.0,
                              lattice_nbest=True, **base),
        searcher_backend="native", channel_order="model")

    stats = {"pool": [0, 0, 0], "lattice": [0, 0, 0]}  # dist, total, depth
    for sent in sents[:n_utts]:
        ids = lex.sentence_to_phonemes(sent)
        lp = ctc_logprobs(rng, ids, noise=2.2)  # ambiguous regime
        ref = sent.split()
        for name, svc in (("pool", pool_svc), ("lattice", lat_svc)):
            svc.reset()
            out = svc.decode_utterance(lp)
            cands = [c[0] for c in out.nbest] or [""]
            stats[name][0] += edit_distance(ref, out.sentence.split())
            stats[name][1] += len(ref)
            stats[name][2] += len(cands)
            if verbose and name == "lattice":
                oracle = min(edit_distance(ref, c.split()) for c in cands)
                print(f"  truth: {sent}")
                print(f"  pool -> {pool_out.sentence!r}"
                      f"  ({len(pool_out.nbest)} candidates)")
                print(f"  lat  -> {out.sentence!r}"
                      f"  ({len(cands)} candidates, oracle dist {oracle})")
                print()
            if name == "pool":
                pool_out = out
    res = {
        name: {"top1_wer": round(d / t, 3), "mean_depth": round(n / n_utts, 1)}
        for name, (d, t, n) in stats.items()
    }
    if verbose:
        print(res)
    return res


if __name__ == "__main__":
    main()
