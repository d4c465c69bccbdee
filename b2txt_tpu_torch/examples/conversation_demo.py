#!/usr/bin/env python
"""Conversation-mode (contextual) decoding with b2txt_tpu_torch.

Counterpart of ``examples/conversation_demo.py``. The reference's
personal-use mode (the figure-4 regime) keeps a running conversation context
and prepends it to every n-best hypothesis before LLM rescoring
(``language-model-standalone.py:165-199``, the
``contextual_decoding_current_context`` Redis key), so earlier turns
disambiguate later ones. This demo shows that flow end to end at small scale:

  A. "sun" and "son" are HOMOPHONES (identical phonemes [S AH N]): the beam
     search produces both parses with identical acoustic scores, and the
     neutral decode LM ties them. The conversation context alone flips the
     final pick ("look at the sky" → "the sun is bright here";
     "he hugged his family" → "the son is bright here") from the SAME
     posteriors. Host only.
  B. the OPT rescorer scores context+hypothesis through its prefix-KV cache
     (the context forward runs ONCE, candidates cross-attend to the cached
     keys/values, ``decode/opt_lm.py`` ``score_prefix_packed_fn``) instead
     of re-running the context inside every candidate as the reference
     does. It runs on the CUDA card unless ``--device cpu`` is given.

    python -m b2txt_tpu_torch.examples.conversation_demo [--device cpu]

``context_scoring`` takes the OPT config, its weights and the dtype, so a
caller can run Part B at another model size.
"""

from __future__ import annotations

import argparse
from typing import Union

import numpy as np
import torch

from ..decode import opt_lm
from ..decode.rescore import NGramLLMAdapter
from ..lm import Lexicon, train_ngram
from ..serve import DecoderService
from ..utils.config import DecodeConfig
from ..utils.device import resolve_device

LEX = {
    "the": ["DH", "AH"],
    "sun": ["S", "AH", "N"],   # homophone pair: identical pronunciation,
    "son": ["S", "AH", "N"],   # only context can tell them apart
    "is": ["IH", "Z"],
    "bright": ["B", "R", "AY", "T"],
    "here": ["HH", "IY", "R"],
    "sky": ["S", "K", "AY"],
    "family": ["F", "AE", "M", "L", "IY"],
    "look": ["L", "UH", "K"],
    "at": ["AE", "T"],
    "his": ["HH", "IH", "Z"],
    "he": ["HH", "IY"],
    "hugged": ["HH", "AH", "G", "D"],
}

# neutral decode-LM corpus: sun and son exactly as frequent, so the n-gram
# fused into the beam search cannot break the homophone tie by itself
DECODE_CORPUS = [
    "the sun is bright here".split(),
    "the son is bright here".split(),
    "look at the sky".split(),
    "he hugged his family".split(),
] * 6

# the "LLM": a larger-context n-gram over conversation-shaped text — enough
# signal that sky-context prefers sun and family-context prefers son once
# llm_rescore prepends the context (exactly the reference blend, :231-251)
LLM_CORPUS = [
    "look at the sky the sun is bright here".split(),
    "at the sky the sun is bright".split(),
    "the sky the sun".split(),
    "he hugged his family the son is bright here".split(),
    "his family the son is here".split(),
    "the family the son".split(),
] * 6

CONTEXTS = ("look at the sky", "he hugged his family")
TEXTS = ["the sun is bright here", "the son is bright here"]
# f32 prefix-KV against concatenated scoring: the same sums, reordered
TINY_TOL = dict(rtol=1e-4, atol=1e-3)


def clean_logits(phoneme_ids, n_classes=41, frames_per=3, hot=6.0):
    rows = []
    for pid in phoneme_ids:
        for _ in range(frames_per):
            row = np.full(n_classes, -hot, np.float32)
            row[pid] = hot
            rows.append(row)
        blank = np.full(n_classes, -hot, np.float32)
        blank[0] = hot
        rows.append(blank)
    return np.stack(rows)


def homophone_picks(say=lambda *a: None) -> dict:
    """Part A: one decode of the same posteriors per conversation context;
    returns {context: final sentence}."""
    lex = Lexicon.from_words(LEX)
    decode_lm = train_ngram(DECODE_CORPUS, order=3)
    llm = NGramLLMAdapter(train_ngram(LLM_CORPUS, order=3))

    svc = DecoderService(
        lex, decode_lm,
        DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=10,
                     do_opt=True, alpha=0.8),
        llm=llm, channel_order="model",
    )

    # the SAME posteriors for every turn: [S AH N] is both words
    logits = clean_logits(lex.sentence_to_phonemes("the sun is bright here"))

    picks = {}
    for context in CONTEXTS:
        svc.set_context(context)           # ← the conversation state
        out = svc.decode_utterance(logits)
        picks[context] = out.sentence
        say(f"context={context!r:32} → {out.sentence!r} "
            f"(confidence {out.confidence:.2f})")
    return picks


def byte_encode(vocab_size: int):
    """The demo's stand-in tokenizer: bytes spread over the vocabulary."""
    return lambda t, n: [(3 + 17 * b) % vocab_size for b in t.encode()][:n]


def context_scoring(cfg: opt_lm.OPTConfig, params=None,
                    device: Union[str, torch.device, None] = None,
                    compute_dtype: torch.dtype = torch.float32) -> dict:
    """Part B: ``TEXTS`` scored after the first of ``CONTEXTS`` through the
    prefix-KV path and by concatenating the context to each text (rows of
    at most 64 tokens). ``params`` is the port's
    OPT state dict (without it, weights drawn from a seeded generator on
    ``device``). Returns both score lists and the prefix-KV run count."""
    device = resolve_device(device)
    if params is None:
        params = opt_lm.init_params(cfg, device, compute_dtype,
                                    torch.Generator(device=device).manual_seed(0))
    enc = byte_encode(cfg.vocab_size)
    resc = opt_lm.OPTRescorer(cfg, params=params, encode=enc, encode_cont=enc,
                              max_len=64, device=device, compute_dtype=compute_dtype)
    context = CONTEXTS[0]
    got = resc.score(TEXTS, context=context)
    want = resc.score([context + " " + t for t in TEXTS])
    return {"prefix_kv": np.asarray(got), "concatenated": np.asarray(want),
            "prefix_runs": resc.prefix_runs}


def main(verbose: bool = True, device: Union[str, torch.device, None] = None) -> dict:
    def say(*a):
        if verbose:
            print(*a)

    device = resolve_device(device)
    picks = homophone_picks(say)
    if picks["look at the sky"] != "the sun is bright here" or \
            picks["he hugged his family"] != "the son is bright here":
        raise RuntimeError(f"the context did not flip the homophone: {picks}")
    say("same acoustics, context flipped the homophone ✓")

    # B: tiny weights here; the path and its parity are what is shown
    scores = context_scoring(opt_lm.OPTConfig.tiny(), device=device)
    if not scores["prefix_runs"]:
        raise RuntimeError("prefix-KV path did not run")
    np.testing.assert_allclose(scores["prefix_kv"], scores["concatenated"], **TINY_TOL)
    say("OPT prefix-KV context scoring == concatenated scoring ✓")
    return picks


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.examples.conversation_demo",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="where the OPT rescorer runs: the CUDA card by default, 'cpu' "
                        "to run on the CPU")
    main(device=p.parse_args().device)
