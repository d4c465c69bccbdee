"""One participant's trials, one after another: the online sentence.

A closed loop with no think time. Each trial's stage 1 runs on the card
through the program's ``evaluate.harness.run_single_decoding_step`` (one
trial, bf16); its logits go into a ``DecoderService`` around the native
searcher, the unpruned n-gram's rescore and the OPT rescorer, as the
reference's language-model process drives it
(``language-model-standalone.py:567-660``): ``reset``, ``decode_chunk`` in
chunks of ``chunk_frames`` frames, ``finalize``. A trial is timed from its
features being handed over to its ``FinalOutput`` on the host;
``sentence_ms_p50`` and ``sentence_ms_p95`` are taken over every trial of
the window.

The comparison takes a sample of the finished trials, drawn from the seed
with the longest among them. Stage 1's log-probs are held against float32
stage 1 from the features (``posterior_gap``). The rest follows the program
from the posteriors it served, because a beam's pruning is not continuous in
its input (a rounding can prune a sentence's best alignment): the python
searcher's lattice n-best on those posteriors, the unpruned rescore and the
word-swap augmentation give the reference's rows, float32 OPT their scores.
``llm_gap`` is the widest gap of a served row's OPT score; ``blend_gap`` the
widest gap of a served row's alpha-blended total, or of the served pick's
total below the reference's best (inf when a served pick or every served
row is missing from the reference's rows).
"""

from __future__ import annotations

import math
import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import Spans, percentile
from ..reference.decode import RefDecoder
from ..reference.gru import log_posteriors
from ..reference.opt import draw_weights, sequence_scores, word_hash_encode
from ..reference.rescore import _clean_text, augment_nbest
from ..traffic import trial_stream
from . import common


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = Spans()
        self.attempted = 0
        self.failed = 0
        self.done: List = []   # (pool index, served logits, FinalOutput)

    def setup(self) -> None:
        from b2txt_tpu_torch.decode.opt_lm import OPTConfig, OPTRescorer
        from b2txt_tpu_torch.decode.opt_lm import word_hash_encode as program_encode
        from b2txt_tpu_torch.evaluate.harness import run_single_decoding_step
        from b2txt_tpu_torch.serve import DecoderService

        cfg = self.config
        (self.world_dir, words, prons, lexicon, lm,
         unpruned) = common.program_world(cfg)
        dcfg = common.decode_config(cfg)
        ocfg = OPTConfig(**cfg["opt"])
        self.opt_weights = draw_weights(cfg["opt"], self.seed, self.device, torch.bfloat16)
        rescorer = OPTRescorer(ocfg, params=self.opt_weights,
                               encode=program_encode(ocfg.vocab_size),
                               device=self.device, max_len=int(cfg["rescorer"]["max_len"]),
                               compute_dtype=getattr(torch, cfg["rescorer"]["compute_dtype"]))
        self.service = DecoderService(
            lexicon, lm, dcfg, rescore_lm=unpruned, llm=rescorer, channel_order="model",
            searcher_backend="native", arpa_path=os.path.join(self.world_dir, "lm.arpa"),
            lexicon_path=os.path.join(self.world_dir, "lexicon.txt"))
        self.tc, self.model, self.sd, code = common.program_model(cfg, self.seed, self.device)
        self.dtype = common.compute_dtype(cfg)
        self.step = run_single_decoding_step
        self.trials, self.days = trial_stream(
            self.traffic, int(cfg["model"]["n_days"]), words, prons, code, self.seed,
            float(self.traffic["feature_noise"]))
        # warm up: the shortest and the longest trials and a few between
        order = np.argsort([t.features.shape[0] for t in self.trials])
        for i in order[np.linspace(0, len(order) - 1, 6).astype(int)]:
            self._one(int(i), record=False)

    def _one(self, i: int, record: bool = True):
        trial, day = self.trials[i], self.days[i]
        chunk = int(self.traffic["chunk_frames"])
        t0 = time.perf_counter()
        logits = self.step(self.model, trial.features, day, self.tc, self.dtype)
        t1 = time.perf_counter()
        self.service.reset()
        for c in range(0, logits.shape[0], chunk):
            self.service.decode_chunk(logits[c: c + chunk])
        t2 = time.perf_counter()
        final = self.service.finalize()
        t3 = time.perf_counter()
        if record:
            self.spans.add("sentence", t3 - t0)
            self.spans.add("stage1", t1 - t0)
            self.spans.add("chunks", t2 - t1)
            self.spans.add("finalize", t3 - t2)
            self.spans.count("trial_bins", trial.features.shape[0])
            self.spans.count("trial_frames", logits.shape[0])
            self.spans.count("trials", 1)
            self.done.append((i, logits, final))
        return t3

    def window(self, seconds: float) -> None:
        t_start = time.perf_counter()
        k = 0
        while True:
            t_end = self._one(k % len(self.trials))
            k += 1
            if t_end - t_start >= seconds:
                break
        self.window_s = t_end - t_start
        self.attempted = len(self.done)
        self.failed = sum(1 for _, _, f in self.done if not f.sentence)

    def detail(self) -> Dict:
        """The window, its trials, and what OPT scored a trial: the rows of
        each finished trial's n-best (the lattice's, augmented) and their
        tokens under the cell's tokenizer."""
        enc = word_hash_encode(self.config["opt"]["vocab_size"])
        max_len = int(self.config["rescorer"]["max_len"])
        rows = [len(f.nbest) for _, _, f in self.done]
        tokens = [sum(len(enc(_clean_text(r[0].strip()), max_len)) for r in f.nbest)
                  for _, _, f in self.done]

        def brief(xs):
            return {"mean": statistics.fmean(xs), "p50": statistics.median(xs), "max": max(xs)}

        return {"window_s": self.window_s, "trials": len(self.done),
                "opt_rows_per_trial": brief(rows), "opt_tokens_per_trial": brief(tokens)}

    def end_to_end(self) -> Dict[str, float]:
        ms = [1e3 * s for s in self.spans.spans["sentence"]]
        return {"sentence_ms_p50": statistics.median(ms), "sentence_ms_p95": percentile(ms, 95)}

    def traced(self) -> None:
        """``trace_trials`` trials of the pool under the profiler."""
        n = int(self.traffic["trace_trials"])
        saved = (dict(self.spans.counters), {k: list(v) for k, v in self.spans.spans.items()},
                 len(self.done))
        for i in range(n):
            with torch.profiler.record_function("bench.sentence"):
                self._one(i)
        counters, spans, n_done = saved
        del self.done[n_done:]
        self.spans.counters, self.spans.spans = counters, spans

    def free(self) -> None:
        del self.service, self.model, self.step, self.opt_weights

    # ------------------------------------------------------------ check
    def check(self, control: str = "") -> Dict[str, float]:
        cfg = self.config
        m, dec, ocfg = cfg["model"], cfg["decode"], cfg["opt"]
        scale, alpha = float(dec["acoustic_scale"]), float(dec["alpha"])
        longest = max(range(len(self.done)),
                      key=lambda j: self.trials[self.done[j][0]].features.shape[0])
        pick = common.sample_indices(len(self.done), int(self.traffic["check_trials"]),
                                     self.seed, [longest])
        ref = RefDecoder(self.world_dir, dec)
        weights = draw_weights(ocfg, self.seed, self.device, torch.bfloat16)
        enc = word_hash_encode(ocfg["vocab_size"])
        max_len = int(cfg["rescorer"]["max_len"])

        def llm(sentences, ctl=False):
            ids = [enc(_clean_text(s.strip()), max_len) for s in sentences]
            return dict(zip(sentences, sequence_scores(weights, ocfg, ids, self.device, ctl)))

        def blended(rows, scores):
            return {r[0]: scale * r[1] + (1 - alpha) * r[2] + alpha * scores[r[0]] for r in rows}

        aug = dict(top_candidates_to_augment=int(dec["top_candidates_to_augment"]),
                   acoustic_scale=scale, score_penalty_percent=float(dec["score_penalty_percent"]))
        post, llm_gap, blend_gap = 0.0, 0.0, 0.0
        floor = float(self.traffic["posterior_floor"])
        for j in pick:
            i, logits, final = self.done[j]
            trial, day = self.trials[i], self.days[i]
            ref_lp = log_posteriors(self.sd, trial.features, day, m, self.device)
            if control:
                served_lp = log_posteriors(self.sd, trial.features, day, m, self.device,
                                           control=True)
                rows = augment_nbest(ref.nbest(served_lp), **aug)
                s_llm = llm([r[0] for r in rows], ctl=True)
                tot = blended(rows, s_llm)
                served_rows = [(r[0], r[1], r[2], s_llm[r[0]], tot[r[0]]) for r in rows]
                served_best = max(tot, key=tot.get) if tot else ""
            else:
                x = logits.astype(np.float64)
                x = x - x.max(-1, keepdims=True)
                served_lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
                served_rows = [(r[0].strip(),) + tuple(r[1:]) for r in final.nbest]
                served_best = final.sentence.strip()
            # stage 1 from the features; the search from the posteriors it was
            # served, since a beam's pruning is not continuous in its input
            post = max(post, common.posterior_gap(served_lp, ref_lp, floor))
            ref_rows = augment_nbest(ref.nbest(served_lp), **aug)
            ref_llm = llm(list(dict.fromkeys([r[0] for r in ref_rows]
                                             + [r[0] for r in served_rows])))
            llm_gap = max([llm_gap] + [abs(r[3] - ref_llm[r[0]]) for r in served_rows])
            # the blended totals of the served rows and the pick among them,
            # against the reference's n-best scores, OPT scores and blend
            ref_tot = blended(ref_rows, ref_llm)
            gaps = [abs(r[4] - ref_tot[r[0]]) for r in served_rows if r[0] in ref_tot]
            if served_best in ref_tot and gaps:
                gaps.append(max(ref_tot.values()) - ref_tot[served_best])
                blend_gap = max([blend_gap] + gaps)
            else:
                blend_gap = math.inf
        return {"posterior_gap": post, "llm_gap": llm_gap, "blend_gap": blend_gap}
