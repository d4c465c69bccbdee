"""The online sentence with an LLM other than OPT in the rescorer's place.

The same closed loop as ``drivers/online.py`` (whose ``Cell`` this one
subclasses: the trial, the window, the trace are its), with the LLM built
from the configuration's ``llm`` block: DeepSeek-V2 (``llm`` holds its
config.json keys) through the program's ``DeepseekV2Rescorer`` on the
shared packed scorer, its weights drawn on the card from the seed
(``reference/deepseek_v2.draw_weights``).

The comparison follows the online cell's, on a sample drawn from the seed
with the longest trial in it, and adds the routing. Before the program is
freed, each sampled trial's served rows go once more through the program's
packed forward, which records each MoE layer's chosen experts. The float32
reference (the program's own bf16 weight values, one layer after another)
then mixes those experts with its own router's probabilities, because a
top-k is not continuous in its input:

* ``route_gap``: over the rows' tokens and MoE layers, the reference's
  router logit of its k-th ranked expert less its lowest logit among the k
  the program chose (0 when the sets agree);
* ``llm_gap``: the widest |served − reference| score of a served row;
* ``posterior_gap`` and ``blend_gap`` as in the online cell.

Under the float8 control the reference in e4m3 takes the program's place,
routing on its own.
"""

from __future__ import annotations

import math
import os
import statistics
from typing import Dict, List

import numpy as np
import torch

from ..reference.decode import RefDecoder
from ..reference.deepseek_v2 import draw_weights, sequence_scores
from ..reference.gru import log_posteriors
from ..reference.opt import word_hash_encode
from ..reference.rescore import _clean_text, augment_nbest
from ..traffic import trial_stream
from . import common
from . import online


class Cell(online.Cell):
    def setup(self) -> None:
        from b2txt_tpu_torch.decode.deepseek_lm import DeepseekV2Config, DeepseekV2Rescorer
        from b2txt_tpu_torch.decode.packed_scorer import word_hash_encode as program_encode
        from b2txt_tpu_torch.evaluate.harness import run_single_decoding_step
        from b2txt_tpu_torch.serve import DecoderService

        cfg = self.config
        (self.world_dir, words, prons, lexicon, lm,
         unpruned) = common.program_world(cfg)
        dcfg = common.decode_config(cfg)
        lcfg = DeepseekV2Config(**cfg["llm"])
        self.llm_weights = self._draw()
        self.rescorer = DeepseekV2Rescorer(
            lcfg, program_encode(lcfg.vocab_size), params=self.llm_weights,
            device=self.device, max_len=int(cfg["rescorer"]["max_len"]),
            compute_dtype=getattr(torch, cfg["rescorer"]["compute_dtype"]))
        self.service = DecoderService(
            lexicon, lm, dcfg, rescore_lm=unpruned, llm=self.rescorer, channel_order="model",
            searcher_backend="native", arpa_path=os.path.join(self.world_dir, "lm.arpa"),
            lexicon_path=os.path.join(self.world_dir, "lexicon.txt"))
        self.tc, self.model, self.sd, code = common.program_model(cfg, self.seed, self.device)
        self.dtype = common.compute_dtype(cfg)
        self.step = run_single_decoding_step
        self.trials, self.days = trial_stream(
            self.traffic, int(cfg["model"]["n_days"]), words, prons, code, self.seed,
            float(self.traffic["feature_noise"]))
        # warm up: every trial of the pool, which the window goes round, so
        # the rescorer meets each of its packed shapes (one graph each) here
        for i in range(len(self.trials)):
            self._one(i, record=False)

    def _draw(self) -> Dict[str, torch.Tensor]:
        """The LLM's bf16 weights on the card, from the seed, every matrix
        N(0, ``llm_init_std``^2)."""
        cfg = self.config
        return draw_weights(cfg["llm"], self.seed, self.device, torch.bfloat16,
                            float(cfg["llm_init_std"]))

    def _rows(self, final) -> List[str]:
        """The texts the rescorer scored for a FinalOutput, in its order."""
        return [_clean_text(r[0].strip()) for r in final.nbest]

    def detail(self) -> Dict:
        """The window, its trials, and what the LLM scored a trial: rows and
        tokens under the cell's tokenizer."""
        enc = word_hash_encode(self.config["llm"]["vocab_size"])
        max_len = int(self.config["rescorer"]["max_len"])
        rows = [len(f.nbest) for _, _, f in self.done]
        tokens = [sum(len(enc(t, max_len)) for t in self._rows(f)) for _, _, f in self.done]

        def brief(xs):
            return {"mean": statistics.fmean(xs), "p50": statistics.median(xs), "max": max(xs)}

        return {"window_s": self.window_s, "trials": len(self.done),
                "llm_rows_per_trial": brief(rows), "llm_tokens_per_trial": brief(tokens)}

    def _sample(self) -> List[int]:
        longest = max(range(len(self.done)),
                      key=lambda j: self.trials[self.done[j][0]].features.shape[0])
        return common.sample_indices(len(self.done), int(self.traffic["check_trials"]),
                                     self.seed, [longest])

    def _program_routing(self, texts: List[str]) -> List[List[torch.Tensor]]:
        """Each text's chosen experts per MoE layer ((tokens, k), on the
        host), from the program's packed forward over the same rows in the
        same order as the timed path's."""
        from b2txt_tpu_torch.utils.device import upload

        resc = self.rescorer
        ids = [resc.encode(t, resc.max_len) for t in texts]
        tokens, seg, pos, _ = resc._pack_arrays(ids)
        routing: List = []
        with torch.inference_mode():
            tok, sg, ps = (upload(a, self.device) for a in (tokens, seg, pos))
            resc.model(tok, (sg > 0).float(), resc.compute_dtype, positions=ps,
                       segment_ids=sg, routing=routing)
        layers = [idx.cpu().numpy() for idx, _ in routing]
        out = []
        for i in range(len(texts)):
            r, c = np.nonzero(seg == i + 1)
            at = np.argsort(pos[r, c], kind="stable")
            out.append([torch.from_numpy(x[r[at], c[at]]) for x in layers])
        return out

    def free(self) -> None:
        self.pick = self._sample()
        self.routing = {j: self._program_routing(self._rows(self.done[j][2]))
                        for j in self.pick if self.done[j][2].nbest}
        del self.rescorer, self.llm_weights
        del self.service, self.model, self.step

    # ------------------------------------------------------------ check
    def check(self, control: str = "") -> Dict[str, float]:
        cfg = self.config
        m, dec, lcfg = cfg["model"], cfg["decode"], cfg["llm"]
        scale, alpha = float(dec["acoustic_scale"]), float(dec["alpha"])
        ref = RefDecoder(self.world_dir, dec)
        weights = self._draw()
        enc = word_hash_encode(lcfg["vocab_size"])
        max_len = int(cfg["rescorer"]["max_len"])
        gaps = {"route_gap": 0.0}

        def llm(texts, follow=None, ctl=False):
            """{text: score} and {text: chosen experts per layer}; with
            ``follow`` ({text: per layer}), the MoE layers mix those."""
            if not texts:
                return {}, {}
            ids = [enc(_clean_text(t.strip()), max_len) for t in texts]
            fl = None
            if follow is not None:
                fl = [torch.cat([follow[t][k] for t in texts])
                      for k in range(len(follow[texts[0]]))]
            scores, chosen, gap = sequence_scores(weights, lcfg, ids, self.device, ctl, fl)
            gaps["route_gap"] = max(gaps["route_gap"], gap)
            cuts = np.cumsum([0] + [len(s) for s in ids])
            per = {t: [c[cuts[i]: cuts[i + 1]].cpu() for c in chosen]
                   for i, t in enumerate(texts)}
            return dict(zip(texts, scores)), per

        def blended(rows, scores):
            return {r[0]: scale * r[1] + (1 - alpha) * r[2] + alpha * scores[r[0]] for r in rows}

        aug = dict(top_candidates_to_augment=int(dec["top_candidates_to_augment"]),
                   acoustic_scale=scale, score_penalty_percent=float(dec["score_penalty_percent"]))
        post, llm_gap, blend_gap = 0.0, 0.0, 0.0
        floor = float(self.traffic["posterior_floor"])
        for j in self.pick:
            i, logits, final = self.done[j]
            trial, day = self.trials[i], self.days[i]
            ref_lp = log_posteriors(self.sd, trial.features, day, m, self.device)
            if control:
                served_lp = log_posteriors(self.sd, trial.features, day, m, self.device,
                                           control=True)
                rows = augment_nbest(ref.nbest(served_lp), **aug)
                s_llm, follow = llm(list(dict.fromkeys(r[0] for r in rows)), ctl=True)
                tot = blended(rows, s_llm)
                served_rows = [(r[0], r[1], r[2], s_llm[r[0]], tot[r[0]]) for r in rows]
                served_best = max(tot, key=tot.get) if tot else ""
            else:
                x = logits.astype(np.float64)
                x = x - x.max(-1, keepdims=True)
                served_lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
                served_rows = [(r[0].strip(),) + tuple(r[1:]) for r in final.nbest]
                served_best = final.sentence.strip()
                follow = dict(zip((r[0] for r in served_rows), self.routing.get(j, [])))
            post = max(post, common.posterior_gap(served_lp, ref_lp, floor))
            ref_rows = augment_nbest(ref.nbest(served_lp), **aug)
            # the served rows following the program's experts; any row only
            # the reference holds, routed by the reference itself
            served_texts = list(dict.fromkeys(r[0] for r in served_rows))
            ref_llm, _ = llm(served_texts, follow)
            ref_llm.update(llm([r[0] for r in ref_rows if r[0] not in ref_llm])[0])
            llm_gap = max([llm_gap] + [abs(r[3] - ref_llm[r[0]]) for r in served_rows])
            ref_tot = blended(ref_rows, ref_llm)
            gaps_j = [abs(r[4] - ref_tot[r[0]]) for r in served_rows if r[0] in ref_tot]
            if served_best in ref_tot and gaps_j:
                gaps_j.append(max(ref_tot.values()) - ref_tot[served_best])
                blend_gap = max([blend_gap] + gaps_j)
            else:
                blend_gap = math.inf
        return {"posterior_gap": post, "route_gap": gaps["route_gap"], "llm_gap": llm_gap,
                "blend_gap": blend_gap}
