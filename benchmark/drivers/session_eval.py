"""Session evaluation, a closed loop.

The window calls the program's ``evaluate.harness.evaluate_session_data``
(the harness's batch of 32 and time bucket of 128) again and again, each
call over one pool entry of planted sessions held in memory, with a
``DecoderService`` around the searcher and the unpruned n-gram's rescore:
``scripts/evaluate_model.py``'s path after the HDF5 read. The traffic mix
names the searcher (``searcher_backend``: ``device``, the default, or
``native``, ``python``); with the device searcher the posteriors stay on
the card (``device_resident``). ``sentences_per_s`` is every trial
finished in the window over the window's time.

The comparison takes a sample of the finished trials, drawn from the seed
with the longest among them. Their served log-probs are held against
float32 stage 1 from the features; their n-best lists against the python
searcher and the unpruned rescore run on the log-probs the program served,
because a beam's pruning is not continuous in its input (a rounding can
prune a sentence's best alignment).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..harness import Spans
from ..reference.decode import RefDecoder
from ..reference.gru import log_posteriors, n_frames
from ..traffic import Session, session_calls
from . import common


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.spans = Spans()
        self.attempted = 0
        self.failed = 0
        self.done: List = []       # (call index, evaluate output, captured finals)

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from b2txt_tpu_torch.evaluate.harness import evaluate_session_data
        from b2txt_tpu_torch.serve import DecoderService

        cfg = self.config
        (self.world_dir, words, prons, lexicon, lm,
         unpruned) = common.program_world(cfg)
        dcfg = common.decode_config(cfg)
        backend = self.traffic.get("searcher_backend", "device")
        self.device_resident = backend == "device"
        searcher = None
        if backend == "device":
            from b2txt_tpu_torch.decode.lmbeam_device import DeviceLexiconBeamSearch

            searcher = DeviceLexiconBeamSearch(lexicon, lm, dcfg, device=self.device)
        self.service = DecoderService(
            lexicon, lm, dcfg, rescore_lm=unpruned, channel_order="model",
            searcher_backend=backend, searcher=searcher,
            arpa_path=os.path.join(self.world_dir, "lm.arpa"),
            lexicon_path=os.path.join(self.world_dir, "lexicon.txt"))
        self.tc, self.model, self.sd, code = common.program_model(cfg, self.seed, self.device)
        self.dtype = common.compute_dtype(cfg)
        self.evaluate = evaluate_session_data
        self.calls = session_calls(self.traffic, int(cfg["model"]["n_days"]), words, prons,
                                   code, self.seed, float(self.traffic["feature_noise"]))
        # capture what the service hands back: the harness keeps only the
        # sentences, the comparison reads the n-best lists (and, on the card,
        # the posteriors the search read)
        self._captured: List = []
        name = "decode_batched_utterances" if self.device_resident else "decode_utterances"
        orig = getattr(self.service, name)

        def spy(inputs, *args, **kwargs):
            outs = orig(inputs, *args, **kwargs)
            self._captured.append((list(inputs), outs))
            return outs

        setattr(self.service, name, spy)
        # warm up what the window's calls use: a full batch of the pool's
        # longest trials (the largest buffers the search and stage 1
        # allocate), then one trial padded to each time bucket
        tb, B = int(self.traffic["time_bucket"]), int(self.traffic["batch_size"])
        lo, hi = self.traffic["bins"]
        pool = sorted((t for s in self.calls[0] for t in s.trials),
                      key=lambda t: t.features.shape[0])
        warm = [Session("day00", 0, pool[-B:])]
        for T_pad in range(-(-lo // tb) * tb, -(-hi // tb) * tb + 1, tb):
            trial = [t for t in pool if t.features.shape[0] <= min(T_pad, hi)][-1]
            warm.append(Session(f"day{len(warm):02d}", len(warm), [trial]))
        self._run_call(warm)
        self._captured.clear()

    def _run_call(self, sessions: List[Session]):
        return self.evaluate(self.model, self.tc, [(s.name, s.columns()) for s in sessions],
                             decoder=self.service, compute_dtype=self.dtype,
                             device_resident=self.device_resident)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        n, k = 0, 0
        t_start = time.perf_counter()
        while True:
            sessions = self.calls[k % len(self.calls)]
            t0 = time.perf_counter()
            out = self._run_call(sessions)
            t1 = time.perf_counter()
            self.done.append((k % len(self.calls), out, self._captured.pop()))
            self.spans.add("call", t1 - t0)
            self.spans.add("lm_decode", out["lm_decode_time"])
            n += len(out["trials"])
            self.failed += sum(1 for t in out["trials"] if not t.decoded_sentence)
            self._count_work(sessions)
            k += 1
            if t1 - t_start >= seconds:
                break
        self.window_s = t1 - t_start
        self.attempted = n

    def _count_work(self, sessions: List[Session]) -> None:
        """Frames the search runs (each batch to its longest trial) and the
        trials' own frames and bins."""
        m = self.config["model"]
        B = int(self.traffic["batch_size"])
        for s in sessions:
            ps = sorted(n_frames(m, t.features.shape[0]) for t in s.trials)
            self.spans.count("search_frames", sum(max(ps[i: i + B]) for i in range(0, len(ps), B)))
            self.spans.count("trial_frames", sum(ps))
            self.spans.count("trial_bins", sum(t.features.shape[0] for t in s.trials))
            self.spans.count("trials", len(ps))

    def detail(self) -> Dict:
        """Each evaluation call's seconds and trials, for reading a run."""
        return {"call_s": self.spans.spans.get("call", []),
                "call_trials": [len(out["trials"]) for _, out, _ in self.done]}

    def end_to_end(self) -> Dict[str, float]:
        return {"sentences_per_s": self.attempted / self.window_s}

    def traced(self) -> None:
        """One session of the pool (its smallest) under the profiler."""
        s = min(self.calls[0], key=lambda s: len(s.trials))
        before = dict(self.spans.counters)
        with torch.profiler.record_function("bench.evaluate"):
            self._run_call([s])
        self._captured.clear()
        self._count_work([s])
        self.traced_frames = self.spans.counters["search_frames"] - before["search_frames"]
        for key in ("search_frames", "trial_frames", "trial_bins", "trials"):
            self.spans.counters[key] = before[key]

    def free(self) -> None:
        del self.service, self.model, self.evaluate

    # ------------------------------------------------------------ check
    def check(self, control: str = "") -> Dict[str, float]:
        """Posterior, score and best gaps over the sampled trials."""
        cfg = self.config
        m = cfg["model"]
        scale = float(cfg["decode"]["acoustic_scale"])
        B = int(self.traffic["batch_size"])
        items = []   # (done index, session index, trial index)
        for d, (ci, _, _) in enumerate(self.done):
            for si, s in enumerate(self.calls[ci]):
                items += [(d, si, ti, s.trials[ti].features.shape[0])
                          for ti in range(len(s.trials))]
        longest = max(range(len(items)), key=lambda i: items[i][3])
        pick = common.sample_indices(len(items), int(self.traffic["check_trials"]),
                                     self.seed, [longest])
        ref = RefDecoder(self.world_dir, cfg["decode"])
        post, score, best = 0.0, 0.0, 0.0
        for i in pick:
            d, si, ti, _ = items[i]
            ci, out, (inputs, finals) = self.done[d]
            sessions = self.calls[ci]
            s = sessions[si]
            # the harness's order of trials: sessions in turn, each in its own
            # order; the sentence it reported for this trial
            k = sum(len(sessions[sj].trials) for sj in range(si)) + ti
            served_best = out["trials"][k].decoded_sentence or ""
            if self.device_resident:
                # on the card: each session sorted by length in batches of B,
                # finals in that order
                base_b, base_f = 0, 0
                for sj in range(si):
                    nt = len(sessions[sj].trials)
                    base_b += -(-nt // B)
                    base_f += nt
                order = np.argsort([t.features.shape[0] for t in s.trials])
                pos = int(np.nonzero(order == ti)[0][0])
                lp_b, lens = inputs[base_b + pos // B]
                P = int(lens[pos % B])
                served_lp = lp_b[pos % B, :P].float().cpu().numpy()
                final = finals[base_f + pos]
            else:
                # on the host: one logits array a trial, in the harness's order
                x = np.asarray(inputs[k], np.float64)
                x = x - x.max(-1, keepdims=True)
                served_lp = x - np.log(np.exp(x).sum(-1, keepdims=True))
                final = finals[k]
            trial = s.trials[ti]
            ref_lp = log_posteriors(self.sd, trial.features, s.day, m, self.device)
            if control:
                # the reference in the precision below stands in the program's place
                served_lp = log_posteriors(self.sd, trial.features, s.day, m, self.device,
                                           control=True)
                served_rows = [r + (0.0, scale * r[1] + r[2]) for r in ref.nbest(served_lp)]
                served_best = served_rows[0][0] if served_rows else ""
            else:
                served_rows = final.nbest
            # stage 1 from the features; the search from the posteriors it was
            # served, since a beam's pruning is not continuous in its input
            post = max(post, common.posterior_gap(served_lp, ref_lp, float(
                self.traffic["posterior_floor"])))
            rows = ref.nbest(served_lp)
            sg, bg = common.nbest_gaps(served_rows, rows, served_best, scale)
            score, best = max(score, sg), max(best, bg)
        return {"posterior_gap": post, "score_gap": score, "best_gap": best}
