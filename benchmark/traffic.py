"""The one traffic generator: planted trials from a mix's parameters.

A mix (``traffic/<name>.json``) gives ranges, and every seed gets the same
multiset of sizes, drawn in another order: a range [lo, hi] split into n
equal strata gives each stratum's midpoint once (``stratified``), so two
seeds differ in which trial is long and which sentence it carries, not in
how much work a run holds. Sentences are drawn from the decode world's words
(``world.plant_sentence``), features are made on the device from their
planted labels (``world.features``) and held on the host, where the
program's entry points take them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from .world import features, plant_sentence


def stratified(lo: int, hi: int, n: int, rng: np.random.Generator) -> List[int]:
    """n integers covering [lo, hi] in equal strata (each stratum's
    midpoint), in an order drawn from ``rng``."""
    width = (hi - lo + 1) / n
    vals = [lo + int((k + 0.5) * width) for k in range(n)]
    return [vals[i] for i in rng.permutation(n)]


@dataclass
class Trial:
    sentence: str
    labels: np.ndarray      # (T,) planted frame labels, -1 = silence
    phone_ids: List[int]    # phoneme ids with SIL at word ends
    features: np.ndarray    # (T, D) float32


@dataclass
class Session:
    name: str
    day: int
    trials: List[Trial]

    def columns(self) -> Dict:
        """The session in ``load_session_file``'s layout, held in memory."""
        n = len(self.trials)
        return {
            "neural_features": [t.features for t in self.trials],
            "n_time_steps": [t.features.shape[0] for t in self.trials],
            "seq_class_ids": [np.asarray(t.phone_ids, np.int32) for t in self.trials],
            "seq_len": [len(t.phone_ids) for t in self.trials],
            "transcriptions": [None] * n,
            "sentence_label": [t.sentence for t in self.trials],
            "session": [self.name] * n,
            "block_num": [i // 16 for i in range(n)],
            "trial_num": list(range(n)),
        }


def make_trials(lengths: Sequence[int], words, prons, code: torch.Tensor,
                rng: np.random.Generator, gen: torch.Generator, noise: float) -> List[Trial]:
    """Planted trials of the given lengths; their features made in one call
    on ``code``'s device and brought to the host."""
    planted = [plant_sentence(words, prons, rng, int(T)) for T in lengths]
    Tmax = max(int(T) for T in lengths)
    lab = np.full((len(lengths), Tmax), -1, np.int64)
    for i, (_, labels, _) in enumerate(planted):
        lab[i, : labels.shape[0]] = labels
    x = features(code, torch.from_numpy(lab).to(code.device), gen, noise).cpu().numpy()
    return [Trial(s, labels, ids, np.ascontiguousarray(x[i, : labels.shape[0]]))
            for i, (s, labels, ids) in enumerate(planted)]


def session_calls(traffic: Dict, n_days: int, words, prons, code: torch.Tensor,
                  seed: int, noise: float) -> List[List[Session]]:
    """``traffic["calls"]`` evaluation calls, each ``sessions_per_call``
    sessions on distinct days; session sizes stratified over
    ``trials_per_session``, each session's trial lengths over ``bins``, so
    the harness's batches (each session sorted by length, 32 rows a batch)
    hold the same lengths whatever the seed."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=code.device).manual_seed(seed % (2 ** 63))
    calls = []
    for _ in range(int(traffic["calls"])):
        n_s = int(traffic["sessions_per_call"])
        sizes = stratified(*traffic["trials_per_session"], n_s, rng)
        lengths = [T for n in sizes for T in stratified(*traffic["bins"], n, rng)]
        days = rng.choice(n_days, n_s, replace=False)
        trials = make_trials(lengths, words, prons, code, rng, gen, noise)
        sessions, k = [], 0
        for d, n in zip(days, sizes):
            sessions.append(Session(f"day{int(d):02d}", int(d), trials[k: k + n]))
            k += n
        calls.append(sessions)
    return calls


def trial_stream(traffic: Dict, n_days: int, words, prons, code: torch.Tensor,
                 seed: int, noise: float):
    """``traffic["pool"]`` single trials, lengths stratified over ``bins``,
    each on a day drawn from ``n_days``. Returns (trials, days)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=code.device).manual_seed(seed % (2 ** 63))
    n = int(traffic["pool"])
    lengths = stratified(*traffic["bins"], n, rng)
    days = [int(d) for d in rng.integers(0, n_days, n)]
    trials: List[Trial] = []
    for i in range(0, n, 64):   # features made 64 trials a call
        trials += make_trials(lengths[i: i + 64], words, prons, code, rng, gen, noise)
    return trials, days
