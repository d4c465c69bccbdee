"""The small decode world of the device searcher's CPU tests: a 10-word
lexicon with one homophone pair, an 18-sentence corpus, three planted
sentences as noisy log-probs. Imports neither JAX nor the JAX package,
so the files that need only the port's side can run where JAX is absent."""

import numpy as np

LEX = {
    "the": ["DH", "AH"], "cat": ["K", "AE", "T"], "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"], "on": ["AA", "N"], "their": ["DH", "EH", "R"],
    "there": ["DH", "EH", "R"], "is": ["IH", "Z"], "hat": ["HH", "AE", "T"],
    "a": ["AH"],
}
CORPUS = [
    "the cat sat on the mat".split(),
    "there is the cat".split(),
    "the cat is there".split(),
    "there is a mat".split(),
    "the cat sat on the hat".split(),
    "a hat is on the mat".split(),
] * 3
SENTENCES = ["there is the cat", "the cat sat on the mat", "a hat is on the mat"]


def noisy_logprobs(ids, seed, hot=4.0, noise=0.6, frames_per=3):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in ids:
        for _ in range(frames_per):
            row = np.full(41, -hot, np.float32)
            row[pid] = 0.0
            rows.append(row)
        blank = np.full(41, -hot, np.float32)
        blank[0] = 0.0
        rows.append(blank)
    lp = np.stack(rows) + noise * rng.standard_normal((len(rows), 41)).astype(np.float32)
    return lp - np.log(np.exp(lp).sum(-1, keepdims=True))


def batch_of(lps):
    T = max(lp.shape[0] for lp in lps)
    batch = np.full((len(lps), T, 41), -20.0, np.float32)
    for i, lp in enumerate(lps):
        batch[i, : lp.shape[0]] = lp
    return batch, np.asarray([lp.shape[0] for lp in lps], np.int32)
