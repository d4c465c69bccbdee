"""The port's ``analysis`` package (figure computations, the notebooks'
pickle formats and their panels) against the JAX package's on the same
inputs: the same numbers, the same panel files."""

import numpy as np
import pytest

from b2txt_tpu import analysis as ref
from b2txt_tpu.analysis import notebook_data as ref_nb
from b2txt_tpu_torch import analysis as ours
from b2txt_tpu_torch.analysis import notebook_data as ours_nb


def copy_task(rng):
    """The t15_copyTask.pkl schema (figure_2.ipynb cell 3)."""
    phones = [["DH", "AH", "SIL", "K", "AE", "T", "SIL"],
              ["DH", "AH", "SIL", "M", "AE", "T", "SIL"]]
    return {
        "post_implant_day": [100, 100, 150, 150, 180, 180],
        "vocab_size": [50, 125000, 50, 125000, 50, 125000],
        "cue_sentence": ["the cat", "the mat", "a hat", "the cat", "a cat", "the hat"],
        "cue_sentence_phonemes": [phones[0]] * 6,
        "decoded_phonemes_raw": [phones[0]] * 3 + [phones[1]] * 3,
        "decoded_sentence": ["the cat", "the mat", "a hat", "the mat", "cat", "the hat"],
        "decoded_logits": [rng.standard_normal((60, 41)).astype(np.float32) for _ in range(6)],
    }


PERSONAL_USE = {
    "trialized_info": {
        "correctness_rating": ["correct", "correct", "mostly correct", "incorrect",
                               "one word wrong", "correct", "blank trial", "no user rating"],
        "post_implant_day": [100, 100, 100, 150, 150, 150, 200, 200],
    },
    "total_use_time": 10.0,
    "total_trial_count": 8,
}


def test_figure_computations_match_jax(rng):
    refs = [["a", "b"], ["a", "b", "c"], ["x"], ["p", "q"]]
    hyps = [["a", "b"], ["a", "c", "c"], ["y"], ["q"]]
    days = ["d1", "d1", "d2", "d2"]
    assert (ours.per_day_error_rates(refs, hyps, days, n_resamples=200)
            == ref.per_day_error_rates(refs, hyps, days, n_resamples=200))
    trials = [{"day": d, "corpus": c, "reference": r, "decoded": h}
              for d, c, r, h in [("d1", "50_word", "The cat.", "the cat"),
                                 ("d1", "125k", "a hat", "the hat"),
                                 ("d2", "50_word", "the mat!", "mat"),
                                 ("d2", "125k", "the cat sat", "the cat sat")]]
    assert (ours.vocab_condition_comparison(trials, n_resamples=200)
            == ref.vocab_condition_comparison(trials, n_resamples=200))
    logits = rng.standard_normal((50, 41)).astype(np.float32)
    a, b = ours.logit_raster(logits), ref.logit_raster(logits)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    a, b = ours.cumulative_usage([1.0, 2.5, 0.5], [30, 50, 20]), ref.cumulative_usage(
        [1.0, 2.5, 0.5], [30, 50, 20])
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    args = ([10, 20, 7], [60.0, 30.0, 0.0], ["d1", "d1", "d2"])
    assert ours.words_per_minute(*args) == ref.words_per_minute(*args)


@pytest.mark.parametrize("metric", ["WER", "PER"])
def test_copy_task_error_rates_match_jax(rng, metric):
    dat = copy_task(rng)
    assert (ours.copy_task_error_rates(dat, metric, n_resamples=300)
            == ref.copy_task_error_rates(dat, metric, n_resamples=300))


def test_personal_use_summary_matches_jax():
    assert ours.personal_use_summary(PERSONAL_USE) == ref.personal_use_summary(PERSONAL_USE)


@pytest.mark.parametrize("figure", [2, 4])
def test_render_figure_writes_the_jax_panels(tmp_path, rng, figure):
    """The same panel files, byte for byte (matplotlib draws both)."""
    if figure == 2:
        dat = copy_task(rng)
        got = ours_nb.render_figure_2(dat, str(tmp_path / "port"), n_resamples=200)
        want = ref_nb.render_figure_2(dat, str(tmp_path / "jax"), n_resamples=200)
    else:
        got = ours_nb.render_figure_4(PERSONAL_USE, str(tmp_path / "port"))
        want = ref_nb.render_figure_4(PERSONAL_USE, str(tmp_path / "jax"))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert len(got) == 3
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_plot_names_resolve_lazily():
    """``plot_*`` are the plots module's functions, reached through the
    package without importing matplotlib at the package's import."""
    from b2txt_tpu_torch.analysis import plots

    for name in ref.__dict__:
        if name.startswith("plot_"):
            assert getattr(ours, name) is getattr(plots, name)
    with pytest.raises(AttributeError):
        ours.plot_nothing
