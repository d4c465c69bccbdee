"""The JAX device searcher with its Viterbi merge and its beam window made
the host searchers'.

The host searchers (``decode/lmbeam.py`` of both packages, the native
decoder, the benchmark's reference) merge two paths into one beam per score
component: the component keeps its best path's score AND that path's
acoustic score. The JAX package's device searcher merges the acoustic
columns by their own max instead, so in Viterbi mode a merged beam can
report a larger acoustic score than any single path has; the port's device
searcher follows the host searchers. The port's tests that hold it to the
JAX device searcher run that searcher with this one function,
``lmbeam_jax._seg_merge4``, swapped for the host semantics (among paths of
equal score, the larger acoustic), and everything else as the JAX package
has it. Sum mode is unchanged: both keep the acoustic max there.

The host searchers also drop, each frame, the beams more than the config's
``beam`` below the best, which the JAX device searcher keeps and the port
drops; ``host_window_expand`` sets them to NEG after the JAX frame step.
"""

import contextlib

import jax
import jax.numpy as jnp
import pytest

from b2txt_tpu.decode import lmbeam_jax

_JAX_SEG_MERGE4 = lmbeam_jax._seg_merge4
_JAX_EXPAND = lmbeam_jax.DeviceLexiconBeamSearch._expand


def host_seg_merge4(values, starts, sum_mode: bool):
    if sum_mode:
        return _JAX_SEG_MERGE4(values, starts, sum_mode)

    def op(a, b):
        va, fa = a
        vb, fb = b
        rank = jnp.maximum(va[..., :2], vb[..., :2])
        # per component, the pair (score, acoustic) with the larger score;
        # equal scores keep the larger acoustic
        ac = jnp.where(vb[..., :2] > va[..., :2], vb[..., 2:],
                       jnp.where(va[..., :2] > vb[..., :2], va[..., 2:],
                                 jnp.maximum(va[..., 2:], vb[..., 2:])))
        merged = jnp.concatenate([rank, ac], axis=-1)
        return jnp.where(fb[..., None], vb, merged), fa | fb

    out, _ = jax.lax.associative_scan(op, (values, starts))
    return out


def host_window_expand(self, state, lp, scale, length_penalty, first_beam=None,
                       sum_mode=True):
    new, parents, syms, words = _JAX_EXPAND(self, state, lp, scale, length_penalty,
                                            first_beam, sum_mode)
    beam = float(self.config.beam)
    if beam <= 0:
        return new, parents, syms, words
    total = (lmbeam_jax._logaddexp(new.s, new.ns) if sum_mode
             else jnp.maximum(new.s, new.ns))
    keep = total >= jnp.max(total) - beam
    neg = jnp.float32(lmbeam_jax.NEG)
    new = new._replace(**{f: jnp.where(keep, getattr(new, f), neg)
                          for f in ("s", "ns", "ac_s", "ac_ns")})
    return new, parents, syms, words


@contextlib.contextmanager
def host_semantics():
    """JAX device searchers traced inside merge and window as the host
    searchers do (their jitted steps are traced per searcher, at its first
    call)."""
    lmbeam_jax._seg_merge4 = host_seg_merge4
    lmbeam_jax.DeviceLexiconBeamSearch._expand = host_window_expand
    try:
        yield
    finally:
        lmbeam_jax._seg_merge4 = _JAX_SEG_MERGE4
        lmbeam_jax.DeviceLexiconBeamSearch._expand = _JAX_EXPAND


@pytest.fixture(scope="module", autouse=True)
def host_viterbi_merge():
    """``host_semantics`` over the whole module (its tests and fixtures)."""
    with host_semantics():
        yield
