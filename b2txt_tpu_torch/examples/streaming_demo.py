#!/usr/bin/env python
"""Online (closed-loop) streaming decode with b2txt_tpu_torch.

Counterpart of ``examples/streaming_demo.py``. The reference's production
use is online: neural bins arrive every 20 ms, the GRU advances with carried
hidden state (rnn_model.py:88,122-132), and the LM decoder refines a partial
sentence per chunk (ctc_wfst_beam_search.cc:70-121 incremental search;
language-model-standalone.py:759-785 partial loop). This demo shows both
halves of that flow, on the CUDA card unless ``--device cpu`` is given:

  A. stateful GRU streaming: one 80 ms hop = one patch_size-bin window
     through a single patched GRU step (``GRUDecoder.forward(states=h,
     return_state=True)``; on the card each layer's step is one launch of
     the recurrence kernel at T = 1); the streamed logits are held against
     the offline full-sequence forward;
  B. incremental LM decode: logit chunks stream into ``DecoderService``,
     the partial sentence grows chunk by chunk, ``finalize()`` returns the
     n-best with the reference's 5-tuple scoring.

    python -m b2txt_tpu_torch.examples.streaming_demo [--device cpu]

``stream_gru`` and ``stream_decode`` take the model, its compute dtype, the
searcher backend and the hop count, so a caller can run them at full width.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Union

import numpy as np
import torch

from ..data import synthetic
from ..lm import Lexicon, train_ngram
from ..models.gru_decoder import GRUDecoder
from ..serve import DecoderService
from ..utils import TrainConfig
from ..utils.config import DecodeConfig, ModelConfig
from ..utils.device import resolve_device

# f32 streaming against the offline forward: the same recurrence, but the
# input projections run as (1, 1, ·) products per hop instead of one
# (1, P, ·) product, so only the summation order may differ
STREAM_TOL_F32 = 1e-4


def demo_model_config() -> ModelConfig:
    """The demo's small model: 64 features, 2 × 64 GRU, patch 14/4."""
    cfg = TrainConfig().model
    cfg.n_input_features = 64
    cfg.n_units = 64
    cfg.n_layers = 2
    return cfg


def make_hop(model: GRUDecoder, day: torch.Tensor, compute_dtype: torch.dtype):
    """One online update: (state (L, 1, H), a patch_size-bin window
    (patch_size, D)) → (one logit frame (C,), the next state)."""

    @torch.no_grad()
    def hop(h: torch.Tensor, window: torch.Tensor):
        logits, h2 = model(window[None], day, states=h, return_state=True,
                           compute_dtype=compute_dtype)
        return logits[0, 0], h2

    return hop


def initial_state(model: GRUDecoder, compute_dtype: torch.dtype) -> torch.Tensor:
    """The learned h0 for every layer, (L, 1, H), in the compute dtype: the
    state the offline forward starts from."""
    H = model.h0.shape[-1]
    return model.h0.detach().reshape(1, 1, H).to(compute_dtype).expand(
        model.n_layers, 1, H).contiguous()


def stream_gru(model: Optional[GRUDecoder] = None, compute_dtype: torch.dtype = torch.float32,
               hops: int = 16, device: Union[str, torch.device, None] = None,
               verbose: bool = True) -> dict:
    """Part A: ``hops`` patch windows of fresh bins (day 1, seed 0)
    through the carried-state forward, then the offline forward over the
    same bins. Without ``model``, the demo's small model (3 days) from
    GRUDecoder's own init. Each hop ends with the host reading its frame.
    Returns the streamed and offline frames (float32 numpy), their max
    |diff|, and each hop's host ms."""
    if model is None:
        model = GRUDecoder(demo_model_config(), 3, 41, device=resolve_device(device),
                           generator=torch.Generator().manual_seed(0))
    dev = model.h0.device
    cfg = model.cfg
    patch, stride = cfg.patch_size, cfg.patch_stride
    day = torch.tensor([1], device=dev)
    hop = make_hop(model, day, compute_dtype)

    rng = np.random.default_rng(0)
    T = patch + (hops - 1) * stride
    bins = torch.from_numpy(
        rng.standard_normal((T, cfg.n_input_features)).astype(np.float32)).to(dev)

    h = initial_state(model, compute_dtype)
    streamed, times = [], []
    for t in range(0, T - patch + 1, stride):
        t0 = time.perf_counter()
        frame, h = hop(h, bins[t : t + patch])
        frame = frame.float().cpu().numpy()  # host sync = end of this hop
        times.append((time.perf_counter() - t0) * 1e3)
        streamed.append(frame)
    streamed = np.stack(streamed)

    with torch.no_grad():
        offline = model(bins[None], day, compute_dtype=compute_dtype)[0].float().cpu().numpy()
    err = float(np.abs(streamed - offline).max())
    hop_ms = float(np.median(times[1:])) if len(times) > 1 else times[0]
    if verbose:
        print(f"A. GRU streaming: {len(streamed)} hops, max |streaming - offline| "
              f"{err:.2e}, median hop {hop_ms:.3f} ms on {dev} "
              f"(80 ms of real time per hop)")
    return {"streamed": streamed, "offline": offline, "max_abs_err": err,
            "hop_ms": times, "median_hop_ms": hop_ms}


def stream_decode(backend: str = "python", device: Union[str, torch.device, None] = None,
                  verbose: bool = True) -> dict:
    """Part B: chunked logits → partial sentences → finalized n-best, through
    ``DecoderService`` with the ``backend`` searcher ("python", "native" or
    "device"; the device searcher runs on ``device``)."""
    prons = synthetic.word_pronunciations()
    lm = train_ngram(synthetic.sentence_corpus(100), order=3)
    lexicon = Lexicon.from_words(prons)
    dcfg = DecodeConfig(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=64)
    searcher = None
    if backend == "device":
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch

        searcher = DeviceLexiconBeamSearch(lexicon, lm, dcfg, device=resolve_device(device))
    service = DecoderService(lexicon, lm, dcfg, channel_order="model",
                             searcher_backend=backend, searcher=searcher)

    sentence = "hello world brain text"
    frames = []
    for pid in lexicon.sentence_to_phonemes(sentence):
        for _ in range(3):
            row = np.full(41, -8.0, np.float32)
            row[pid] = 0.0
            frames.append(row)
        blank = np.full(41, -8.0, np.float32)
        blank[0] = 0.0
        frames.append(blank)
    logits = np.stack(frames)

    service.reset()
    partials = []
    for i in range(0, logits.shape[0], 8):  # ~8 frames per network chunk
        partial = service.decode_chunk(logits[i : i + 8])
        partials.append(partial)
        if verbose:
            print(f"B. partial after chunk {len(partials):2d}: {partial!r}")
    final = service.finalize()
    if verbose:
        print(f"B. final: {final.sentence!r}")
        print("B. n-best (sentence, ac, ngram, llm, total):")
        for cand in final.nbest[:3]:
            print(f"     {cand}")
    return {"sentence": sentence, "partials": partials, "final": final}


def main(verbose: bool = True, device: Union[str, torch.device, None] = None) -> dict:
    device = resolve_device(device)
    stream = stream_gru(verbose=verbose, device=device)
    if stream["max_abs_err"] >= STREAM_TOL_F32:
        raise RuntimeError(f"streaming != offline forward (max |diff| {stream['max_abs_err']})")
    out = stream_decode(verbose=verbose, device=device)
    out["hop_ms"] = stream["median_hop_ms"]
    out["stream"] = stream
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.examples.streaming_demo",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="the CUDA card by default, 'cpu' to run on the CPU")
    main(device=p.parse_args().device)
