"""Streaming decode service: the in-process replacement for the reference's
two-process Redis pipeline.

Protocol parity with ``language-model-standalone.py:514-790``: the verbs
reset / update_params / decode_chunk (partial output per chunk) / finalize
(final output with ';'-packed 5-tuple scoring) behave like the Redis streams
remote_lm_reset, remote_lm_update_params, remote_lm_input →
remote_lm_output_partial, remote_lm_finalize → remote_lm_output_final,
including the conversational context prefix for LLM rescoring
(contextual_decoding_current_context). A drop-in Redis adapter that speaks the
original stream names lives in ``redis_adapter.py``.

Logits arrive in the wire channel order [BLANK, SIL, phones...] (what
evaluate_model.py:190 sends after rearrange_speech_logits_pt) or the model
order [BLANK, phones..., SIL]; the service permutes internally.

Counterpart of ``b2txt_tpu/serve/service.py`` with its three searchers: the
native C++ decoder on the host (``runtime``), the device searcher
(``decode/lmbeam_device.py``, built on the CUDA card; a searcher built
elsewhere, e.g. on the CPU for tests, is passed as ``searcher=``) and the
python oracle.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..decode.lmbeam import DecodeResult, LexiconBeamSearch, decode_numpy
from ..decode.rescore import (
    LLMScorer,
    RescoreOutput,
    augment_nbest,
    llm_rescore_async,
    llm_rescore_group_async,
    rescore_nbest_with_ngram,
    results_to_nbest,
)
from ..lm.lexicon import Lexicon
from ..lm.ngram import NGramLM
from ..utils.config import DecodeConfig
from ..utils.profiling import span

LOG = logging.getLogger("b2txt_tpu_torch.serve")

# wire (LM) order [BLANK, SIL, p1..p39]  →  model order [BLANK, p1..p39, SIL]:
# wire channel i lands at model channel _LM_TO_MODEL[i].
_LM_TO_MODEL = np.asarray([0, 40] + list(range(1, 40)), np.int32)

# request ids of the requests started without one
_REQUEST_IDS = itertools.count(1)


def lm_order_to_model_order(logits: np.ndarray) -> np.ndarray:
    """Inverse of rearrange_speech_logits_pt on the last axis."""
    out = np.empty_like(logits)
    out[..., _LM_TO_MODEL] = logits
    return out


@dataclass
class FinalOutput:
    """Final decode product (remote_lm_output_final entry equivalent)."""

    sentence: str
    nbest: List[tuple]  # (sentence, ac, ngram, llm, total)
    context: str = ""
    confidence: Optional[float] = None

    def scoring_packed(self) -> str:
        """';'-joined 5-tuples, the wire format parsed at
        evaluate_model_helpers.py:251-258."""
        parts: List[str] = []
        for s, a, n, l, t in self.nbest:
            parts.append(";".join(map(str, [s, a, n, l, t])))
        return ";".join(parts)

    @classmethod
    def parse_scoring(cls, packed: str) -> "FinalOutput":
        fields = packed.split(";")
        rows = [
            (fields[i], float(fields[i + 1]), float(fields[i + 2]),
             float(fields[i + 3]), float(fields[i + 4]))
            for i in range(0, len(fields) - 4, 5)
        ]
        rows.sort(key=lambda r: -r[4])
        # dedupe, keeping the first (best) occurrence
        seen = set()
        deduped = []
        for r in rows:
            if r[0] not in seen:
                seen.add(r[0])
                deduped.append(r)
        return cls(sentence=deduped[0][0] if deduped else "", nbest=deduped)


def _make_searcher(
    backend: str,
    lexicon: Lexicon,
    lm: NGramLM,
    config: DecodeConfig,
    arpa_path: Optional[str],
    lexicon_path: Optional[str],
):
    """Construct the requested searcher backend (all three share the
    reset/decode/finish_decoding/result/set_opt protocol and are
    cross-parity-tested — tests/test_torch_searcher_crosscheck.py)."""
    # lattice n-best (deep candidate lists from the provenance graph —
    # decode/lattice.py) requires the Kaldi-style ngram state space; the
    # device searcher decodes the pool only (the production deep-nbest path
    # is the C++ lattice on the host core, like the reference's)
    if config.lattice_nbest and config.sum_mode:
        raise ValueError(
            "lattice_nbest requires sum_mode=False (Viterbi): merging "
            "different word histories under log-sum would pool distinct "
            "sentences' path mass"
        )
    state_key = "ngram" if config.lattice_nbest else "history"
    if backend == "python":
        return LexiconBeamSearch(lexicon, lm, config, state_key=state_key)
    if backend == "device":
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch

        if config.lattice_nbest:
            raise ValueError(
                "lattice_nbest needs the 'native' (C++ lattice, like the "
                "reference's) or 'python' backend; the device searcher "
                "returns the beam pool"
            )
        return DeviceLexiconBeamSearch(lexicon, lm, config)
    if backend == "native":
        from ..runtime import NativeLexiconBeamSearch, write_lexicon

        if arpa_path is None or lexicon_path is None:
            # dump the in-memory LM/lexicon for the C++ loader
            import tempfile

            tmp = tempfile.mkdtemp(prefix="b2t_native_")
            if arpa_path is None:
                arpa_path = os.path.join(tmp, "lm.arpa")
                lm.to_arpa(arpa_path)
            if lexicon_path is None:
                lexicon_path = os.path.join(tmp, "lexicon.txt")
                write_lexicon(lexicon, lexicon_path)
        return NativeLexiconBeamSearch(arpa_path, lexicon_path, config,
                                       state_key=state_key)
    raise ValueError(
        f"searcher_backend must be 'python', 'native' or 'device', got {backend!r}"
    )


class DecoderService:
    """reset / update_params / decode_chunk / finalize over a fused beam search.

    ``searcher_backend`` selects the engine: "native" (C++ host decoder — the
    production default for host decoding), "device" (the batched searcher
    on the CUDA card), or "python" (the oracle; slow, for tests and small
    vocabularies). The native searcher reads ``arpa_path`` and
    ``lexicon_path``; where either is None, the in-memory ``lm`` or
    ``lexicon`` is written to a temporary directory for it.
    """

    def __init__(
        self,
        lexicon: Lexicon,
        lm: NGramLM,
        config: Optional[DecodeConfig] = None,
        rescore_lm: Optional[NGramLM] = None,
        llm: Optional[LLMScorer] = None,
        channel_order: str = "lm",
        searcher_backend: str = "python",
        arpa_path: Optional[str] = None,
        lexicon_path: Optional[str] = None,
        searcher: Optional[Any] = None,
        llm_group_candidates: int = 0,
    ):
        """``llm_group_candidates`` > 0 groups the LLM forwards of
        consecutive utterances' n-best lists into one packed call of up to
        that many candidates (output-identical — decode/rescore.py
        llm_rescore_group_async; only when no conversational context is
        set). 0 = one call per utterance. An already-built ``searcher`` (e.g.
        a DeviceLexiconBeamSearch with its tables on the card) can be
        injected to avoid rebuilding it, or to run it on the CPU; it must
        match ``searcher_backend``."""
        if channel_order not in ("lm", "model"):
            raise ValueError(f"channel_order must be 'lm' or 'model', got {channel_order!r}")
        self.config = config or DecodeConfig()
        self.searcher_backend = searcher_backend
        self.searcher = searcher if searcher is not None else _make_searcher(
            searcher_backend, lexicon, lm, self.config, arpa_path, lexicon_path)
        self.rescore_lm = rescore_lm
        # device backend: rescore the FULL candidate pool on the card (native
        # pool-rescore parity, runtime/decoder.cc:675-690) instead of the
        # post-cut host list rescore
        self._sync_device_rescore()
        self.llm = llm
        self.llm_group_candidates = int(llm_group_candidates)
        self.channel_order = channel_order
        self.context: str = ""
        self.request_id: Any = None

    def _sync_device_rescore(self) -> None:
        """Keep the device searcher's on-card pool rescore in step with
        cfg.rescore (runtime update_params can toggle it)."""
        s = self.searcher
        if self.searcher_backend != "device" or not hasattr(s, "attach_rescore_lm"):
            self._internal_rescore = False
            return
        if self.config.rescore and self.rescore_lm is not None:
            if getattr(s, "rescore_lm", None) is None:
                cached = getattr(self, "_device_rescore_cache", None)
                if cached is not None:
                    # re-enable without repacking the unpruned table
                    s.rescore_lm = cached
                else:
                    s.attach_rescore_lm(self.rescore_lm)
            self._internal_rescore = True
        else:
            if getattr(s, "rescore_lm", None) is not None:
                self._device_rescore_cache = s.rescore_lm
            s.rescore_lm = None
            self._internal_rescore = False

    # ------------------------------------------------------------- protocol
    def reset(self, request_id: Any = None) -> None:
        """Start a request: its id is ``request_id``, or else the next of a
        counter, and every span until the next reset carries it."""
        self.searcher.reset()
        self._start_request(request_id)
        LOG.info("Reset the language model.")

    def _start_request(self, request_id: Any = None) -> None:
        self.request_id = next(_REQUEST_IDS) if request_id is None else request_id

    def set_context(self, context: str) -> None:
        """Conversation context prepended for LLM rescoring."""
        self.context = (context or "").strip()

    def update_params(self, **kwargs: Any) -> Dict[str, Any]:
        """Update decode options at runtime; unknown keys are rejected.
        (remote_lm_update_params → SetOpt parity)."""
        cfg = self.config.replace(**kwargs)
        self.config = cfg
        self.searcher.set_opt(cfg)
        self._sync_device_rescore()
        LOG.info(f"Updated language model params: {kwargs}")
        return cfg.to_dict()

    def decode_chunk(self, logits: np.ndarray) -> str:
        """Consume a (T, 41) chunk of logits, return the partial sentence."""
        with span("serve.decode_chunk", rid=self.request_id):
            logits = np.asarray(logits, np.float32).reshape(-1, 41)
            if self.channel_order == "lm":
                logits = lm_order_to_model_order(logits)
            decode_numpy(self.searcher, logits)
            res = self.searcher.result()
            return res[0].sentence if res else ""

    def finalize(self) -> FinalOutput:
        with span("serve.finalize", rid=self.request_id):
            results = self.searcher.finish_decoding()
            final = self._finalize_results(results)
        LOG.info("Final:  %s", final.sentence)
        return final

    def _finalize_results(self, results: List[DecodeResult]) -> FinalOutput:
        """Post-search pipeline (rescore → augment → LLM) for one utterance's
        n-best list — shared by the streaming and batched paths."""
        return self._finalize_begin(results)()

    def _host_finalize(self, results: List[DecodeResult]):
        """Host finalize for one utterance — unpruned n-gram rescore (unless
        already done on the card) then augment_nbest. Returns the prepped
        n-best list (possibly empty)."""
        cfg = self.config
        nbest = results_to_nbest(results)

        if (cfg.rescore and self.rescore_lm is not None and nbest
                and not self._internal_rescore):
            t = time.perf_counter()
            nbest = rescore_nbest_with_ngram(nbest, self.rescore_lm)
            LOG.info("Rescore time: %.3f", time.perf_counter() - t)

        if cfg.nbest > 1 and nbest:
            before = len(nbest)
            nbest = augment_nbest(
                nbest,
                top_candidates_to_augment=cfg.top_candidates_to_augment,
                acoustic_scale=cfg.acoustic_scale,
                score_penalty_percent=cfg.score_penalty_percent,
            )
            LOG.info(f"Augmented nbest from {before} to {len(nbest)} candidates.")
        return nbest

    def _wrap_llm_finish(self, finish, context: str):
        """FinalOutput-producing thunk around a RescoreOutput finish thunk."""

        def done() -> FinalOutput:
            # timed from fetch start, not dispatch: under the pipelined
            # path the window between begin and done holds OTHER
            # utterances' host work (the spans opt.dispatch and opt.fetch
            # split the two)
            t = time.perf_counter()
            out: RescoreOutput = finish()
            LOG.info("LLM rescore time: %.3f", time.perf_counter() - t)
            return FinalOutput(
                sentence=out.best, nbest=out.nbest,
                context=context, confidence=out.confidence,
            )

        return done

    def _finalize_begin(self, results: List[DecodeResult]):
        """Host finalize (unpruned rescore → augment) + LLM DISPATCH for one
        utterance; returns a zero-arg callable producing the FinalOutput.

        The LLM forward (if any) is dispatched before returning — via
        llm_rescore_async — so the batched paths can run the NEXT utterance's
        host finalize work under this utterance's 6.7b device forward instead
        of serializing [host prep → forward → fetch] per utterance."""
        cfg = self.config
        nbest = self._host_finalize(results)

        if cfg.do_opt and self.llm is not None and nbest:
            finish = llm_rescore_async(
                self.llm, nbest, cfg.acoustic_scale, cfg.alpha,
                length_penalty=cfg.length_penalty, context=self.context or None,
            )
            return self._wrap_llm_finish(finish, self.context)
        if nbest:
            rows = [
                (s.strip(), a, l, 0.0, cfg.acoustic_scale * a + l)
                for s, a, l in nbest
            ]
            final = FinalOutput(sentence=rows[0][0], nbest=rows, context=self.context)
        else:
            LOG.error("No output from language model.")
            final = FinalOutput(sentence="", nbest=[], context=self.context)
        return lambda: final

    # -------------------------------------------------------------- helpers
    def decode_utterance(self, logits: np.ndarray, chunk: int = 0) -> FinalOutput:
        """reset → decode (optionally chunked) → finalize in one call."""
        self.reset()
        logits = np.asarray(logits, np.float32).reshape(-1, 41)
        if chunk <= 0:
            self.decode_chunk(logits)
        else:
            for i in range(0, logits.shape[0], chunk):
                self.decode_chunk(logits[i : i + chunk])
        return self.finalize()

    def decode_utterances(
        self, logits_list: Sequence[np.ndarray], batch_size: int = 32
    ) -> List[FinalOutput]:
        """Decode many utterances. With the device backend the set runs
        through the batched device search (DeviceLexiconBeamSearch
        .decode_batches) in batches of ``batch_size``; the python backend
        decodes serially. Finalize is pipelined: the LLM forward of
        utterance i (if any) overlaps the search of utterance i+1."""
        searcher = self.searcher
        if self.searcher_backend != "device" or not hasattr(searcher, "decode_batches"):
            def stream():
                for logits in logits_list:
                    self.reset()
                    self.decode_chunk(logits)
                    yield 1, [self.searcher.finish_decoding()]

            return self._finalize_pipelined(stream(), fresh_ids=False)

        prepped = []
        for logits in logits_list:
            logits = np.asarray(logits, np.float32).reshape(-1, 41)
            if self.channel_order == "lm":
                logits = lm_order_to_model_order(logits)
            x = logits - logits.max(axis=-1, keepdims=True)
            prepped.append(x - np.log(np.exp(x).sum(-1, keepdims=True)))

        sizes = []
        batches = []
        for start in range(0, len(prepped), batch_size):
            chunk = prepped[start : start + batch_size]
            n = len(chunk)
            B = batch_size if len(prepped) > batch_size else n
            T = max(p.shape[0] for p in chunk)
            lp = np.full((B, T, 41), -30.0, np.float32)
            lengths = np.zeros(B, np.int32)
            for i, p in enumerate(chunk):
                lp[i, : p.shape[0]] = p
                lengths[i] = p.shape[0]
            batches.append((lp, lengths))
            sizes.append(n)
        # software-pipelined: batch j+1's device search overlaps batch j's
        # host-side n-best extraction
        return self._finalize_pipelined(zip(sizes, searcher.decode_batches(batches)))

    def _finalize_pipelined(self, batched_results, fresh_ids: bool = True) -> List[FinalOutput]:
        """Finalize utterances from (n, nbest_lists) pairs with the LLM
        forwards software-pipelined: every utterance's forward is dispatched
        (``_finalize_begin``) before any fetch it doesn't depend on, bounded
        to ``window`` outstanding forwards so the device dispatch queue stays
        shallow. Without an LLM this degenerates to the plain loop (the
        begin thunks are precomputed outputs). Each utterance is a request
        of its own: with ``fresh_ids`` it takes the next id, else the one
        its ``reset`` gave."""
        window = 64
        pending: List = []
        outs: List[FinalOutput] = []
        group_cap = (
            self.llm_group_candidates
            if (self.config.do_opt and self.llm is not None
                and not (self.context or "").split())
            else 0
        )
        if group_cap <= 0:
            for n, nbest_lists in batched_results:
                for r in nbest_lists[:n]:
                    if fresh_ids:
                        self._start_request()
                    with span("serve.finalize", rid=self.request_id):
                        pending.append(self._finalize_begin(r))
                    if len(pending) > window:
                        outs.append(pending.pop(0)())
            outs.extend(p() for p in pending)
            return outs

        # grouped LLM dispatch: buffer host-finalized n-best lists until the
        # accumulated candidate count would pass group_cap, then score the
        # whole group in ONE packed 6.7b call (output-identical per
        # utterance — llm_rescore_group_async). Capacity-based flushing (not
        # a fixed utterance count) keeps the packed call's segment bucket —
        # and so the compiled 6.7b program — stable across groups.
        cfg = self.config
        buf: List = []
        n_cands = 0

        def flush() -> None:
            nonlocal buf, n_cands
            if not buf:
                return
            thunks = llm_rescore_group_async(
                self.llm, buf, cfg.acoustic_scale, cfg.alpha,
                length_penalty=cfg.length_penalty, context=None,
            )
            ctx = self.context
            for nb, th in zip(buf, thunks):
                if nb:
                    pending.append(self._wrap_llm_finish(th, ctx))
                else:
                    LOG.error("No output from language model.")
                    empty = FinalOutput(sentence="", nbest=[], context=ctx)
                    pending.append(lambda empty=empty: empty)
            buf, n_cands = [], 0

        for n, nbest_lists in batched_results:
            for r in nbest_lists[:n]:
                if fresh_ids:
                    self._start_request()
                with span("serve.finalize", rid=self.request_id):
                    nb = self._host_finalize(r)
                if buf and n_cands + len(nb) > group_cap:
                    flush()
                buf.append(nb)
                n_cands += len(nb)
                while len(pending) > window:
                    outs.append(pending.pop(0)())
        flush()
        outs.extend(p() for p in pending)
        return outs

    def decode_batched_utterances(
        self, batches: Sequence[tuple], sizes: Optional[Sequence[int]] = None
    ) -> List[FinalOutput]:
        """Device-resident batched decode: ``batches`` is a sequence of
        (log_probs (B, T, 41), lengths (B,)) already in MODEL channel order
        and log-softmax normalized — typically tensors on the card straight
        from the RNN forward (``evaluate.harness._batched_inference_device``;
        at canonical params the searcher keeps them there —
        lmbeam_device._prep_batch). ``sizes`` gives the REAL utterance count
        per batch (≤ B, for padded tails). Requires the device backend."""
        searcher = self.searcher
        if not hasattr(searcher, "decode_batches"):
            raise ValueError(
                "decode_batched_utterances requires the device searcher "
                f"backend, got {self.searcher_backend!r}"
            )
        if sizes is None:
            sizes = [lp.shape[0] for lp, _ in batches]
        return self._finalize_pipelined(zip(sizes, searcher.decode_batches(batches)))
