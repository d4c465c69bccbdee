"""Standalone LM decode server speaking the reference's Redis protocol
(reference: language_model/language-model-standalone.py CLI, :793-824).

Counterpart of ``scripts/language_model_standalone.py`` without its
``--opt_backend`` options (the JAX OPT rescorer has no counterpart in the
port yet; ``--do_opt`` uses the transformers rescorer), plus ``--device``:
the device searcher (``--searcher device``) and the LLM run on the CUDA card
unless ``--device cpu`` is given; the native and python searchers run on the
host.

    python -m b2txt_tpu_torch.scripts.language_model_standalone --lm_path lm/openwebtext_3gram

The --lm_path directory holds lm.arpa (+ optional lm_unpruned.arpa for
--rescore) and lexicon.txt — the ARPA/lexicon replace the reference's
TLG.fst/words.txt/G.fst artifacts. Needs the ``redis`` package and a server
(``serve/fakeredis.py`` stands in for both in-process).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m b2txt_tpu_torch.scripts.language_model_standalone",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--lm_path", type=str, required=True)
    p.add_argument("--max_active", type=int, default=7000)
    p.add_argument("--min_active", type=int, default=200)
    p.add_argument("--beam", type=float, default=17.0)
    p.add_argument("--lattice_beam", type=float, default=8.0)
    p.add_argument("--ctc_blank_skip_threshold", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--acoustic_scale", type=float, default=0.3)
    p.add_argument("--nbest", type=int, default=100)
    p.add_argument("--beam_width", type=int, default=128)
    p.add_argument("--top_candidates_to_augment", type=int, default=20)
    p.add_argument("--score_penalty_percent", type=float, default=0.01)
    p.add_argument("--blank_penalty", type=float, default=9.0)
    p.add_argument("--rescore", action="store_true")
    p.add_argument("--do_opt", action="store_true")
    p.add_argument("--opt_model", type=str, default="facebook/opt-6.7b")
    p.add_argument("--opt_cache_dir", type=str, default=None)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--searcher", default="native",
                   choices=["native", "device", "python"],
                   help="beam-search backend")
    p.add_argument("--device", default=None,
                   help="where the device searcher and the LLM run: the CUDA "
                        "card by default, 'cpu' to run on the CPU")
    p.add_argument("--redis_ip", type=str, default="localhost")
    p.add_argument("--redis_port", type=int, default=6379)
    p.add_argument("--input_stream", type=str, default="remote_lm_input")
    p.add_argument("--partial_output_stream", type=str, default="remote_lm_output_partial")
    p.add_argument("--final_output_stream", type=str, default="remote_lm_output_final")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..lm import Lexicon, NGramLM
    from ..serve import DecoderService
    from ..serve.redis_adapter import RedisDecoderServer
    from ..utils.config import DecodeConfig

    lm_path = os.path.expanduser(args.lm_path)
    lm = NGramLM.from_arpa(os.path.join(lm_path, "lm.arpa"))
    lexicon = Lexicon.from_file(os.path.join(lm_path, "lexicon.txt"), vocab=lm.vocab)
    rescore_lm = None
    unpruned = os.path.join(lm_path, "lm_unpruned.arpa")
    if args.rescore and os.path.exists(unpruned):
        rescore_lm = NGramLM.from_arpa(unpruned)
    llm = None
    if args.do_opt:
        from ..decode.rescore import TorchCausalLMRescorer

        llm = TorchCausalLMRescorer(args.opt_model, cache_dir=args.opt_cache_dir,
                                    device=args.device)

    cfg = DecodeConfig(
        max_active=args.max_active, min_active=args.min_active, beam=args.beam,
        lattice_beam=args.lattice_beam, acoustic_scale=args.acoustic_scale,
        ctc_blank_skip_threshold=args.ctc_blank_skip_threshold,
        length_penalty=args.length_penalty, nbest=args.nbest,
        blank_penalty=args.blank_penalty, alpha=args.alpha,
        do_opt=args.do_opt, rescore=args.rescore and rescore_lm is not None,
        top_candidates_to_augment=args.top_candidates_to_augment,
        score_penalty_percent=args.score_penalty_percent,
        beam_width=args.beam_width,
    )
    searcher = None
    if args.searcher == "device":
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch

        searcher = DeviceLexiconBeamSearch(lexicon, lm, cfg, device=args.device)
    service = DecoderService(
        lexicon, lm, cfg, rescore_lm=rescore_lm, llm=llm, channel_order="lm",
        searcher_backend=args.searcher,
        arpa_path=os.path.join(lm_path, "lm.arpa"),
        lexicon_path=os.path.join(lm_path, "lexicon.txt"),
        searcher=searcher,
    )

    server = RedisDecoderServer(
        service, args.redis_ip, args.redis_port,
        args.input_stream, args.partial_output_stream, args.final_output_stream,
    )
    server.run()


if __name__ == "__main__":
    main()
