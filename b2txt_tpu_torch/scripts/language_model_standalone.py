"""Standalone LM decode server speaking the reference's Redis protocol
(reference: language_model/language-model-standalone.py CLI, :793-824).

Counterpart of ``scripts/language_model_standalone.py``, plus ``--device``:
the device searcher (``--searcher device``) and the LLM run on the CUDA card
unless ``--device cpu`` is given; the native and python searchers run on the
host. ``--do_opt`` rescores with the transformers model (``--opt_backend
torch``) or with the port's OPT (``--opt_backend port``, decode/opt_lm.py:
bf16 weights from ``--opt_weights``, or drawn on the device with
``--opt_random_init``; GPT-2 BPE from ``--opt_vocab`` and ``--opt_merges``).

    python -m b2txt_tpu_torch.scripts.language_model_standalone --lm_path lm/openwebtext_3gram
    python -m b2txt_tpu_torch.scripts.language_model_standalone --lm_path L --do_opt \
        --opt_backend port --opt_weights opt-6.7b.pt --opt_vocab vocab.json \
        --opt_merges merges.txt

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
    p.add_argument("--opt_backend", default="torch", choices=["torch", "port"],
                   help="LLM rescorer: host transformers (reference parity) "
                   "or the port's OPT on --device (decode/opt_lm.py)")
    p.add_argument("--opt_weights", type=str, default=None,
                   help="(port) torch state_dict file of OPT weights (HF names); "
                   "held bf16 on the device")
    p.add_argument("--opt_vocab", type=str, default=None,
                   help="(port) GPT-2 vocab.json for the byte-level BPE")
    p.add_argument("--opt_merges", type=str, default=None,
                   help="(port) GPT-2 merges.txt")
    p.add_argument("--opt_random_init", action="store_true",
                   help="(port) random bf16 weights drawn on the device instead of "
                   "--opt_weights — throughput measurement only")
    p.add_argument("--opt_size", default="6.7b", choices=["6.7b", "tiny"],
                   help="(port) architecture shapes (tiny is the test config)")
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


def port_opt(args, parser) -> "OPTRescorer":
    """The port's OPT rescorer as the options describe it, bf16 on
    ``--device``."""
    import torch

    from ..decode.opt_lm import OPTConfig, OPTRescorer, init_params, params_from_hf
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = OPTConfig.opt_6_7b() if args.opt_size == "6.7b" else OPTConfig.tiny()
    encode = None
    if args.opt_vocab and args.opt_merges:
        from ..utils.bpe import ByteBPE

        encode = ByteBPE.for_opt(args.opt_vocab, args.opt_merges)
    if args.opt_weights:
        sd = torch.load(args.opt_weights, map_location="cpu", weights_only=True)
        if "model_state_dict" in sd:
            sd = sd["model_state_dict"]
        params = {k: v.to(device, torch.bfloat16) for k, v in params_from_hf(sd).items()
                  if k != "lm_head.weight"}   # tied: OPTRescorer ties it again
    elif args.opt_random_init:
        # drawn on the device: shipping 13.3 GB from the host is the wrong
        # default for a measurement-only mode
        params = init_params(cfg, device, torch.bfloat16,
                             torch.Generator(device=device).manual_seed(0))
    else:
        parser.error("--opt_backend port requires --opt_weights or --opt_random_init")
    return OPTRescorer(cfg, params=params, encode=encode, device=device,
                       compute_dtype=torch.bfloat16)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)

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
    if args.do_opt and args.opt_backend == "port":
        llm = port_opt(args, parser)
    elif args.do_opt:
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
