"""Evaluate a trained checkpoint over sessions: greedy PER, optional LM decode
+ WER, competition CSV (reference: model_training/evaluate_model.py CLI).

Counterpart of ``scripts/evaluate_model.py``, with the same options plus
``--device``: the model runs on the CUDA card unless ``--device cpu`` is
given (the device searcher, ``--searcher device``, runs there too; the
native and python searchers run on the host).

    python -m b2txt_tpu_torch.scripts.evaluate_model --model_path trained_models/baseline_rnn \
        --data_dir data/hdf5_data_final --eval_type val --csv_path out.csv
    ... --lm_dir lm/openwebtext_3gram --rescore --nbest 100

``--model_path`` holds ``checkpoint/best_checkpoint`` and
``checkpoint/args.yaml``. The checkpoint is either pickle format: the port's
(parameters under the reference's names, ``train.checkpoint``) or the JAX
package's (its parameter tree, converted here); or a reference PyTorch
checkpoint. Reading HDF5 sessions needs h5py, args.yaml needs PyYAML.
"""

from __future__ import annotations

import argparse
import os
import pickle


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m b2txt_tpu_torch.scripts.evaluate_model",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--model_path", required=True,
                   help="dir with checkpoint/best_checkpoint + checkpoint/args.yaml, "
                        "or a reference PyTorch checkpoint dir")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--eval_type", default="val", choices=["val", "test"])
    p.add_argument("--csv_path", default=None)
    p.add_argument("--lm_dir", default=None,
                   help="dir with lm.arpa (+ optional lm_unpruned.arpa, lexicon.txt); "
                        "enables beam-search decoding + WER")
    p.add_argument("--acoustic_scale", type=float, default=0.325)
    p.add_argument("--blank_penalty", type=float, default=90.0)
    p.add_argument("--alpha", type=float, default=0.55)
    p.add_argument("--nbest", type=int, default=100)
    p.add_argument("--beam_width", type=int, default=128)
    p.add_argument("--rescore", action="store_true")
    p.add_argument("--do_opt", action="store_true", help="LLM rescoring (transformers)")
    p.add_argument("--opt_model", default="facebook/opt-6.7b")
    p.add_argument("--opt_cache_dir", default=None)
    p.add_argument("--llm_group", type=int, default=96,
                   help="group up to this many n-best candidates across "
                        "utterances per LLM call on batched paths "
                        "(output-identical; 0 = one call per utterance)")
    p.add_argument("--searcher", default="native",
                   choices=["native", "device", "python"],
                   help="beam-search backend: native C++ host decoder "
                        "(default), the batched searcher on --device, or the "
                        "Python oracle")
    p.add_argument("--device", default=None,
                   help="where the model (and the device searcher and the LLM) "
                        "run: the CUDA card by default, 'cpu' to run on the CPU")
    return p


def load_decoder(ckpt_path: str, cfg, device):
    """A GRUDecoder on ``device`` with the checkpoint's weights (any of the
    three layouts in the module's docstring)."""
    import numpy as np
    import torch

    from ..models import GRUDecoder, load_torch_checkpoint, params_from_jax

    try:
        with open(ckpt_path, "rb") as f:
            params = pickle.load(f)["params"]
    except (pickle.UnpicklingError, KeyError, TypeError):
        # reference torch checkpoint (a zip archive, or a legacy torch pickle)
        params = load_torch_checkpoint(ckpt_path)
        print(f"Loaded reference PyTorch checkpoint: {ckpt_path}")
    if "day_w" in params:   # a JAX-layout parameter tree
        state = params_from_jax(params)
    else:
        state = {k: torch.from_numpy(np.array(v, np.float32, copy=True))
                 for k, v in params.items()}
    n_days = sum(k.startswith("day_weights.") for k in state)
    model = GRUDecoder(cfg.model, n_days, int(state["out.weight"].shape[0]), device=device)
    model.load_state_dict(state)
    return model


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..evaluate import evaluate_sessions, write_competition_csv
    from ..utils import TrainConfig, resolve_device

    device = resolve_device(args.device)
    ckpt_path = os.path.join(args.model_path, "checkpoint", "best_checkpoint")
    args_yaml = os.path.join(args.model_path, "checkpoint", "args.yaml")
    cfg = TrainConfig.load(args_yaml)
    model = load_decoder(ckpt_path, cfg, device)

    decoder = None
    if args.lm_dir:
        from ..lm import Lexicon, NGramLM
        from ..serve import DecoderService
        from ..utils.config import DecodeConfig

        lm = NGramLM.from_arpa(os.path.join(args.lm_dir, "lm.arpa"))
        lex_path = os.path.join(args.lm_dir, "lexicon.txt")
        lexicon = Lexicon.from_file(lex_path, vocab=lm.vocab)
        rescore_lm = None
        unpruned = os.path.join(args.lm_dir, "lm_unpruned.arpa")
        if args.rescore and os.path.exists(unpruned):
            rescore_lm = NGramLM.from_arpa(unpruned)
        llm = None
        if args.do_opt:
            from ..decode.rescore import TorchCausalLMRescorer

            llm = TorchCausalLMRescorer(args.opt_model, cache_dir=args.opt_cache_dir,
                                        device=str(device))
        dcfg = DecodeConfig(
            acoustic_scale=args.acoustic_scale, blank_penalty=args.blank_penalty,
            alpha=args.alpha, nbest=args.nbest, beam_width=args.beam_width,
            rescore=args.rescore and rescore_lm is not None, do_opt=args.do_opt,
        )
        searcher = None
        if args.searcher == "device":
            from ..decode.lmbeam_device import DeviceLexiconBeamSearch

            searcher = DeviceLexiconBeamSearch(lexicon, lm, dcfg, device=device)
        decoder = DecoderService(
            lexicon, lm, dcfg, rescore_lm=rescore_lm, llm=llm,
            channel_order="model", searcher_backend=args.searcher,
            arpa_path=os.path.join(args.lm_dir, "lm.arpa"),
            lexicon_path=lex_path, searcher=searcher,
            llm_group_candidates=args.llm_group,
        )

    out = evaluate_sessions(
        model, cfg, args.data_dir, eval_type=args.eval_type, decoder=decoder,
        verbose=True,
    )
    if "greedy_PER" in out:
        print(f"Aggregate greedy PER: {out['greedy_PER']:.4f}")
        for s, v in out.get("day_PER", {}).items():
            print(f"  {s}: {v:.4f}")
    if "WER" in out:
        lo, hi = out["WER_CI"]
        print(f"Aggregate WER: {out['WER']:.4f}  (95% CI {lo:.4f}–{hi:.4f})")
        print(f"LM decode throughput: {out['sentences_per_sec']:.2f} sentences/s")
    if args.csv_path:
        write_competition_csv(out["trials"], args.csv_path)
        print(f"Wrote {args.csv_path}")


if __name__ == "__main__":
    main()
