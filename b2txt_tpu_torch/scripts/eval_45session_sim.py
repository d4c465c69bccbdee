"""Simulated 45-session evaluation at reference scale.

Counterpart of ``scripts/eval_45session_sim.py``, with the same options
plus ``--device``: the model (and the device searcher) run on the CUDA card
unless ``--device cpu`` is given. Real t15 data is not in the repository,
so this drives the production path — 45 sessions × N trials through
bucketed batched RNN inference (bf16, the full 512-feature 5×768 model),
greedy PER, and the LM beam decode with WER — on synthetic sessions with a
planted phoneme code. The weights are random (drawn from a seeded
``torch.Generator``), so PER and WER are ~1: this measures the path's
throughput, not its accuracy. The reference's equivalent flow
(evaluate_model.py stages 1+2 over Redis) takes ~15–20 min for ~1,450
trials on an RTX 4090.

    python -m b2txt_tpu_torch.scripts.eval_45session_sim [--trials-per-session 32] \\
        [--sessions 45] [--searcher native|device|python] [--device_resident] [--device cpu]

Writing the sessions as HDF5 needs h5py. Everything after the write is
:func:`evaluate`, over (session, columns) pairs; :func:`simulated_sessions`
gives the same sessions in memory, without files.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Iterable, Sequence, Tuple

SEED = 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.eval_45session_sim",
                                description="Simulated 45-session evaluation at reference scale")
    p.add_argument("--sessions", type=int, default=45)
    p.add_argument("--trials-per-session", type=int, default=32)
    p.add_argument("--neural-dim", type=int, default=512)
    p.add_argument("--searcher", default="native",
                   choices=["native", "device", "python"],
                   help="LM beam-search backend for stage 2")
    p.add_argument("--device_resident", action="store_true",
                   help="keep posteriors on the card end to end (device searcher "
                        "only): only greedy argmax ids are fetched, stage 2 "
                        "consumes the stage-1 tensors directly")
    p.add_argument("--out", default=None)
    p.add_argument("--beam_width", type=int, default=128,
                   help="beam K (random-weight soft posteriors need a wide beam)")
    p.add_argument("--device", default=None,
                   help="where the model and the device searcher run: the CUDA card "
                        "by default, 'cpu' to run on the CPU")
    return p


def session_names(n: int):
    return [f"t15.2023.{i:04d}" for i in range(n)]


def make_config(sessions: Sequence[str], neural_dim: int):
    """``TrainConfig()`` (512 features, 5×768 GRU) at ``neural_dim``, with
    ``sessions`` as its day list, all evaluated."""
    from ..utils import TrainConfig

    cfg = TrainConfig()
    cfg.model.n_input_features = neural_dim
    cfg.dataset.neural_dim = neural_dim
    cfg.dataset.sessions = list(sessions)
    cfg.dataset.dataset_probability_val = [1] * len(sessions)
    return cfg


def make_model(cfg, device, seed: int = SEED):
    """A GRUDecoder with one day layer per session and random weights."""
    import torch

    from ..models import GRUDecoder

    return GRUDecoder(cfg.model, len(cfg.dataset.sessions), 41, device=device,
                      generator=torch.Generator().manual_seed(seed))


def simulated_sessions(sessions: Sequence[str], trials_per_session: int,
                       neural_dim: int) -> Dict[str, Dict[str, list]]:
    """The val trials ``write_synthetic_sessions`` writes, as the columns
    ``load_session_file`` reads back, held in memory."""
    from ..data import synthetic

    drawn = synthetic.synthetic_trials(sessions, trials_per_session=trials_per_session,
                                       neural_dim=neural_dim, seed=SEED, split="val")
    out = {}
    for si, session in enumerate(sessions):
        trials = drawn[si]
        out[session] = {
            "neural_features": [t.input_features for t in trials],
            "n_time_steps": [t.n_time_steps for t in trials],
            "seq_class_ids": [t.seq_class_ids for t in trials],
            "seq_len": [t.seq_len for t in trials],
            "transcriptions": [t.transcription for t in trials],
            "sentence_label": [t.sentence_label for t in trials],
            "session": [t.session for t in trials],
            "block_num": [t.block_num for t in trials],
            "trial_num": [t.trial_num for t in trials],
        }
    return out


def make_decoder(out: str, searcher: str, beam_width: int, device):
    """The synthetic world's trigram and lexicon (written to ``out`` as
    lm.arpa and lexicon.txt for the native searcher) in a DecoderService."""
    from ..data import synthetic
    from ..lm import Lexicon, train_ngram
    from ..lm.lexicon import strip_stress
    from ..serve import DecoderService
    from ..utils.config import DecodeConfig

    lexicon = Lexicon.from_words(synthetic.word_pronunciations())
    lm = train_ngram(synthetic.sentence_corpus(200), order=3)
    arpa = os.path.join(out, "lm.arpa")
    lm.to_arpa(arpa)
    lexp = os.path.join(out, "lexicon.txt")
    with open(lexp, "w") as f:
        for w, pron in synthetic.word_pronunciations().items():
            f.write(f"{w.upper()}  {' '.join(strip_stress(pron))}\n")

    dcfg = DecodeConfig(acoustic_scale=0.325, blank_penalty=2.0, nbest=10,
                        beam_width=beam_width)
    dev_searcher = None
    if searcher == "device":
        from ..decode.lmbeam_device import DeviceLexiconBeamSearch

        dev_searcher = DeviceLexiconBeamSearch(lexicon, lm, dcfg, device=device)
    return DecoderService(lexicon, lm, dcfg, channel_order="model", searcher_backend=searcher,
                          arpa_path=arpa, lexicon_path=lexp, searcher=dev_searcher)


def evaluate(model, cfg, session_data: Iterable[Tuple[str, Dict]], decoder,
             device_resident: bool = False) -> Dict:
    """Stages 1 and 2 over (session, columns) pairs, bf16, as
    ``evaluate_sessions`` runs them after its file read."""
    import torch

    from ..evaluate import evaluate_session_data

    return evaluate_session_data(model, cfg, session_data, eval_type="val", decoder=decoder,
                                 compute_dtype=torch.bfloat16,
                                 device_resident=device_resident,
                                 sessions=cfg.dataset.sessions)


def run(args, cfg) -> Dict:
    """Write the sessions as HDF5 under ``args.out``, read them back and
    evaluate them with a model of ``cfg``; prints main's report."""
    from ..data import synthetic
    from ..data.hdf5_store import load_session_file
    from ..evaluate import write_competition_csv
    from ..utils import resolve_device

    device = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp()
    sessions = cfg.dataset.sessions
    print(f"Writing {len(sessions)} synthetic sessions x "
          f"{args.trials_per_session} trials (D={args.neural_dim})...")
    t0 = time.time()
    synthetic.write_synthetic_sessions(
        out, sessions, trials_per_session=args.trials_per_session,
        neural_dim=args.neural_dim, seed=SEED, splits=("val",),
    )
    print(f"  data written in {time.time() - t0:.1f}s")

    model = make_model(cfg, device)
    decoder = make_decoder(out, args.searcher, args.beam_width, device)
    session_data = ((s, load_session_file(os.path.join(out, s, "data_val.hdf5")))
                    for s in sessions)

    print(f"Stage 1+2: batched RNN inference + {args.searcher} LM decode...")
    t0 = time.time()
    res = evaluate(model, cfg, session_data, decoder, args.device_resident)
    wall = time.time() - t0
    n = len(res["trials"])
    print(f"  {n} trials in {wall / 60:.2f} min "
          f"({n / wall:.1f} sentences/s end-to-end)")
    print(f"  greedy PER (random weights, expected ~1): {res.get('greedy_PER', -1):.3f}")
    print(f"  WER vs labels (random weights, expected ~1): {res.get('WER', -1):.3f}")
    csv_path = os.path.join(out, "submission.csv")
    write_competition_csv(res["trials"], csv_path)
    print(f"  wrote {csv_path}")
    print(f"Reference flow: ~1,450 trials in 15-20 min -> "
          f"this run projects {1450 / (n / wall) / 60:.2f} min for 1,450 trials")
    return res


def main(argv=None) -> Dict:
    args = build_parser().parse_args(argv)
    return run(args, make_config(session_names(args.sessions), args.neural_dim))


if __name__ == "__main__":
    main()
