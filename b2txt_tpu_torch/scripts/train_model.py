"""Train the GRU phoneme decoder (reference: model_training/train_model.py).

Counterpart of ``scripts/train_model.py``, plus ``--device``: training runs
on the CUDA card (the GRU recurrence through K1 forward and K2 backward,
and K3 with ``use_fused_preprocess``) unless ``--device cpu`` is given.

    python -m b2txt_tpu_torch.scripts.train_model [path/to/rnn_args.yaml] [--device cpu]

The reference's rnn_args.yaml layout loads unchanged. Reading it (and
writing args.yaml beside each checkpoint) needs PyYAML; the HDF5 sessions
it names need h5py.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m b2txt_tpu_torch.scripts.train_model",
        description="Train the GRU phoneme decoder from an rnn_args.yaml "
        "(the reference's file loads unchanged)")
    p.add_argument("args_yaml", nargs="?", default="rnn_args.yaml",
                   help="path to rnn_args.yaml (default: ./rnn_args.yaml)")
    p.add_argument("--device", default=None,
                   help="where training runs: the CUDA card by default, 'cpu' to "
                        "train on the CPU")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ..train import Trainer
    from ..utils import load_args_yaml

    cfg = load_args_yaml(args.args_yaml)
    return Trainer(cfg, device=args.device).train()


if __name__ == "__main__":
    main()
