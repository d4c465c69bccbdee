"""Convert checkpoints between the reference's PyTorch format and the port's.

Counterpart of ``scripts/convert_checkpoint.py``, with the same options:

    python -m b2txt_tpu_torch.scripts.convert_checkpoint --from-torch ckpt.pt --out best_checkpoint
    python -m b2txt_tpu_torch.scripts.convert_checkpoint --from-tpu best_checkpoint --out ckpt.pt

``--from-torch`` writes the port's pickle checkpoint (``train.checkpoint``:
parameters under the reference's names). ``--from-tpu`` reads either
pickle layout, the port's or the JAX package's parameter tree, and writes
``{"model_state_dict", "val_PER", "val_loss"}`` as the reference does.
Both run on the CPU: no tensor goes to the card.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.convert_checkpoint",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--from-torch", dest="from_torch",
                   help="reference PyTorch checkpoint (.pt) to read")
    p.add_argument("--from-tpu", dest="from_tpu",
                   help="pickle checkpoint to read (the port's or the JAX package's layout)")
    p.add_argument("--out", required=True)
    return p


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    if bool(args.from_torch) == bool(args.from_tpu):
        p.error("exactly one of --from-torch / --from-tpu required")

    from ..models import load_torch_checkpoint, state_dict_from_params
    from ..train.checkpoint import load_checkpoint, save_checkpoint

    if args.from_torch:
        params = state_dict_from_params(load_torch_checkpoint(args.from_torch))
        save_checkpoint(args.out, params)
        print(f"Wrote b2txt_tpu_torch checkpoint: {args.out}")
    else:
        import numpy as np
        import torch

        ckpt = load_checkpoint(args.from_tpu)
        params = ckpt["params"]
        if "day_w" in params:   # the JAX package's parameter tree
            params = state_dict_from_params(params)
        sd = {k: torch.from_numpy(np.array(v, copy=True)) for k, v in params.items()}
        torch.save({"model_state_dict": sd,
                    "val_PER": ckpt.get("val_PER", float("inf")),
                    "val_loss": ckpt.get("val_loss", float("inf"))}, args.out)
        print(f"Wrote torch checkpoint: {args.out}")


if __name__ == "__main__":
    main()
