"""Download the t15 copy-task dataset from Dryad (reference: download_data.py).

Counterpart of ``scripts/download_data.py``, with the same options:

    python -m b2txt_tpu_torch.scripts.download_data [--out data/] [--doi DOI]

Needs network access.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m b2txt_tpu_torch.scripts.download_data",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="data")
    p.add_argument("--doi", default=None)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..data.download import DRYAD_DOI, download_dataset

    paths = download_dataset(args.out, doi=args.doi or DRYAD_DOI)
    print(f"Downloaded {len(paths)} files to {args.out}")


if __name__ == "__main__":
    main()
