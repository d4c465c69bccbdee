"""One run of one benchmark cell on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and, with
``--trace 1``, ``breakdown``), and ``limits`` last: each number the
comparison with the plain reference reads, beside its limit. The same
numbers are the last lines of standard error. Exits with a code other than
0, and prints no result, without enough CUDA devices or when a module of
JAX or of the JAX package was loaded.

Directories a run writes, all inside the checkout or the run's TMPDIR:
``benchmark/.cache/`` (the decode world's files, built by a checkout's first
run), ``b2txt_tpu_torch/_build/`` (the program's nvcc and g++ builds) and
``benchmark/.cache/torch_extensions``, ``benchmark/.cache/triton`` (empty
unless the program comes to use them).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# fixed cache directories inside the checkout; no library that would load
# JAX by itself (transformers) is allowed to
for _k, _v in (("TORCH_EXTENSIONS_DIR", os.path.join(HERE, ".cache", "torch_extensions")),
               ("TRITON_CACHE_DIR", os.path.join(HERE, ".cache", "triton"))):
    os.environ[_k] = _v
for _k in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[_k] = "0"
# one process with few threads: the measured paths are host-bound Python,
# and idle pool threads spinning beside it make its pace swing
for _k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_k, "1")

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
if HERE in sys.path:
    sys.path.remove(HERE)

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main())
