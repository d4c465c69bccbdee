"""b2txt_tpu_torch — the PyTorch/CUDA port of b2txt_tpu for NVIDIA Hopper.

Keeps b2txt_tpu's module layout and names, so each module has a counterpart
there. The GRU recurrence runs as hand-written CUDA kernels
(``csrc/gru_fwd.cu`` forward, ``csrc/gru_bwd.cu`` backward) and the fused
augmentation + smoothing as a Triton kernel (``ops/preprocess.py``); plain
tensor code is ordinary PyTorch. Imports neither JAX nor b2txt_tpu.

Subpackages
-----------
- ``utils``     config / phoneme tables / metrics / device resolution
- ``ops``       smoothing, augmentations, CTC, the GRU recurrence and the
                fused preprocess (kernels + plain versions)
- ``models``    GRUDecoder, checkpoint import, planted full-size weights
- ``data``      HDF5 sessions, batch sampling and assembly, synthetic data
- ``train``     Trainer, optimizer groups and schedules, checkpoints
- ``lm``        ARPA n-gram models and lexicon
- ``decode``    the host lexicon + n-gram beam search, lattice, rescoring
- ``serve``     streaming decode service
- ``evaluate``  batched inference: features → per-utterance logits
"""

__version__ = "0.1.0"
