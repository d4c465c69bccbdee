"""b2txt_tpu_torch — the PyTorch/CUDA port of b2txt_tpu for NVIDIA Hopper.

Keeps b2txt_tpu's module layout and names, so each module has a counterpart
there. The GRU recurrence runs as hand-written CUDA kernels
(``csrc/gru_fwd.cu`` forward, ``csrc/gru_bwd.cu`` backward), the fused
augmentation + smoothing as one too (``csrc/preprocess.cu``), as does the
row gather (``csrc/row_gather.cu``); plain tensor code is ordinary PyTorch.
Imports neither JAX nor b2txt_tpu.

Subpackages
-----------
- ``utils``     config / phoneme tables / metrics / device resolution / g2p
- ``ops``       smoothing, augmentations, CTC, the GRU recurrence and the
                fused preprocess (kernels + plain versions)
- ``models``    GRUDecoder, checkpoint import, planted full-size weights
- ``data``      HDF5 sessions, batch sampling and assembly, synthetic data
- ``train``     Trainer, optimizer groups and schedules, checkpoints
- ``lm``        ARPA n-gram models and lexicon
- ``decode``    the host lexicon + n-gram beam search, the device searcher,
                lattice, rescoring
- ``runtime``   the native C++ beam-search decoder and n-gram trainer
                (built with g++ at first use, bound with ctypes)
- ``serve``     streaming decode service (native, device and python
                searchers), the Redis stream server and client, a fake redis
- ``evaluate``  session evaluation: batched inference, greedy PER,
                LM-decoded WER, the competition CSV, golden-CSV checks
- ``scripts``   CLIs: ``evaluate_model``, ``language_model_standalone``,
                ``profile_gather``, ``time_gru``
"""

__version__ = "0.1.0"
