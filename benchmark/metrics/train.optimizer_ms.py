"""train.optimizer_ms: the median, over the traced steps, of the program's
span ``train.optimizer`` (Trainer.train_step after the backward: the frozen
leaves' zero gradients, the global norm, clipping, the learning rates and
AdamW's step), in ms."""

import statistics


def read(run):
    try:
        from b2txt_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in records()
          if r.name == "train.optimizer" and r.end_ns is not None]
    return statistics.median(ms) if ms else None
