"""CTC loss and greedy decoding.

Counterpart of ``b2txt_tpu/ops/ctc.py``. The JAX package wrote its own CTC to
match ``torch.nn.CTCLoss(blank=0, reduction='none', zero_infinity=False)``,
the reference's loss (rnn_trainer.py:242,538-545); the port calls that loss
itself. One difference: an impossible alignment (input shorter than the
labels need) gives ``inf`` here and 1e30 in the JAX package.

``torch.nn.functional.ctc_loss`` returns a gradient with respect to its
log-probabilities that is right only once it flows back through a
log-softmax (it assumes normalized inputs), so feed it log-softmax outputs,
as ``ctc_loss_from_logits`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def ctc_loss(
    log_probs: torch.Tensor,       # (B, T, C) log-softmax outputs
    targets: torch.Tensor,         # (B, S) int labels, padded past target_lengths
    input_lengths: torch.Tensor,   # (B,)
    target_lengths: torch.Tensor,  # (B,)
    blank: int = 0,
) -> torch.Tensor:
    """Per-sample CTC negative log-likelihood, (B,)."""
    return F.ctc_loss(
        log_probs.transpose(0, 1), targets.long(), input_lengths.long(),
        target_lengths.long(), blank=blank, reduction="none", zero_infinity=False,
    )


def ctc_loss_from_logits(logits, targets, input_lengths, target_lengths, blank: int = 0):
    """log_softmax over classes in float32, then CTC (rnn_trainer.py:538-545)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return ctc_loss(log_probs, targets, input_lengths, target_lengths, blank=blank)


def greedy_decode_ids(logits: torch.Tensor, input_lengths: torch.Tensor) -> torch.Tensor:
    """Per-frame argmax ids (B, T), frames past input_length forced to blank
    (0). Collapsing happens on the host (``batched_greedy_collapse``)."""
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.where(t < input_lengths[:, None], ids, torch.zeros_like(ids))


def batched_greedy_collapse(ids, input_lengths) -> list:
    """Host-side: collapse repeats + drop blanks for each row of (B, T) ids."""
    from ..utils.phonemes import greedy_collapse

    ids = np.asarray(ids)
    lens = np.asarray(input_lengths)
    return [greedy_collapse(ids[i, : lens[i]]) for i in range(ids.shape[0])]
