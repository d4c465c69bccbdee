"""Session evaluation: greedy PER, LM-decoded WER and the competition CSV
(``harness``), and golden-CSV regression helpers (``golden``)."""

from .harness import (
    TrialEval,
    evaluate_session_data,
    evaluate_sessions,
    run_single_decoding_step,
    write_competition_csv,
)
