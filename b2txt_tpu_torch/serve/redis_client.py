"""Redis client helpers: talk to a remote LM server over the reference's
stream protocol.

Parity target: ``evaluate_model_helpers.py:129-297`` (reset_remote_language_model,
update_remote_lm_params, send_logits_to_remote_lm, finalize_remote_lm) — the
request/ack stream pairs with blocking xread polls. Works against either the
reference's language-model-standalone.py or this framework's
RedisDecoderServer. Requires the ``redis`` package (gated import).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np

from .service import FinalOutput


def get_current_redis_time_ms(redis_conn) -> int:
    t = redis_conn.time()
    return int(t[0] * 1000 + t[1] / 1000)


class RemoteLMClient:
    """Stateful client tracking last-seen stream ids (one per ack stream)."""

    def __init__(
        self,
        redis_ip: str = "localhost",
        redis_port: int = 6379,
        input_stream: str = "remote_lm_input",
        partial_output_stream: str = "remote_lm_output_partial",
        final_output_stream: str = "remote_lm_output_final",
        block_ms: int = 10000,
    ):
        import redis  # gated

        self.r = redis.Redis(host=redis_ip, port=redis_port)
        self.r.ping()
        self.input_stream = input_stream
        self.partial_output_stream = partial_output_stream
        self.final_output_stream = final_output_stream
        self.block_ms = block_ms
        now = get_current_redis_time_ms(self.r)
        self._last: Dict[str, int] = {
            "remote_lm_done_resetting": now,
            "remote_lm_done_updating_params": now,
            partial_output_stream: now,
            final_output_stream: now,
        }

    def _await(self, stream: str):
        while True:
            msgs = self.r.xread(
                {stream: self._last[stream]}, count=1, block=self.block_ms
            )
            if msgs:
                entry_id, data = msgs[0][1][-1]
                self._last[stream] = entry_id
                return data
            print(f"Still waiting for {stream} from ts {self._last[stream]}...")

    def reset(self) -> None:
        self.r.xadd("remote_lm_reset", {"done": 0})
        time.sleep(0.001)
        self._await("remote_lm_done_resetting")

    def update_params(self, **params) -> None:
        self.r.xadd("remote_lm_update_params", params)
        time.sleep(0.001)
        self._await("remote_lm_done_updating_params")

    def send_logits(self, logits: np.ndarray) -> str:
        """Send a (T, 41) float32 chunk; returns the partial sentence."""
        self.r.xadd(
            self.input_stream,
            {"logits": np.asarray(logits, np.float32).tobytes()},
        )
        data = self._await(self.partial_output_stream)
        return data[b"lm_response_partial"].decode()

    def set_context(self, context: str) -> None:
        self.r.set("contextual_decoding_current_context", context)

    def finalize(self) -> FinalOutput:
        self.r.xadd("remote_lm_finalize", {"done": 0})
        time.sleep(0.005)
        data = self._await(self.final_output_stream)
        sentence = data[b"lm_response_final"].decode()
        if b"scoring" in data and data[b"scoring"]:
            out = FinalOutput.parse_scoring(data[b"scoring"].decode())
            out.sentence = sentence or out.sentence
            if b"context_str" in data:
                out.context = data[b"context_str"].decode()
            return out
        return FinalOutput(sentence=sentence, nbest=[])
