"""Redis-stream adapter: drop-in compatibility with the reference client.

Speaks the exact stream protocol of ``language-model-standalone.py:514-790``
(remote_lm_input / remote_lm_output_partial / remote_lm_output_final and the
reset / finalize / update_params request-ack pairs, the remote_lm_args mirror
stream, and the contextual_decoding_current_context key), so the reference's
``evaluate_model.py`` can talk to this service unchanged. Requires a running
redis server + the ``redis`` package (not in the base image — import is gated).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from .service import DecoderService

LOG = logging.getLogger("b2txt_tpu_torch.serve.redis")


def get_current_redis_time_ms(r) -> int:
    t = r.time()
    return int(t[0] * 1000 + t[1] / 1000)


class RedisDecoderServer:
    """Main loop mirroring the standalone LM process (≤1000 Hz poll, reconnect
    state machine, request-ack stream pairs)."""

    def __init__(
        self,
        service: DecoderService,
        redis_ip: str = "localhost",
        redis_port: int = 6379,
        input_stream: str = "remote_lm_input",
        partial_output_stream: str = "remote_lm_output_partial",
        final_output_stream: str = "remote_lm_output_final",
    ):
        try:
            import redis  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "RedisDecoderServer requires the `redis` package; use "
                "DecoderService directly for in-process serving."
            ) from e
        self._redis = __import__("redis")
        self.service = service
        self.redis_ip = redis_ip
        self.redis_port = redis_port
        self.input_stream = input_stream
        self.partial_output_stream = partial_output_stream
        self.final_output_stream = final_output_stream
        self._running = False

    def _connect(self):
        try:
            conn = self._redis.Redis(host=self.redis_ip, port=self.redis_port)
            conn.ping()
            return conn
        except self._redis.exceptions.ConnectionError:
            LOG.warning("Can't connect to redis server (ConnectionError).")
            return None

    def stop(self) -> None:
        self._running = False

    def run(self, max_iterations: Optional[int] = None) -> None:
        r = None
        while r is None:
            r = self._connect()
            if r is None:
                time.sleep(3)

        state = -1
        last = {}
        args_mirror = self.service.config.to_dict()
        timeout_ms = 100
        prev_loop = 0.0
        self._running = True
        iterations = 0

        while self._running:
            if max_iterations is not None:
                iterations += 1
                if iterations > max_iterations:
                    break
            loop_time = time.time() - prev_loop
            if loop_time < 0.001:
                time.sleep(0.001 - loop_time)
            prev_loop = time.time()

            try:
                r.ping()
            except self._redis.exceptions.ConnectionError:
                if state != 0:
                    LOG.error("Lost redis connection; retrying...")
                state = 0
                time.sleep(1)
                continue

            if state != 1:
                now = get_current_redis_time_ms(r)
                last = {k: now for k in ("logits", "reset", "finalize", "update")}
            state = 1

            if r.xlen("remote_lm_args") == 0:
                r.xadd("remote_lm_args", _flatten(args_mirror))

            # reset?
            msgs = r.xread({"remote_lm_reset": last["reset"]}, count=1, block=None)
            if msgs:
                for entry_id, _ in msgs[0][1]:
                    last["reset"] = entry_id
                # the request's id is the reset message's stream entry id
                self.service.reset(request_id=last["reset"])
                r.xadd("remote_lm_done_resetting", {"done": 1})
                continue

            # finalize?
            msgs = r.xread({"remote_lm_finalize": last["finalize"]}, count=1, block=None)
            if msgs:
                for entry_id, _ in msgs[0][1]:
                    last["finalize"] = entry_id
                ctx = r.get("contextual_decoding_current_context")
                self.service.set_context(ctx.decode() if ctx is not None else "")
                final = self.service.finalize()
                if self.service.config.nbest > 1:
                    r.xadd(self.final_output_stream, {
                        "lm_response_final": final.sentence,
                        "scoring": final.scoring_packed(),
                        "context_str": final.context,
                    })
                else:
                    r.xadd(self.final_output_stream, {"lm_response_final": final.sentence})
                r.xadd("remote_lm_done_finalizing", {"done": 1})
                continue

            # update params?
            msgs = r.xread({"remote_lm_update_params": last["update"]}, count=1, block=None)
            if msgs:
                for entry_id, data in msgs[0][1]:
                    last["update"] = entry_id
                    updates = {}
                    for key, cast in _PARAM_CASTS.items():
                        if key.encode() in data:
                            updates[key] = cast(data[key.encode()])
                    args_mirror = self.service.update_params(**updates)
                    r.xadd("remote_lm_args", _flatten(args_mirror))
                    r.xadd("remote_lm_done_updating_params", {"done": 1})
                continue

            # logits
            try:
                msgs = r.xread({self.input_stream: last["logits"]}, count=1, block=timeout_ms)
            except self._redis.exceptions.ConnectionError:
                state = 0
                time.sleep(1)
                continue
            if msgs:
                for entry_id, data in msgs[0][1]:
                    last["logits"] = entry_id
                    logits = np.frombuffer(data[b"logits"], dtype=np.float32).reshape(-1, 41)
                partial = self.service.decode_chunk(logits)
                r.xadd(self.partial_output_stream, {"lm_response_partial": partial})


_PARAM_CASTS = {
    "max_active": int, "min_active": int, "beam": float, "lattice_beam": float,
    "acoustic_scale": float, "ctc_blank_skip_threshold": float,
    "length_penalty": float, "nbest": int, "blank_penalty": float,
    "alpha": float, "do_opt": lambda v: bool(int(v)), "rescore": lambda v: bool(int(v)),
    "top_candidates_to_augment": int, "score_penalty_percent": float,
    "beam_width": int,
}


def _flatten(d: dict) -> dict:
    return {k: (int(v) if isinstance(v, bool) else v) for k, v in d.items() if v is not None}
