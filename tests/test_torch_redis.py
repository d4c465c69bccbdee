"""The Redis-stream protocol of the port (serve/redis_adapter.py ↔
serve/redis_client.py) over its in-process fake redis: the cases of
tests/test_redis_protocol.py, and, for the same logits, the JAX package's
server and the port's putting the same entries on every stream.

One fake is installed (the port's ``fakeredis``): both packages' adapters
take whatever ``import redis`` finds when they are built, and
``reset_all()`` runs before every server so no two share streams."""

import shutil
import sys
import threading
import time

import numpy as np
import pytest

from b2txt_tpu.lm import Lexicon as JaxLexicon
from b2txt_tpu.lm import train_ngram as jax_train_ngram
from b2txt_tpu.serve.redis_adapter import RedisDecoderServer as JaxRedisDecoderServer
from b2txt_tpu.serve.service import DecoderService as JaxDecoderService
from b2txt_tpu.utils.config import DecodeConfig as JaxDecodeConfig
from b2txt_tpu_torch.lm import Lexicon, train_ngram
from b2txt_tpu_torch.serve import fakeredis
from b2txt_tpu_torch.serve.redis_adapter import RedisDecoderServer
from b2txt_tpu_torch.serve.redis_client import RemoteLMClient
from b2txt_tpu_torch.serve.service import DecoderService
from b2txt_tpu_torch.utils.config import DecodeConfig
from b2txt_tpu_torch.utils.phonemes import rearrange_speech_logits

LEX = {
    "the": ["DH", "AH"],
    "cat": ["K", "AE", "T"],
    "sat": ["S", "AE", "T"],
    "mat": ["M", "AE", "T"],
    "on": ["AA", "N"],
}
CORPUS = ["the cat sat on the mat".split(), "the cat sat".split()] * 4
KNOBS = dict(acoustic_scale=0.5, blank_penalty=1.0, nbest=5, beam_width=32, beam=0.0)


@pytest.fixture(autouse=True)
def _redis_module_restored(monkeypatch):
    """The port's fake is ``redis`` only for the test that installs it: the
    JAX package's Redis tests, which may run next in the same worker, read
    the fake they installed when imported."""
    for name in ("redis", "redis.exceptions"):
        monkeypatch.setitem(sys.modules, name, sys.modules.get(name))


def make_service(backend="python") -> DecoderService:
    return DecoderService(Lexicon.from_words(LEX), train_ngram(CORPUS, order=2),
                          DecodeConfig(**KNOBS), channel_order="lm", searcher_backend=backend)


def make_jax_service(backend="python") -> JaxDecoderService:
    return JaxDecoderService(JaxLexicon.from_words(LEX), jax_train_ngram(CORPUS, order=2),
                             JaxDecodeConfig(**KNOBS), channel_order="lm",
                             searcher_backend=backend)


def clean_logits(sentence, hot=6.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for pid in Lexicon.from_words(LEX).sentence_to_phonemes(sentence):
        for _ in range(2):
            row = np.full(41, -hot, np.float32)
            row[pid] = 0.0
            rows.append(row)
        blank = np.full(41, -hot, np.float32)
        blank[0] = 0.0
        rows.append(blank)
    model_order = np.stack(rows)
    model_order += noise * rng.standard_normal(model_order.shape).astype(np.float32)
    return rearrange_speech_logits(model_order)  # LM wire order


class Running:
    """A server looping in a thread over a fresh fake redis, and a client."""

    def __init__(self, server_cls, service):
        fakeredis.install_fake_redis()
        fakeredis.reset_all()
        self.service = service
        self.server = server_cls(service)
        self.thread = threading.Thread(target=self.server.run, daemon=True)
        self.thread.start()
        time.sleep(0.05)  # let the server connect and initialize stream cursors
        self.client = RemoteLMClient()

    def stop(self):
        self.server.stop()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()


@pytest.fixture()
def running():
    r = Running(RedisDecoderServer, make_service())
    yield r.service, r.server, r.client
    r.stop()


def test_full_decode_round_trip(running):
    service, server, client = running
    client.reset()
    partial = client.send_logits(clean_logits("the cat sat"))
    assert partial  # server streamed a partial sentence back
    final = client.finalize()
    assert final.sentence == "the cat sat"
    # ';'-packed 5-tuple scoring parsed into (sentence, ac, ngram, llm, total)
    assert final.nbest and len(final.nbest[0]) == 5
    assert final.nbest[0][0] == "the cat sat"


def test_chunked_logits_and_reset_between_utterances(running):
    service, server, client = running
    client.reset()
    logits = clean_logits("the cat sat on the mat")
    for i in range(0, logits.shape[0], 7):
        client.send_logits(logits[i : i + 7])
    assert client.finalize().sentence == "the cat sat on the mat"
    client.reset()
    client.send_logits(clean_logits("the mat"))
    assert client.finalize().sentence == "the mat"


def test_update_params_ack_and_mirror(running):
    service, server, client = running
    client.update_params(acoustic_scale=0.7, nbest=3, blank_penalty=2.0)
    assert service.config.acoustic_scale == 0.7
    assert service.config.nbest == 3
    assert service.config.blank_penalty == 2.0
    entries = fakeredis.Redis().xread({"remote_lm_args": 0})
    assert entries
    assert entries[0][1][-1][1][b"acoustic_scale"] == b"0.7"


def test_context_key_reaches_service(running):
    service, server, client = running
    client.set_context("we were talking about pets")
    client.reset()
    client.send_logits(clean_logits("the cat"))
    client.finalize()
    assert service.context == "we were talking about pets"


def test_reconnect_state_machine(running):
    """The server rides out a lost connection and serves afterwards."""
    service, server, client = running
    client.reset()
    assert client.send_logits(clean_logits("the cat"))
    assert client.finalize().sentence == "the cat"
    fakeredis.set_down(True)
    time.sleep(0.3)   # server loop observes the loss → state 0
    fakeredis.set_down(False)
    time.sleep(1.3)   # server retries after its 1 s backoff
    client.reset()
    client.send_logits(clean_logits("the mat"))
    assert client.finalize().sentence == "the mat"


def _session(server_cls, service):
    """One client session (update_params, a context, two chunked utterances,
    noisy logits) against a server; returns every stream's entries, ids
    dropped."""
    r = Running(server_cls, service)
    try:
        c = r.client
        c.update_params(acoustic_scale=0.6, nbest=4)
        c.set_context("about the cat")
        for k, sent in enumerate(["the cat sat on the mat", "the mat"]):
            c.reset()
            logits = clean_logits(sent, hot=4.0, noise=0.5, seed=k)
            for i in range(0, logits.shape[0], 5):
                c.send_logits(logits[i : i + 5])
            c.finalize()
    finally:
        r.stop()
    streams = fakeredis._server("localhost", 6379).streams
    return {name: [data for _, data in entries] for name, entries in streams.items()}


@pytest.mark.parametrize("backend", ["python", "native"])
def test_both_packages_put_the_same_entries_on_every_stream(backend):
    if backend == "native" and shutil.which("g++") is None:
        pytest.skip("g++ not available")
    theirs = _session(JaxRedisDecoderServer, make_jax_service(backend))
    ours = _session(RedisDecoderServer, make_service(backend))
    assert set(ours) >= {b"remote_lm_output_partial", b"remote_lm_output_final",
                         b"remote_lm_args", b"remote_lm_done_finalizing"}
    assert ours == theirs
