"""The framework-free modules the port carries as copies stay equal to their
originals in the JAX package."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

COPIES = [
    "utils/phonemes.py", "utils/metrics.py", "lm/arpa.py", "lm/ngram.py",
    "lm/lexicon.py", "decode/lmbeam.py", "decode/lattice.py", "decode/rescore.py",
    "data/sampler.py", "utils/logging.py",
    "runtime/decoder.cc", "runtime/ngram_train.cc", "data/real_assets.py", "utils/lts.py",
    "utils/g2p.py", "evaluate/golden.py", "serve/fakeredis.py", "serve/redis_adapter.py",
    "serve/redis_client.py", "utils/bpe.py", "decode/prefix_beam.py", "lm/corpus.py",
    "data/adversarial.py", "data/download.py", "analysis/figures.py", "analysis/plots.py",
    "analysis/notebook_data.py",
]


# the one change a copy carries: (the port's text, the original's text), or
# a list of such pairs where the change touches several places
CHANGED = {
    "lm/ngram.py": (
        """    # the unigram normalizers do not depend on the word: summed once here,
    # not in every call (a sum over the vocabulary per word is quadratic)
    uni_total = (sum(c for g, c in counts[0].items() if g != (BOS,)) if order == 1
                 else sum(cont[0].values()))
    uni_types = len(cont[0])

    def unigram_p(w: str) -> float:
        if order == 1:
            total = uni_total
            return (counts[0].get((w,), 0) + 0.5) / (total + 0.5 * V)
        total = uni_total
        nt = uni_types
""",
        """    def unigram_p(w: str) -> float:
        if order == 1:
            total = sum(c for g, c in counts[0].items() if g != (BOS,))
            return (counts[0].get((w,), 0) + 0.5) / (total + 0.5 * V)
        total = sum(cont[0].values())
        nt = len(cont[0])
"""),
    # device=None means the card (and raises without one), as every entry
    # point of the port; the original falls back to the CPU
    "decode/rescore.py": (
        """        import torch
        from ..utils.device import resolve_device

        self.torch = torch
        self.device = str(resolve_device(device))
""",
        """        import torch

        self.torch = torch
        self.device = device or ("cuda" if torch.cuda.is_available() else "cpu")
"""),
    # the reference checkout defaults to ./reference (B2TXT_REFERENCE_ROOT names
    # another); the original's default is a path of the machine it was written on
    "data/real_assets.py": (
        '''REFERENCE_ROOT = os.environ.get("B2TXT_REFERENCE_ROOT", "reference")''',
        next(ln for ln in (ROOT / "b2txt_tpu/data/real_assets.py").read_text().splitlines()
             if ln.startswith("REFERENCE_ROOT = "))),
    # the port's logger, and the request id a reset starts
    "serve/redis_adapter.py": [
        ('''LOG = logging.getLogger("b2txt_tpu_torch.serve.redis")''',
         '''LOG = logging.getLogger("b2txt_tpu.serve.redis")'''),
        ('''                # the request's id is the reset message's stream entry id
                self.service.reset(request_id=last["reset"])
''', '''                self.service.reset()
''')],
    # the native trainer sums the unigram normalizers once per estimate (the
    # original sums them in every UnigramP call: quadratic in the vocabulary,
    # ~50 s at 125k words); integer sums, so the same floats
    "runtime/ngram_train.cc": [
        ("""  std::vector<std::unordered_map<uint64_t, int64_t>> type_counts;  // per order
  // the unigram normalizers do not depend on the word: summed once in
  // Estimate, not in every UnigramP call (a sum over the vocabulary per word
  // is quadratic: ~50 s at 125k words)
  int64_t uni_total = 0, uni_types = 0;
""", """  std::vector<std::unordered_map<uint64_t, int64_t>> type_counts;  // per order
"""),
        ("""  void SumUnigramNormalizers() {
    uni_total = uni_types = 0;
    if (order == 1) {
      for (size_t i = 0; i < counts[0].size(); ++i)
        if (counts[0].Gram(static_cast<int32_t>(i))[0] != bos)
          uni_total += counts[0].count[i];
      return;
    }
    for (size_t i = 0; i < cont[0].size(); ++i) {
      uni_total += cont[0].count[i];
      uni_types++;
    }
  }

  double UnigramP(int w, const std::vector<int>& vw) const {
    int V = static_cast<int>(vw.size());
    if (order == 1) {
      int64_t total = uni_total;
""", """  double UnigramP(int w, const std::vector<int>& vw) const {
    int V = static_cast<int>(vw.size());
    if (order == 1) {
      int64_t total = 0;
      for (size_t i = 0; i < counts[0].size(); ++i)
        if (counts[0].Gram(static_cast<int32_t>(i))[0] != bos)
          total += counts[0].count[i];
"""),
        ("""    int64_t total = uni_total;
    int64_t nt = uni_types;
""", """    int64_t total = 0;
    int64_t nt = 0;
    for (size_t i = 0; i < cont[0].size(); ++i) {
      total += cont[0].count[i];
      nt++;
    }
"""),
        ("""    SumUnigramNormalizers();
""", ""),
    ],
    # matplotlib is imported where a figure is drawn, not with the module, so
    # the module (and the analysis package) imports on a host without it
    "analysis/notebook_data.py": [
        ("from .figures import cumulative_usage\n\n\n",
         """from .figures import cumulative_usage
from .plots import (
    plot_correctness_by_day,
    plot_correctness_pie,
    plot_cumulative_usage,
    plot_error_rates_by_day,
    plot_logit_raster,
)


"""),
        ("""    # matplotlib only where a figure is drawn: the rest imports without it
    from .plots import plot_error_rates_by_day, plot_logit_raster

""", ""),
        ("""    from .plots import plot_correctness_by_day, plot_correctness_pie, plot_cumulative_usage

""", ""),
    ],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    """Verbatim, but for the one change listed in CHANGED."""
    ours = (ROOT / "b2txt_tpu_torch" / rel).read_text()
    changes = CHANGED.get(rel, [])
    for port_text, original in changes if isinstance(changes, list) else [changes]:
        assert ours.count(port_text) == 1
        ours = ours.replace(port_text, original)
    assert ours == (ROOT / "b2txt_tpu" / rel).read_text()


def test_lts_asset_is_byte_identical_and_loads():
    """The packaged letter-to-sound model sits beside the port's package, so
    the port's g2p loads it (a missing asset would fall back to the rules
    without a word)."""
    from b2txt_tpu_torch.utils.g2p import G2p
    from b2txt_tpu_torch.utils.lts import LetterToSound

    rel = "assets/lts_cmudict.json.gz"
    assert (ROOT / "b2txt_tpu_torch" / rel).read_bytes() == (ROOT / "b2txt_tpu" / rel).read_bytes()
    assert Path(LetterToSound.pretrained_path()) == ROOT / "b2txt_tpu_torch" / rel
    assert G2p().lts is not None


def test_causal_lm_rescorer_runs_on_the_card_unless_told_otherwise():
    """``device=None`` means the card and raises without one; ``device="cpu"``
    builds on the CPU (a stand-in model and tokenizer: nothing is loaded)."""
    from types import SimpleNamespace
    from unittest import mock

    import torch

    from b2txt_tpu_torch.decode.rescore import TorchCausalLMRescorer

    def parts():
        return {"model": torch.nn.Linear(2, 2), "tokenizer": SimpleNamespace(pad_token="<eos>")}

    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchCausalLMRescorer(**parts())
        r = TorchCausalLMRescorer(**parts(), device="cpu")
    assert r.device == "cpu" and r.tokenizer.padding_side == "right"


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_train_ngram_equals_the_original(order):
    """The port's trainer sums the unigram normalizers once (linear in the
    vocabulary where the original is quadratic: minutes at 125k words); the
    tables are the original's, value for value."""
    import numpy as np

    from b2txt_tpu.lm import train_ngram as original
    from b2txt_tpu_torch.lm import train_ngram

    rng = np.random.default_rng(order)
    words = [f"w{i}" for i in range(60)]
    corpus = [[words[j] for j in rng.integers(0, 60, rng.integers(2, 9))] for _ in range(200)]
    assert train_ngram(corpus, order=order).tables == original(corpus, order=order).tables
    vocab = words[:40]
    assert (train_ngram(corpus, order=order, vocab=vocab).tables
            == original(corpus, order=order, vocab=vocab).tables)


def test_config_copy_differs_only_in_the_yaml_import():
    """The port's config imports PyYAML inside save/load, so the port imports
    without it; the dataclasses and their defaults are the same."""
    from b2txt_tpu.utils import config as ref
    from b2txt_tpu_torch.utils import config as ours

    def strip(path):
        return [ln for ln in path.read_text().splitlines()
                if ln.strip() and "import yaml" not in ln]

    assert strip(ROOT / "b2txt_tpu_torch/utils/config.py") == strip(
        ROOT / "b2txt_tpu/utils/config.py")
    assert ours.TrainConfig().to_dict() == ref.TrainConfig().to_dict()
    assert ours.DecodeConfig().to_dict() == ref.DecodeConfig().to_dict()


def test_hdf5_store_copy_differs_only_in_the_h5py_import():
    """The port imports h5py inside the functions that read or write HDF5,
    so training from trials in memory needs no h5py."""
    def strip(path):
        return [ln for ln in path.read_text().splitlines()
                if ln.strip() and "import h5py" not in ln]

    assert strip(ROOT / "b2txt_tpu_torch/data/hdf5_store.py") == strip(
        ROOT / "b2txt_tpu/data/hdf5_store.py")


def test_synthetic_copy_is_verbatim_plus_in_memory_trials():
    ours = (ROOT / "b2txt_tpu_torch/data/synthetic.py").read_text()
    ref = (ROOT / "b2txt_tpu/data/synthetic.py").read_text()
    assert ours.startswith(ref)
    assert "def synthetic_trials(" in ours[len(ref):]


# functions and tables the port copies from the programs outside the JAX
# package: (the port's file under b2txt_tpu_torch/, the original, names)
OUTSIDE = [
    ("scripts/world.py", "bench.py",
     ["build_world", "make_planted_utts", "score_results", "aggregate_wer"]),
    ("scripts/quality_ladder.py", "scripts/quality_ladder.py", ["pool_metrics"]),
    ("examples/lattice_demo.py", "examples/lattice_demo.py", ["main"]),
    ("examples/spelling_demo.py", "examples/spelling_demo.py",
     ["FALLBACK_WORDS", "spelled_corpus", "main"]),
    ("examples/conversation_demo.py", "examples/conversation_demo.py",
     ["LEX", "DECODE_CORPUS", "LLM_CORPUS", "clean_logits"]),
]


def _top_level(path: Path, package: str):
    """{name: AST dump} of a file's top-level functions and assignments,
    docstrings dropped and relative imports resolved against ``package``,
    with the port's package named as the JAX package."""
    import ast

    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            base = package.split(".")[: len(package.split(".")) - node.level + 1]
            node.module = ".".join(base + ([node.module] if node.module else []))
            node.level = 0
        if isinstance(node, ast.ImportFrom) and node.module.startswith("b2txt_tpu_torch"):
            node.module = "b2txt_tpu" + node.module[len("b2txt_tpu_torch"):]
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                node.body = body[1:]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


@pytest.mark.parametrize("port,original,names", OUTSIDE, ids=[o[0] for o in OUTSIDE])
def test_copies_of_the_programs_are_verbatim(port, original, names):
    """The same code but for docstrings, comments and imports, which name
    the port's modules relatively."""
    package = "b2txt_tpu_torch." + port.rsplit("/", 1)[0].replace("/", ".")
    ours = _top_level(ROOT / "b2txt_tpu_torch" / port, package)
    theirs = _top_level(ROOT / original, "")
    for name in names:
        assert ours[name] == theirs[name], name


@pytest.mark.parametrize("name", ["figure_2.ipynb", "figure_4.ipynb"])
def test_notebooks_are_the_jax_ones_over_the_port(name):
    """The port's notebooks are the JAX package's with the port's package
    and their place in it (two levels below the root) swapped in."""
    import json

    def code(path):
        nb = json.loads(path.read_text())
        return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]

    ours = [src.replace("b2txt_tpu_torch.analysis", "b2txt_tpu.analysis")
               .replace('sys.path.insert(0, os.path.join("..", ".."))', 'sys.path.insert(0, "..")')
               .replace('os.path.join("..", "..", "data",', 'os.path.join("..", "data",')
            for src in code(ROOT / "b2txt_tpu_torch" / "analyses" / name)]
    assert ours == code(ROOT / "analyses" / name)
