"""The framework-free modules the port carries as copies stay equal to their
originals in the JAX package."""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

COPIES = [
    "utils/phonemes.py", "utils/metrics.py", "lm/arpa.py", "lm/ngram.py",
    "lm/lexicon.py", "decode/lmbeam.py", "decode/lattice.py", "decode/rescore.py",
    "data/sampler.py", "utils/logging.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_verbatim(rel):
    ours = (ROOT / "b2txt_tpu_torch" / rel).read_text()
    assert ours == (ROOT / "b2txt_tpu" / rel).read_text()


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
