from .hdf5_store import (
    Trial,
    load_session_file,
    read_trial,
    session_name_from_path,
    train_test_split_indices,
    write_session_file,
)
from .sampler import BatchSampler
from .loader import BatchLoader, batch_to_device, collate, prefetch_iterator
from . import synthetic
