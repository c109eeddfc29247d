"""Pretraining iterable over pre-tokenized packed shards.

Port of ``accessory_tpu/data/falcon_packed.py`` (FalconPacked): the skeleton
of ``data/falcon.py`` (the validation file, sharding, prefetch, resume) over
``.pkl`` files of fixed-length token lists, which
``tools/generate_packed_data.py`` writes offline, so the hot loop tokenizes
nothing.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from accessory_tpu_torch.data.falcon import Falcon, _split_files


class FalconPacked(Falcon):
    def __init__(self, data_dir: str, rank: int = 0, num_shards: int = 1,
                 split: str = "train"):
        files = sorted(glob.glob(os.path.join(data_dir, "*.pkl")))
        if not files:
            raise FileNotFoundError(f"no packed .pkl files under {data_dir}")
        self.files = _split_files(files, split, rank, num_shards)
        self.max_words = None
        self.tokenizer = None
        self._file_idx = 0
        self._curr_idx = 0
        self._prefetched = {}
        self._prefetch_thread = None

    def _read_file(self, idx: int) -> list:
        with open(self.files[idx % len(self.files)], "rb") as f:
            return pickle.load(f)

    def _encode(self, item) -> np.ndarray:      # the items are token lists already
        return np.asarray(item, np.int32)
