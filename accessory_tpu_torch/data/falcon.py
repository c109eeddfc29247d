"""Pretraining iterable dataset over parquet shards (RefinedWeb / Falcon style).

Port of ``accessory_tpu/data/falcon.py`` (Falcon, batched):

  * the last file of the corpus is kept for validation, the rest train;
  * file-level sharding ``files[rank::num_shards]``;
  * a background thread reads the next parquet file while this one's items
    are served;
  * each item is tokenized with BOS / EOS and cut or 0-padded to
    ``max_words``;
  * resume through ``state_dict`` / ``load_state_dict`` ({_file_idx,
    _curr_idx}), which ``train/ckpt.py`` saves per data shard.

Parquet is read with pandas, imported at the read; where it is missing (the
card's machine has none) the read raises an ImportError that names it.
Items are numpy int32.
"""

from __future__ import annotations

import glob
import os
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from accessory_tpu_torch.data.alpaca import _require


def _split_files(files: List[str], split: str, rank: int, num_shards: int) -> List[str]:
    """The split's files (val: the last; train: the others, or the only one),
    then this shard's of them."""
    files = (files[:-1] if len(files) > 1 else files) if split == "train" else files[-1:]
    files = files[rank::num_shards] if num_shards > 1 else files
    if not files:
        raise ValueError(f"shard {rank} of {num_shards} has no {split} file")
    return files


class Falcon:
    def __init__(self, data_dir: str, max_words: int, tokenizer,
                 rank: int = 0, num_shards: int = 1, split: str = "train"):
        files = sorted(glob.glob(os.path.join(data_dir, "*.parquet")))
        if not files:
            raise FileNotFoundError(f"no parquet files under {data_dir}")
        self.files = _split_files(files, split, rank, num_shards)
        self.max_words = max_words
        self.tokenizer = tokenizer
        self._file_idx = 0
        self._curr_idx = 0
        self._prefetched: Dict[int, list] = {}
        self._prefetch_thread: Optional[threading.Thread] = None

    # -- resume -------------------------------------------------------------

    def state_dict(self) -> Dict[str, int]:
        return {"_file_idx": self._file_idx, "_curr_idx": self._curr_idx}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._file_idx = state["_file_idx"]
        self._curr_idx = state["_curr_idx"]

    # -- io -----------------------------------------------------------------

    def _read_file(self, idx: int) -> list:
        pd = _require("pandas", "parquet pretraining shards (data.falcon)")
        df = pd.read_parquet(self.files[idx % len(self.files)], columns=["content"])
        return df["content"].tolist()

    def _get_file(self, idx: int) -> list:
        if idx in self._prefetched:
            return self._prefetched.pop(idx)
        return self._read_file(idx)

    def _start_prefetch(self, idx: int) -> None:
        def work():
            self._prefetched[idx] = self._read_file(idx)

        self._prefetch_thread = threading.Thread(target=work, daemon=True)
        self._prefetch_thread.start()

    # -- iteration ----------------------------------------------------------

    def _encode(self, text: str) -> np.ndarray:
        t = self.tokenizer.encode(text, bos=True, eos=True)[: self.max_words]
        return np.asarray(t + [0] * (self.max_words - len(t)), np.int32)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            contents = self._get_file(self._file_idx)
            self._start_prefetch(self._file_idx + 1)      # the next file's read overlaps
            while self._curr_idx < len(contents):
                item = contents[self._curr_idx]
                self._curr_idx += 1
                yield self._encode(item)
            if self._prefetch_thread is not None:
                self._prefetch_thread.join()
            self._file_idx += 1
            self._curr_idx = 0


def batched(it: Iterator[np.ndarray], batch_size: int) -> Iterator[np.ndarray]:
    """Stack an item iterator into (batch, max_words) arrays (a last partial
    batch is dropped)."""
    buf: List[np.ndarray] = []
    for item in it:
        buf.append(item)
        if len(buf) == batch_size:
            yield np.stack(buf)
            buf = []
