"""Finetune dataset and grouped distributed sampler.

Port of ``accessory_tpu/data/alpaca.py`` (MetaPreprocessor, FinetuneDataset,
FinetuneDistSampler): a META config of annotation files, each of one
``type``; items grouped by type and length-sorted within it; the prompt
masked out of the labels, 0-padding; every global batch drawn from ONE type,
resumable at (epoch, start_iter). Outputs are numpy.

The card's machine has no PyYAML, so the config is read by
``read_meta_config``: the reference's shape (a ``META:`` list of flat
mappings of scalars, comments, quoted or plain values) or a ``.json`` file of
the same structure. ``.csv`` annotation files (tab-separated, read with
pandas), the h5 on-disk annotation cache (``cache_on_disk``, h5py) and items
with an image (PIL through ``data_reader``, then ``transform``; the text
budget is ``max_words - image_words``) import their package at the call:
where it is missing, the call raises an ImportError that names it.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import re
import warnings
from pathlib import Path
from time import sleep
from typing import Any, Dict, Iterator, List

import numpy as np

from accessory_tpu_torch.data.data_reader import read_img_general
from accessory_tpu_torch.data.system_prompt import format_prompt


def _require(package: str, what: str):
    """``package`` imported, or an ImportError that names it and what needs it."""
    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{what} need the {package!r} package, which is not installed") from e

_INT = re.compile(r"[-+]?[0-9]+")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9]+(\.[0-9]*)?)([eE][-+]?[0-9]+)?")


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _scalar(v: str, where: str):
    """A YAML plain or quoted scalar (the forms a META entry uses)."""
    if len(v) >= 2 and v[0] == v[-1] and v[0] in "'\"":
        body = v[1:-1]
        return body.replace("''", "'") if v[0] == "'" else json.loads(v)
    if v[:1] in "[{&*!|>":
        raise ValueError(f"{where}: {v!r} is not a plain scalar (the META reader takes a list "
                         "of flat mappings of scalars; use a .json config for more)")
    if v in ("", "~", "null", "Null", "NULL"):
        return None
    if v in ("true", "True", "TRUE"):
        return True
    if v in ("false", "False", "FALSE"):
        return False
    if _INT.fullmatch(v):
        return int(v)
    if _FLOAT.fullmatch(v):
        return float(v)
    return v


def _key_value(body: str, where: str):
    m = re.match(r"""("[^"]*"|'[^']*'|[^:'"]+):(?:\s+(.*))?$""", body)
    if not m:
        raise ValueError(f"{where}: expected 'key: value', got {body!r}")
    key = m.group(1).strip()
    if key[:1] in "'\"":
        key = key[1:-1]
    return key, (m.group(2) or "").strip()


def read_meta_config(path: str) -> Dict[str, Any]:
    """A finetune data config: ``.json`` as it is; otherwise the YAML subset
    the reference's configs use (top-level ``key: scalar`` lines and
    ``key:`` blocks of ``- key: value`` mappings, configs/data/*.yaml)."""
    with open(path) as f:
        text = f.read()
    if os.path.splitext(path)[-1] == ".json":
        return json.loads(text)
    out: Dict[str, Any] = {}
    block, item = None, None
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{path}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if "\t" in line[:indent + 1]:
            raise ValueError(f"{where}: tabs in indentation")
        body = line.strip()
        if indent == 0:
            key, val = _key_value(body, where)
            block, item = (key, None) if val == "" else (None, None)
            out[key] = [] if val == "" else _scalar(val, where)
        elif block is None:
            raise ValueError(f"{where}: indented line outside a block")
        elif body == "-" or body.startswith("- "):
            item = {}
            out[block].append(item)
            if body[1:].strip():
                key, val = _key_value(body[1:].strip(), where)
                item[key] = _scalar(val, where)
        elif item is None:
            raise ValueError(f"{where}: a block holds a list of mappings ('- key: value')")
        else:
            key, val = _key_value(body, where)
            item[key] = _scalar(val, where)
    return out


class MetaPreprocessor:
    """Annotation-format adapters (reference alpaca.py:212-244)."""

    def preprocess(self, meta_l: List[Dict], recipe: str) -> List[Dict]:
        return getattr(self, f"_{recipe}")(meta_l)

    @staticmethod
    def _single_turn_llava(meta_l):
        return [{
            "image": d["image"],
            "instruction": d["conversations"][0]["value"],
            "output": d["conversations"][1]["value"],
        } for d in meta_l]

    @staticmethod
    def _caption(meta_l):
        out = []
        for d in meta_l:
            cap = d["caption"]
            if isinstance(cap, list):
                cap = random.choice(cap)
            out.append({"image": d["url"], "output": cap})
        return out


def _read_meta_file(meta_path: str) -> List[Dict]:
    ext = os.path.splitext(meta_path)[-1]
    if ext == ".json":
        with open(meta_path) as f:
            return json.load(f)
    if ext == ".jsonl":
        with open(meta_path) as f:
            return [json.loads(line) for line in f]
    if ext == ".csv":
        pd = _require("pandas", ".csv annotation files")
        return pd.read_csv(meta_path, sep="\t", engine="pyarrow").to_dict(orient="records")
    raise NotImplementedError(f"unknown meta extension {ext}")


def _collect(config) -> tuple:
    """(the annotations grouped by type, length-sorted within a type, one
    list; {type: [start, end)})."""
    group_ann: Dict[str, List[Dict]] = {}
    for meta in config["META"]:
        meta_l = _read_meta_file(meta["path"])
        if meta.get("preprocess"):
            meta_l = MetaPreprocessor().preprocess(meta_l, meta["preprocess"])
        prompt_type = meta.get("prompt_type", "alpaca")
        for item in meta_l:
            item["sys_prompt"] = prompt_type
        group_ann.setdefault(meta["type"], []).extend(meta_l)

    # length sort within a type: batches of similar length; dialog items
    # (no instruction / output keys) sort by their total text
    def sort_key(d):
        try:
            return len(format_prompt(d, d["sys_prompt"]) + d["output"])
        except KeyError:
            return sum(len(s.get("value", "")) for s in d.get("conversations", []))

    for meta_l in group_ann.values():
        meta_l.sort(key=sort_key)
    ranges, start = {}, 0
    for t, meta_l in group_ann.items():
        ranges[t] = [start, start + len(meta_l)]
        start += len(meta_l)
    return sum(group_ann.values(), start=[]), ranges


class FinetuneDataset:
    """``cache_on_disk``: rank 0 writes the collected annotations once to
    ``./accessory_data_cache/<config path>/data.h5`` (one JSON string an
    item and the type ranges) and marks it ready; every rank then reads
    its items from that file (the other ranks wait for the mark)."""

    def __init__(self, config_path: str, transform=None, max_words: int = 30,
                 image_words: int = 257, tokenizer=None, cache_on_disk: bool = False,
                 rank: int = 0):
        self.config = read_meta_config(config_path)
        self.cache_on_disk = cache_on_disk
        if cache_on_disk:
            h5py = _require("h5py", "the on-disk annotation cache (cache_on_disk)")
            ident = config_path
            for ch in ["/", "\\", ".", "?", "!"]:
                ident = ident.replace(ch, "-")
            cache_dir = Path(f"./accessory_data_cache/{ident}")
            if rank == 0:
                cache_dir.mkdir(parents=True, exist_ok=True)
            if rank == 0 and not ((cache_dir / "data.h5").exists()
                                  and (cache_dir / "ready").exists()):
                ann, ranges = _collect(self.config)
                with h5py.File(cache_dir / "data.h5", "w") as f:
                    ds = f.create_dataset("ann", (len(ann),), dtype=h5py.vlen_dtype(str))
                    ds[:] = [json.dumps(a) for a in ann]
                    f.create_dataset("group_indice_range", data=json.dumps(ranges))
                (cache_dir / "ready").write_text("ready")
            while not (cache_dir / "ready").exists():
                sleep(1)
            cache_file = h5py.File(cache_dir / "data.h5", "r")
            self.ann = cache_file["ann"]
            ranges = json.loads(cache_file["group_indice_range"].asstr()[()])
        else:
            self.ann, ranges = _collect(self.config)
        self.group_indices = {t: list(range(lo, hi)) for t, (lo, hi) in ranges.items()}
        self.transform = transform
        self.max_words = max_words
        self.image_words = image_words
        self.tokenizer = tokenizer

    def __len__(self) -> int:
        return len(self.ann)

    def __getitem__(self, index: int):
        """(tokens, labels, tokens mask) as numpy, and the image (the
        transform's output, or the RGB pixels as an array without one) for
        an item with an image, whose text then has ``max_words -
        image_words`` positions."""
        item = self.ann[index]
        if self.cache_on_disk:
            item = json.loads(item)
        image = item.get("image")
        if image is not None:
            _require("PIL", "items with an image")
            image = read_img_general(image)
            image = self.transform(image) if self.transform else np.asarray(image)
        answer = item["output"]
        prompt = format_prompt(item, item["sys_prompt"])
        t_prompt = self.tokenizer.encode(prompt, bos=True, eos=False)
        t_full = self.tokenizer.encode(prompt + answer, bos=True, eos=True)

        max_words = self.max_words - (self.image_words if image is not None else 0)
        tokens = np.array(t_full, np.int32)
        if len(tokens) > max_words:
            warnings.warn(f"truncating overlong input ({len(tokens)} > {max_words})")
            tokens = tokens[:max_words]
        pad = max_words - len(tokens)
        tokens = np.concatenate([tokens, np.full(pad, -1, np.int32)])

        labels = tokens.copy()
        labels[:len(t_prompt)] = -1  # the prompt is not scored
        tokens_mask = tokens >= 0
        labels_mask = labels >= 0
        tokens = np.where(tokens_mask, tokens, 0)
        labels = np.where(labels_mask, labels, 0)
        if image is None:
            return tokens, labels, tokens_mask.astype(np.float32)
        return tokens, labels, tokens_mask.astype(np.float32), image

    def groups(self) -> List[List[int]]:
        return list(self.group_indices.values())


class FinetuneDistSampler:
    """Distributed grouped sampler: every global batch comes from a single
    dataset type; resumable via ``set_epoch(epoch, start_iter)``. On one
    device num_replicas is 1 (the rank / replica arithmetic is kept for the
    data-parallel port, ROADMAP A10)."""

    def __init__(self, dataset: FinetuneDataset, num_replicas: int, rank: int,
                 shuffle: bool = True, seed: int = 0, batch_size: int = None,
                 acc_grad: int = 1):
        if batch_size is None or not 0 <= rank < num_replicas:
            raise ValueError(f"batch_size {batch_size}, rank {rank} of {num_replicas}")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.batch_size = batch_size
        self.acc_grad = acc_grad
        self.epoch = 0
        self.start_iter = 0

        global_bsz = batch_size * num_replicas * acc_grad
        self.group_len = {}
        total = 0
        for i, g in enumerate(dataset.groups()):
            trimmed = len(g) // global_bsz * global_bsz
            self.group_len[i] = trimmed
            total += trimmed
        self.total_size = total
        self.num_samples = total // num_replicas

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        global_bsz = self.batch_size * self.num_replicas * self.acc_grad
        rng = random.Random(self.seed + self.epoch)
        global_batches: List[List[int]] = []
        for gi, g in enumerate(self.dataset.groups()):
            g = list(g)
            if self.shuffle:
                rng.shuffle(g)
            g = g[:self.group_len[gi]]
            for i in range(0, len(g), global_bsz):
                global_batches.append(g[i:i + global_bsz])
        if self.shuffle:
            rng.shuffle(global_batches)

        indices: List[int] = []
        own = self.batch_size * self.acc_grad
        for gb in global_batches:
            start = self.rank * own
            indices.extend(gb[start:start + own])
        assert len(indices) == self.num_samples
        # resume: skip the iterations already consumed
        skip = self.start_iter * self.batch_size * self.acc_grad
        return iter(indices[skip:])

    def set_epoch(self, epoch: int, start_iter: int = 0) -> None:
        self.epoch = epoch
        self.start_iter = start_iter
