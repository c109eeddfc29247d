"""Offline token packing for pretraining.

Port of ``accessory_tpu/tools/generate_packed_data.py``: each parquet file's
"content" rows are tokenized with BOS / EOS, concatenated, sliced into
``max_words``-token sequences by ``native.pack_stream`` (the C library, or
its numpy version where none is built) and pickled as one list of token
lists per source file, which ``data.FalconPacked`` reads.

    python -m accessory_tpu_torch.tools.generate_packed_data --data_dir parquet/ \\
        --out_dir packed/ --tokenizer_path tokenizer.model [--max_words 2048]
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
from pathlib import Path


def get_args_parser():
    p = argparse.ArgumentParser("pack pretraining data", add_help=False)
    p.add_argument("--data_dir", required=True, type=str)
    p.add_argument("--out_dir", required=True, type=str)
    p.add_argument("--tokenizer_path", required=True, type=str)
    p.add_argument("--max_words", default=2048, type=int)
    return p


def pack_tokens(stream, out_path: str, max_words: int) -> int:
    """Slice a token stream into ``max_words`` rows and pickle them as token
    lists; returns the row count."""
    import numpy as np

    from accessory_tpu_torch import native

    arr = native.pack_stream(np.asarray(stream, np.int32), max_words)
    packed = [row.tolist() for row in arr]
    with open(out_path, "wb") as f:
        pickle.dump(packed, f)
    return len(packed)


def pack_file(path: str, out_path: str, tokenizer, max_words: int) -> int:
    from accessory_tpu_torch.data.alpaca import _require

    pd = _require("pandas", "parquet input (generate_packed_data)")
    df = pd.read_parquet(path, columns=["content"])
    stream = []
    for text in df["content"]:
        stream.extend(tokenizer.encode(text, bos=True, eos=True))
    return pack_tokens(stream, out_path, max_words)


def main(args) -> None:
    from accessory_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer(args.tokenizer_path)
    os.makedirs(args.out_dir, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(args.data_dir, "*.parquet"))):
        out = os.path.join(args.out_dir, Path(f).stem + ".pkl")
        n = pack_file(f, out, tok, args.max_words)
        print(f"{f} -> {out}: {n} sequences")


if __name__ == "__main__":
    main(get_args_parser().parse_args())
