"""HF snapshot downloader.

Port of ``accessory_tpu/tools/download.py`` (reference
accessory/tools/download.py:19-60, misc.py:619-668 hf:// resolution). It
needs network access and ``huggingface_hub``, imported inside ``download``;
on a machine without either, place the files under --local_dir by hand and
pass the local path, which ``resolve_hf_path`` returns as it is.

Run: python -m accessory_tpu_torch.tools.download --repo_id org/name --local_dir dir/
"""

from __future__ import annotations

import argparse


def get_args_parser():
    p = argparse.ArgumentParser("download HF snapshot", add_help=False)
    p.add_argument("--repo_id", required=True, type=str)
    p.add_argument("--local_dir", default=None, type=str)
    p.add_argument("--allow_patterns", nargs="*", default=None)
    return p


def download(repo_id: str, local_dir=None, allow_patterns=None) -> str:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise ImportError("huggingface_hub not installed; place the files under --local_dir "
                          "and pass that path") from e
    return snapshot_download(repo_id, local_dir=local_dir, allow_patterns=allow_patterns)


def resolve_hf_path(path: str) -> str:
    """'hf://org/name' -> a local snapshot dir (downloaded); any other path
    as it is (reference meta.py:125-130)."""
    if not path.startswith("hf://"):
        return path
    return download(path[len("hf://"):])


if __name__ == "__main__":
    a = get_args_parser().parse_args()
    print(download(a.repo_id, a.local_dir, a.allow_patterns))
