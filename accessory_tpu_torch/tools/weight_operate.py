"""Extract / apply weight deltas between checkpoints.

Port of ``accessory_tpu/tools/weight_operate.py`` (reference
accessory/tools/weight_operate.py:17-30: delta = finetuned - base in f32,
stored f16; apply = base + delta in f32, stored in the base's dtype). Used
to ship finetunes as diff checkpoints. Reads and writes the native
checkpoint format with the port's numpy container (no ``safetensors``, no
torch): bf16 leaves travel as their raw bits and round to nearest even on
the way back. Keys absent from the base, and quantized leaves (``#`` parts),
ship whole.

Usage:
  python -m accessory_tpu_torch.tools.weight_operate --operate_type extract \\
      --pretrained_path base/ --delta_path finetuned/ --output_path delta/
  python -m accessory_tpu_torch.tools.weight_operate --operate_type apply \\
      --pretrained_path base/ --delta_path delta/ --output_path merged/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("weight delta extract/apply", add_help=False)
    p.add_argument("--pretrained_path", required=True, type=str)
    p.add_argument("--delta_path", required=True, type=str)
    p.add_argument("--output_path", default="./output", type=str)
    p.add_argument("--operate_type", default="apply", choices=["extract", "apply"])
    return p


def _load_flat(path):
    from accessory_tpu_torch.checkpoint.native import _read_flat, _read_quant_meta

    return _read_flat(path), _read_quant_meta(path)


def _save_flat(path, flat, quant):
    from accessory_tpu_torch.checkpoint.native import _write_flat

    _write_flat(path, flat, quant_meta=quant)


def extract_delta(base_path: str, finetuned_path: str, out_path: str) -> None:
    from accessory_tpu_torch.convert import _f32

    base, _ = _load_flat(base_path)
    tuned, quant = _load_flat(finetuned_path)
    delta = {}
    for k, v in tuned.items():
        if k in base and "#" not in k:
            delta[k] = (_f32(v) - _f32(base[k])).astype(np.float16)
        else:
            delta[k] = v  # new params (PEFT) ship whole
    _save_flat(out_path, delta, quant)
    # mark as diff so loaders apply add semantics
    with open(os.path.join(out_path, "DIFF"), "w") as f:
        f.write("delta checkpoint: load with apply/add semantics\n")


def apply_delta(base_path: str, delta_path: str, out_path: str) -> None:
    from accessory_tpu_torch.checkpoint.native import _add_delta

    base, quant = _load_flat(base_path)
    delta, dquant = _load_flat(delta_path)
    merged = dict(base)
    for k, v in delta.items():
        merged[k] = _add_delta(base[k], v) if k in base and "#" not in k else v
    quant.update(dquant)
    _save_flat(out_path, merged, quant)


def main(args) -> None:
    if args.operate_type == "extract":
        extract_delta(args.pretrained_path, args.delta_path, args.output_path)
    else:
        apply_delta(args.pretrained_path, args.delta_path, args.output_path)


if __name__ == "__main__":
    main(get_args_parser().parse_args())
