"""Training checkpoints: save, find the latest, resume in two stages.

Port of ``accessory_tpu/train/ckpt.py``. An ``epoch{N}[-iter{M}]`` directory
holds:

  weights.safetensors / quant.json  the params (``--only_save_trainable``:
                                    the trainable subset) through
                                    ``checkpoint.native.save_checkpoint``, the
                                    native format the JAX package loads;
  config.json, meta.json, tokenizer the model's self-description;
  opt_state.safetensors             the optimizer state: ``count`` and
                                    ``mu/<path>`` / ``nu/<path>`` per trainable
                                    leaf (bf16 as raw bits under
                                    ``<key>@bf16``), written with the port's
                                    numpy safetensors writer, bit for bit (the
                                    reference writes an orbax directory; the
                                    card's machine has no orbax);
  other.json                        epoch, iter, step and the run's arguments;
  dataset-shard-{r}.json            the data iterator's state, if given.

Resume is two stages, as in the reference: the weights before the model is
quantized (``resume_stage1``), the optimizer state and progress after the
train state exists (``resume_stage2``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from accessory_tpu_torch.checkpoint.native import (load_checkpoint_list, read_safetensors,
                                                   save_checkpoint, write_safetensors)

OPT_FILE = "opt_state.safetensors"
_BF16 = "@bf16"


def ckpt_dir_name(epoch: int, it: Optional[int] = None) -> str:
    return f"epoch{epoch}" + (f"-iter{it}" if it is not None else "")


def _opt_arrays(opt_state) -> Dict[str, np.ndarray]:
    out = {"count": np.asarray(opt_state["count"], np.int64)}
    for part in ("mu", "nu"):
        for path, t in opt_state[part].items():
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                out[f"{part}/{path}{_BF16}"] = t.view(torch.int16).numpy().view(np.uint16)
            else:
                out[f"{part}/{path}"] = t.numpy()
    return out


def save_train_checkpoint(output_dir: str, state, args=None, epoch: int = 0,
                          it: Optional[int] = None, model_args=None,
                          llama_type: Optional[str] = None, tokenizer=None,
                          dataset_state: Optional[Dict[str, Any]] = None,
                          trainable_filter=None, only_save_trainable: bool = False,
                          data_shard_rank: int = 0) -> str:
    """Write ``output_dir/epoch{epoch}[-iter{it}]`` (see the module docstring)
    and return its path."""
    save_dir = os.path.join(output_dir, ckpt_dir_name(epoch, it))
    os.makedirs(save_dir, exist_ok=True)
    save_checkpoint(save_dir, state.params,
                    filter=trainable_filter if only_save_trainable else None)
    if model_args is not None:
        with open(Path(save_dir) / "config.json", "w") as f:
            json.dump(dataclasses.asdict(model_args), f, indent=2)
    if llama_type is not None:
        with open(Path(save_dir) / "meta.json", "w") as f:
            json.dump({"llama_type": llama_type}, f, indent=2)
    if tokenizer is not None and hasattr(tokenizer, "save"):
        tokenizer.save(save_dir)
    write_safetensors(str(Path(save_dir) / OPT_FILE), _opt_arrays(state.opt_state))
    with open(Path(save_dir) / "other.json", "w") as f:
        json.dump({"epoch": epoch, "iter": it if it is not None else 0, "step": int(state.step),
                   "train_args": vars(args) if args else None}, f, indent=2, default=str)
    if dataset_state is not None:
        with open(Path(save_dir) / f"dataset-shard-{data_shard_rank}.json", "w") as f:
            json.dump(dataset_state, f)
    return save_dir


def resume_stage1(resume_dir: str, template_params, dtype: Optional[str] = None, *, args,
                  device="cuda"):
    """The weights of ``resume_dir`` over ``template_params`` (the leaves a
    trainable-only checkpoint lacks), before the model is quantized."""
    return load_checkpoint_list([resume_dir], template_params, dtype=dtype, args=args,
                                device=device)


def resume_stage2(resume_dir: str, state, data_shard_rank: int = 0):
    """The optimizer state and step of ``resume_dir`` into an existing
    TrainState, each moment on its param's device. Returns (state, other.json
    as a dict, the dataset state or None)."""
    arrays = read_safetensors(str(Path(resume_dir) / OPT_FILE))
    opt = {"count": int(arrays["count"]), "mu": {}, "nu": {}}
    for key, arr in arrays.items():
        if key == "count":
            continue
        part, path = key.split("/", 1)
        ref = state.opt_state[part][path.removesuffix(_BF16)]
        t = torch.from_numpy(np.array(arr))
        if path.endswith(_BF16):
            t = t.view(torch.bfloat16)
        opt[part][path.removesuffix(_BF16)] = t.to(ref.device)
    missing = set(state.opt_state["mu"]) - set(opt["mu"])
    if missing:
        raise KeyError(f"{resume_dir}/{OPT_FILE} lacks the state of {sorted(missing)[:4]}...")
    meta = json.loads((Path(resume_dir) / "other.json").read_text())
    state = dataclasses.replace(state, opt_state=opt, step=int(meta["step"]))
    ds_file = Path(resume_dir) / f"dataset-shard-{data_shard_rank}.json"
    ds_state = json.loads(ds_file.read_text()) if ds_file.exists() else None
    return state, meta, ds_state


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest epochN[-iterM] directory with an other.json (auto-resume)."""
    if not os.path.isdir(output_dir):
        return None
    best, key = None, (-1, -1)
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"epoch(\d+)(?:-iter(\d+))?", name)
        if m and (Path(output_dir) / name / "other.json").exists():
            k = (int(m.group(1)), int(m.group(2) or 1 << 60))
            if k > key:
                key, best = k, os.path.join(output_dir, name)
    return best
