"""Pretraining CLI on one device.

Port of ``accessory_tpu/main_pretrain.py``: the same arguments, the same
loop. The model is built with ``MetaModel`` in ``--precision``'s dtype,
resumed or loaded from ``--pretrained_path``; every leaf trains in that
dtype (the reference keeps no f32 masters here, unlike finetuning). The
iteration-based LR (``train.adjust_learning_rate``: warmup, then a cosine to
``--min_lr`` at ``--lr_decay_iters``) drives AdamW with a global-norm clip;
``make_train_step`` runs each step (``--checkpointing``: ``util.remat_policy``'s
selective recompute; the MoE loss for a ``mixtral*`` type). The data is
``data.Falcon`` over parquet shards, or ``data.FalconPacked`` over the
``.pkl`` shards of ``tools/generate_packed_data`` (``--packed_data``); the
last file is the validation split. Every ``--save_freq`` iterations a
checkpoint with the dataset's position is saved (``train/ckpt.py``), and the
run resumes from the newest one (``--auto_resume``) or ``--resume`` with the
iteration and the data position; every ``--val_freq`` iterations up to
``--val_iters`` validation batches are scored into ``output_dir/log.txt``. A
non-finite loss stops the run.

On one card every ``--data_parallel`` mode is the same single-device step;
``--model_parallel_size`` other than 1 waits for ROADMAP A10 (the reference's
mesh and sharded train state).

    python -m accessory_tpu_torch.main_pretrain --llama_config cfg.json \\
        --tokenizer_path tokenizer.model --data_meta_path packed/ --packed_data \\
        --output_dir out [--checkpointing]
"""

from __future__ import annotations

import argparse
import math
import os


def get_args_parser():
    p = argparse.ArgumentParser("accessory_tpu_torch pretraining", add_help=False)
    p.add_argument("--batch_size", default=8, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--llama_type", default="llama", type=str)
    p.add_argument("--llama_config", nargs="*", default=[], type=str)
    p.add_argument("--tokenizer_path", type=str, required=True)
    p.add_argument("--pretrained_path", nargs="*", default=[], type=str)
    p.add_argument("--data_meta_path", type=str, required=True,
                   help="directory of parquet shards (or packed .pkl)")
    p.add_argument("--packed_data", action="store_true")
    p.add_argument("--max_words", default=2048, type=int)
    p.add_argument("--output_dir", default="./output", type=str)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--min_lr", type=float, default=3e-5)
    p.add_argument("--warmup_iters", type=int, default=2000)
    p.add_argument("--lr_decay_iters", type=int, default=400000)
    p.add_argument("--max_iters", type=int, default=400000)
    p.add_argument("--weight_decay", type=float, default=0.1)
    p.add_argument("--clip_grad", type=float, default=1.0)
    p.add_argument("--data_parallel", choices=["ddp", "sdp", "fsdp"], default="fsdp")
    p.add_argument("--model_parallel_size", type=int, default=1)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--checkpointing", action="store_true")
    p.add_argument("--save_freq", type=int, default=5000)
    p.add_argument("--val_freq", type=int, default=5000)
    p.add_argument("--val_iters", type=int, default=20)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    return p


def lm_batch(tokens) -> dict:
    """Labels aligned with the inputs (pad 0 masked); the loss shifts them
    itself."""
    return {"examples": tokens, "labels": tokens.copy()}


def main(args, tokenizer=None, device="cuda"):
    """Run the pretraining loop; returns the final TrainState. ``tokenizer``:
    a tokenizer object in place of the one at ``--tokenizer_path`` (the
    model config then gives vocab_size)."""
    import numpy as np
    import torch

    from accessory_tpu_torch.checkpoint import load_checkpoint_list
    from accessory_tpu_torch.data import Falcon, FalconPacked
    from accessory_tpu_torch.data.falcon import batched
    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.train import (TrainState, adjust_learning_rate,
                                           cross_entropy_loss, make_optimizer,
                                           make_train_step)
    from accessory_tpu_torch.train.ckpt import (find_latest_checkpoint, resume_stage1,
                                                resume_stage2, save_train_checkpoint)
    from accessory_tpu_torch.util.logging import MetricLogger, write_log_line

    if args.model_parallel_size != 1:
        raise NotImplementedError("--model_parallel_size > 1: tensor parallelism and the "
                                  "sharded train state wait for the parallel package "
                                  "(ROADMAP A10)")
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"device: {device}", flush=True)
    dtype = "bfloat16" if args.precision == "bf16" else "float32"
    model = MetaModel(args.llama_type, list(args.llama_config) + [{"dtype": dtype}],
                      None if tokenizer is not None else args.tokenizer_path,
                      max_seq_len=args.max_words, seed=args.seed, device=device,
                      tokenizer=tokenizer)
    module = model.module

    resume_dir = args.resume or (
        find_latest_checkpoint(args.output_dir) if args.auto_resume else None)
    if resume_dir:
        print(f"resuming weights from {resume_dir}")
        model.params = resume_stage1(resume_dir, model.params, dtype=dtype, args=model.args,
                                     device=device)
    elif args.pretrained_path:
        model.params = load_checkpoint_list(list(args.pretrained_path), model.params,
                                            dtype=dtype, args=model.args, device=device)

    def lr_fn(step):
        return adjust_learning_rate(step, args)

    tx = make_optimizer(model.params, lr_fn, weight_decay=args.weight_decay,
                        clip_norm=args.clip_grad)
    state = TrainState.create(model.params, tx)
    step_fn = make_train_step(module, model.args, tx, remat=args.checkpointing,
                              accum_steps=args.accum_iter,
                              moe_aux=args.llama_type.startswith("mixtral"), device=device)

    shard, n_shards = 0, 1
    ds_cls = FalconPacked if args.packed_data else Falcon
    kwargs = {} if args.packed_data else {"max_words": args.max_words,
                                          "tokenizer": model.tokenizer}
    train_ds = ds_cls(args.data_meta_path, rank=shard, num_shards=n_shards, split="train",
                      **kwargs)
    val_ds = ds_cls(args.data_meta_path, rank=0, num_shards=1, split="val", **kwargs)

    start_it = 0
    if resume_dir:
        state, meta_r, ds_state = resume_stage2(resume_dir, state, data_shard_rank=shard)
        start_it = meta_r["iter"]
        if ds_state:
            train_ds.load_state_dict(ds_state)

    logger = MetricLogger()
    loader = batched(iter(train_ds), args.batch_size * args.accum_iter)
    for it, tokens in logger.log_every(loader, args.log_every, "Pretrain", start_iter=start_it,
                                       total=args.max_iters):
        if it >= args.max_iters:
            break
        state, metrics = step_fn(state, lm_batch(tokens))
        c_loss = float(metrics["c_loss"])
        if not math.isfinite(c_loss):
            raise SystemExit(f"non-finite loss at iteration {it}, aborting")
        logger.update(closs=c_loss, lr=lr_fn(state.step))

        if (it + 1) % args.save_freq == 0:
            save_train_checkpoint(args.output_dir, state, args, 0, it + 1,
                                  model_args=model.args, llama_type=args.llama_type,
                                  tokenizer=model.tokenizer,
                                  dataset_state=train_ds.state_dict(), data_shard_rank=shard)
        if (it + 1) % args.val_freq == 0:
            vlosses = []
            with torch.no_grad():
                for vi, vtok in enumerate(batched(iter(val_ds), args.batch_size)):
                    if vi >= args.val_iters:
                        break
                    vb = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                          for k, v in lm_batch(vtok).items()}
                    logits = module.forward(state.params, model.args, vb["examples"])[0]
                    vlosses.append(float(cross_entropy_loss(logits, vb["labels"])[0]))
            print(f"val loss @ {it + 1}: {np.mean(vlosses):.4f}")
            write_log_line(args.output_dir, {"iter": it + 1, "val_loss": float(np.mean(vlosses))})
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
