"""Finetuning CLI on one device.

Port of ``accessory_tpu/main_finetune.py``: the same arguments, the same
loop. The model is built with ``MetaModel``, resumed or loaded from
``--pretrained_path``; ``--quant`` quantizes the frozen base to W4 (QPEFT:
LoRA / bias / norm weights train over it, ``--only_save_trainable``
required); trainable leaves train as f32 masters; ``FinetuneDataset`` and
``FinetuneDistSampler`` give the batches and ``make_train_step`` runs each
step (``--checkpointing``: every layer checkpointed, ``util.remat_policy(True)``); a
checkpoint is saved every ``--save_interval`` epochs and every
``--save_iteration_interval`` steps, and the run resumes from the newest one
(``--auto_resume``) or ``--resume``. Per-epoch averages go to
``output_dir/log.txt`` (no TensorBoard).

On one card every ``--data_parallel`` mode is the same single-device step;
``--model_parallel_size`` other than 1 waits for ROADMAP A10. Items with an
image come out of the dataset as the JAX package's do (no transform: the
file's RGB pixels, ROADMAP C13) and ``collate`` stacks them into the
batch's "images".

    python -m accessory_tpu_torch.main_finetune --llama_config cfg.json \\
        --tokenizer_path tokenizer.model --data_config data.yaml \\
        --output_dir out --quant --only_save_trainable [--checkpointing]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("accessory_tpu_torch finetuning", add_help=False)
    p.add_argument("--batch_size", default=4, type=int, help="per data-shard batch size")
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--epochs", default=4, type=int)
    p.add_argument("--llama_type", default="llama", type=str)
    p.add_argument("--llama_config", nargs="*", default=[], type=str)
    p.add_argument("--tokenizer_path", type=str, required=True)
    p.add_argument("--pretrained_path", nargs="*", default=[], type=str)
    p.add_argument("--data_config", type=str, required=True)
    p.add_argument("--max_words", default=512, type=int)
    p.add_argument("--image_words", default=0, type=int)
    p.add_argument("--output_dir", default="./output", type=str)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=float, default=1.0)
    p.add_argument("--weight_decay", type=float, default=0.02)
    p.add_argument("--clip_grad", type=float, default=2.0)
    p.add_argument("--data_parallel", choices=["ddp", "sdp", "fsdp"], default="fsdp")
    p.add_argument("--model_parallel_size", type=int, default=1)
    p.add_argument("--precision", choices=["bf16", "fp32"], default="bf16")
    p.add_argument("--checkpointing", action="store_true")
    p.add_argument("--quant", action="store_true", help="QPEFT: quantize the frozen base to W4")
    p.add_argument("--only_save_trainable", action="store_true")
    p.add_argument("--trainable_params", default=None, type=str,
                   help="substring filter for trainable params (full mode)")
    p.add_argument("--save_interval", default=1, type=int)
    p.add_argument("--save_iteration_interval", default=5000, type=int)
    p.add_argument("--auto_resume", action="store_true", default=True)
    p.add_argument("--resume", default=None, type=str)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=10)
    return p


def collate(items) -> dict:
    """A step's dataset items -> {"examples", "labels"[, "images"]}, each
    stacked; "images" holds the images of the items that carry one (the
    dataset gives an image item as (tokens, labels, mask, image))."""
    out = {"examples": np.stack([it[0] for it in items]),
           "labels": np.stack([it[1] for it in items])}
    images = [it[3] for it in items if len(it) > 3]
    if images:
        out["images"] = np.stack(images)
    return out


def main(args, tokenizer=None, device="cuda"):
    """Run the finetuning loop; returns the final TrainState. ``tokenizer``:
    a tokenizer object in place of the one at ``--tokenizer_path`` (the
    model config then gives vocab_size)."""
    from accessory_tpu_torch.checkpoint import load_checkpoint_list
    from accessory_tpu_torch.data.alpaca import FinetuneDataset, FinetuneDistSampler
    from accessory_tpu_torch.meta import MetaModel
    from accessory_tpu_torch.quant.quantize import DEFAULT_BLOCKLIST, quantize_params
    from accessory_tpu_torch.train import (TrainState, adjust_learning_rate_epoch,
                                           make_optimizer, make_train_step)
    from accessory_tpu_torch.train.ckpt import (find_latest_checkpoint, resume_stage1,
                                                resume_stage2, save_train_checkpoint)
    from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
    from accessory_tpu_torch.util.logging import MetricLogger, write_log_line

    if args.model_parallel_size != 1:
        raise NotImplementedError("--model_parallel_size > 1: tensor parallelism waits for "
                                  "the parallel package (ROADMAP A10)")
    os.makedirs(args.output_dir, exist_ok=True)
    print(f"device: {device}", flush=True)

    dtype = "bfloat16" if args.precision == "bf16" else "float32"
    # the compute dtype is set before the weights are drawn, so they are made
    # in it (the reference sets it on the args after init)
    model = MetaModel(args.llama_type, list(args.llama_config) + [{"dtype": dtype}],
                      None if tokenizer is not None else args.tokenizer_path,
                      max_seq_len=args.max_words, seed=args.seed, device=device,
                      tokenizer=tokenizer)
    module = model.module

    # resume / pretrained weights (stage 1: before quantization)
    resume_dir = args.resume or (
        find_latest_checkpoint(args.output_dir) if args.auto_resume else None)
    start_epoch, start_iter = 0, 0
    if resume_dir:
        print(f"resuming weights from {resume_dir}")
        model.params = resume_stage1(resume_dir, model.params, dtype=dtype, args=model.args,
                                     device=device)
    elif args.pretrained_path:
        model.params = load_checkpoint_list(list(args.pretrained_path), model.params,
                                            dtype=dtype, args=model.args, device=device)

    # trainability and the optional W4 base (QPEFT)
    get_filter = getattr(module, "get_trainable_params_filter", None)
    trainable = get_filter(model.args) if get_filter else (lambda n: True)
    if args.trainable_params:
        subs = args.trainable_params.split(",")
        base_trainable = trainable
        trainable = lambda n: base_trainable(n) and any(s in n for s in subs)  # noqa: E731
    if args.quant:
        if not args.only_save_trainable:
            raise ValueError("--quant training requires --only_save_trainable")
        block = tuple(DEFAULT_BLOCKLIST) + tuple(model.get_quant_blocklist())
        model.params = quantize_params(model.params, bits=4, blocklist=block)
    # trainable params train as f32 masters
    model.params = promote_trainable_params_to_fp32(model.params, trainable)

    lr_args = argparse.Namespace(lr=args.lr, min_lr=args.min_lr,
                                 warmup_epochs=args.warmup_epochs, epochs=args.epochs)
    dataset = FinetuneDataset(args.data_config, max_words=args.max_words,
                              image_words=args.image_words, tokenizer=model.tokenizer)
    sampler = FinetuneDistSampler(dataset, num_replicas=1, rank=0, batch_size=args.batch_size,
                                  acc_grad=args.accum_iter, seed=args.seed)
    iters_per_epoch = len(sampler) // (args.batch_size * args.accum_iter)

    def lr_fn(step):
        return adjust_learning_rate_epoch(
            min(max(step / max(iters_per_epoch, 1), 0), args.epochs), lr_args)

    tx = make_optimizer(model.params, lr_fn, weight_decay=args.weight_decay,
                        clip_norm=args.clip_grad, trainable=trainable)
    state = TrainState.create(model.params, tx)
    step_fn = make_train_step(module, model.args, tx, remat=args.checkpointing,
                              accum_steps=args.accum_iter,
                              moe_aux=args.llama_type.startswith("mixtral"), device=device)
    if resume_dir:
        state, meta_r, _ = resume_stage2(resume_dir, state)
        start_epoch, start_iter = meta_r["epoch"], meta_r["iter"]
        if start_iter == 0:
            start_epoch += 1

    def batches(epoch):
        sampler.set_epoch(epoch, start_iter if epoch == start_epoch else 0)
        buf = []
        per_step = args.batch_size * args.accum_iter
        for idx in iter(sampler):
            buf.append(dataset[idx])
            if len(buf) == per_step:
                yield collate(buf)
                buf = []

    save_kw = dict(model_args=model.args, llama_type=args.llama_type,
                   tokenizer=model.tokenizer, trainable_filter=trainable,
                   only_save_trainable=args.only_save_trainable)
    for epoch in range(start_epoch, args.epochs):
        logger = MetricLogger()
        it = start_iter if epoch == start_epoch else 0
        for i, batch in logger.log_every(batches(epoch), args.log_every, f"Epoch [{epoch}]",
                                         start_iter=it, total=iters_per_epoch):
            state, metrics = step_fn(state, batch)
            c_loss = float(metrics["c_loss"])
            if not math.isfinite(c_loss):
                raise SystemExit(f"non-finite loss at step {state.step}, aborting")
            logger.update(closs=c_loss, grad_norm=float(metrics["grad_norm"]),
                          lr=lr_fn(state.step))
            if (i + 1) % args.save_iteration_interval == 0:
                save_train_checkpoint(args.output_dir, state, args, epoch, i + 1, **save_kw)
        start_iter = 0
        if (epoch + 1) % args.save_interval == 0 or epoch + 1 == args.epochs:
            save_train_checkpoint(args.output_dir, state, args, epoch, None, **save_kw)
        write_log_line(args.output_dir, {"epoch": epoch,
                                         "closs": logger.meters["closs"].global_avg})
    return state


if __name__ == "__main__":
    main(get_args_parser().parse_args())
