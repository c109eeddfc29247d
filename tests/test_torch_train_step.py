"""Whole training steps of the port against the JAX package's
``make_train_step`` on the CPU: a 2-layer GQA LLaMA (dim 128, 2 / 1 heads,
vocab 64), the same weights (made by JAX, PEFT leaves set to random values
from a numpy seed so that every gradient is non-trivial) and the same batch.
Each case compares the loss, every trainable leaf's gradient, grad_norm and
every trainable leaf after the AdamW update.

Cases: QPEFT (W4 planes base, LoRA + bias + norm) in f32 and bf16 compute,
norm-only QPEFT (its wo / w2 modules would take the fused kernel call, which
has no backward: the training forward composes them unfused), full
finetuning in f32 and bf16, and accum_steps=2.

Tolerances. f32: the two W4 forwards differ by ~5e-5 relative (the JAX
planes kernel rounds q*s, the port keeps q exact; ROADMAP §C), so loss,
gradients and grad_norm are held to 2e-4 (relative L2 for gradients). bf16:
activations round at other points in the two frameworks, so 1e-2 on the loss
and 6e-2 relative L2 on gradients. Updated params: the first AdamW step moves
an element by lr * g / (|g| + eps), about lr * sign(g), which turns a gradient
element near zero (a few ulps of the leaf's largest) into an update of
either sign; so the update (new - old) / lr is compared to 1e-3 where the
JAX gradient is at least a tenth of its leaf's largest, and the optimizer's
own arithmetic is held to optax to 1e-6 on equal gradients in
tests/test_torch_train_ops.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.train import TrainState as JTrainState
from accessory_tpu.train import make_optimizer as jmake_optimizer
from accessory_tpu.train import make_train_step as jmake_train_step
from accessory_tpu.train.loss import cross_entropy_loss as jce
from accessory_tpu.train.precision import promote_trainable_params_to_fp32 as jpromote
from accessory_tpu.train.train_step import combine_params, partition_params as jpartition

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
from accessory_tpu_torch.train.train_step import grads_of

from test_torch_generate import to_numpy_tree

CFG = dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=64, multiple_of=64,
           max_seq_len=16)
LR = 1e-2
TOL = {"float32": dict(loss=2e-5, grad=2e-4, upd=1e-3),
       "bfloat16": dict(loss=1e-2, grad=6e-2, upd=1e-3)}


def _jax_leaf(tree, path):
    """The JAX (stacked) leaf for a port path like layers/1/attention/wq/lora_a."""
    parts = path.split("/")
    if parts[0] != "layers":
        node = tree
        for p in parts:
            node = node[p]
        return np.asarray(node, np.float32)
    node = tree["layers"]
    for p in parts[2:]:
        node = node[p]
    return np.asarray(node[int(parts[1])], np.float32)


def _case(dtype, quant, peft, seed=0):
    jargs = JArgs(**CFG, dtype=dtype, **peft)
    params = jllama.init_params(jax.random.PRNGKey(seed), jargs)
    rng = np.random.RandomState(seed)

    def randomize(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if "lora_b" in name or name.endswith("bias"):
            return jnp.asarray(rng.standard_normal(x.shape) * 0.05, x.dtype)
        if "norm" in name:
            return jnp.asarray(1 + rng.standard_normal(x.shape) * 0.1, x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(randomize, params)
    if quant:
        params = jquantize_params(params, bits=4, group_size=64, layout="planes")
    trainable = jllama.get_trainable_params_filter(jargs)
    params = jpromote(params, trainable)
    args = LLaMAArgs(**CFG, dtype=dtype, **peft)
    port = params_from_jax(to_numpy_tree(params), args, device="cpu")
    batch = {"examples": rng.randint(1, 64, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 64, (4, 16)).astype(np.int32)}
    return jargs, params, trainable, args, port, batch


def _jax_grads(jargs, params, batch, remat, accum=1):
    """Gradients as the reference's train step computes them (its loss_fn
    with the bf16 autocast; with ``accum`` microbatches their mean), for the
    comparison of each leaf."""
    cdt = jnp.dtype(jargs.dtype)

    def loss(diff, static, ex, lab):
        p = combine_params(diff, static)
        if cdt != jnp.float32:
            p = jax.tree.map(lambda x: x.astype(cdt) if hasattr(x, "dtype")
                             and x.dtype == jnp.float32 and not hasattr(x, "packed") else x, p,
                             is_leaf=lambda x: hasattr(x, "packed"))
        logits, _ = jllama.forward(p, jargs, ex, remat=remat)
        return jce(logits, lab)[0]

    diff, static = jpartition(params)
    grads = [jax.grad(loss)(diff, static, jnp.asarray(ex), jnp.asarray(lab))
             for ex, lab in zip(np.split(batch["examples"], accum),
                                np.split(batch["labels"], accum))]
    return jax.tree.map(lambda *g: sum(g) / accum, *grads)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _run(dtype, quant, peft, remat=False, accum=1, clip=1.0, wd=0.0):
    jargs, jparams, trainable, args, port, batch = _case(dtype, quant, peft)
    tx = jmake_optimizer(jparams, LR, weight_decay=wd, clip_norm=clip, trainable=trainable)
    jstate, jm = jax.jit(jmake_train_step(jllama, jargs, tx, remat=remat, accum_steps=accum))(
        JTrainState.create(jparams, tx), {k: jnp.asarray(v) for k, v in batch.items()})

    ttx = make_optimizer(port, LR, weight_decay=wd, clip_norm=clip,
                         trainable=llama.get_trainable_params_filter(args))
    before = {k: v.detach().clone() for k, v in _trainable(port, ttx).items()}
    state = TrainState.create(port, ttx)
    step = make_train_step(llama, args, ttx, remat=remat, accum_steps=accum, device="cpu")
    state, m = step(state, batch)
    tol = TOL[dtype]
    assert abs(float(m["c_loss"]) - float(jm["c_loss"])) <= tol["loss"] * abs(float(jm["c_loss"]))
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        3 * tol["grad"] * float(jm["grad_norm"])
    assert int(round(float(m["n_tokens"]))) == int(round(float(jm["n_tokens"])))
    jg = _jax_grads(jargs, jparams, batch, remat, accum)
    grads = grads_of(state)
    for path in before:
        got = grads[path].to(torch.float32).numpy() / accum
        err = _rel_l2(got, _jax_leaf(jg, path))
        assert err <= tol["grad"], (path, err)
    for path, old in before.items():
        new = _port_leaf(state.params, path)
        upd = (new.detach().to(torch.float32) - old.to(torch.float32)).numpy() / LR
        want = (_jax_leaf(jstate.params, path) - old.to(torch.float32).numpy()) / LR
        g = np.abs(_jax_leaf(jg, path))
        sure = g >= 0.1 * g.max()
        assert sure.any() and np.abs(upd - want)[sure].max() <= tol["upd"], path
    return state


def _trainable(params, tx):
    return {p: _port_leaf(params, p) for p, lab in tx.labels.items() if lab != "frozen"}


def _port_leaf(params, path):
    node = params
    for p in path.split("/"):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return node


PEFT = dict(lora_rank=4, bias_tuning=True, norm_tuning=True)


@pytest.mark.parametrize("dtype,remat", [("float32", False), ("bfloat16", "full")])
def test_qpeft_lora_bias_norm(dtype, remat):
    _run(dtype, True, PEFT, remat=remat)


def test_qpeft_norm_only_trains_through_fusable_modules():
    _run("float32", True, dict(norm_tuning=True), remat=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_finetune(dtype):
    _run(dtype, False, {}, wd=0.02)


def test_accum_steps_2():
    _run("float32", True, PEFT, accum=2)


def test_remat_gives_identical_port_results():
    """Each layer checkpointed or not: the same gradients and params, bit for
    bit (the recompute runs the same ops on the same inputs)."""
    out = []
    for remat in (False, "full"):
        _, _, _, args, port, batch = _case("bfloat16", True, PEFT)
        tx = make_optimizer(port, LR, clip_norm=1.0,
                            trainable=llama.get_trainable_params_filter(args))
        state = TrainState.create(port, tx)
        state, m = make_train_step(llama, args, tx, remat=remat, device="cpu")(state, batch)
        out.append((m, grads_of(state), state.params))
    (m0, g0, p0), (m1, g1, p1) = out
    assert float(m0["c_loss"]) == float(m1["c_loss"])
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    for path in tx.labels:
        a, b = _port_leaf(p0, path), _port_leaf(p1, path)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
