"""The port's training pieces against the JAX package's, on the CPU: the
masked shifted cross entropy, the LR schedules, the optimizer's labels, the
f32 promotion of trainable leaves, and AdamW with the global-norm clip
(the port writes optax's arithmetic out by hand; held to optax to 1e-6
relative on the same gradients, one and three steps, clipped and not).
Inputs come from numpy seeds."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.train import lr_sched as jlr
from accessory_tpu.train.loss import cross_entropy_loss as jce
from accessory_tpu.train.optim import make_optimizer as jmake_optimizer
from accessory_tpu.train.optim import param_label_fn as jlabels
from accessory_tpu.train.precision import promote_trainable_params_to_fp32 as jpromote

from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.convert import params_from_jax
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant.qtensor import QuantizedWeight
from accessory_tpu_torch.train import lr_sched
from accessory_tpu_torch.train.loss import cross_entropy_loss
from accessory_tpu_torch.train.optim import make_optimizer, param_label_fn
from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
from accessory_tpu_torch.train.tree import named_leaves

from test_torch_generate import to_numpy_tree

CFG = dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=64, multiple_of=64,
           max_seq_len=16)
PEFT = dict(lora_rank=4, bias_tuning=True, norm_tuning=True)


@pytest.mark.parametrize("shift", [True, False])
@pytest.mark.parametrize("ignore_index", [0, -1])
def test_cross_entropy_loss(shift, ignore_index):
    rng = np.random.RandomState(0)
    logits = (rng.standard_normal((3, 9, 33)) * 3).astype(np.float32)
    labels = rng.randint(0, 33, (3, 9)).astype(np.int32)
    labels[0, :5] = ignore_index          # a masked prompt
    labels[2, 3] = ignore_index
    got, n = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                ignore_index, shift)
    want, wn = jce(jnp.asarray(logits), jnp.asarray(labels), ignore_index, shift)
    assert int(n) == int(wn)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_cross_entropy_loss_all_masked_is_zero():
    logits = torch.zeros((1, 4, 5))
    labels = torch.zeros((1, 4), dtype=torch.int32)
    loss, n = cross_entropy_loss(logits, labels)
    assert int(n) == 0 and float(loss) == 0.0


@pytest.mark.parametrize("lr,min_lr,warmup,total", [(1e-3, 0.0, 2.0, 10.0),
                                                    (2e-5, 1e-6, 0.0, 4.0),
                                                    (3e-4, 3e-5, 100.0, 1000.0)])
def test_cosine_lr(lr, min_lr, warmup, total):
    for it in np.linspace(0, 1.2 * total, 37):
        got = lr_sched.cosine_lr(it, lr, min_lr, warmup, total)
        want = float(jlr.cosine_lr(it, lr, min_lr, warmup, total))
        # the reference evaluates in f32: near the cosine's end its value
        # carries an f32 rounding of lr
        assert abs(got - want) <= 1e-6 * lr, it


def test_epoch_and_iteration_schedules():
    args = argparse.Namespace(lr=1e-4, min_lr=1e-6, warmup_epochs=0.5, epochs=3,
                              warmup_iters=20, lr_decay_iters=200)
    for frac in (0.0, 0.25, 0.5, 1.3, 2.99, 3.0):
        want = float(jlr.adjust_learning_rate_epoch(frac, args))
        assert abs(lr_sched.adjust_learning_rate_epoch(frac, args) - want) <= 1e-6 * args.lr
    for it in (0, 7, 20, 150, 200, 250):
        want = float(jlr.adjust_learning_rate(it, args))
        assert abs(lr_sched.adjust_learning_rate(it, args) - want) <= 1e-6 * args.lr


def _model_trees(peft, quant):
    jargs = JArgs(**CFG, **peft)
    params = jllama.init_params(jax.random.PRNGKey(0), jargs)
    if quant:
        params = jquantize_params(params, bits=4, group_size=64, layout="planes")
    port = params_from_jax(to_numpy_tree(params), LLaMAArgs(**CFG, **peft), device="cpu")
    return jargs, params, port


def _jax_name(path):
    """layers/3/attention/wq/lora_a -> layers/attention/wq/lora_a (stacked)."""
    parts = path.split("/")
    return "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" else path


@pytest.mark.parametrize("peft,quant", [(PEFT, True), (dict(norm_tuning=True), True),
                                        ({}, False)])
def test_param_labels_match_the_reference(peft, quant):
    jargs, jparams, port = _model_trees(peft, quant)
    trainable = llama.get_trainable_params_filter(LLaMAArgs(**CFG, **peft))
    jtrain = jllama.get_trainable_params_filter(jargs)
    want = {}
    for path, lab in jax.tree_util.tree_flatten_with_path(
            jlabels(jparams, jtrain),
            is_leaf=lambda x: isinstance(x, str))[0]:
        want["/".join(str(getattr(p, "key", p)) for p in path)] = lab
    got = param_label_fn(port, trainable)
    qleaves = {p for p, leaf in named_leaves(port) if isinstance(leaf, QuantizedWeight)}
    assert {p: lab for p, lab in got.items() if p not in qleaves}  # something to compare
    for path, lab in got.items():
        if path in qleaves:
            assert lab == "frozen"
        else:
            assert lab == want[_jax_name(path)], path
    assert set(got.values()) >= ({"frozen", "no_decay"} if peft else {"decay", "no_decay"})


def test_promote_trainable_params_to_fp32():
    jargs, jparams, port = _model_trees(PEFT, True)
    jparams = jax.tree.map(lambda x: x.astype(jnp.bfloat16) if hasattr(x, "dtype")
                           and x.dtype == jnp.float32 else x, jparams,
                           is_leaf=lambda x: hasattr(x, "packed"))
    port = params_from_jax(to_numpy_tree(jparams), LLaMAArgs(**CFG, **PEFT), device="cpu")
    trainable = llama.get_trainable_params_filter(LLaMAArgs(**CFG, **PEFT))
    got = promote_trainable_params_to_fp32(port, trainable)
    want = jpromote(jparams, jllama.get_trainable_params_filter(jargs))
    wflat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: hasattr(x, "packed"))[0]:
        wflat["/".join(str(getattr(p, "key", p)) for p in path)] = leaf
    n_f32 = 0
    for path, leaf in named_leaves(got):
        if isinstance(leaf, QuantizedWeight):
            continue
        w = wflat[_jax_name(path)]
        assert (leaf.dtype == torch.float32) == (w.dtype == jnp.float32), path
        n_f32 += leaf.dtype == torch.float32
        assert torch.equal(leaf.to(torch.float32),
                           torch.from_numpy(np.asarray(w, np.float32))[int(path.split("/")[1])]
                           if path.startswith("layers/") else
                           torch.from_numpy(np.asarray(w, np.float32))), path
    assert n_f32 > 0


def _opt_tree(rng):
    """A small tree with decay, no_decay and frozen leaves (f32)."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": {"weight": a(16, 8)}, "proj": {"weight": a(8, 12), "bias": a(12)},
            "attention_norm": {"weight": a(8)}, "head": {"weight": a(12, 16)},
            "scalar_gain": a(1)}


@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_matches_optax(clip, steps, wd):
    """Same params, same gradients each step: the port's AdamW (decay /
    no_decay / frozen groups, the clip g * (clip / norm) where norm > clip,
    the schedule read at the count before the update) against optax, f32,
    to 1e-6 relative per leaf."""
    rng = np.random.RandomState(1)
    tree = _opt_tree(rng)

    def trainable(name):
        return not name.startswith("head")

    def sched_j(count):
        return jlr.cosine_lr(count, 1e-2, 1e-3, 1.0, 4.0)

    def sched_t(count):
        return lr_sched.cosine_lr(count, 1e-2, 1e-3, 1.0, 4.0)

    jparams = jax.tree.map(jnp.asarray, tree)
    jtx = jmake_optimizer(jparams, sched_j, weight_decay=wd, clip_norm=clip,
                          trainable=trainable)
    jstate = jtx.init(jparams)
    params = {k: {kk: torch.from_numpy(v.copy()) for kk, v in d.items()}
              if isinstance(d, dict) else torch.from_numpy(d.copy()) for k, d in tree.items()}
    tx = make_optimizer(params, sched_t, weight_decay=wd, clip_norm=clip, trainable=trainable)
    assert set(tx.labels.values()) == {"decay", "no_decay", "frozen"}
    state = tx.init(params)
    flat = dict(named_leaves(params))
    for _ in range(steps):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                             tree)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        gflat = {p: torch.from_numpy(np.array(g)) for p, g in named_leaves(grads)}
        state = tx.update(gflat, state, flat)
    assert state["count"] == steps
    for path, leaf in named_leaves(jparams):
        got, want = flat[path].numpy(), np.asarray(leaf)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-6, (path, err)
    assert np.array_equal(flat["head/weight"].numpy(), tree["head"]["weight"])
    assert "head/weight" not in state["mu"]


def test_clip_is_the_optax_form():
    """norm > clip scales by clip / norm exactly (no + 1e-6 as in
    torch.nn.utils.clip_grad_norm_); norm <= clip leaves g as it is."""
    p = {"w": torch.zeros(4)}
    for clip, g in ((1.0, [3.0, 4.0, 0.0, 0.0]), (10.0, [3.0, 4.0, 0.0, 0.0])):
        tx = make_optimizer(p, 1.0, weight_decay=0.0, clip_norm=clip)
        state = tx.init(p)
        grads = {"w": torch.tensor(g)}
        params = {"w": torch.zeros(4)}
        tx.update(grads, state, params)
        want_g = torch.tensor(g) * (clip / 5.0 if clip < 5.0 else 1.0)
        # first Adam step: u = g_hat / (|g_hat| + eps) per element
        want = -want_g / (want_g.abs() + 1e-8)
        assert torch.allclose(params["w"], want, rtol=1e-6, atol=0)


def test_convert_carries_peft_leaves_both_ways():
    """A stacked JAX tree's lora_a / lora_b / bias leaves (W4 base) come
    across in params_from_jax per layer and go back in params_to_jax
    stacked, bit for bit."""
    from accessory_tpu_torch.convert import params_to_jax

    jargs, jparams, port = _model_trees(PEFT, True)
    back = params_to_jax(port)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jparams, is_leaf=lambda x: hasattr(x, "packed"))[0]:
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] not in ("lora_a", "lora_b", "bias"):
            continue
        for i in range(jargs.n_layers):
            node = port["layers"][i]
            for k in keys[1:]:
                node = node[k]
            want = torch.from_numpy(np.asarray(leaf, np.float32)[i])
            assert node.dtype == torch.bfloat16 and torch.equal(node.float(), want), keys
        node = back
        for k in keys:
            node = node[k]
        # bf16 leaves go out as their raw bits
        assert np.array_equal(node.bits, np.asarray(leaf).view(np.uint16)), keys
        n += 1
    assert n == 7 * 3
