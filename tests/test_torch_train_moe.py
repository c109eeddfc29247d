"""Mixtral and SPHINX-MoE trained with the MoE loss in the port, against the
JAX package's ``make_train_step(..., moe_aux=True)`` on the CPU.

- Mixtral, 2 layers, dim 128, 4 / 2 heads, 4 experts of width 128, top 2,
  full finetuning of every dense leaf (the router included), dense experts
  (the ragged dispatch) or W4 experts and attention (the JAX package's planes
  layout, its Pallas kernels in interpret mode), f32 and bf16 compute, one
  or two microbatches: two steps from the same weights and batch. Held each
  step: loss, c_loss, aux_loss and grad_norm; after the first step every
  trainable leaf's gradient (the JAX loss's, c_loss + aux, the mean over the
  microbatches) and every updated leaf, (new - old) / lr, to 1e-3 where the
  JAX gradient is at least a tenth of its leaf's largest (where it is
  smaller AdamW's lr * g / (|g| + eps) may take either sign); in f32, after
  both steps, the two steps' update, (new - old) / lr, to twice the
  gradients' relative tolerance where both steps' JAX gradients are that large and of one sign
  (the second step's direction mixes the two gradients and carries their
  error: a gradient's relative error moves an update of about one lr by
  about that many lr a step, unless the two cancel; in bf16 that error is
  too near an lr for the check to say anything, and the second step is held
  by its metrics, which read the updated leaves). With W4
  and two microbatches the JAX step's update rounds the packed W4 words
  through f32 (ROADMAP C14): there the first step is held, and the packed
  words, changed by JAX and kept by the port. With W4 in bf16 only the
  losses are held: the two W4 forwards round the dequantized weight at
  other points (ROADMAP "Deliberate differences"), 4.4% relative L2 on this
  model's logits and up to 17% on its norm and router gradients.
- SPHINX-MoE (``mixtral_sparse_ens``, the tiny towers of
  test_torch_train_images over a 2-layer f32 Mixtral decoder): an image
  batch in two microbatches, with and without ``moe_aux``, against the JAX
  step: losses, every trainable leaf's gradient, and grad_norm against the
  norm of the JAX gradients of every leaf but the frozen towers (ROADMAP
  "Deliberate differences").
- The step's refusal of ``moe_aux`` under a context-parallel mesh of more
  than one rank (ROADMAP A10), and its one-rank form equal to the plain step.

Tolerances: test_torch_train_step's TOL (f32: loss 2e-5 relative, gradients
2e-4 relative L2; bf16: 1e-2 and 6e-2; a first update 1e-3 of an lr), the
aux loss as the loss, grad_norm 3x the gradient tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import MixtralArgs as JArgs
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.models import mixtral as jmixtral
from accessory_tpu.quant.quantize import DEFAULT_BLOCKLIST as JBLOCK
from accessory_tpu.quant.quantize import quantize_params as jquantize_params
from accessory_tpu.train import TrainState as JTrainState
from accessory_tpu.train import make_optimizer as jmake_optimizer
from accessory_tpu.train import make_train_step as jmake_train_step
from accessory_tpu.train.loss import cross_entropy_loss as jce
from accessory_tpu.train.precision import promote_trainable_params_to_fp32 as jpromote
from accessory_tpu.train.train_step import combine_params, partition_params as jpartition

from accessory_tpu_torch.config import MixtralArgs
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import mixtral
from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
from accessory_tpu_torch.train.train_step import grads_of

from test_torch_generate import one_torch_thread, to_numpy_tree  # noqa: F401  (fixture)
from test_torch_train_images import DECODER, TOWERS, _batch
from test_torch_train_step import TOL, _jax_leaf, _port_leaf, _rel_l2
from test_torch_visual import perturbed, to_jax

CFG = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128, num_experts=4,
           vocab_size=64, max_seq_len=32)
LR = 1e-2


def _mixtral(dtype, experts, seed=0):
    """(JAX args, JAX params, port args, port params, batch): the JAX draw
    (W4 g64: every eligible weight but the router in the planes layout), the
    trainable leaves promoted to f32 masters on both sides."""
    jargs = JArgs(**CFG, dtype=dtype)
    params = jmixtral.init_params(jax.random.PRNGKey(seed), jargs)
    if experts == "w4":
        params = jquantize_params(params, bits=4, group_size=64,
                                  blocklist=tuple(JBLOCK) + ("gate",), layout="planes")
    params = jpromote(params, jmixtral.get_trainable_params_filter(jargs))
    args = MixtralArgs(**CFG, dtype=dtype)
    port = params_from_jax(to_numpy_tree(params), args, device="cpu")
    rng = np.random.RandomState(seed)
    batch = {"examples": rng.randint(1, 64, (4, 16)).astype(np.int32),
             "labels": rng.randint(0, 64, (4, 16)).astype(np.int32)}
    return jargs, params, args, port, batch


def _jax_grads(jmod, jargs, params, batch, accum, moe_aux, images=False):
    """The JAX step's loss gradient (c_loss + aux with ``moe_aux``, the bf16
    autocast of f32 leaves), the mean over ``accum`` microbatches."""
    cdt = jnp.dtype(jargs.dtype)

    def loss(diff, static, ex, lab, *img):
        p = combine_params(diff, static)
        if cdt != jnp.float32:
            p = jax.tree.map(lambda x: x.astype(cdt) if hasattr(x, "dtype")
                             and x.dtype == jnp.float32 and not hasattr(x, "packed") else x, p,
                             is_leaf=lambda x: hasattr(x, "packed"))
        kw = {"images": img[0]} if img else {}
        if moe_aux:
            logits, _, aux = jmod.forward(p, jargs, ex, with_aux_loss=True, **kw)
        else:
            (logits, _), aux = jmod.forward(p, jargs, ex, **kw), 0.0
        return jce(logits, lab)[0] + aux

    diff, static = jpartition(params)
    keys = ("examples", "labels") + (("images",) if images else ())
    split = {k: np.split(np.asarray(batch[k]), accum) for k in keys}
    grad = jax.jit(jax.grad(loss))
    grads = [grad(diff, static, *(jnp.asarray(split[k][i]) for k in keys))
             for i in range(accum)]
    return jax.tree.map(lambda *g: sum(g) / accum, *grads)


def _close(got, want, tol, what):
    assert abs(float(got) - float(want)) <= tol * abs(float(want)), (what, got, want)


@pytest.mark.parametrize("experts,dtype,accum", [
    ("dense", "float32", 1), ("dense", "bfloat16", 2), ("w4", "float32", 1),
    ("w4", "bfloat16", 1), ("w4", "float32", 2)])
def test_mixtral_moe_aux_step_matches_jax(experts, dtype, accum):
    """Two steps (one with W4 and two microbatches, where the JAX update is at
    fault, ROADMAP C14) from the same weights and batch; see the module
    docstring for what is held."""
    jargs, jparams, args, port, batch = _mixtral(dtype, experts)
    trainable = mixtral.get_trainable_params_filter(args)
    jtx = jmake_optimizer(jparams, LR, weight_decay=0.02, clip_norm=1.0,
                          trainable=jmixtral.get_trainable_params_filter(jargs))
    jstep = jax.jit(jmake_train_step(jmixtral, jargs, jtx, remat=False, accum_steps=accum,
                                     moe_aux=True))
    tx = make_optimizer(port, LR, weight_decay=0.02, clip_norm=1.0, trainable=trainable)
    paths = [p for p, lab in tx.labels.items() if lab != "frozen"]
    assert "layers/0/feed_forward/gate/weight" in paths
    before = {p: _port_leaf(port, p).detach().clone() for p in paths}
    step = make_train_step(mixtral, args, tx, remat="full", accum_steps=accum, moe_aux=True,
                           device="cpu")
    jstate, state = JTrainState.create(jparams, jtx), TrainState.create(port, tx)
    tol = TOL[dtype]
    c14 = experts == "w4" and accum > 1
    jgrads = []
    # bf16 with W4: the two W4 forwards round at other points (the JAX planes
    # kernel rounds q * s to bf16, the port keeps q exact: 4.4% relative L2
    # on this model's logits, up to 17% on its norm and router gradients),
    # so only the losses are held there
    held = not (experts == "w4" and dtype == "bfloat16")
    for i in range(1 if c14 else 2):
        jgrads.append(_jax_grads(jmixtral, jargs, jstate.params, batch, accum, True))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        for key in ("loss", "c_loss", "aux_loss"):
            _close(m[key], jm[key], tol["loss"], (i, key))
        assert float(m["aux_loss"]) > 0
        if not held:
            continue
        _close(m["grad_norm"], jm["grad_norm"], 3 * tol["grad"], (i, "grad_norm"))
        if i == 0:
            grads = grads_of(state)
            for path in paths:
                got = grads[path].to(torch.float32).numpy() / accum
                err = _rel_l2(got, _jax_leaf(jgrads[0], path))
                assert err <= tol["grad"], (path, err)
            _updates_close(before, state.params, jstate.params, jgrads, tol["upd"])
    if c14:
        # the JAX step rounded its packed W4 words through f32; the port's stay
        jw = np.asarray(jstate.params["layers"]["feed_forward"]["w1"]["weight"].packed)
        jw0 = np.asarray(jparams["layers"]["feed_forward"]["w1"]["weight"].packed)
        assert not np.array_equal(jw, jw0)
        assert torch.equal(state.params["layers"][0]["feed_forward"]["w1"]["weight"][0].packed,
                           port["layers"][0]["feed_forward"]["w1"]["weight"][0].packed)
    elif dtype == "float32":
        _updates_close(before, state.params, jstate.params, jgrads, 2 * tol["grad"])


def _updates_close(before, params, jparams, jgrads, tol):
    """(new - old) / lr of every trainable leaf against JAX's, the largest
    difference, where each step's JAX gradient so far is at least a tenth of
    its leaf's largest and of one sign (where two steps' gradients cancel,
    AdamW's direction takes their difference, and its error grows without
    bound)."""
    for path, old in before.items():
        old = old.to(torch.float32).numpy()
        got = (_port_leaf(params, path).detach().to(torch.float32).numpy() - old) / LR
        want = (_jax_leaf(jparams, path) - old) / LR
        sure = np.ones(old.shape, bool)
        for jg in jgrads:
            g = _jax_leaf(jg, path)
            sure &= (np.abs(g) >= 0.1 * np.abs(g).max()) & (np.sign(g) == np.sign(
                _jax_leaf(jgrads[0], path)))
        assert sure.any(), path
        err = np.abs(got - want)[sure].max()
        assert err <= tol, (path, err)


def _sphinx_moe(seed=0):
    cfg = dict(DECODER, hidden_dim=96, num_experts=4, **TOWERS)
    tm = MetaModel("mixtral_sparse_ens", cfg, max_seq_len=256, init_params=False, device="cpu")
    tree = perturbed(params_to_jax(tm.module.init_params(tm.args, seed=seed, device="cpu")),
                     seed=seed + 1, scale=0.02)
    jm = JMetaModel("mixtral_sparse_ens", cfg, max_seq_len=256, init_params=False)
    return (jm.module, jm.args, to_jax(tree), tm.module, tm.args,
            params_from_jax(tree, tm.args, device="cpu"))


@pytest.mark.parametrize("moe_aux", [True, False])
def test_sphinx_moe_image_step_matches_jax(moe_aux):
    """A SPHINX-MoE image batch, 4 images in two microbatches, one step."""
    jmod, jargs, jparams, tmod, targs, tparams = _sphinx_moe()
    batch, accum = _batch(targs.vocab_size), 2
    jtx = jmake_optimizer(jparams, 1e-3, clip_norm=None,
                          trainable=jmod.get_trainable_params_filter(jargs))
    _, jmet = jax.jit(jmake_train_step(jmod, jargs, jtx, remat=False, accum_steps=accum,
                                       moe_aux=moe_aux))(
        JTrainState.create(jparams, jtx), {k: jnp.asarray(v) for k, v in batch.items()})
    tx = make_optimizer(tparams, 1e-3, clip_norm=None,
                        trainable=tmod.get_trainable_params_filter(targs))
    trainable = [p for p, lab in tx.labels.items() if lab != "frozen"]
    frozen_visual = {p for p, lab in tx.labels.items()
                     if lab == "frozen" and p.startswith("visual/")}
    state, met = make_train_step(tmod, targs, tx, remat=True, accum_steps=accum,
                                 moe_aux=moe_aux, device="cpu")(TrainState.create(tparams, tx),
                                                                batch)
    for key in ("loss", "c_loss") + (("aux_loss",) if moe_aux else ()):
        _close(met[key], jmet[key], TOL["float32"]["loss"], key)
    assert (float(met["aux_loss"]) > 0) == moe_aux
    jg = _jax_grads(jmod, jargs, jparams, batch, accum, moe_aux, images=True)
    grads = grads_of(state)
    assert trainable and not frozen_visual & set(grads)
    for path in trainable:
        err = _rel_l2(grads[path].numpy() / accum, _jax_leaf(jg, path))
        assert err <= TOL["float32"]["grad"], (path, err)
    outside = [np.asarray(g, np.float32) for path, g in
               jax.tree_util.tree_flatten_with_path(jg)[0]
               if "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
               not in frozen_visual]
    norm = float(np.sqrt(sum(np.sum(g * g) for g in outside)))
    _close(met["grad_norm"], norm, 3 * TOL["float32"]["grad"], "grad_norm")


class _Mesh:
    """A (dp, cp) mesh stand-in (the step reads its axis sizes and ranks; its
    groups are never reached)."""

    mesh_dim_names = ("dp", "cp")

    def __init__(self, dp, cp):
        self.shape = (dp, cp)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def test_moe_aux_under_context_parallel():
    """More than one dp x cp rank: moe_aux raises naming A10. One rank: the
    cp step with moe_aux equals the plain one."""
    from accessory_tpu_torch.parallel.context import make_cp_attn_fn

    _, _, args, port, batch = _mixtral("float32", "dense")
    tx = make_optimizer(port, LR)
    for dp, cp in ((2, 1), (1, 2)):
        with pytest.raises(NotImplementedError, match="A10"):
            make_train_step(mixtral, args, tx, moe_aux=True,
                            attn_fn=make_cp_attn_fn(_Mesh(dp, cp)), device="cpu")
    out = []
    for attn_fn in (None, make_cp_attn_fn(_Mesh(1, 1))):
        params = params_from_jax(params_to_jax(port), args, device="cpu")
        tx = make_optimizer(params, LR)
        _, m = make_train_step(mixtral, args, tx, remat=False, moe_aux=True, attn_fn=attn_fn,
                               device="cpu")(TrainState.create(params, tx), batch)
        out.append({k: float(v) for k, v in m.items()})
    for key in ("loss", "c_loss", "aux_loss", "grad_norm"):
        _close(out[1][key], out[0][key], 1e-6, key)
