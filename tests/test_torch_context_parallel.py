"""Context parallelism of the port against the JAX package on the CPU.

- The plain versions of the row-26 kernel (``flash_attention_cp`` and its
  backward) at every shard's query offset against JAX ``attention(...,
  q_offset=)`` and its ``jax.vjp``.
- ``parallel.cp_attention`` and a context-parallel train step in spawned
  gloo process groups, one spawn a world: (cp 2), (cp 4), (cp 2, tp 2),
  (dp 2, cp 2). Each rank feeds its shard of the same numpy inputs; the
  parent gathers the shards and holds them against JAX ``cp_attention`` (its
  XLA branch, on the conftest's 8-device CPU mesh with the world's cp and tp)
  and JAX ``make_train_step(..., attn_fn=make_cp_attn_fn(mesh))``: the loss,
  every gradient, grad_norm and the updated parameters; (cp 4) also against
  the splash branch in interpret mode (S 512, head_dim 64), (cp 2, tp 2) and
  (cp 4) with ``remat=True``.

The spawned children import this module, so it imports no JAX at its top:
JAX is imported inside the tests. Tolerances (f32 throughout): attention
outputs and gradients 2e-5 absolute (sums in other orders; the splash case
2e-4, its own tolerance in tests/test_context_parallel.py); the train step's
loss 1e-5 relative, gradients 1e-4 relative L2 and grad_norm 3e-4 relative
(a sum over the ranks in gloo's order), updated parameters as in
tests/test_torch_train_step.py: (new - old) / lr to 1e-3 where the JAX
gradient is at least a tenth of its leaf's largest (the first AdamW step
moves an element by about lr * sign(g)).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from accessory_tpu_torch.ops.flash_attention import flash_attention_cp

CFG = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128, multiple_of=32,
           max_seq_len=32)
B, S = 2, 32
LR = 1e-2
# world name -> (mesh axes of the port's ranks, remat of its train step)
WORLDS = {"cp2": ({"cp": 2}, False), "cp4": ({"cp": 4}, True),
          "cp2_tp2": ({"cp": 2, "tp": 2}, True), "dp2_cp2": ({"dp": 2, "cp": 2}, False)}
SPLASH = dict(b=1, s=512, nq=4, nkv=2, hd=64)


def _inputs(b, s, nq, nkv, hd, seed):
    rng = np.random.RandomState(seed)
    return {"q": rng.standard_normal((b, s, nq, hd)).astype(np.float32),
            "k": rng.standard_normal((b, s, nkv, hd)).astype(np.float32),
            "v": rng.standard_normal((b, s, nkv, hd)).astype(np.float32),
            "dout": rng.standard_normal((b, s, nq, hd)).astype(np.float32)}


# ---------------------------------------------------------------- the plain versions


@pytest.mark.parametrize("nq,nkv", [(4, 2), (4, 4)])
@pytest.mark.parametrize("cp", [2, 4])
def test_plain_cp_kernel_matches_jax_at_every_offset(cp, nq, nkv):
    import jax
    import jax.numpy as jnp

    from accessory_tpu.ops.attention import attention

    x = _inputs(2, 32, nq, nkv, 16, seed=cp + nq + nkv)
    s_l = 32 // cp
    kf, vf = (torch.from_numpy(x[n]) for n in ("k", "v"))

    @jax.jit
    def jax_ref(q, k, v, do, off):
        out, vjp = jax.vjp(lambda a, b, c: attention(a, b, c, causal=True, q_offset=off),
                           q, k, v)
        return (out,) + vjp(do)

    for rank in range(cp):
        rows = slice(rank * s_l, (rank + 1) * s_l)
        want, wq, wk, wv = jax_ref(jnp.asarray(x["q"][:, rows]), jnp.asarray(x["k"]),
                               jnp.asarray(x["v"]), jnp.asarray(x["dout"][:, rows]),
                               rank * s_l)
        q = torch.from_numpy(x["q"][:, rows]).requires_grad_(True)
        k, v = kf.clone().requires_grad_(True), vf.clone().requires_grad_(True)
        out = flash_attention_cp(q, k, v, rank * s_l)
        out.backward(torch.from_numpy(x["dout"][:, rows]))
        for got, ref in ((out, want), (q.grad, wq), (k.grad, wk), (v.grad, wv)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-5,
                                       rtol=2e-5)
        # keys past the shard's last row get no gradient from it
        assert not k.grad[:, (rank + 1) * s_l:].any() and not v.grad[:, (rank + 1) * s_l:].any()


def test_plain_cp_kernel_refuses_bad_offsets():
    x = _inputs(1, 16, 2, 1, 16, seed=0)
    q, k, v = (torch.from_numpy(x[n]) for n in ("q", "k", "v"))
    for off in (-1, 1, torch.tensor(0)):
        with pytest.raises(ValueError, match="q_offset"):
            flash_attention_cp(q, k, v, off)


# ---------------------------------------------------------------- spawned worlds


def _worker(rank, world, tmp, axes, remat):
    """One rank of a gloo world: cp_attention forward and backward on its
    shard, then one train step; writes its results to rank<r>.pt."""
    torch.set_num_threads(1)
    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.convert import params_from_jax
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.parallel import (cp_attention, init_distributed_mode, make_mesh,
                                              make_cp_attn_fn)
    from accessory_tpu_torch.parallel.mesh import axis_rank, axis_size
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.train_step import grads_of
    from accessory_tpu_torch.train.tree import named_leaves

    init_distributed_mode(init_method="file://" + os.path.join(tmp, "store"),
                          world_size=world, rank=rank, device="cpu")
    mesh = make_mesh(axes, device="cpu")
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    res = {"cp_rank": axis_rank(mesh, "cp"), "dp_rank": axis_rank(mesh, "dp")}
    cp = axis_size(mesh, "cp")
    for tag in ("attn", "splash"):
        if tag not in inp:
            continue
        x = inp[tag]
        s_l = x["q"].shape[1] // cp
        rows = slice(res["cp_rank"] * s_l, (res["cp_rank"] + 1) * s_l)
        q, k, v = (torch.from_numpy(x[n][:, rows]).requires_grad_(True) for n in ("q", "k", "v"))
        out = cp_attention(q, k, v, mesh=mesh)
        out.backward(torch.from_numpy(x["dout"][:, rows]))
        res[tag] = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}

    args = LLaMAArgs(**CFG, dtype="float32")
    params = params_from_jax(inp["params"], args, device="cpu")
    tx = make_optimizer(params, LR, weight_decay=0.0, clip_norm=1.0)
    step = make_train_step(llama, args, tx, remat=remat, attn_fn=make_cp_attn_fn(mesh),
                           device="cpu")
    state, m = step(TrainState.create(params, tx), inp["batch"])
    res["metrics"] = {k: float(v) for k, v in m.items()}
    res["grads"] = {k: g.clone() for k, g in grads_of(state).items()}
    res["params"] = {k: v.detach().clone() for k, v in named_leaves(state.params)}
    torch.save(res, os.path.join(tmp, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.destroy_process_group()


_JAX_REFS = {}


def _jax_mesh(axes):
    from accessory_tpu.parallel.mesh import make_mesh

    cp, tp = axes.get("cp", 1), axes.get("tp", 1)
    return make_mesh({"dp": 8 // (cp * tp), "cp": cp, "tp": tp})


def _jax_attention(axes, x, **kw):
    import jax
    import jax.numpy as jnp

    from accessory_tpu.parallel.context import cp_attention

    mesh = _jax_mesh(axes)

    def f(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: cp_attention(a, b, c, mesh=mesh, **kw), q, k, v)
        return (out,) + vjp(do)

    return [np.asarray(t) for t in jax.jit(f)(*(jnp.asarray(x[n])
                                                 for n in ("q", "k", "v", "dout")))]


def _jax_train(axes, remat, jparams, batch):
    """JAX make_train_step with cp attention on the world's mesh: metrics,
    updated params, and the gradients its loss_fn takes (cached: the worlds
    (cp 2) and (dp 2, cp 2) share a JAX mesh)."""
    import jax
    import jax.numpy as jnp

    from accessory_tpu.config import LLaMAArgs as JArgs
    from accessory_tpu.models import llama as jllama
    from accessory_tpu.parallel.context import make_cp_attn_fn
    from accessory_tpu.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu.train.loss import cross_entropy_loss

    key = (axes.get("cp", 1), axes.get("tp", 1), remat)
    if key not in _JAX_REFS:
        jargs = JArgs(**CFG, dtype="float32")
        attn_fn = make_cp_attn_fn(_jax_mesh(axes))
        tx = make_optimizer(jparams, LR, weight_decay=0.0, clip_norm=1.0)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        state, m = jax.jit(make_train_step(jllama, jargs, tx, remat=remat, attn_fn=attn_fn))(
            TrainState.create(jparams, tx), jb)

        def loss(p):
            logits, _ = jllama.forward(p, jargs, jb["examples"], remat=remat, attn_fn=attn_fn)
            return cross_entropy_loss(logits, jb["labels"])[0]

        grads = jax.jit(jax.grad(loss))(jparams)
        _JAX_REFS[key] = ({k: float(v) for k, v in m.items()}, state.params, grads)
    return _JAX_REFS[key]


def _jax_leaf(tree, path):
    parts = path.split("/")
    node = tree["layers"] if parts[0] == "layers" else tree
    for p in (parts[2:] if parts[0] == "layers" else parts):
        node = node[p]
    return np.asarray(node[int(parts[1])] if parts[0] == "layers" else node, np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("world", list(WORLDS))
def test_cp_world_matches_jax(world, tmp_path):
    import jax

    from accessory_tpu.config import LLaMAArgs as JArgs
    from accessory_tpu.models import llama as jllama
    from test_torch_generate import to_numpy_tree

    axes, remat = WORLDS[world]
    n_ranks = int(np.prod(list(axes.values())))
    jparams = jllama.init_params(jax.random.PRNGKey(0), JArgs(**CFG, dtype="float32"))
    rng = np.random.RandomState(7)
    batch = {"examples": rng.randint(1, 128, (B, S)).astype(np.int32),
             "labels": rng.randint(0, 128, (B, S)).astype(np.int32)}
    batch["labels"][0, 5:9] = 0                                 # ignored labels in a shard
    inp = {"attn": _inputs(B, S, 4, 2, 16, seed=1), "params": to_numpy_tree(jparams),
           "batch": batch}
    if world == "cp4":
        inp["splash"] = _inputs(seed=3, **SPLASH)
    with open(tmp_path / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    torch.multiprocessing.spawn(_worker, args=(n_ranks, str(tmp_path), axes, remat),
                                nprocs=n_ranks, join=True)
    res = [torch.load(tmp_path / f"rank{r}.pt") for r in range(n_ranks)]

    cp = axes.get("cp", 1)
    for tag, kw, tol in (("attn", {}, 2e-5), ("splash", dict(use_splash=True, interpret=True),
                                               2e-4)):
        if tag not in inp:
            continue
        want = _jax_attention(axes, inp[tag], **kw)
        for r in res:
            # every rank of a cp coordinate holds the same shard; gradients of
            # the keys are the rank's own rows after the reduce-scatter
            s_l = inp[tag]["q"].shape[1] // cp
            rows = slice(r["cp_rank"] * s_l, (r["cp_rank"] + 1) * s_l)
            for name, ref in zip(("out", "dq", "dk", "dv"), want):
                np.testing.assert_allclose(r[tag][name].numpy(), ref[:, rows], atol=tol,
                                           rtol=tol, err_msg=f"{world} {tag} {name}")

    metrics, jnew, jgrads = _jax_train(axes, remat, jparams, batch)
    for r in res:
        m = r["metrics"]
        assert abs(m["c_loss"] - metrics["c_loss"]) <= 1e-5 * abs(metrics["c_loss"])
        assert abs(m["grad_norm"] - metrics["grad_norm"]) <= 3e-4 * metrics["grad_norm"]
        assert round(m["n_tokens"]) == round(metrics["n_tokens"])
        for path, g in r["grads"].items():
            assert _rel_l2(g.numpy(), _jax_leaf(jgrads, path)) <= 1e-4, (world, path)
        old = inp["params"]
        for path, new in r["params"].items():
            jg = _jax_leaf(jgrads, path)
            sure = np.abs(jg) >= 0.1 * np.abs(jg).max()
            upd = (new.numpy() - _jax_leaf(old, path)) / LR
            jupd = (_jax_leaf(jnew, path) - _jax_leaf(old, path)) / LR
            np.testing.assert_allclose(upd[sure], jupd[sure], atol=1e-3, err_msg=path)
        # every rank ends with the same parameters
        for path, new in r["params"].items():
            assert torch.equal(new, res[0]["params"][path]), (world, path)
