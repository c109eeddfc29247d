"""Port parity, DiT: ``dit_forward`` (f32 and bf16, learned sigma on and
off, caption features 0 and 16), every ``GaussianDiffusion`` method, the
DDIM and DDPM loops from the JAX package's own draws, ``cfg_model_fn``,
``ema_update``, the loss-second-moment sampler, one ``make_dit_train_step``
step (uniform and loss-aware) on the t, noise and drop mask JAX drew, and
the two CLIs (``train.main`` on tmp shards; ``sample.main`` on a checkpoint
written by the JAX package's ``save_checkpoint``).

Tiny widths (dim 64, 2 layers, 4 heads, 8x8 latents, 10 classes); params
drawn by the JAX package, every leaf perturbed from a numpy seed (so the
adaLN-zero gates are open and every gradient is non-trivial), handed to the
port through ``convert.params_from_jax``. Tolerances: f32 1e-5 where the op
order is the same (the forward, the diffusion terms), 1e-4 through the
sample loops' steps; bf16 2e-2 of the output's scale; the sampler's state
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accessory_tpu.checkpoint import load_checkpoint as jload_checkpoint
from accessory_tpu.checkpoint import save_checkpoint as jsave_checkpoint
from accessory_tpu.dit import diffusion as jdiff
from accessory_tpu.dit import sample as jsample
from accessory_tpu.dit import timestep_sampler as jts
from accessory_tpu.dit.model import DiTArgs as JDiTArgs
from accessory_tpu.dit.model import dit_forward as jdit_forward
from accessory_tpu.dit.model import init_dit as jinit_dit
from accessory_tpu.dit.train import make_dit_train_step as jmake_step
from accessory_tpu.train.train_step import TrainState as JTrainState

from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.dit import diffusion as tdiff
from accessory_tpu_torch.dit import sample as tsample
from accessory_tpu_torch.dit import timestep_sampler as tts
from accessory_tpu_torch.dit import train as ttrain
from accessory_tpu_torch.dit.model import DiTArgs, dit_forward, init_dit
from accessory_tpu_torch.train import TrainState, make_optimizer
from accessory_tpu_torch.train.tree import map_leaves

from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)
from test_torch_visual import perturbed, to_jax

TINY = dict(input_size=8, patch_size=2, in_channels=4, dim=64, n_layers=2, n_heads=4,
            num_classes=10, multiple_of=32)
F32 = dict(rtol=1e-5, atol=1e-5)
LOOP = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


def _pair(learn_sigma=True, cap=0, dtype="float32", seed=0):
    """(JAX args, JAX params, port args, port params): the same numbers."""
    cfg = dict(TINY, learn_sigma=learn_sigma, cap_feat_dim=cap, dtype=dtype)
    jargs = JDiTArgs(**cfg)
    tree = perturbed(jinit_dit(jax.random.PRNGKey(seed), jargs), seed + 1)
    jd = jnp.dtype(dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), to_jax(tree))
    args = DiTArgs(**cfg)
    cast = torch.bfloat16 if dtype == "bfloat16" else None
    return jargs, jparams, args, params_from_jax(tree, args, device="cpu", cast=cast)


def _inputs(b=3, cap=0, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 4, 8, 8).astype(np.float32)
    t = np.array([0, 437, 999][:b], np.int32)
    y = np.array([3, 10, 7][:b], np.int32)     # 10 = the CFG null label
    caps = rng.randn(b, 5, cap).astype(np.float32) if cap else None
    return x, t, y, caps


def _t(a, dtype=None):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(
        dtype or torch.from_numpy(np.asarray(a)).dtype)


@pytest.mark.parametrize("dtype,learn_sigma,cap", [("float32", True, 0),
                                                    ("float32", False, 16),
                                                    ("float32", True, 16),
                                                    ("bfloat16", True, 0)])
def test_dit_forward_matches_jax(dtype, learn_sigma, cap):
    jargs, jp, args, tp = _pair(learn_sigma, cap, dtype)
    x, t, y, caps = _inputs(cap=cap)
    want = np.asarray(jdit_forward(jp, jargs, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                                   cap_feats=None if caps is None else jnp.asarray(caps)),
                      np.float32)
    got = dit_forward(tp, args, _t(x), _t(t, torch.long), _t(y, torch.long),
                      cap_feats=_t(caps)).float().numpy()
    assert got.shape == (3, args.out_channels, 8, 8)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_init_dit_is_adaln_zero_and_round_trips():
    """init_dit's output is exactly zero (zero head and gates), the tree
    carries the reference's leaves, and params_to_jax / params_from_jax
    round-trip it bit for bit."""
    args = DiTArgs(**TINY, cap_feat_dim=16)
    params = init_dit(0, args, device="cpu")
    x, t, y, caps = _inputs(cap=16)
    out = dit_forward(params, args, _t(x), _t(t, torch.long), _t(y, torch.long), _t(caps))
    assert float(out.abs().max()) == 0.0
    jtree = jinit_dit(jax.random.PRNGKey(0), JDiTArgs(**TINY, cap_feat_dim=16))
    back = params_to_jax(params)
    assert jax.tree.structure(jtree) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.shape == b.shape
    again = params_from_jax(back, args, device="cpu")
    for a, b in zip(jax.tree.leaves(params_to_jax(again)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_remat_gives_identical_gradients():
    """Each block checkpointed (True keeps its products, "full" nothing) or
    not: the same loss and gradients, bit for bit."""
    _, _, args, _ = _pair()
    x, t, y, _ = _inputs()
    grads = []
    for remat in (False, True, "full"):
        _, _, _, tp = _pair()
        leaves = [p.requires_grad_(True) for p in _leaves(tp)]
        out = dit_forward(tp, args, _t(x), _t(t, torch.long), _t(y, torch.long), remat=remat)
        (out * out).sum().backward()
        grads.append([p.grad for p in leaves])
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(grads[0], g))


def _leaves(node):
    if isinstance(node, dict):
        return [x for v in node.values() for x in _leaves(v)]
    if isinstance(node, list):
        return [x for v in node for x in _leaves(v)]
    return [node]


@pytest.mark.parametrize("learn_sigma,var_type", [(True, "learned_range"),
                                                  (False, "fixed_small"),
                                                  (False, "fixed_large")])
def test_gaussian_diffusion_methods_match_jax(learn_sigma, var_type):
    jg = jdiff.GaussianDiffusion(num_timesteps=50, learn_sigma=learn_sigma, var_type=var_type)
    tg = tdiff.GaussianDiffusion(num_timesteps=50, learn_sigma=learn_sigma, var_type=var_type)
    for name in tdiff._TABLES:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    rng = np.random.RandomState(1)
    x0 = rng.randn(4, 4, 8, 8).clip(-1, 1).astype(np.float32)
    x0[0, 0, 0, :2] = (-1.0, 1.0)          # the discretized NLL's edge bins
    noise = rng.randn(4, 4, 8, 8).astype(np.float32)
    t = np.array([0, 1, 25, 49], np.int32)
    out = rng.randn(4, 8 if learn_sigma else 4, 8, 8).astype(np.float32)
    J, T = (lambda a: jnp.asarray(a)), (lambda a: torch.from_numpy(np.array(a)))
    tl = T(t).long()

    def close(got, want, **tol):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or F32))

    xt_j = jg.q_sample(J(x0), J(t), J(noise))
    xt_t = tg.q_sample(T(x0), tl, T(noise))
    close(xt_t, xt_j)
    for g, w in zip(tg.q_posterior(T(x0), xt_t, tl), jg.q_posterior(J(x0), xt_j, J(t))):
        close(g, w)
    close(tg._eps_to_x0(xt_t, tl, T(noise)), jg._eps_to_x0(xt_j, J(t), J(noise)))
    for clip in (True, False):
        for g, w in zip(tg.p_mean_variance(T(out), xt_t, tl, clip=clip),
                        jg.p_mean_variance(J(out), xt_j, J(t), clip=clip)):
            close(g, w)
    if learn_sigma:
        close(tg.vb_term(T(out), T(x0), xt_t, tl), jg.vb_term(J(out), J(x0), xt_j, J(t)),
              rtol=1e-5, atol=1e-4)
    # training_loss on the noise JAX draws from its key
    key = jax.random.PRNGKey(7)
    jnoise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    w = rng.randn(8 if learn_sigma else 4).astype(np.float32) * 0.3
    j_fn = lambda x, tt: jnp.tile(x, (1, 2 if learn_sigma else 1, 1, 1)) * J(w)[None, :, None, None]  # noqa: E731
    t_fn = lambda x, tt: x.repeat(1, 2 if learn_sigma else 1, 1, 1) * T(w)[None, :, None, None]  # noqa: E731
    for reduce in (True, False):
        lj, pj = jg.training_loss(j_fn, J(x0), J(t), key, reduce=reduce)
        lt, pt = tg.training_loss(t_fn, T(x0), tl, noise=T(jnoise), reduce=reduce)
        close(lt, lj, rtol=1e-5, atol=1e-4)
        for k in ("mse", "vb"):
            close(pt[k], pj[k], rtol=1e-5, atol=1e-4)


def test_respacing_matches_jax():
    jg = jdiff.GaussianDiffusion(num_timesteps=100).respaced("ddim10")
    tg = tdiff.GaussianDiffusion(num_timesteps=100).respaced("ddim10")
    assert tg.num_timesteps == 10
    np.testing.assert_array_equal(tg.timestep_map, np.asarray(jg.timestep_map))
    for name in tdiff._TABLES:
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)))
    t = torch.tensor([0, 4, 9])
    np.testing.assert_array_equal(tg._model_t(t).numpy(), np.asarray(jg._model_t(jnp.asarray(t))))
    for counts in ("ddim50", [10, 15, 20], "10"):
        assert tdiff.space_timesteps(300, counts) == jdiff.space_timesteps(300, counts)


def _model_fns(learn_sigma=True):
    """The tiny DiT under CFG on both sides, labels fixed."""
    jargs, jp, args, tp = _pair(learn_sigma)
    y = np.array([1, 2], np.int32)
    jf = jdiff.cfg_model_fn(lambda x, t, yy: jdit_forward(jp, jargs, x, t, yy), 2.0,
                            jargs.num_classes)
    tf = tdiff.cfg_model_fn(lambda x, t, yy: dit_forward(tp, args, x, t, yy), 2.0,
                            args.num_classes)
    return (lambda x, t: jf(x, t, jnp.asarray(y))), (lambda x, t: tf(x, t, torch.tensor([1, 2])))


def test_cfg_model_fn_matches_jax():
    jf, tf = _model_fns()
    x = np.random.RandomState(3).randn(2, 4, 8, 8).astype(np.float32)
    t = np.array([10, 900], np.int32)
    np.testing.assert_allclose(tf(torch.from_numpy(x), torch.from_numpy(t).long()).numpy(),
                               np.asarray(jf(jnp.asarray(x), jnp.asarray(t))), **F32)


@pytest.mark.parametrize("respace", [None, "ddim5"])
def test_ddim_from_the_same_x_T(respace):
    jf, tf = _model_fns()
    jg, tg = jdiff.GaussianDiffusion(num_timesteps=40), tdiff.GaussianDiffusion(num_timesteps=40)
    if respace:
        jg, tg = jg.respaced(respace), tg.respaced(respace)
    key = jax.random.PRNGKey(4)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (2, 4, 8, 8), jnp.float32))
    steps = None if respace else 6
    want = jg.ddim_sample_loop(jf, (2, 4, 8, 8), key, steps=steps)
    got = tg.ddim_sample_loop(tf, (2, 4, 8, 8), steps=steps, x_T=torch.from_numpy(x_T),
                              device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP)


def test_ddpm_with_jax_draws():
    """p_sample_loop from JAX's x_T and its per-step draws (the test repeats
    the reference's key splits, diffusion.py:265-274)."""
    jf, tf = _model_fns()
    jg, tg = jdiff.GaussianDiffusion(num_timesteps=8), tdiff.GaussianDiffusion(num_timesteps=8)
    shape = (2, 4, 8, 8)
    key = jax.random.PRNGKey(9)
    k, sub = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(sub, shape, jnp.float32))
    noise = []
    for _ in range(8):
        k, sub = jax.random.split(k)
        noise.append(torch.from_numpy(np.asarray(jax.random.normal(sub, shape, jnp.float32))))
    want = jg.p_sample_loop(jf, shape, key)
    got = tg.p_sample_loop(tf, shape, x_T=torch.from_numpy(x_T), noise=noise, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(2)
    e = {"w": rng.randn(5, 3).astype(np.float32), "l": [rng.randn(4).astype(np.float32)]}
    p = {"w": rng.randn(5, 3).astype(np.float32), "l": [rng.randn(4).astype(np.float32)]}
    want = jdiff.ema_update(to_jax(e), to_jax(p), decay=0.99)
    te = {"w": torch.from_numpy(e["w"].copy()), "l": [torch.from_numpy(e["l"][0].copy())]}
    out = tdiff.ema_update(te, {"w": torch.from_numpy(p["w"]), "l": [torch.from_numpy(p["l"][0])]},
                           decay=0.99)
    assert out is te
    np.testing.assert_array_equal(te["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(te["l"][0].numpy(), np.asarray(want["l"][0]))


def test_sampler_weights_and_updates_exact():
    """The same (t, loss) batches through both samplers' updates, with
    duplicates inside a batch: history and counts equal; the weights, and
    the importance weights of JAX's drawn t, to f32 rounding (1e-6: XLA's
    CPU reductions sum the 7 timesteps in another order and take the mean
    as a product with 1/H)."""
    T, H = 7, 3
    rng = np.random.RandomState(0)
    js, ts = jts.init_sampler_state(T, H), tts.init_sampler_state(T, H, device="cpu")
    key = jax.random.PRNGKey(1)
    for i in range(9):
        t = rng.randint(0, T, size=(5,)).astype(np.int32)
        losses = rng.uniform(0.1, 2.0, size=(5,)).astype(np.float32)
        js = jts.update_sampler_state(js, jnp.asarray(t), jnp.asarray(losses))
        ts = tts.update_sampler_state(ts, torch.from_numpy(t).long(), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(tts.sampler_weights(ts).numpy(),
                                   np.asarray(jts.sampler_weights(js)), rtol=1e-6)
        key, sub = jax.random.split(key)
        jt, jw = jts.sample_timesteps(js, sub, 6)
        tt, tw = tts.sample_timesteps(ts, None, 6, t=torch.from_numpy(np.asarray(jt)))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert int(ts.counts.min()) >= H           # warmed: the weights above were not uniform
    t, w = tts.sample_timesteps(ts, torch.Generator().manual_seed(0), 4000)
    p = tts.sampler_weights(ts)
    assert t.min() >= 0 and t.max() < T
    np.testing.assert_allclose(np.bincount(t.numpy(), minlength=T) / 4000, p.numpy(), atol=0.03)
    torch.testing.assert_close(w, 1.0 / (T * p[t]))


def _warm_state(T, H, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0.1, 2.0, (T, H)).astype(np.float32),
            rng.randint(H, 3 * H, (T,)).astype(np.int32))


@pytest.mark.parametrize("sampler", ["uniform", "loss-second-moment"])
def test_train_step_matches_jax(sampler):
    """One step from the same params and JAX's own draws (the test repeats
    its key splits, train.py:80): loss, the update where the gradient is not
    negligible (|Δp| / lr within 1e-3), the EMA, and the sampler's state."""
    jargs, jp, args, tp = _pair(seed=2)
    T, b = 50, 4
    jg, tg = jdiff.GaussianDiffusion(num_timesteps=T), tdiff.GaussianDiffusion(num_timesteps=T)
    rng = np.random.RandomState(8)
    lat = rng.randn(b, 4, 8, 8).clip(-1, 1).astype(np.float32)
    lab = np.array([1, 2, 3, 4], np.int32)
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=0.0))
    made = jmake_step(jargs, jg, jtx, schedule_sampler=sampler)
    loss_aware = sampler != "uniform"
    jstep, jss = made if loss_aware else (made, None)
    hist, counts = _warm_state(T, 10)
    if loss_aware:
        jss = jts.SamplerState(jnp.asarray(hist), jnp.asarray(counts))
    jema = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    key = jax.random.PRNGKey(11)
    out = jax.jit(jstep)(JTrainState.create(jp, jtx), jema, jnp.asarray(lat), jnp.asarray(lab),
                         key, sampler_state=jss)
    _, k_t, k_n, k_drop = jax.random.split(key, 4)
    jt = (jts.sample_timesteps(jss, k_t, b)[0] if loss_aware
          else jax.random.randint(k_t, (b,), 0, T))
    draws = {"t": torch.from_numpy(np.asarray(jt)),
             "noise": torch.from_numpy(np.asarray(jax.random.normal(k_n, lat.shape,
                                                                    jnp.float32))),
             "drop": torch.from_numpy(np.asarray(jax.random.uniform(k_drop, (b,))
                                                 < jargs.class_dropout_prob))}

    tx = make_optimizer(tp, LR, weight_decay=0.0, betas=(0.9, 0.999), clip_norm=1.0)
    before = {k: v.detach().clone() for k, v in _named(tp).items()}
    tema = map_leaves(lambda _, x: x.detach().clone(), tp)
    made = ttrain.make_dit_train_step(args, tg, tx, schedule_sampler=sampler, device="cpu")
    tstep, _ = made if loss_aware else (made, None)
    tss = tts.SamplerState(torch.from_numpy(hist), torch.from_numpy(counts))
    res = tstep(TrainState.create(tp, tx), tema, torch.from_numpy(lat), torch.from_numpy(lab),
                sampler_state=tss if loss_aware else None, draws=draws)
    state, metrics = res[0], res[2]
    np.testing.assert_allclose(float(metrics["loss"]), float(out[2]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["mse"]), float(out[2]["mse"]), rtol=1e-5)
    jnew, jnew_ema = _jax_named(out[0].params), _jax_named(out[1])
    new = _named(state.params)
    for path, old in before.items():
        g = new[path].grad.abs()
        sure = g >= 1e-2 * g.max()
        upd = ((new[path].detach() - old) / LR).numpy()
        want = (jnew[path] - old.numpy()) / LR
        assert sure.any() and np.abs(upd - want)[sure.numpy()].max() <= 1e-3, path
        np.testing.assert_allclose(_named(res[1])[path].numpy(), jnew_ema[path], atol=1e-6)
    if loss_aware:
        np.testing.assert_allclose(res[3].history.numpy(), np.asarray(out[4].history),
                                   rtol=1e-5)
        np.testing.assert_array_equal(res[3].counts.numpy(), np.asarray(out[4].counts))


def _named(tree):
    from accessory_tpu_torch.train.tree import named_leaves

    return dict(named_leaves(tree))


def _jax_named(tree):
    """The JAX tree's leaves under the port's paths (layer i of the stacked
    layers at layers/i/...)."""
    back = params_from_jax(jax.tree.map(np.asarray, tree), DiTArgs(**TINY), device="cpu")
    return {k: v.numpy() for k, v in _named(back).items()}


def _write_shards(d, n=12, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(2):
        np.savez(d / f"shard{i}.npz", latents=rng.randn(n, 4, 8, 8).astype(np.float32),
                 labels=rng.randint(0, 4, n))


@pytest.mark.parametrize("sampler", ["uniform", "loss-second-moment"])
def test_train_main_runs_and_saves(tmp_path, sampler):
    """2 iterations plus a save on tmp shards; the checkpoint's two trees are
    what the JAX package's load_checkpoint reads (layers stacked), its
    ``model`` the params the run ended with."""
    _write_shards(tmp_path)
    args = ttrain.get_args_parser().parse_args([
        "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"), "--dim", "64",
        "--n_layers", "2", "--n_heads", "4", "--input_size", "8", "--num_classes", "4",
        "--batch_size", "4", "--max_iters", "2", "--save_freq", "2", "--log_every", "1",
        "--schedule_sampler", sampler])
    state, ema = ttrain.main(args, device="cpu")
    assert state.step == 2 and state.opt_state["count"] == 2
    ck = jload_checkpoint(str(tmp_path / "out" / "iter2"))
    assert set(ck) == {"model", "ema"}
    assert ck["model"]["layers"]["wqkv"]["weight"].shape == (2, 64, 192)
    for path, leaf in _named(state.params).items():
        np.testing.assert_array_equal(_jax_named(ck["model"])[path], leaf.detach().numpy())
    with pytest.raises(NotImplementedError, match="A10"):
        args.model_parallel_size = 2
        ttrain.main(args, device="cpu")


def test_c15_train_main_honours_ema_decay(tmp_path):
    """ROADMAP C15: the reference's step ignores --ema_decay (its EMA moves
    at 0.9999 whatever the flag); the port's main passes it on, so at decay
    0 the EMA after one step is the params, bit for bit."""
    _write_shards(tmp_path)
    args = ttrain.get_args_parser().parse_args([
        "--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"), "--dim", "64",
        "--n_layers", "2", "--n_heads", "4", "--input_size", "8", "--num_classes", "4",
        "--batch_size", "4", "--max_iters", "1", "--ema_decay", "0", "--log_every", "1"])
    state, ema = ttrain.main(args, device="cpu")
    ema = _named(ema)
    for path, leaf in _named(state.params).items():
        assert torch.equal(ema[path], leaf.detach())


def test_sample_main_on_a_jax_checkpoint(tmp_path):
    """sample.main reads a checkpoint the JAX package wrote, takes its ema
    tree, and writes the latents ``sample`` gives; from JAX's x_T, ``sample``
    agrees with the JAX package's."""
    jargs, jp, args, _ = _pair(seed=4)
    _, jema, _, tema = _pair(seed=6)
    jsave_checkpoint(str(tmp_path / "ck"), {"model": jp, "ema": jema})
    cli = tsample.get_args_parser().parse_args([
        "--ckpt", str(tmp_path / "ck"), "--labels", "1", "3", "--steps", "4",
        "--out", str(tmp_path / "s.npz"), "--dim", "64", "--n_layers", "2", "--n_heads", "4",
        "--input_size", "8", "--num_classes", "10", "--seed", "3"])
    tsample.main(cli, device="cpu")
    lat = np.load(tmp_path / "s.npz")["latents"]
    assert lat.shape == (2, 4, 8, 8) and np.isfinite(lat).all()
    direct = tsample.sample(tema, args, [1, 3], 4.0, "ddim", 4, seed=3, device="cpu")
    np.testing.assert_array_equal(lat, direct.numpy())
    key = jax.random.PRNGKey(3)
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (2, 4, 8, 8), jnp.float32))
    want = jsample.sample(jema, jargs, [1, 3], 4.0, "ddim", 4, seed=3)
    got = tsample.sample(tema, args, [1, 3], 4.0, "ddim", 4, device="cpu",
                         x_T=torch.from_numpy(x_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP)


def test_latent_batches_cycle_and_refuse_short_shards(tmp_path):
    """Batches run shard after shard and wrap around (a shard's short tail
    skipped); shards that hold no whole batch raise instead of spinning."""
    _write_shards(tmp_path, n=6)
    it = ttrain.latent_batches(str(tmp_path), 4)
    batches = [next(it) for _ in range(3)]
    assert [b[0].shape for b in batches] == [(4, 4, 8, 8)] * 3
    first = np.load(tmp_path / "shard0.npz")["latents"][:4]
    np.testing.assert_array_equal(batches[0][0], first)
    np.testing.assert_array_equal(batches[2][0], first)
    assert batches[0][1].dtype == np.int64
    with pytest.raises(ValueError, match="holds a batch"):
        next(ttrain.latent_batches(str(tmp_path), 7))
