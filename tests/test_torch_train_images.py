"""Finetuning with images in the port, against the JAX package on the CPU:

- one ``make_train_step`` step with an image batch split into two
  microbatches, for ``llama_ens`` (full finetuning), ``llama_qformerv2``
  and ``llama_adapter`` with its visual branch: the loss against the JAX
  step's, every trainable leaf's gradient against the JAX loss's gradient
  (the mean over the microbatches; llama_qformerv2 trains visual
  projections), and ``grad_norm`` against the norm of the JAX gradients of
  every leaf but the frozen visual ones (the port builds no graph through
  the frozen towers; the JAX package differentiates them and counts them
  in its norm, ROADMAP "Deliberate differences"); a SPHINX-MoE batch
  trains, and images under a context-parallel ``attn_fn`` raise with their
  ROADMAP label;
- ``FinetuneDataset``'s image items (PNG files read with PIL, the
  resized-center-crop transform, ``max_words - image_words`` text
  positions), a tab-separated ``.csv`` annotation file and the h5
  annotation cache, item for item against the JAX dataset on the same
  files (the port writes the cache and the JAX dataset reads it); the
  ImportError that names a missing package;
- ``main_finetune.collate``: a step's image items stacked as the JAX
  loop stacks them;
- every llama_type of the JAX ``ARGS_REGISTRY`` resolves in the port.

Tiny towers (test_torch_sphinx's) over 2-layer f32 decoders of width 64.
Tolerances (f32, summation order apart): loss 2e-5 relative, gradients 2e-4
relative L2, grad_norm 2e-4 relative (test_torch_train_step's f32 ones);
data items exactly.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.config import ARGS_REGISTRY as JREGISTRY
from accessory_tpu.data import transform as jtransform
from accessory_tpu.data.alpaca import FinetuneDataset as JDataset
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.train import TrainState as JTrainState
from accessory_tpu.train import make_optimizer as jmake_optimizer
from accessory_tpu.train import make_train_step as jmake_train_step
from accessory_tpu.train.loss import cross_entropy_loss as jce
from accessory_tpu.train.train_step import combine_params, partition_params as jpartition

from accessory_tpu_torch import main_finetune
from accessory_tpu_torch.config import ARGS_REGISTRY
from accessory_tpu_torch.convert import params_from_jax, params_to_jax
from accessory_tpu_torch.data import transform
from accessory_tpu_torch.data.alpaca import FinetuneDataset
from accessory_tpu_torch.meta import MetaModel
from accessory_tpu_torch.models import get_model_module
from accessory_tpu_torch.models import llama_adapter
from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
from accessory_tpu_torch.train.train_step import grads_of

from test_torch_finetune import ByteTok, _alpaca
from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)
from test_torch_train_step import _jax_leaf, _rel_l2
from test_torch_visual import perturbed, to_jax

TOWERS = dict(vit_patch=56, clip_width=32, clip_layers=2, clip_heads=2, dino_width=48,
              dino_layers=2, dino_heads=2, convnext_depths=(1, 1, 1, 1),
              convnext_dims=(8, 16, 32, 64), qformer_width=32, qformer_layers=2,
              qformer_heads=2)
DECODER = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64, multiple_of=32,
               dtype="float32", max_seq_len=256)
CASES = {"llama_ens": dict(DECODER, **TOWERS),
         "llama_qformerv2": dict(DECODER, **TOWERS),
         "llama_adapter": dict(DECODER, prefix_layers=1, prefix_len=4, v_embed_dim=32,
                               v_depth=2, v_num_heads=2)}
TOL = dict(loss=2e-5, grad=2e-4)


def _models(llama_type, seed=0):
    """(JAX module, JAX args, JAX params, port module, port args, port params)
    on the same weights: the port's draw moved by seeded noise (the
    adapter's gates open), handed to JAX through params_to_jax."""
    cfg = CASES[llama_type]
    tm = MetaModel(llama_type, cfg, max_seq_len=cfg["max_seq_len"], init_params=False,
                   device="cpu")
    if llama_type == "llama_adapter":
        params = llama_adapter.init_params(tm.args, seed=seed, device="cpu", with_visual=True)
    else:
        params = tm.module.init_params(tm.args, seed=seed, device="cpu")
    tree = perturbed(params_to_jax(params), seed=seed + 1, scale=0.02)
    if llama_type == "llama_adapter":
        tree["adapter"]["gate"] = np.random.RandomState(seed).randn(
            *tree["adapter"]["gate"].shape).astype(np.float32)
    jm = JMetaModel(llama_type, cfg, max_seq_len=cfg["max_seq_len"], init_params=False)
    return (jm.module, jm.args, to_jax(tree), tm.module, tm.args,
            params_from_jax(tree, tm.args, device="cpu"))


def _batch(vocab, seed=3, b=4, s=12):
    rng = np.random.RandomState(seed)
    return {"examples": rng.randint(1, vocab, (b, s)).astype(np.int32),
            "labels": rng.randint(0, vocab, (b, s)).astype(np.int32),
            "images": rng.randn(b, 3, 224, 224).astype(np.float32)}


def _jax_grads(jmod, jargs, params, batch, accum):
    """The JAX step's gradients (its loss_fn with images), the mean over
    ``accum`` microbatches, every differentiated leaf."""

    def loss(diff, static, ex, lab, img):
        logits, _ = jmod.forward(combine_params(diff, static), jargs, ex, images=img)
        return jce(logits, lab)[0]

    diff, static = jpartition(params)
    split = {k: np.split(v, accum) for k, v in batch.items()}
    grad = jax.jit(jax.grad(loss))
    grads = [grad(diff, static, *(jnp.asarray(split[k][i])
                                            for k in ("examples", "labels", "images")))
             for i in range(accum)]
    return jax.tree.map(lambda *g: sum(g) / accum, *grads)


@pytest.mark.parametrize("llama_type", sorted(CASES))
def test_image_step_matches_jax(llama_type):
    """One step, batch 4 in two microbatches of 2 images each (see the
    module docstring for what is held and to what tolerance)."""
    jmod, jargs, jparams, tmod, targs, tparams = _models(llama_type)
    batch, accum = _batch(targs.vocab_size), 2
    jtrain = jmod.get_trainable_params_filter(jargs)
    tx = jmake_optimizer(jparams, 1e-3, clip_norm=None, trainable=jtrain)
    _, jmet = jax.jit(jmake_train_step(jmod, jargs, tx, remat=False, accum_steps=accum))(
        JTrainState.create(jparams, tx), {k: jnp.asarray(v) for k, v in batch.items()})

    ttx = make_optimizer(tparams, 1e-3, clip_norm=None,
                         trainable=tmod.get_trainable_params_filter(targs))
    trainable = [p for p, lab in ttx.labels.items() if lab != "frozen"]
    frozen_visual = {p for p, lab in ttx.labels.items()
                     if lab == "frozen" and p.startswith("visual/")}
    assert trainable and len(frozen_visual) > 10
    state = TrainState.create(tparams, ttx)
    state, met = make_train_step(tmod, targs, ttx, remat=False, accum_steps=accum,
                                 device="cpu")(state, batch)
    want = float(jmet["c_loss"])
    assert abs(float(met["c_loss"]) - want) <= TOL["loss"] * abs(want)
    jg = _jax_grads(jmod, jargs, jparams, batch, accum)
    grads = grads_of(state)
    assert not frozen_visual & set(grads)
    for path in trainable:
        err = _rel_l2(grads[path].numpy() / accum, _jax_leaf(jg, path))
        assert err <= TOL["grad"], (path, err)
    outside = [np.asarray(g, np.float32) for path, g in
               jax.tree_util.tree_flatten_with_path(jg)[0]
               if "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
               not in frozen_visual]
    norm = float(np.sqrt(sum(np.sum(g * g) for g in outside)))
    assert abs(float(met["grad_norm"]) - norm) <= TOL["grad"] * norm


def test_refused_image_batches():
    """A SPHINX-MoE image batch trains (ROADMAP A7 is done: the MoE loss is in
    the step; tests/test_torch_train_moe.py holds it against JAX), an image
    batch under a cp attn_fn raises naming A10."""
    from accessory_tpu_torch.parallel.context import make_cp_attn_fn

    cfg = dict(DECODER, hidden_dim=96, num_experts=4, **TOWERS)
    tm = MetaModel("mixtral_sparse_ens", cfg, max_seq_len=256, device="cpu")
    tx = make_optimizer(tm.params, 1e-3, trainable=tm.module.get_trainable_params_filter(tm.args))
    step = make_train_step(tm.module, tm.args, tx, moe_aux=True, device="cpu")
    _, met = step(TrainState.create(tm.params, tx), _batch(64))
    assert np.isfinite(float(met["loss"])) and float(met["aux_loss"]) > 0
    step = make_train_step(tm.module, tm.args, tx, attn_fn=make_cp_attn_fn(_OneRankMesh()),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        step(TrainState.create(tm.params, tx), _batch(64))


class _OneRankMesh:
    """A (dp, cp) mesh stand-in of one rank (the step reads only its axis
    sizes before the refusal)."""

    mesh_dim_names, shape = ("dp", "cp"), (1, 1)


# ---------------------------------------------------------------- data


def _png(path, seed, size=(40, 30)):
    from PIL import Image

    arr = np.random.RandomState(seed).randint(0, 256, size[::-1] + (3,), dtype=np.uint8)
    Image.fromarray(arr).save(path)
    return str(path)


def _image_data(tmp_path, n=6):
    """An annotation file of items with an image and one of text items."""
    items = _alpaca(np.random.RandomState(1), n)
    for i, it in enumerate(items):
        it["image"] = _png(tmp_path / f"img{i}.png", seed=i)
    (tmp_path / "mm.json").write_text(json.dumps(items))
    (tmp_path / "text.json").write_text(json.dumps(_alpaca(np.random.RandomState(2), 5)))
    cfg = tmp_path / "mm.yaml"
    cfg.write_text(f"META:\n  - path: {tmp_path / 'mm.json'}\n    type: image\n"
                   f"  - path: {tmp_path / 'text.json'}\n    type: text\n")
    return str(cfg)


def _same_items(a, b):
    assert len(a) == len(b) and a.groups() == b.groups()
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_image_items_match_jax(tmp_path):
    """Items with an image: the transformed pixels (3, 224, 224) and the
    text in max_words - image_words positions, equal to the JAX dataset's
    with its own copy of the transform; text items keep max_words."""
    cfg = _image_data(tmp_path)
    kw = dict(max_words=160, image_words=40, tokenizer=ByteTok())
    ds = FinetuneDataset(cfg, transform=transform.get_transform("resized_center_crop", 224),
                         **kw)
    jds = JDataset(cfg, transform=jtransform.get_transform("resized_center_crop", 224), **kw)
    _same_items(ds, jds)
    img_item = ds[ds.groups()[0][0]]
    assert len(img_item) == 4 and img_item[0].shape == (120,) \
        and img_item[3].shape == (3, 224, 224)
    assert ds[ds.groups()[1][0]][0].shape == (160,)


def test_csv_annotations_match_jax(tmp_path):
    """A tab-separated .csv annotation file (pandas with the pyarrow
    engine): the same items as the JAX dataset's."""
    import pandas as pd

    pd.DataFrame(_alpaca(np.random.RandomState(4), 7)).to_csv(tmp_path / "a.csv", sep="\t",
                                                               index=False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"META:\n  - path: {tmp_path / 'a.csv'}\n    type: text\n")
    kw = dict(max_words=120, tokenizer=ByteTok())
    _same_items(FinetuneDataset(str(cfg), **kw), JDataset(str(cfg), **kw))


def test_h5_cache_matches_jax(tmp_path, monkeypatch):
    """cache_on_disk: the port writes ./accessory_data_cache/<config>/data.h5
    and its ready mark; a second port dataset and the JAX one read it; all
    three give the items of the uncached dataset."""
    cfg = _image_data(tmp_path)
    monkeypatch.chdir(tmp_path)
    kw = dict(max_words=160, image_words=40, tokenizer=ByteTok(),
              transform=transform.get_transform("resized_center_crop", 224))
    plain = FinetuneDataset(cfg, **kw)
    cached = FinetuneDataset(cfg, cache_on_disk=True, **kw)
    ident = cfg
    for ch in "/\\.?!":
        ident = ident.replace(ch, "-")
    assert (tmp_path / "accessory_data_cache" / ident / "ready").exists()
    again = FinetuneDataset(cfg, cache_on_disk=True, **kw)
    jkw = dict(kw, transform=jtransform.get_transform("resized_center_crop", 224))
    jcached = JDataset(cfg, cache_on_disk=True, **jkw)
    for ds in (cached, again, jcached):
        _same_items(plain, ds)


def test_missing_packages_are_named(tmp_path, monkeypatch):
    """Without pandas, h5py or PIL the call that needs it raises an
    ImportError naming the package (no fallback)."""
    cfg_csv = tmp_path / "c.yaml"
    cfg_csv.write_text(f"META:\n  - path: {tmp_path / 'a.csv'}\n    type: text\n")
    cfg_mm = _image_data(tmp_path)
    monkeypatch.chdir(tmp_path)
    for mod, call in (("pandas", lambda: FinetuneDataset(str(cfg_csv), tokenizer=ByteTok())),
                      ("h5py", lambda: FinetuneDataset(cfg_mm, tokenizer=ByteTok(),
                                                       cache_on_disk=True)),
                      ("PIL", lambda: FinetuneDataset(cfg_mm, tokenizer=ByteTok())[0])):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, mod, None)
            with pytest.raises(ImportError, match=mod):
                call()


def test_collate_stacks_images_as_the_jax_loop(tmp_path):
    """main_finetune.collate of a step's items: examples, labels and images
    stacked, as the JAX main_finetune's batches stack the same items; a
    text-only step has no "images"."""
    cfg = _image_data(tmp_path)
    kw = dict(max_words=160, image_words=40, tokenizer=ByteTok(),
              transform=transform.get_transform("resized_center_crop", 224))
    ds = FinetuneDataset(cfg, **kw)
    img_ids, text_ids = ds.groups()
    batch = main_finetune.collate([ds[i] for i in img_ids[:4]])
    jitems = [JDataset(cfg, **dict(kw, transform=jtransform.get_transform(
        "resized_center_crop", 224)))[i] for i in img_ids[:4]]
    for key, k in (("examples", 0), ("labels", 1), ("images", 3)):
        np.testing.assert_array_equal(batch[key], np.stack([it[k] for it in jitems]))
    assert sorted(main_finetune.collate([ds[i] for i in text_ids[:2]])) == ["examples", "labels"]


def test_every_jax_llama_type_resolves():
    """Every llama_type of the JAX ARGS_REGISTRY has the same args class name
    in the port's registry and a model module there."""
    assert sorted(ARGS_REGISTRY) == sorted(JREGISTRY)
    for t, cls in JREGISTRY.items():
        assert ARGS_REGISTRY[t].__name__ == cls.__name__, t
        assert get_model_module(t).__name__.startswith("accessory_tpu_torch.models."), t


@pytest.mark.parametrize("name", ["llama_adapter.init_params", "llama_adapter.init_kv_cache",
                                  "llama_adapter._init_visual", "sphinx_moe.init_params",
                                  "sphinx_moe.init_kv_cache", "sphinx_moe.init_paged_cache",
                                  "sphinx.init_visual"])
def test_new_entry_points_default_to_cuda(name):
    """The slice's entry points take device="cuda" by default (only tests
    pass "cpu"), as tests/test_torch_hygiene.py holds for the others."""
    import importlib
    import inspect

    mod, fn = name.split(".")
    obj = getattr(importlib.import_module(f"accessory_tpu_torch.models.{mod}"), fn)
    assert inspect.signature(obj).parameters["device"].default == "cuda"


def test_c13_main_finetune_stacks_untransformed_pixels(tmp_path):
    """ROADMAP C13 pinned: main_finetune builds its dataset without a
    transform in both packages, so an image item is the file's RGB pixels,
    (H, W, 3) uint8, the same in both, and collate stacks them as the JAX
    loop does: (b, H, W, 3), which no model's forward takes."""
    cfg = _image_data(tmp_path)
    kw = dict(max_words=160, image_words=40, tokenizer=ByteTok())
    ds, jds = FinetuneDataset(cfg, **kw), JDataset(cfg, **kw)
    ids = ds.groups()[0][:2]
    for i in ids:
        got, want = ds[i][3], jds[i][3]
        assert got.shape == (30, 40, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert main_finetune.collate([ds[i] for i in ids])["images"].shape == (2, 30, 40, 3)
