"""Port parity, SPHINX's visual towers and their inputs: ``vit_forward`` in
the CLIP and the DINOv2 style, ``convnext_forward`` and ``qformer_forward``
against the JAX package's at small widths; ``resize_linear`` against
``jax.image.resize(..., "linear")`` shrinking and growing; the
``visual_import`` converters against the JAX package's on state dicts of
small random transformers models (and the port's towers against those
models' outputs); the image transforms and the image reader against the
JAX package's on a PIL image.

Every tree is drawn once with numpy from a seed (the port's init, then each
leaf moved off its init value so that LayerScale, the ConvNeXt layer scale
and every bias matter) and given to both packages. Both sides compute in
f32 and differ only in summation order: outputs are held to 1e-4 (relative
and absolute) against JAX, to 2e-4 against transformers (the JAX package's
own tolerance there), and converted leaves and transforms bit for bit.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint import visual_import as jvi
from accessory_tpu.data import data_reader as jreader
from accessory_tpu.data import transform as jtransform
from accessory_tpu.models import visual as jv

from accessory_tpu_torch.checkpoint import visual_import as tvi
from accessory_tpu_torch.data import data_reader as treader
from accessory_tpu_torch.data import transform as ttransform
from accessory_tpu_torch.models import visual as tv

from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)

TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=2e-4, atol=2e-4)


def to_numpy(node):
    if isinstance(node, dict):
        return {k: to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy(v) for v in node]
    return node.numpy() if isinstance(node, torch.Tensor) else np.asarray(node)


def to_torch(node):
    if isinstance(node, dict):
        return {k: to_torch(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_torch(v) for v in node]
    return torch.from_numpy(np.array(node))


def to_jax(node):
    if isinstance(node, dict):
        return {k: to_jax(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_jax(v) for v in node]
    return jnp.asarray(node)


def perturbed(tree, seed: int, scale: float = 0.05):
    """Each f32 leaf plus seeded normal noise of ``scale``."""
    rng = np.random.RandomState(seed)

    def f(node):
        if isinstance(node, dict):
            return {k: f(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f(v) for v in node]
        return (node + scale * rng.randn(*node.shape)).astype(np.float32)

    return f(to_numpy(tree))


VIT = {"clip": dict(image_size=56, patch_size=14, width=32, layers=2, heads=4),
       "dinov2": dict(image_size=56, patch_size=14, width=48, layers=2, heads=4, act="gelu",
                      ln_pre=False, layerscale=True, ffn="swiglu", norm_eps=1e-6,
                      patch_bias=True)}


@pytest.mark.parametrize("style", sorted(VIT))
def test_vit_forward(style):
    """The CLIP style (QuickGELU, ln_pre, eps 1e-5) and the DINOv2 style
    (LayerScale, SwiGLU, patch bias, no pre-LN, eps 1e-6) against JAX."""
    tcfg, jcfg = tv.ViTConfig(**VIT[style]), jv.ViTConfig(**VIT[style])
    assert tcfg.ffn_hidden == jcfg.ffn_hidden and tcfg.n_tokens == jcfg.n_tokens == 17
    params = perturbed(tv.init_vit(tcfg, seed=1, device="cpu"), seed=2)
    imgs = np.random.RandomState(3).randn(2, 3, 56, 56).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jv.vit_forward(p, jcfg, x))(to_jax(params),
                                                                        jnp.asarray(imgs)))
    got = tv.vit_forward(to_torch(params), tcfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 17, tcfg.width)
    np.testing.assert_allclose(got, want, **TOL)


def test_convnext_forward():
    """Two stages (the 4 x 4 stem and a 2 x 2 downsampling), the depthwise
    7 x 7 as shifted multiply-adds against XLA's grouped convolution, the
    layer scale at ~1 instead of 1e-6."""
    cfg = dict(depths=(1, 2), dims=(8, 16))
    params = perturbed(tv.init_convnext(tv.ConvNeXtConfig(**cfg), seed=4, device="cpu"), seed=5)
    for stage in params["stages"]:
        stage["blocks"]["gamma"] += 1.0
    imgs = np.random.RandomState(6).randn(2, 3, 64, 64).astype(np.float32)
    jcfg = jv.ConvNeXtConfig(**cfg)
    want = np.asarray(jax.jit(lambda p, x: jv.convnext_forward(p, jcfg, x))(to_jax(params),
                                                                             jnp.asarray(imgs)))
    got = tv.convnext_forward(to_torch(params), tv.ConvNeXtConfig(**cfg),
                              torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (2, 64, 16)
    np.testing.assert_allclose(got, want, **TOL)


def test_qformer_forward():
    cfg = dict(n_queries=8, width=32, layers=2, heads=4, kv_dim=24)
    params = perturbed(tv.init_qformer(tv.QFormerConfig(**cfg), seed=7, device="cpu"), seed=8)
    feats = np.random.RandomState(9).randn(2, 17, 24).astype(np.float32)
    jcfg = jv.QFormerConfig(**cfg)
    want = np.asarray(jax.jit(lambda p, x: jv.qformer_forward(p, jcfg, x))(to_jax(params),
                                                                            jnp.asarray(feats)))
    got = tv.qformer_forward(to_torch(params), tv.QFormerConfig(**cfg),
                             torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, 8, 32)
    np.testing.assert_allclose(got, want, **TOL)


# the 448 -> 224 global view, the 224 -> 256 ConvNeXt input, the ens5p2 2x
# pooling of a 16 x 16 patch grid, and an odd growth
RESIZES = {"shrink_448_224": ((2, 3, 448, 448), (224, 224)),
           "grow_224_256": ((2, 3, 224, 224), (256, 256)),
           "pool_16_8": ((2, 8, 16, 16), (8, 8)),
           "grow_7_13": ((1, 2, 7, 7), (13, 13))}


@pytest.mark.parametrize("case", sorted(RESIZES))
def test_resize_linear(case):
    """Antialiased where it shrinks, plain bilinear where it grows, as
    jax.image.resize's "linear" computes it: to 1e-6 (f32 rounding)."""
    shape, size = RESIZES[case]
    x = np.random.RandomState(10).randn(*shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape[:2] + size, "linear"))
    got = tv.resize_linear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- visual_import


def _hf_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _same_leaves(got, want):
    """Every leaf of the port's converted tree bit-equal to the JAX one's."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(to_numpy(got))[0])
    assert len(flat_g) == len(flat_w) > 5
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == np.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g, np.asarray(w))


def _clip():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    model = CLIPVisionModel(CLIPVisionConfig(hidden_size=64, intermediate_size=256,
                                             num_hidden_layers=2, num_attention_heads=4,
                                             image_size=56, patch_size=14)).eval()
    sd = {(k if k.startswith("vision_model.") else "vision_model." + k): v
          for k, v in _hf_state(model).items()}
    cfg = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4)

    def reference(x):
        out = model(x).last_hidden_state
        return model.vision_model.post_layernorm(out)   # post-LN on every token, as ours

    return sd, cfg, tvi.convert_hf_clip_vision, jvi.convert_hf_clip_vision, tv.vit_forward, \
        reference, (2, 3, 56, 56)


def _dinov2():
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(0)
    model = Dinov2Model(Dinov2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                     image_size=56, patch_size=14, use_swiglu_ffn=True,
                                     mlp_ratio=4)).eval()
    cfg = dict(image_size=56, patch_size=14, width=64, layers=2, heads=4, act="gelu",
               ln_pre=False, layerscale=True, ffn="swiglu", norm_eps=1e-6, patch_bias=True)
    return _hf_state(model), cfg, tvi.convert_hf_dinov2, jvi.convert_hf_dinov2, \
        tv.vit_forward, lambda x: model(x).last_hidden_state, (2, 3, 56, 56)


def _convnext(timm_names=False):
    from transformers import ConvNextConfig, ConvNextModel

    torch.manual_seed(0)
    model = ConvNextModel(ConvNextConfig(depths=[2, 2], hidden_sizes=[16, 32], num_stages=2,
                                         image_size=32)).eval()
    sd = _hf_state(model)
    if timm_names:   # the open_clip trunk's names for the same tensors
        inv = {v: k for k, v in tvi._TIMM_BLOCK.items()}
        out = {}
        for k, v in sd.items():
            parts = k.split(".")
            if k.startswith("embeddings.patch_embeddings."):
                out["visual.trunk.stem.0." + parts[-1]] = v
            elif k.startswith("embeddings.layernorm."):
                out["visual.trunk.stem.1." + parts[-1]] = v
            elif ".downsampling_layer." in k:
                out[f"visual.trunk.stages.{parts[2]}.downsample.{parts[4]}.{parts[5]}"] = v
            elif ".layers." in k:
                out[f"visual.trunk.stages.{parts[2]}.blocks.{parts[4]}."
                    + inv[".".join(parts[5:])]] = v
        sd = out

    def reference(x):
        out = model(x).last_hidden_state
        return out.permute(0, 2, 3, 1).reshape(out.shape[0], -1, out.shape[1])

    return sd, dict(depths=(2, 2), dims=(16, 32)), tvi.convert_convnext, jvi.convert_convnext, \
        tv.convnext_forward, reference, (2, 3, 32, 32)


def _qformer():
    from transformers import Blip2QFormerConfig, Blip2QFormerModel

    torch.manual_seed(0)
    model = Blip2QFormerModel(Blip2QFormerConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, encoder_hidden_size=48,
        cross_attention_frequency=1, intermediate_size=128)).eval()
    sd = _hf_state(model)
    queries = np.random.RandomState(0).randn(1, 8, 32).astype(np.float32) * 0.2
    sd["query_tokens"] = queries

    def reference(feats):
        return model(query_embeds=torch.from_numpy(queries).expand(feats.shape[0], -1, -1),
                     encoder_hidden_states=feats).last_hidden_state

    return sd, dict(n_queries=8, width=32, layers=2, heads=4, kv_dim=48), \
        tvi.convert_hf_blip2_qformer, jvi.convert_hf_blip2_qformer, tv.qformer_forward, \
        reference, (2, 5, 48)


CONVERTERS = {"clip": (_clip, tv.ViTConfig, jv.ViTConfig),
              "dinov2": (_dinov2, tv.ViTConfig, jv.ViTConfig),
              "convnext": (_convnext, tv.ConvNeXtConfig, jv.ConvNeXtConfig),
              "convnext_timm": (lambda: _convnext(True), tv.ConvNeXtConfig, jv.ConvNeXtConfig),
              "qformer": (_qformer, tv.QFormerConfig, jv.QFormerConfig)}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_visual_import_matches_jax(name):
    """Each converter on a small random transformers model's state dict (a
    ConvNeXt also in open_clip's trunk names): every converted leaf bit-equal
    to the JAX converter's, and the port's tower on it reproduces the
    transformers model's hidden states."""
    make, tcls, jcls = CONVERTERS[name]
    sd, cfg, tconv, jconv, forward, reference, in_shape = make()
    params = tconv(sd, tcls(**cfg), device="cpu")
    _same_leaves(params, jconv(sd, jcls(**cfg)))
    x = np.random.RandomState(1).randn(*in_shape).astype(np.float32)
    with torch.no_grad():
        want = reference(torch.from_numpy(x)).numpy()
        got = forward(params, tcls(**cfg), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)


# ---------------------------------------------------------------- image inputs


@pytest.fixture(scope="module")
def pil_image():
    from PIL import Image

    rng = np.random.RandomState(11)
    return Image.fromarray(rng.randint(0, 256, (200, 300, 3), dtype=np.uint8), "RGB")


@pytest.mark.parametrize("name", ["padded_resize", "resized_center_crop", "random_resized_crop"])
def test_transform_matches_jax(pil_image, name):
    """The same (3, 224, 224) f32 CLIP-normalized array, bit for bit (the
    random crop drawn from the same seeded random.Random)."""
    if name == "random_resized_crop":
        got = ttransform.random_resized_crop(pil_image, 224, rng=random.Random(3))
        want = jtransform.random_resized_crop(pil_image, 224, rng=random.Random(3))
    else:
        got = ttransform.get_transform(name, 224)(pil_image)
        want = jtransform.get_transform(name, 224)(pil_image)
    assert got.shape == (3, 224, 224) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_img_general(tmp_path, pil_image):
    """A file and an object-store path (through an injected client) read as
    the JAX package reads them; an s3:// path without a client raises."""
    path = tmp_path / "img.png"
    pil_image.save(path)
    np.testing.assert_array_equal(np.asarray(treader.read_img_general(str(path))),
                                  np.asarray(jreader.read_img_general(str(path))))

    class Client:
        def get(self, p):
            assert p == "s3://bucket/img.png"
            return path.read_bytes()

    with pytest.raises(RuntimeError, match="set_s3_client"):
        treader.read_img_general("s3://bucket/img.png")
    treader.set_s3_client(Client())
    try:
        got = treader.read_img_general("s3://bucket/img.png")
    finally:
        treader.set_s3_client(None)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(pil_image))
