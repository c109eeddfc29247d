"""Port parity, the import of the reference's PyTorch checkpoints
(``checkpoint/torch_import.py`` and its use in ``checkpoint/native.py``)
against the JAX package's ``accessory_tpu/checkpoint/torch_import.py``.
Each family's state dict (LLaMA, InternLM, Falcon in both block layouts,
Mixtral with one leaf an expert and with the sparse fused layout; bf16, in
the reference's names and (out, in) orientation) is split into shards by
the tensor-parallel dim table and written with ``torch.save`` in
``tmp_path`` as ``meta_ori`` (two ``consolidated.NN.pth``), ``consolidated``
at mp 2 (the keys under ``llma.`` in a ``{"model": ...}`` dict) and
``consolidated_diff``. The port's merge rules, format inference and
``import_reference_checkpoint`` are held bit for bit to the JAX package's,
except where the JAX package merges InternLM's MLP with LLaMA's roles
(ROADMAP C9, pinned here); ``from_pretrained`` of such directories, base
and diff, to the JAX ``MetaModel``'s leaves bit for bit and its greedy
text. CPU only.
"""

import json
import re
import shutil
import warnings

import numpy as np
import pytest
import torch

from accessory_tpu.checkpoint import load_checkpoint_list as jload_checkpoint_list
from accessory_tpu.checkpoint import torch_import as jti
from accessory_tpu.meta import MetaModel as JMetaModel
from accessory_tpu.tokenizer import Tokenizer as JTokenizer

from accessory_tpu_torch.checkpoint import load_checkpoint_list, torch_import as tti
from accessory_tpu_torch.config import ARGS_REGISTRY
from accessory_tpu_torch.convert import BF16Bits, params_to_jax
from accessory_tpu_torch.meta import MetaModel

from test_torch_generate import tok_path  # noqa: F401  (fixture)

D, H, L, E, HEADS = 64, 128, 2, 4, 4
FAMILIES = ["llama", "internlm", "falcon", "falcon_mqa", "mixtral", "mixtral_sparse"]
CONFIGS = {"llama": dict(dim=D, n_layers=L, n_heads=HEADS, n_kv_heads=2, multiple_of=128,
                         ffn_dim_multiplier=0.753),
           "internlm": dict(num_layers=L, hidden_size=D, num_attention_heads=HEADS,
                            multiple_of=128, mlp_ratio=2.0),
           "falcon": dict(num_layers=L, hidden_size=D, num_attention_heads=HEADS,
                          num_kv_heads=2, bias=True)}


def _state_dict(family: str, vocab: int, seed: int = 0):
    """A reference state dict of ``family`` (bf16, torch (out, in))."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g) * 0.2).to(torch.bfloat16)

    def one(n):
        return (1 + 0.1 * torch.randn(n, generator=g)).to(torch.bfloat16)

    kv = 2 * D // HEADS
    sd = {}
    for i in range(L):
        p = f"layers.{i}."
        if family == "internlm":
            sd.update({p + "norm1.weight": one(D), p + "norm2.weight": one(D),
                       p + "mixer.Wqkv.weight": w(3 * D, D), p + "mixer.Wqkv.bias": w(3 * D),
                       p + "mixer.out_proj.weight": w(D, D), p + "mixer.out_proj.bias": w(D),
                       p + "mlp.w1.weight": w(H, D), p + "mlp.w2.weight": w(H, D),
                       p + "mlp.w3.weight": w(D, H)})
            continue
        if family.startswith("falcon"):
            mqa = family == "falcon_mqa"
            att = p + "self_attention."
            nkv = D // HEADS if mqa else kv
            sd.update({att + "wq.weight": w(D, D), att + "wk.weight": w(nkv, D),
                       att + "wv.weight": w(nkv, D),
                       att + "dense.weight": w(D, D), p + "mlp.dense_h_to_4h.weight": w(4 * D, D),
                       p + "mlp.dense_4h_to_h.weight": w(D, 4 * D)})
            lns = ("input_layernorm",) if mqa else ("ln_attn", "ln_mlp")
            for ln in lns:
                sd.update({p + ln + ".weight": one(D), p + ln + ".bias": w(D)})
            if not mqa:
                for name, n in (("wq", D), ("wk", kv), ("wv", kv), ("dense", D)):
                    sd[att + name + ".bias"] = w(n)
                sd[p + "mlp.dense_h_to_4h.bias"] = w(4 * D)
                sd[p + "mlp.dense_4h_to_h.bias"] = w(D)
            continue
        sd.update({p + "attention_norm.weight": one(D), p + "ffn_norm.weight": one(D),
                   p + "attention.wq.weight": w(D, D), p + "attention.wk.weight": w(kv, D),
                   p + "attention.wv.weight": w(kv, D), p + "attention.wo.weight": w(D, D)})
        ff = p + "feed_forward."
        if family == "llama":
            sd.update({ff + "w1.weight": w(H, D), ff + "w2.weight": w(D, H),
                       ff + "w3.weight": w(H, D)})
        elif family == "mixtral":
            sd[ff + "gate.weight"] = w(E, D)
            for e in range(E):
                sd.update({ff + f"experts.{e}.w1.weight": w(H, D),
                           ff + f"experts.{e}.w2.weight": w(D, H),
                           ff + f"experts.{e}.w3.weight": w(H, D)})
        else:
            sd.update({ff + "gate.weight": w(E, D), ff + "w1": w(E * H, D), ff + "w2": w(E * H, D),
                       ff + "w3": w(E * H, D)})
    if family.startswith(("internlm", "falcon")):
        sd["word_embeddings.weight"] = w(vocab, D)
    else:
        sd["tok_embeddings.weight"] = w(vocab, D)
    if family.startswith("falcon"):
        sd.update({"ln_f.weight": one(D), "ln_f.bias": w(D)})
    else:
        sd["norm.weight"] = one(D)
    sd["output.weight"] = w(vocab, D)
    return sd


def _split(sd, family, mp):
    """The shards a tensor-parallel save of ``sd`` at ``mp`` holds (whole
    experts distributed, everything else by the dim table)."""
    family = family.split("_mqa")[0]
    shards = [{} for _ in range(mp)]
    for name, t in sd.items():
        if family == "mixtral" and ".experts." in name:
            shards[int(re.search(r"experts\.(\d+)\.", name).group(1)) % mp][name] = t
            continue
        rule, dim = tti._merge_rule(name, family)
        if rule == "rep":
            parts = [t.clone() for _ in range(mp)]
        elif rule == "moe_fused":
            parts = [c.reshape(-1, t.shape[-1]) for c in t.view(E, -1, t.shape[-1]).chunk(mp, 1)]
        else:
            parts = t.chunk(mp, dim)
        for shard, part in zip(shards, parts):
            shard[name] = part.clone()   # torch.save writes a view's whole storage
    return shards


def _write(path, sd, family, fmt, mp):
    """Write ``sd`` as the ``fmt`` files of an mp-``mp`` save."""
    path.mkdir(parents=True, exist_ok=True)
    for r, shard in enumerate(_split(sd, family, mp)):
        if fmt == "meta_ori":
            torch.save(shard, path / f"consolidated.{r:02d}.pth")
        else:
            tail = "model-diff" if fmt == "consolidated_diff" else "model"
            torch.save({"model": {"llma." + k: v for k, v in shard.items()}},
                       path / f"consolidated.{r:02d}-of-{mp:02d}.{tail}.pth")
    return str(path)


def _equal_flat(got, want):
    assert set(got) == set(want) and len(got) > 5
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("family", FAMILIES)
def test_merge_rules_and_detection(family):
    """Every name of each family merges by the JAX package's rule (InternLM's
    mlp.w2 / mlp.w3 excepted: C9) and the family is detected alike; the
    format inference agrees on every file layout and refuses an empty dir
    and a missing shard."""
    fam = family.split("_mqa")[0]
    sd = _state_dict(family, 96)
    for name in sd:
        want = jti._merge_rule(name, fam)
        if fam == "internlm" and name.endswith((".mlp.w2.weight", ".mlp.w3.weight")):
            want = ("cat", 0 if name.endswith("w2.weight") else 1)
        assert tti._merge_rule(name, fam) == want, name
    assert tti.detect_llama_type(sd) == jti.detect_llama_type(sd) == fam


def test_format_inference(tmp_path):
    sd = _state_dict("llama", 96)
    for fmt, mp in (("meta_ori", 2), ("consolidated", 2), ("consolidated_diff", 1)):
        path = _write(tmp_path / fmt, sd, "llama", fmt, mp)
        assert tti.infer_checkpoint_format_and_mp_size(path) == \
            jti.infer_checkpoint_format_and_mp_size(path) == (fmt, mp)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tti.infer_checkpoint_format_and_mp_size(str(tmp_path / "empty"))
    (tmp_path / "consolidated" / "consolidated.01-of-02.model.pth").unlink()
    with pytest.raises(ValueError, match="expect 2 shards"):
        tti.infer_checkpoint_format_and_mp_size(str(tmp_path / "consolidated"))


@pytest.mark.parametrize("fmt", ["meta_ori", "consolidated", "consolidated_diff"])
@pytest.mark.parametrize("family", FAMILIES)
def test_import_bit_equal_to_jax(tmp_path, family, fmt):
    """``import_reference_checkpoint`` (the family detected from the names)
    against the JAX package's on the same files: the same keys, dtypes,
    shapes and bits, and equal to the unsharded save's import. InternLM at
    mp 2: the port's equals the unsharded import, the JAX package's MLP
    comes out in LLaMA's shapes (C9)."""
    fam = family.split("_mqa")[0]
    sd = _state_dict(family, 96, seed=1)
    mp = 1 if fmt == "consolidated_diff" else 2
    got = tti.import_reference_checkpoint(_write(tmp_path / "a", sd, fam, fmt, mp))
    whole = tti.import_reference_checkpoint(_write(tmp_path / "b", sd, fam, "meta_ori", 1))
    _equal_flat(got, whole)
    _equal_flat(whole, jti.import_reference_checkpoint(str(tmp_path / "b")))
    want = jti.import_reference_checkpoint(str(tmp_path / "a"))
    if fam == "internlm" and mp == 2:
        assert want["layers/mlp/w2/weight"].shape == (L, 2 * D, H // 2)
        assert got["layers/mlp/w2/weight"].shape == (L, D, H)
        want = {k: v for k, v in want.items() if not k.startswith(("layers/mlp/w2",
                                                                  "layers/mlp/w3"))}
        got = {k: v for k, v in got.items() if k in want}
    _equal_flat(got, want)
    assert all(v.dtype == np.float32 for v in got.values())


def test_replicated_mismatch_warns(tmp_path):
    """A replicated parameter that differs across the shards is taken from
    shard 0 with a warning, as in the JAX package."""
    sd = _state_dict("llama", 96)
    path = tmp_path / "ckpt"
    path.mkdir()
    shards = _split(sd, "llama", 2)
    shards[1]["norm.weight"] = shards[1]["norm.weight"] + 1
    for r, shard in enumerate(shards):
        torch.save(shard, path / f"consolidated.{r:02d}.pth")
    with pytest.warns(UserWarning, match="norm.weight"):
        got = tti.load_torch_checkpoint(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jti.load_torch_checkpoint(str(path))
    _equal_flat(got, want)
    assert np.array_equal(got["norm.weight"], sd["norm.weight"].float().numpy())


def _port_leaves(params):
    """The port's params as the JAX package's flat numpy leaves (bf16 raw bits
    as uint16)."""
    out = {}

    def visit(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{prefix}/{k}" if prefix else k)
        else:
            out[prefix] = node.bits if isinstance(node, BF16Bits) else np.asarray(node)

    visit(params_to_jax(params), "")
    return out


def _jax_leaves(tree):
    out = {}

    def visit(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{prefix}/{k}" if prefix else k)
        else:
            a = np.asarray(node)
            out[prefix] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    visit(tree, "")
    return out


@pytest.mark.parametrize("family", ["llama", "internlm", "falcon"])
def test_from_pretrained_consolidated_and_diff(tmp_path, tok_path, family):  # noqa: F811
    """A base directory (``consolidated`` at mp 2; InternLM ``meta_ori`` at mp
    1, which the JAX package merges right) and a ``consolidated_diff``
    directory of deltas to every weight (the converter takes whole layers):
    the port's
    ``load_checkpoint_list([base, diff], dtype="bfloat16")`` against the JAX
    package's, every leaf bit for bit (the deltas added in f32, the sums
    rounded to bf16); then ``MetaModel.from_pretrained`` of the base in f32
    against the JAX MetaModel's, identical greedy text."""
    vocab = JTokenizer(tok_path).n_words
    sd = _state_dict(family, vocab, seed=2)
    fmt, mp = ("meta_ori", 1) if family == "internlm" else ("consolidated", 2)
    base = _write(tmp_path / "base", sd, family, fmt, mp)
    (tmp_path / "base" / "config.json").write_text(json.dumps(CONFIGS[family]))
    (tmp_path / "base" / "meta.json").write_text(json.dumps({"llama_type": family}))
    shutil.copy(tok_path, tmp_path / "base" / "tokenizer.json")
    g = torch.Generator().manual_seed(3)
    delta = {k: (torch.randn(v.shape, generator=g) * 0.01).to(torch.bfloat16)
             for k, v in sd.items()}
    diff = _write(tmp_path / "diff", delta, family, "consolidated_diff", 1)
    args = ARGS_REGISTRY[family](**CONFIGS[family], vocab_size=vocab)
    got = _port_leaves(load_checkpoint_list([base, diff], dtype="bfloat16", args=args,
                                            device="cpu"))
    want = _jax_leaves(jload_checkpoint_list([base, diff], dtype="bfloat16"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    head = "output/weight"
    assert not np.array_equal(got[head], _port_leaves(load_checkpoint_list(
        [base], dtype="bfloat16", args=args, device="cpu"))[head])
    tm = MetaModel.from_pretrained(base, max_seq_len=64, dtype="float32", device="cpu")
    jm = JMetaModel.from_pretrained(base, max_seq_len=64, dtype="float32")
    prompts = ["the quick brown fox", "hi"]
    assert tm.generate(prompts, max_gen_len=8) == jm.generate(prompts, max_gen_len=8)
