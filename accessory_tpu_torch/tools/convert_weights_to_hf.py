"""Export a LLaMA checkpoint to the HuggingFace format, and import one back.

Port of ``accessory_tpu/tools/convert_weights_to_hf.py`` (reference
accessory/tools/convert_weights_to_hf.py). Native checkpoints are unsharded,
so this is a renaming / transposing pass over numpy arrays, read and written
with the port's numpy safetensors container (no ``safetensors``, no torch):

  our (in, out) stacked layers -> HF (out, in) per-layer names;
  tok_embeddings -> model.embed_tokens; wq/wk/wv/wo ->
  model.layers.N.self_attn.{q,k,v,o}_proj; w1/w3/w2 -> mlp.{gate,up,down}_proj;
  norm -> model.norm; output -> lm_head.

HF stores q/k rows in the rotated-half RoPE layout where the reference uses
interleaved pairs; the rows are permuted as the reference converter does
(interleave -> half split), and back on import. Arrays go out as f32 (bf16
leaves widened exactly). The export takes a dense checkpoint, as the
reference's does.

Run: python -m accessory_tpu_torch.tools.convert_weights_to_hf --src ckpt/ --dst hf/
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from pathlib import Path

import numpy as np


def get_args_parser():
    p = argparse.ArgumentParser("convert to HF", add_help=False)
    p.add_argument("--src", required=True, type=str, help="native checkpoint dir")
    p.add_argument("--dst", required=True, type=str)
    return p


def _permute_rope(w_out_in: np.ndarray, n_heads: int) -> np.ndarray:
    """Reorder rows from interleaved (x0, x1 pairs) to HF's half-split layout.

    w: (n_heads * hd, in). Row k of head h holds rotary dim k: interleaved
    pairs (2i, 2i+1) map to HF positions (i, i + hd/2)."""
    out_dim, in_dim = w_out_in.shape
    hd = out_dim // n_heads
    w = w_out_in.reshape(n_heads, hd // 2, 2, in_dim)
    w = np.concatenate([w[:, :, 0], w[:, :, 1]], axis=1)  # (h, hd, in)
    return w.reshape(out_dim, in_dim)


def _unpermute_rope(w_out_in: np.ndarray, n_heads: int) -> np.ndarray:
    """Inverse of _permute_rope: HF half-split rows -> interleaved pairs."""
    out_dim, in_dim = w_out_in.shape
    hd = out_dim // n_heads
    w = w_out_in.reshape(n_heads, 2, hd // 2, in_dim)
    w = np.stack([w[:, 0], w[:, 1]], axis=2)  # (h, hd/2, 2, in)
    return w.reshape(out_dim, in_dim)


def _T(a) -> np.ndarray:
    from accessory_tpu_torch.convert import _f32

    return np.ascontiguousarray(_f32(a).T)


def convert_to_hf(src: str, dst: str) -> None:
    from accessory_tpu_torch.checkpoint.native import read_checkpoint_tree, write_safetensors
    from accessory_tpu_torch.convert import _f32

    params = read_checkpoint_tree(src)
    cfg = json.loads((Path(src) / "config.json").read_text()) \
        if (Path(src) / "config.json").exists() else {}
    n_heads = cfg.get("n_heads", 32)
    n_kv = cfg.get("n_kv_heads") or n_heads

    sd = {"model.embed_tokens.weight": _f32(params["tok_embeddings"]["weight"]),
          "model.norm.weight": _f32(params["norm"]["weight"]),
          "lm_head.weight": _T(params["output"]["weight"])}
    lay = params["layers"]
    L = lay["attention_norm"]["weight"].shape[0]
    att, ff = lay["attention"], lay["feed_forward"]
    for i in range(L):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = _f32(lay["attention_norm"]["weight"][i])
        sd[pre + "post_attention_layernorm.weight"] = _f32(lay["ffn_norm"]["weight"][i])
        sd[pre + "self_attn.q_proj.weight"] = _permute_rope(_T(att["wq"]["weight"][i]), n_heads)
        sd[pre + "self_attn.k_proj.weight"] = _permute_rope(_T(att["wk"]["weight"][i]), n_kv)
        sd[pre + "self_attn.v_proj.weight"] = _T(att["wv"]["weight"][i])
        sd[pre + "self_attn.o_proj.weight"] = _T(att["wo"]["weight"][i])
        sd[pre + "mlp.gate_proj.weight"] = _T(ff["w1"]["weight"][i])
        sd[pre + "mlp.down_proj.weight"] = _T(ff["w2"]["weight"][i])
        sd[pre + "mlp.up_proj.weight"] = _T(ff["w3"]["weight"][i])

    os.makedirs(dst, exist_ok=True)
    write_safetensors(str(Path(dst) / "model.safetensors"), sd)

    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "hidden_size": cfg.get("dim", 4096),
        "num_hidden_layers": cfg.get("n_layers", L),
        "num_attention_heads": n_heads,
        "num_key_value_heads": n_kv,
        "intermediate_size": int(ff["w1"]["weight"].shape[-1]),
        "vocab_size": int(params["tok_embeddings"]["weight"].shape[0]),
        "rms_norm_eps": cfg.get("norm_eps", 1e-5),
        "rope_theta": cfg.get("rope_theta", 10000.0),
        "max_position_embeddings": cfg.get("max_seq_len", 2048),
        "torch_dtype": "float32",
    }
    (Path(dst) / "config.json").write_text(json.dumps(hf_cfg, indent=2))
    for tok_file in ("tokenizer.json", "tokenizer_config.json", "tokenizer.model"):
        srcf = Path(src) / tok_file
        if srcf.exists():
            (Path(dst) / tok_file).write_bytes(srcf.read_bytes())


def convert_hf_to_ours(src: str, n_heads: int, n_kv_heads=None):
    """A HF LLaMA checkpoint dir (model*.safetensors, f32) -> the flat param
    dict of the native format ("/"-joined keys, stacked layers, (in, out)
    layout): the inverse of convert_to_hf."""
    from accessory_tpu_torch.checkpoint.native import read_safetensors

    sd = {}
    for f in sorted(glob.glob(os.path.join(src, "*.safetensors"))):
        sd.update(read_safetensors(f))
    n_kv = n_kv_heads or n_heads

    out = {"tok_embeddings/weight": np.array(sd["model.embed_tokens.weight"]),
           "norm/weight": np.array(sd["model.norm.weight"]),
           "output/weight": _T(sd["lm_head.weight"])}
    ids = sorted({int(m.group(1)) for k in sd if (m := re.match(r"model\.layers\.(\d+)\.", k))})

    def stack(fmt, transform=None):
        return np.stack([(transform(np.asarray(sd[fmt.format(i)])) if transform
                          else np.asarray(sd[fmt.format(i)])) for i in ids])

    Lf = "model.layers.{}."
    out["layers/attention_norm/weight"] = stack(Lf + "input_layernorm.weight")
    out["layers/ffn_norm/weight"] = stack(Lf + "post_attention_layernorm.weight")
    out["layers/attention/wq/weight"] = stack(
        Lf + "self_attn.q_proj.weight",
        lambda w: _T(_unpermute_rope(np.asarray(w, np.float32), n_heads)))
    out["layers/attention/wk/weight"] = stack(
        Lf + "self_attn.k_proj.weight",
        lambda w: _T(_unpermute_rope(np.asarray(w, np.float32), n_kv)))
    out["layers/attention/wv/weight"] = stack(Lf + "self_attn.v_proj.weight", _T)
    out["layers/attention/wo/weight"] = stack(Lf + "self_attn.o_proj.weight", _T)
    out["layers/feed_forward/w1/weight"] = stack(Lf + "mlp.gate_proj.weight", _T)
    out["layers/feed_forward/w2/weight"] = stack(Lf + "mlp.down_proj.weight", _T)
    out["layers/feed_forward/w3/weight"] = stack(Lf + "mlp.up_proj.weight", _T)
    return out


if __name__ == "__main__":
    a = get_args_parser().parse_args()
    convert_to_hf(a.src, a.dst)
