"""Import the PyTorch checkpoints of the project this system was modelled on
(``consolidated.NN.pth`` "meta_ori", ``consolidated.NN-of-MM.model.pth``,
and ``consolidated.NN-of-MM.model-diff.pth`` deltas) as a flat dict of the
native checkpoint's keys.

Own copy of ``accessory_tpu/checkpoint/torch_import.py`` (numpy and torch
only). The shards of a tensor-parallel save merge to full weights by the
reference's dim table in torch's (out, in) orientation: column-parallel
weights and biases concatenate on dim 0, row-parallel weights on dim 1,
embeddings on dim 1, the rest are replicated (shard 0, with a warning where
the shards disagree); a fused sparse-MoE weight (E * H / mp, dim) a shard
merges expert by expert. The table goes by name, and InternLM names its MLP
w1 (gate), w2 (up), w3 (down): its w2 is column-parallel and its w3
row-parallel, the roles LLaMA's w3 and w2 have. The JAX package merges them
with LLaMA's roles, so an InternLM save at mp > 1 comes out in the wrong
shapes there (ROADMAP C9); here the family's shards are read first, its
type detected from their names, and its own rule applied.

``convert_state_dict`` maps the merged names of LLaMA, InternLM, Falcon and
Mixtral (one leaf an expert, or the sparse fused layout) to "/"-joined keys
with ``layers`` stacked on a leading axis and weights transposed to
(in, out), the arrays f32 where the shard held bf16 (exact).
``checkpoint.native.load_checkpoint_list`` turns that dict into the port's
per-layer params (a Mixtral layer's (E, in, out) experts stay a dense leaf
a layer until ``quantize`` makes them per-expert W4 weights).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_FILENAME_PATTERNS = {
    "meta_ori": re.compile(r"^consolidated\.(\d{2})\.pth$"),
    "consolidated": re.compile(r"^consolidated\.(\d{2})-of-(\d{2})\.model\.pth$"),
    "consolidated_diff": re.compile(r"^consolidated\.(\d{2})-of-(\d{2})\.model-diff\.pth$"),
}

# suffix -> merge behaviour in torch's (out, in) orientation: column-parallel
# weights / biases cat on dim 0, row-parallel weights on dim 1 (their bias is
# replicated), parallel embeddings on dim 1, anything else replicated
_COL_W = (".wq.weight", ".wk.weight", ".wv.weight", ".w1.weight", ".w3.weight",
          "output.weight", ".Wqkv.weight", ".dense_h_to_4h.weight", ".lora_b.weight")
_ROW_W = (".wo.weight", ".w2.weight", ".dense.weight", ".out_proj.weight",
          ".dense_4h_to_h.weight", ".lora_a.weight")
_COL_B = (".wq.bias", ".wk.bias", ".wv.bias", ".w1.bias", ".w3.bias", ".Wqkv.bias",
          ".dense_h_to_4h.bias")
_EMBED_W = ("tok_embeddings.weight", "word_embeddings.weight")


# InternLM's MLP: w2 is the up projection, w3 the down one
_INTERNLM_MLP = {".mlp.w2.weight": ("cat", 0), ".mlp.w3.weight": ("cat", 1)}


def _merge_rule(name: str, llama_type: str) -> Tuple[str, int]:
    """("cat", dim), ("rep", 0) or ("moe_fused", 0) for a parameter name."""
    if llama_type.startswith("internlm"):
        for suffix, rule in _INTERNLM_MLP.items():
            if name.endswith(suffix):
                return rule
    if llama_type.startswith("mixtral_sparse") and re.search(
            r"feed_forward\.w[123]$|feed_forward\.w[123]\.weight$|\.moe\.w[123]$", name):
        return ("moe_fused", 0)
    if llama_type.startswith("mixtral") and ".experts." in name:
        # whole experts are distributed, not sharded: union by name
        return ("rep", 0)
    if name.endswith(_EMBED_W):
        return ("cat", 1)
    if name.endswith(_COL_W) or name.endswith(_COL_B):
        return ("cat", 0)
    if name.endswith(_ROW_W):
        return ("cat", 1)
    return ("rep", 0)


def infer_checkpoint_format_and_mp_size(path: str) -> Tuple[str, int]:
    """The format of a checkpoint dir and its model-parallel size, from its
    file names."""
    files = [f.name for f in Path(path).iterdir() if f.is_file()]
    for fmt, pat in FORMAT_FILENAME_PATTERNS.items():
        matches = [m for m in (pat.match(f) for f in files) if m]
        if matches:
            if fmt == "meta_ori":
                return fmt, len(matches)
            mp = int(matches[0].group(2))
            if len(matches) != mp:
                raise ValueError(f"expect {mp} shards, found {len(matches)} in {path}")
            return fmt, mp
    raise FileNotFoundError(f"no recognized checkpoint files under {path}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()  # exact
    return t.numpy()


def _strip(k: str) -> str:
    for prefix in ("llma.", "model.", "module."):
        if k.startswith(prefix):
            return k[len(prefix):]
    return k


def _guess_num_experts(shards, name: str) -> int:
    # the router's (E, dim) weight lives next to the fused expert weights
    gate_name = (name.rsplit(".", 2)[0] + ".gate.weight" if ".weight" in name
                 else name.rsplit(".", 1)[0] + ".gate.weight")
    for sh in shards:
        if gate_name in sh:
            return sh[gate_name].shape[0]
    return 8  # Mixtral's


def _load_shards(path: str) -> List[Dict[str, Any]]:
    """Every shard of a checkpoint dir in order, {stripped name: tensor}."""
    fmt, _ = infer_checkpoint_format_and_mp_size(path)
    pat = FORMAT_FILENAME_PATTERNS[fmt]
    shards = []
    for f in sorted(f for f in Path(path).iterdir() if f.is_file() and pat.match(f.name)):
        sd = torch.load(str(f), map_location="cpu", weights_only=True)
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
        shards.append({_strip(k): v for k, v in sd.items()})
    return shards


def _merge(shards: List[Dict[str, Any]], llama_type: str) -> Dict[str, np.ndarray]:
    all_keys: List[str] = []
    for sh in shards:
        all_keys += [k for k in sh if k not in all_keys]
    merged: Dict[str, np.ndarray] = {}
    for name in all_keys:
        present = [sh[name] for sh in shards if name in sh]
        rule, dim = _merge_rule(name, llama_type)
        if len(present) == 1 or rule == "rep":
            ref0 = present[0].float() if len(present) > 1 else None
            for other in present[1:]:
                # replicated params must agree across the shards
                diff = float((other.float() - ref0).abs().max())
                if diff > 1e-6:
                    warnings.warn(f"replicated param {name!r} differs across TP shards "
                                  f"(max abs diff {diff:.3e})")
                    break
            merged[name] = _to_numpy(present[0])
        elif rule == "moe_fused":
            n_experts = _guess_num_experts(shards, name)
            views = [w.view(n_experts, -1, w.shape[-1]) for w in present]
            merged[name] = _to_numpy(torch.cat(views, dim=1).reshape(-1, views[0].shape[-1]))
        else:
            merged[name] = _to_numpy(torch.cat(present, dim=dim))
    return merged


def load_torch_checkpoint(path: str, llama_type: str = "llama") -> Dict[str, np.ndarray]:
    """All shards of a checkpoint dir merged to full weights by
    ``llama_type``'s rules: {reference name: array}, the "llma." / "model."
    / "module." prefixes stripped."""
    return _merge(_load_shards(path), llama_type)


def detect_llama_type(keys) -> str:
    """The model family from a state dict's key names."""
    keys = list(keys)
    if any(".mixer.Wqkv." in k for k in keys):
        return "internlm"
    if any(".self_attention." in k for k in keys):
        return "falcon"
    if any(".feed_forward.experts." in k for k in keys):
        return "mixtral"
    if any(re.search(r"\.feed_forward\.w[123]$", k) for k in keys):
        return "mixtral_sparse"
    return "llama"


def import_reference_checkpoint(path: str, llama_type: Optional[str] = None,
                                n_layers: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A checkpoint dir as the native checkpoint's flat dict ("/"-joined
    keys, stacked layers, (in, out) weights). ``llama_type`` None: the
    family is detected from the shards' key names before they merge."""
    shards = _load_shards(path)
    if llama_type is None:
        llama_type = detect_llama_type(k for sh in shards for k in sh)
    return convert_state_dict(_merge(shards, llama_type), llama_type, n_layers=n_layers)


def _layer_ids(sd: Dict[str, np.ndarray]) -> List[int]:
    ids = set()
    for k in sd:
        m = re.match(r"layers\.(\d+)\.", k)
        if m:
            ids.add(int(m.group(1)))
    return sorted(ids)


def _stack(sd, template: str, ids, transform=None) -> np.ndarray:
    return np.stack([transform(sd[template.format(i)]) if transform else sd[template.format(i)]
                     for i in ids])


def _T(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def convert_state_dict(sd: Dict[str, np.ndarray], llama_type: str,
                       n_layers: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Merged reference names -> the native flat keys, for llama(_peft),
    internlm, falcon, mixtral and mixtral_sparse naming."""
    ids = _layer_ids(sd)
    if n_layers is not None and len(ids) not in (0, n_layers):
        raise ValueError(f"{len(ids)} layers in the checkpoint, expected {n_layers}")
    out: Dict[str, np.ndarray] = {}
    L = "layers.{}."
    family = llama_type.split("_")[0]
    if family == "llama" or llama_type.startswith("mixtral"):
        if "tok_embeddings.weight" in sd:
            out["tok_embeddings/weight"] = sd["tok_embeddings.weight"]
        if "norm.weight" in sd:
            out["norm/weight"] = sd["norm.weight"]
        if "output.weight" in sd:
            out["output/weight"] = _T(sd["output.weight"])
        if ids:
            out["layers/attention_norm/weight"] = _stack(sd, L + "attention_norm.weight", ids)
            out["layers/ffn_norm/weight"] = _stack(sd, L + "ffn_norm.weight", ids)
            for w in ("wq", "wk", "wv", "wo"):
                out[f"layers/attention/{w}/weight"] = _stack(sd, L + f"attention.{w}.weight",
                                                             ids, _T)
            if llama_type.startswith("mixtral"):
                _convert_moe(sd, ids, out, fused="sparse" in llama_type)
            else:
                for w in ("w1", "w2", "w3"):
                    out[f"layers/feed_forward/{w}/weight"] = _stack(
                        sd, L + f"feed_forward.{w}.weight", ids, _T)
    elif family == "internlm":
        if "word_embeddings.weight" in sd:
            out["word_embeddings/weight"] = sd["word_embeddings.weight"]
        if "norm.weight" in sd:
            out["norm/weight"] = sd["norm.weight"]
        if "output.weight" in sd:
            out["output/weight"] = _T(sd["output.weight"])
        if ids:
            out["layers/norm1/weight"] = _stack(sd, L + "norm1.weight", ids)
            out["layers/norm2/weight"] = _stack(sd, L + "norm2.weight", ids)
            out["layers/mixer/Wqkv/weight"] = _stack(sd, L + "mixer.Wqkv.weight", ids, _T)
            out["layers/mixer/Wqkv/bias"] = _stack(sd, L + "mixer.Wqkv.bias", ids)
            out["layers/mixer/out_proj/weight"] = _stack(sd, L + "mixer.out_proj.weight", ids,
                                                         _T)
            out["layers/mixer/out_proj/bias"] = _stack(sd, L + "mixer.out_proj.bias", ids)
            # InternLM names its MLP weights w1 / w2 / w3 (gate, up, down)
            for w in ("w1", "w2", "w3"):
                out[f"layers/mlp/{w}/weight"] = _stack(sd, L + f"mlp.{w}.weight", ids, _T)
    elif family == "falcon":
        if "word_embeddings.weight" in sd:
            out["word_embeddings/weight"] = sd["word_embeddings.weight"]
        for nm in ("ln_f.weight", "ln_f.bias"):
            if nm in sd:
                out[nm.replace(".", "/")] = sd[nm]
        if "output.weight" in sd:
            out["output/weight"] = _T(sd["output.weight"])
        if ids:
            att = "self_attention."
            for w in ("wq", "wk", "wv", "dense"):
                out[f"layers/self_attention/{w}/weight"] = _stack(sd, L + att + f"{w}.weight",
                                                                  ids, _T)
                if L.format(0) + att + f"{w}.bias" in sd:
                    out[f"layers/self_attention/{w}/bias"] = _stack(sd, L + att + f"{w}.bias",
                                                                    ids)
            for w in ("dense_h_to_4h", "dense_4h_to_h"):
                out[f"layers/mlp/{w}/weight"] = _stack(sd, L + f"mlp.{w}.weight", ids, _T)
                if L.format(0) + f"mlp.{w}.bias" in sd:
                    out[f"layers/mlp/{w}/bias"] = _stack(sd, L + f"mlp.{w}.bias", ids)
            for ln in ("ln_attn", "ln_mlp", "input_layernorm", "post_attention_layernorm"):
                if L.format(0) + ln + ".weight" in sd:
                    out[f"layers/{ln}/weight"] = _stack(sd, L + ln + ".weight", ids)
                    out[f"layers/{ln}/bias"] = _stack(sd, L + ln + ".bias", ids)
    else:
        raise ValueError(f"no converter for llama_type {llama_type!r}")
    return out


def _convert_moe(sd, ids, out, fused: bool) -> None:
    """Mixtral's FFN -> the f32 router (L, dim, E) and the experts stacked
    (L, E, dim, H) / (L, E, H, dim)."""
    L = "layers.{}."
    out["layers/feed_forward/gate/weight"] = _stack(
        sd, L + "feed_forward.gate.weight", ids, _T).astype(np.float32)
    n_experts = sd[L.format(ids[0]) + "feed_forward.gate.weight"].shape[0]
    if fused:
        # fused (E * H, dim): w1 / w3 are (out=H, in=dim) an expert ->
        # (dim, H); w2's fused rows are already (H, dim)
        def unfuse(transpose):
            def f(a):
                a = a.reshape(n_experts, -1, a.shape[-1])
                return np.ascontiguousarray(np.swapaxes(a, 1, 2)) if transpose else a
            return f

        out["layers/feed_forward/w1/weight"] = _stack(sd, L + "feed_forward.w1", ids,
                                                      unfuse(True))
        out["layers/feed_forward/w3/weight"] = _stack(sd, L + "feed_forward.w3", ids,
                                                      unfuse(True))
        out["layers/feed_forward/w2/weight"] = _stack(sd, L + "feed_forward.w2", ids,
                                                      unfuse(False))
        return

    def stack_experts(w):
        return np.stack([np.stack([_T(sd[L.format(i) + f"feed_forward.experts.{e}.{w}.weight"])
                                   for e in range(n_experts)]) for i in ids])

    for w in ("w1", "w3", "w2"):
        out[f"layers/feed_forward/{w}/weight"] = stack_experts(w)
