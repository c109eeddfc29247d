"""Port parity, the host-side tools: the files ``extract_delta`` /
``apply_delta`` and ``convert_to_hf`` write hold arrays equal to the JAX
package's (bit for bit: the same f32 arithmetic, f16 deltas, bf16 rounded to
nearest even), ``convert_hf_to_ours`` gives back the original, and
``download`` resolves a local path and its parser reads its flags, with no
network (``huggingface_hub`` is imported only inside ``download``).

Checkpoints are a tiny LLaMA (dim 64, 2 layers, GQA 4 / 2) written by the
JAX package's ``save_checkpoint`` in f32 and bf16, with a finetuned copy
(every leaf plus seeded noise) and a W4 leaf that ships whole.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accessory_tpu.checkpoint import save_checkpoint
from accessory_tpu.config import LLaMAArgs
from accessory_tpu.models import llama as jllama
from accessory_tpu.quant.quantize import quantize_params
from accessory_tpu.tools import convert_weights_to_hf as jhf
from accessory_tpu.tools import weight_operate as jwo

from accessory_tpu_torch.checkpoint import read_safetensors
from accessory_tpu_torch.tools import convert_weights_to_hf as hf
from accessory_tpu_torch.tools import download, weight_operate

ARGS = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=96, multiple_of=32,
            max_seq_len=64)


def _params(dtype, seed=0, noise=0.0):
    args = LLaMAArgs(**ARGS, dtype=dtype)
    params = jllama.init_params(jax.random.PRNGKey(0), args)
    rng = np.random.RandomState(seed)
    return args, jax.tree.map(
        lambda x: (x.astype(jnp.float32) + noise * rng.randn(*x.shape)).astype(x.dtype), params)


def _files(d):
    """{name: arrays} of every safetensors file under d, and its JSON files."""
    out = {p.name: read_safetensors(str(p)) for p in sorted(d.glob("*.safetensors"))}
    out.update({p.name: json.loads(p.read_text()) for p in sorted(d.glob("*.json"))})
    return out


def _assert_same_files(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        if name.endswith(".json"):
            assert g == w, name
            continue
        assert g.keys() == w.keys(), name
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_delta_files_equal_jax(tmp_path, dtype):
    _, base = _params(dtype)
    _, tuned = _params(dtype, seed=1, noise=0.01)
    # a new (PEFT-like) leaf and a W4 leaf: both ship whole
    tuned = dict(tuned, extra={"weight": jnp.ones((3, 5), jnp.float32)})
    tuned["layers"]["feed_forward"]["w2"]["weight"] = quantize_params(
        {"w": {"weight": tuned["layers"]["feed_forward"]["w2"]["weight"][0]}},
        group_size=32)["w"]["weight"]
    b, t = tmp_path / "base", tmp_path / "tuned"
    save_checkpoint(str(b), base)
    save_checkpoint(str(t), tuned)
    weight_operate.extract_delta(str(b), str(t), str(tmp_path / "d"))
    jwo.extract_delta(str(b), str(t), str(tmp_path / "jd"))
    _assert_same_files(tmp_path / "d", tmp_path / "jd")
    assert (tmp_path / "d" / "DIFF").read_text() == (tmp_path / "jd" / "DIFF").read_text()
    weight_operate.apply_delta(str(b), str(tmp_path / "d"), str(tmp_path / "m"))
    jwo.apply_delta(str(b), str(tmp_path / "jd"), str(tmp_path / "jm"))
    _assert_same_files(tmp_path / "m", tmp_path / "jm")
    merged = read_safetensors(str(tmp_path / "m" / "weights.safetensors"))
    key = "layers/attention/wq/weight" + ("@bf16" if dtype == "bfloat16" else "")
    want = read_safetensors(str(t / "weights.safetensors"))[key]
    if dtype == "float32":
        np.testing.assert_allclose(merged[key], want, atol=2e-3)
    args = weight_operate.get_args_parser().parse_args(
        ["--pretrained_path", str(b), "--delta_path", str(tmp_path / "d"), "--output_path",
         str(tmp_path / "m2")])
    weight_operate.main(args)
    _assert_same_files(tmp_path / "m2", tmp_path / "m")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hf_export_equal_jax_and_import_round_trips(tmp_path, dtype):
    args, params = _params(dtype, noise=0.05)
    src = tmp_path / "src"
    save_checkpoint(str(src), params)
    (src / "config.json").write_text(json.dumps({
        "dim": args.dim, "n_layers": args.n_layers, "n_heads": args.n_heads,
        "n_kv_heads": args.kv_heads, "norm_eps": args.norm_eps, "rope_theta": 5e5,
        "max_seq_len": args.max_seq_len}))
    (src / "tokenizer.json").write_text('{"stub": true}')
    hf.convert_to_hf(str(src), str(tmp_path / "hf"))
    jhf.convert_to_hf(str(src), str(tmp_path / "jhf"))
    _assert_same_files(tmp_path / "hf", tmp_path / "jhf")
    assert (tmp_path / "hf" / "tokenizer.json").read_text() == '{"stub": true}'
    back = hf.convert_hf_to_ours(str(tmp_path / "hf"), n_heads=4, n_kv_heads=2)
    jback = jhf.convert_hf_to_ours(str(tmp_path / "jhf"), n_heads=4, n_kv_heads=2)
    assert back.keys() == jback.keys()
    orig = read_safetensors(str(src / "weights.safetensors"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, jback[k], err_msg=k)
        stored = orig.get(k)
        want = (stored.astype(np.float32) if stored is not None else
                (orig[k + "@bf16"].astype(np.uint32) << 16).view(np.float32))
        np.testing.assert_array_equal(v.astype(np.float32), want, err_msg=k)
    for a, b in ((hf._permute_rope, jhf._permute_rope), (hf._unpermute_rope, jhf._unpermute_rope)):
        w = np.arange(32 * 5, dtype=np.float32).reshape(32, 5)
        np.testing.assert_array_equal(a(w, 2), b(w, 2))
    np.testing.assert_array_equal(hf._unpermute_rope(hf._permute_rope(w, 4), 4), w)


def test_download_offline(tmp_path, monkeypatch):
    assert download.resolve_hf_path(str(tmp_path)) == str(tmp_path)
    assert download.resolve_hf_path("relative/dir") == "relative/dir"
    a = download.get_args_parser().parse_args(["--repo_id", "org/name", "--local_dir", "x",
                                               "--allow_patterns", "*.json", "*.model"])
    assert (a.repo_id, a.local_dir, a.allow_patterns) == ("org/name", "x",
                                                          ["*.json", "*.model"])
    import sys

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)   # not installed
    with pytest.raises(ImportError, match="local_dir"):
        download.resolve_hf_path("hf://org/name")
