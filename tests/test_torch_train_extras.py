"""The rest of training in the port against the JAX package on the CPU:

- ``util.remat_policy``: every layer kept, checkpointed with the selective
  policy (``True`` / ``"dots"``) or with full recompute: the same loss and
  gradients, bit for bit, for LLaMA (W4 with LoRA, and dense) and for
  Mixtral with the MoE loss; the selective policy keeps the flash forward's
  output (one forward a layer), full recompute runs it twice, and the W4
  products are recomputed under both; a MoE recompute replays its forward's
  routing (``ops.moe.routing_replay``);
- ``train.optim.scale_lr_by_prefix`` chained after AdamW: two updates
  against ``optax.chain(tx, scale_lr_by_prefix(...))`` on the same
  gradients, 1e-6 relative per leaf (test_torch_train_ops' tolerance);
- ``data.conversation``'s dialog dataset: ``find_sublist``, the token ids
  and labels of ``FinetuneDialogDataset`` on an inline JSON config item for
  item against the JAX dataset, and ``LabelAllZeroError`` where JAX raises
  it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accessory_tpu.data import conversation as jconv
from accessory_tpu.train import lr_sched as jlr
from accessory_tpu.train.optim import make_optimizer as jmake_optimizer
from accessory_tpu.train.optim import scale_lr_by_prefix as jscale

from accessory_tpu_torch.config import LLaMAArgs, MixtralArgs
from accessory_tpu_torch.data import conversation
from accessory_tpu_torch.models import llama, mixtral
from accessory_tpu_torch.ops import flash_attention as tflash
from accessory_tpu_torch.ops import moe
from accessory_tpu_torch.quant import qtensor
from accessory_tpu_torch.quant.quantize import quantize_params
from accessory_tpu_torch.train import TrainState, lr_sched, make_optimizer, make_train_step
from accessory_tpu_torch.train.optim import chain, scale_lr_by_prefix
from accessory_tpu_torch.train.train_step import grads_of
from accessory_tpu_torch.train.tree import named_leaves
from accessory_tpu_torch.util import remat_policy

from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)
from test_torch_train_ops import _opt_tree

LLAMA = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64, multiple_of=64,
             max_seq_len=32, lora_rank=4)
MIXTRAL = dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=64, hidden_dim=128,
               num_experts=4, max_seq_len=32)


def _counting(monkeypatch):
    """Counts of the flash forward's and the W4 product's plain versions."""
    calls = {"flash": 0, "w4": 0}
    fwd, qmm = tflash._forward, qtensor._kernel_qmm_impl

    def flash(*a, **k):
        calls["flash"] += 1
        return fwd(*a, **k)

    def w4(*a, **k):
        calls["w4"] += 1
        return qmm(*a, **k)

    monkeypatch.setattr(tflash, "_forward", flash)
    monkeypatch.setattr(qtensor, "_kernel_qmm_impl", w4)
    return calls


@pytest.mark.parametrize("family", ["llama", "llama_dense", "mixtral_dense", "mixtral_w4"])
def test_remat_policies_agree(family, monkeypatch):
    """One bf16 step, batch 2 x 16 in two microbatches, under each remat
    setting: the metrics and every gradient bit-equal to the step that keeps
    every activation; flash forwards a step: one a layer and microbatch
    (False, True, "dots"), two under "full"; W4 products: recomputed under
    both checkpointed settings."""
    calls = _counting(monkeypatch)
    rng = np.random.RandomState(0)
    batch = {"examples": rng.randint(1, 64, (2, 16)), "labels": rng.randint(1, 64, (2, 16))}
    res = {}
    for remat in (False, True, "dots", "full"):
        if family.startswith("llama"):
            module, args = llama, LLaMAArgs(**LLAMA, dtype="bfloat16")
            params = llama.init_params(args, seed=0, device="cpu")
            if family == "llama":
                params = quantize_params(params, bits=4)
        else:
            module, args = mixtral, MixtralArgs(**MIXTRAL, dtype="bfloat16")
            params = mixtral.init_params(args, seed=0, device="cpu")
            if family == "mixtral_w4":
                params = quantize_params(params, bits=4, blocklist=["gate", "norm",
                                                                    "tok_embeddings", "output"])
        tx = make_optimizer(params, 1e-3, trainable=module.get_trainable_params_filter(args))
        step = make_train_step(module, args, tx, remat=remat, accum_steps=2,
                               moe_aux=module is mixtral, device="cpu")
        calls.update(flash=0, w4=0)
        state, m = step(TrainState.create(params, tx), batch)
        res[remat] = ({k: float(v) for k, v in m.items()},
                      {k: g.clone() for k, g in grads_of(state).items()}, dict(calls))
    met, grads, base = res[False]
    assert met["aux_loss"] > 0 if family.startswith("mixtral") else met["aux_loss"] == 0
    layers, micro = args.n_layers, 2
    assert base["flash"] == layers * micro
    for remat in (True, "dots", "full"):
        assert res[remat][0] == met, remat
        assert set(res[remat][1]) == set(grads)
        for k, g in grads.items():
            assert torch.equal(res[remat][1][k], g), (remat, k)
        want_flash = layers * micro * (2 if remat == "full" else 1)
        assert res[remat][2]["flash"] == want_flash, (remat, res[remat][2])
        assert res[remat][2]["w4"] == 2 * base["w4"], (remat, res[remat][2])


def test_remat_policy_values():
    """What each setting keeps for the recompute: "full" only the MoE
    routing, True / "dots" also the flash output and the dense products."""
    assert remat_policy(False) is None and remat_policy(None) is None
    assert set(remat_policy("full").keywords["keep"]) == {"route"}
    assert set(remat_policy(True).keywords["keep"]) == {"route", "flash", "dots"}
    assert remat_policy("dots").keywords == remat_policy(True).keywords
    with pytest.raises(ValueError, match="remat"):
        remat_policy("some")


def test_routing_replay_takes_the_recorded_experts():
    """Inside ``routing_replay`` the first MoE call records its experts and a
    later run takes them even where its own scores choose others (its own
    choice is kept in the routing record); the weights are its scores at the
    recorded experts."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 16, generator=gen)
    w1, w3 = torch.randn(4, 16, 8, generator=gen), torch.randn(4, 16, 8, generator=gen)
    w2 = torch.randn(4, 8, 16, generator=gen)
    gate_a, gate_b = torch.randn(16, 4, generator=gen), torch.randn(16, 4, generator=gen)
    memo = []
    with moe.routing_replay(memo):
        first, _ = moe.moe_ffn(x, gate_a, w1, w3, w2, k=2)
    _, idx_a, _ = moe.topk_gating(x, gate_a, 2)
    assert len(memo) == 1 and torch.equal(memo[0].to(torch.int32), idx_a)
    with moe.record_routing(detail=True) as log, moe.routing_replay(memo):
        replayed, _ = moe.moe_ffn(x, gate_b, w1, w3, w2, k=2)
    _, idx_b, scores_b = moe.topk_gating(x, gate_b, 2)
    assert not torch.equal(idx_a, idx_b)
    assert torch.equal(log[0]["idx"], idx_a) and log[0]["replayed"]
    assert torch.equal(log[0]["own_idx"].to(torch.int32), idx_b)
    weights = scores_b.gather(1, idx_a.long())
    combine = torch.zeros(6, 4).scatter(1, idx_a.long(), weights / weights.sum(-1, True))
    dense = torch.stack([torch.nn.functional.silu(x @ w1[e]) * (x @ w3[e]) @ w2[e]
                         for e in range(4)], 1)
    torch.testing.assert_close(replayed, (combine[:, :, None] * dense).sum(1),
                               rtol=1e-5, atol=1e-5)


def test_scale_lr_by_prefix_matches_optax():
    """Two AdamW updates with a clip and decay, chained with the prefix scale
    (a longer prefix beats a shorter one; a frozen leaf stays put), against
    optax.chain(tx, scale_lr_by_prefix) on the same gradients."""
    rng = np.random.RandomState(2)
    tree = _opt_tree(rng)
    scales = {"pro": 3.0, "proj": 0.5, "embed": 0.25, "attention_norm": 2.0}

    def trainable(name):
        return not name.startswith("head")

    jparams = jax.tree.map(jnp.asarray, tree)
    jtx = optax.chain(jmake_optimizer(jparams, lambda c: jlr.cosine_lr(c, 1e-2, 1e-3, 1.0, 4.0),
                                      weight_decay=0.05, clip_norm=1.0, trainable=trainable),
                      jscale(jparams, scales))
    jstate = jtx.init(jparams)
    params = {k: {kk: torch.from_numpy(v.copy()) for kk, v in d.items()}
              if isinstance(d, dict) else torch.from_numpy(d.copy()) for k, d in tree.items()}
    tx = chain(make_optimizer(params, lambda c: lr_sched.cosine_lr(c, 1e-2, 1e-3, 1.0, 4.0),
                              weight_decay=0.05, clip_norm=1.0, trainable=trainable),
               scale_lr_by_prefix(params, scales))
    assert tx.transforms[0].scale_of("proj/bias") == 0.5
    assert tx.transforms[0].scale_of("prologue") == 3.0
    assert tx.transforms[0].scale_of("scalar_gain") == 1.0
    state = tx.init(params)
    flat = dict(named_leaves(params))
    for _ in range(2):
        grads = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
                             tree)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        state = tx.update({p: torch.from_numpy(np.array(g)) for p, g in named_leaves(grads)},
                          state, flat)
    for path, leaf in named_leaves(jparams):
        got, want = flat[path].numpy(), np.asarray(leaf)
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-6, (path, err)
    assert np.array_equal(flat["head/weight"].numpy(), tree["head"]["weight"])


class DialogTok:
    """Bytes 0..255, BOS 256, EOS 257; a segment is its bytes."""

    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return [self.bos_id] * bos + list(s.encode()) + [self.eos_id] * eos

    def encode_segment(self, s):
        return list(s.encode())

    def decode(self, t):
        return bytes(x for x in t if x < 256).decode(errors="replace")


def _dialogs(rng, n):
    words = "kernel card token layer weight step loss the of a".split()

    def text(lo, hi):
        return " ".join(rng.choice(words, rng.randint(lo, hi)))

    out = []
    for i in range(n):
        turns = []
        for t in range(1 + i % 3):
            turns += [{"from": "human", "value": ("<image>\n" if t == 0 and i % 4 == 0 else "")
                       + text(2, 9)}, {"from": "gpt" if t % 2 else "assistant",
                                      "value": text(1, 12)}]
        out.append({"conversations": turns})
    return out


def test_find_sublist():
    for a, b in (([1, 2, 3, 2, 3], [2, 3]), ([1, 2], [3]), ([], []), ([5], []),
                 ([1, 2, 3], [1, 2, 3, 4]), ([4, 4, 4], [4, 4])):
        assert conversation.find_sublist(a, b) == jconv.find_sublist(a, b)


@pytest.mark.parametrize("template", ["default", "vicuna_v1_1", "llava_v1"])
def test_dialog_dataset_matches_jax(tmp_path, template):
    """Two dialog files of two types behind a JSON config; every item's
    tokens, labels and mask equal JAX's for the template; a window that
    cuts every reply raises LabelAllZeroError on both sides."""
    rng = np.random.RandomState(5)
    for name, n in (("a", 7), ("b", 5)):
        (tmp_path / f"{name}.json").write_text(json.dumps(_dialogs(rng, n)))
    cfg = tmp_path / "data.json"
    cfg.write_text(json.dumps({"META": [{"path": str(tmp_path / "a.json"), "type": "chat"},
                                        {"path": str(tmp_path / "b.json"), "type": "chat2"}]}))
    tok = DialogTok()
    kw = dict(max_words=768, tokenizer=tok)
    port = conversation.FinetuneDialogDataset(
        str(cfg), conv_template_func=conversation.CONV_TEMPLATES[template], **kw)
    ref = jconv.FinetuneDialogDataset(str(cfg), conv_template_func=jconv.CONV_TEMPLATES[template],
                                      **kw)
    assert len(port) == len(ref) == 12 and port.groups() == ref.groups()
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[1].any()
    short = dict(kw, max_words=8)
    port_s = conversation.FinetuneDialogDataset(
        str(cfg), conv_template_func=conversation.CONV_TEMPLATES[template], **short)
    ref_s = jconv.FinetuneDialogDataset(str(cfg),
                                        conv_template_func=jconv.CONV_TEMPLATES[template],
                                        **short)
    with pytest.raises(conversation.LabelAllZeroError):
        port_s.get_item_func(3)
    with pytest.raises(jconv.LabelAllZeroError):
        ref_s.get_item_func(3)
