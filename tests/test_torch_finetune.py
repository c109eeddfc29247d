"""The port's finetune data, training checkpoints and ``main_finetune`` on the
CPU, against the JAX package where it has a counterpart.

- ``read_meta_config`` (the port's reader of the META config, no PyYAML)
  against ``yaml.safe_load`` on the repo's configs and on a generated one.
- ``FinetuneDataset`` / ``FinetuneDistSampler`` against the JAX ones: the
  same stub tokenizer object, one YAML config parsed by both, the same
  items, the same order over two epochs and two replicas, and resume at an
  iteration.
- A trainable-only checkpoint written by the port loads in the JAX
  ``load_checkpoint_list`` over a JAX template, values equal.
- The resume round trip: weights, optimizer state (bit for bit), step and
  progress come back.
- ``main_finetune.main(device="cpu")``: one epoch (three steps) of QPEFT
  over generated alpaca data, the checkpoint, ``log.txt``, then a second
  call that resumes from it for the next epoch.
Data and weights are made from numpy / torch seeds."""

import argparse
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from accessory_tpu.checkpoint import load_checkpoint_list as jload_checkpoint_list
from accessory_tpu.config import LLaMAArgs as JArgs
from accessory_tpu.data.alpaca import FinetuneDataset as JDataset
from accessory_tpu.data.alpaca import FinetuneDistSampler as JSampler
from accessory_tpu.models import llama as jllama

from accessory_tpu_torch import main_finetune
from accessory_tpu_torch.config import LLaMAArgs
from accessory_tpu_torch.data.alpaca import (FinetuneDataset, FinetuneDistSampler,
                                             read_meta_config)
from accessory_tpu_torch.models import llama
from accessory_tpu_torch.quant.quantize import quantize_params
from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
from accessory_tpu_torch.train.ckpt import (find_latest_checkpoint, resume_stage1,
                                            resume_stage2, save_train_checkpoint)
from accessory_tpu_torch.train.precision import promote_trainable_params_to_fp32
from accessory_tpu_torch.train.tree import named_leaves

REPO = Path(__file__).resolve().parents[1]
WORDS = ("alpha beta gamma delta tensor kernel quantize adapter gradient epoch batch "
         "token cache layer norm").split()


class ByteTok:
    """Bytes 0..255, BOS 256, EOS 257."""

    bos_id, eos_id, n_words = 256, 257, 258

    def encode(self, s, bos, eos):
        return [self.bos_id] * bos + list(s.encode()) + [self.eos_id] * eos

    def decode(self, t):
        return bytes(x for x in t if x < 256).decode(errors="replace")


def _alpaca(rng, n):
    def text(lo, hi):
        return " ".join(rng.choice(WORDS, rng.randint(lo, hi)))

    return [{"instruction": text(2, 8), "input": text(1, 4) if i % 3 == 0 else "",
             "output": text(2, 10)} for i in range(n)]


def _data(tmp_path, n_a=12, n_b=9, seed=0):
    """Two annotation files of two types and a YAML META config over them
    (comments, quoted and plain scalars, the reference's shape)."""
    rng = np.random.RandomState(seed)
    a, b = tmp_path / "a.json", tmp_path / "b.jsonl"
    a.write_text(json.dumps(_alpaca(rng, n_a)))
    b.write_text("\n".join(json.dumps(d) for d in _alpaca(rng, n_b)))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"""# generated finetune data config
META:
  - path: {a}   # instructions
    type: text
    prompt_type: alpaca
  -
    path: "{b}"
    type: 'short'
    prompt_type: None
""")
    return cfg


def test_meta_config_reader_matches_yaml(tmp_path):
    paths = sorted((REPO / "configs" / "data").glob("*.yaml")) + [_data(tmp_path)]
    assert len(paths) >= 2
    for p in paths:
        assert read_meta_config(str(p)) == yaml.safe_load(p.read_text()), p
    j = tmp_path / "data.json"
    j.write_text(json.dumps({"META": [{"path": "x.json", "type": "text"}]}))
    assert read_meta_config(str(j)) == {"META": [{"path": "x.json", "type": "text"}]}


def test_meta_config_reader_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("META:\n  - path: [a, b]\n")
    with pytest.raises(ValueError, match="plain scalar"):
        read_meta_config(str(bad))
    # .csv files and the h5 cache read where their packages are installed:
    # without them, an ImportError naming the package
    csv = tmp_path / "c.yaml"
    csv.write_text(f"META:\n  - path: {tmp_path / 'x.csv'}\n    type: text\n")
    import sys

    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "pandas", None)
        with pytest.raises(ImportError, match="pandas"):
            FinetuneDataset(str(csv), tokenizer=ByteTok())
    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        with pytest.raises(ImportError, match="h5py"):
            FinetuneDataset(str(_data(tmp_path)), tokenizer=ByteTok(), cache_on_disk=True)


@pytest.mark.parametrize("replicas,rank", [(1, 0), (2, 1)])
def test_dataset_and_sampler_match_the_reference(tmp_path, replicas, rank):
    cfg = str(_data(tmp_path))
    tok = ByteTok()
    ds = FinetuneDataset(cfg, max_words=160, tokenizer=tok)
    jds = JDataset(cfg, max_words=160, tokenizer=tok)
    assert len(ds) == len(jds) == 21 and ds.groups() == jds.groups()
    with pytest.warns(UserWarning, match="truncating"):
        _ = FinetuneDataset(cfg, max_words=24, tokenizer=tok)[0]
    for i in range(len(ds)):
        for got, want in zip(ds[i], jds[i]):
            assert np.array_equal(got, want), i
    kw = dict(num_replicas=replicas, rank=rank, batch_size=2, acc_grad=2, seed=3)
    s, js = FinetuneDistSampler(ds, **kw), JSampler(jds, **kw)
    assert len(s) == len(js) > 0
    for epoch, start in ((0, 0), (1, 0), (1, 1), (2, 2)):
        s.set_epoch(epoch, start)
        js.set_epoch(epoch, start)
        assert list(iter(s)) == list(iter(js)), (epoch, start)


CFG = dict(dim=128, n_layers=2, n_heads=2, n_kv_heads=1, vocab_size=258, multiple_of=64,
           max_seq_len=64, lora_rank=4, bias_tuning=True, norm_tuning=True)


def _qpeft_state(seed=0, dtype="float32"):
    args = LLaMAArgs(**CFG, dtype=dtype)
    trainable = llama.get_trainable_params_filter(args)
    params = llama.init_params(args, seed=seed, device="cpu")
    params = promote_trainable_params_to_fp32(quantize_params(params), trainable)
    tx = make_optimizer(params, 1e-3, clip_norm=1.0, trainable=trainable)
    return args, trainable, tx, TrainState.create(params, tx)


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    return {"examples": torch.randint(1, 258, (2, 24), generator=g),
            "labels": torch.randint(0, 258, (2, 24), generator=g)}


def test_trainable_only_checkpoint_loads_in_jax(tmp_path):
    args, trainable, tx, state = _qpeft_state()
    state, _ = make_train_step(llama, args, tx, remat=False, device="cpu")(state, _batch(0))
    d = save_train_checkpoint(str(tmp_path), state, epoch=0, model_args=args,
                              trainable_filter=trainable, only_save_trainable=True)
    jargs = JArgs(**CFG, dtype="float32")
    template = jllama.init_params(jax.random.PRNGKey(1), jargs)
    loaded = jload_checkpoint_list([d], template, dtype="float32")
    n = 0
    for path, leaf in named_leaves(state.params):
        parts = path.split("/")
        node = loaded
        for p in (parts[:1] + parts[2:] if parts[0] == "layers" else parts):
            node = node[p]
        got = np.asarray(node)[int(parts[1])] if parts[0] == "layers" else np.asarray(node)
        if trainable(path):
            np.testing.assert_array_equal(got, leaf.detach().numpy(), err_msg=path)
            n += 1
        elif parts[-1] == "weight" and parts[0] == "layers":
            # frozen base weights are not in the file: the template's remain
            want = np.asarray(template["layers"][parts[2]][parts[3]]["weight"])[int(parts[1])]
            np.testing.assert_array_equal(got, want, err_msg=path)
    assert n == 2 * (7 * 3 + 2) + 1     # lora_a / lora_b / bias per projection, two norms


def test_resume_round_trip(tmp_path):
    args, trainable, tx, state = _qpeft_state(dtype="bfloat16")
    step = make_train_step(llama, args, tx, remat="full", device="cpu")
    for i in range(2):
        state, _ = step(state, _batch(i))
    d = save_train_checkpoint(str(tmp_path), state, argparse.Namespace(lr=1e-3), epoch=1,
                              it=2, model_args=args, trainable_filter=trainable,
                              only_save_trainable=True, dataset_state={"pos": 5})
    assert find_latest_checkpoint(str(tmp_path)) == d
    _, _, tx2, _ = _qpeft_state(seed=9, dtype="bfloat16")
    template = llama.init_params(args, seed=9, device="cpu")
    # dtype=None keeps the saved f32 masters (main_finetune passes the compute
    # dtype, as the reference does, and resumes from bf16-rounded masters)
    params = resume_stage1(d, template, args=args, device="cpu")
    params = promote_trainable_params_to_fp32(quantize_params(params), trainable)
    back, meta, ds_state = resume_stage2(d, TrainState.create(params, tx2))
    assert back.step == 2 and meta["epoch"] == 1 and meta["iter"] == 2
    assert ds_state == {"pos": 5} and back.opt_state["count"] == 2
    for part in ("mu", "nu"):
        assert back.opt_state[part].keys() == state.opt_state[part].keys()
        for k, v in state.opt_state[part].items():
            assert back.opt_state[part][k].dtype == v.dtype and torch.equal(
                back.opt_state[part][k], v), (part, k)
    ours = dict(named_leaves(state.params))
    for path, leaf in named_leaves(back.params):
        if trainable(path):
            assert torch.equal(leaf, ours[path].detach()), path
    # the resumed state takes the next step
    back, m = step(back, _batch(2))
    assert back.step == 3 and np.isfinite(float(m["c_loss"]))


def _finetune_args(tmp_path, out, epochs):
    cfg = tmp_path / "llama.json"
    cfg.write_text(json.dumps({k: v for k, v in CFG.items() if k != "max_seq_len"}))
    return main_finetune.get_args_parser().parse_args([
        "--llama_config", str(cfg), "--tokenizer_path", "unused",
        "--data_config", str(_data(tmp_path, n_a=4, n_b=2)), "--output_dir", str(out),
        "--batch_size", "2", "--epochs", str(epochs), "--max_words", "96",
        "--quant", "--only_save_trainable", "--checkpointing", "--lr", "1e-3",
        "--warmup_epochs", "0", "--log_every", "1"])


def test_main_finetune_one_epoch_then_resume(tmp_path):
    out = tmp_path / "out"
    state = main_finetune.main(_finetune_args(tmp_path, out, 1), tokenizer=ByteTok(),
                               device="cpu")
    # 4 "text" and 2 "short" items, batch 2, no batch mixing types: 3 steps
    assert state.step == 3 and state.opt_state["count"] == 3
    assert (out / "epoch0" / "weights.safetensors").exists()
    logs = [json.loads(x) for x in (out / "log.txt").read_text().splitlines()]
    assert len(logs) == 1 and logs[0]["epoch"] == 0 and np.isfinite(logs[0]["closs"])
    saved = json.loads((out / "epoch0" / "quant.json").read_text())
    assert saved == {}                                   # trainable leaves only: no W4
    state2 = main_finetune.main(_finetune_args(tmp_path, out, 2), tokenizer=ByteTok(),
                                device="cpu")
    assert state2.step == 6 and state2.opt_state["count"] == 6
    assert (out / "epoch1" / "other.json").exists()
    assert len((out / "log.txt").read_text().splitlines()) == 2


def test_main_finetune_refuses_model_parallel(tmp_path):
    a = _finetune_args(tmp_path, tmp_path / "o", 1)
    a.model_parallel_size = 2
    with pytest.raises(NotImplementedError, match="A10"):
        main_finetune.main(a, tokenizer=ByteTok(), device="cpu")
