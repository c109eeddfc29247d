"""Pretraining in the port against the JAX package on the CPU:

- ``native``: the C library (built from ``csrc/packing.cc`` into
  ``accessory_tpu_torch/build/``) and the numpy versions, each entry equal to
  ``accessory_tpu.native``'s on the same inputs;
- ``data.Falcon`` over a temporary directory of parquet shards and
  ``data.FalconPacked`` over ``.pkl`` shards: the train and validation
  splits, the file sharding, the items across a file boundary, and a resume
  from ``state_dict``, item for item against the JAX classes; ``batched``;
- ``tools.generate_packed_data.pack_file``: the pickle equal to the JAX
  tool's, byte for byte;
- ``main_pretrain.main`` in both packages from one JAX-written native
  checkpoint (``--pretrained_path``), over packed shards written by the
  port's tool: 2 iterations with a save, then a resume to iteration 3 (the
  data position and the iteration carried over), with validation. Each
  iteration's c_loss and the validation loss are held to
  test_torch_train_step's f32 TOL (2e-5 relative); the resumed run starts
  from the saved step.
"""

import json
import os
import pickle

import numpy as np
import pytest

from accessory_tpu import native as jnative
from accessory_tpu.data import Falcon as JFalcon
from accessory_tpu.data import FalconPacked as JFalconPacked
from accessory_tpu.tools.generate_packed_data import pack_file as jpack_file

from accessory_tpu_torch import native
from accessory_tpu_torch.data import Falcon, FalconPacked
from accessory_tpu_torch.data.falcon import batched
from accessory_tpu_torch.tools.generate_packed_data import pack_file

from test_torch_finetune import ByteTok
from test_torch_generate import one_torch_thread  # noqa: F401  (fixture)
from test_torch_train_step import TOL


@pytest.fixture(params=["c", "numpy"])
def native_path(request, monkeypatch):
    """The port's native module on its C library or on its numpy versions."""
    if request.param == "c":
        assert native.available(), native.build_error
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
        assert not native.available()
    return request.param


def test_native_matches_reference(native_path):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 32000, 1000).astype(np.int32)
    for max_words in (7, 16, 1000, 1001):
        np.testing.assert_array_equal(native.pack_stream(tokens, max_words),
                                      jnative.pack_stream(tokens, max_words))
    items = [rng.randint(1, 99, n).astype(np.int32) for n in (0, 3, 9, 12)]
    for max_words in (1, 8, 16):
        np.testing.assert_array_equal(native.pad_batch(items, max_words, pad_id=5),
                                      jnative.pad_batch(items, max_words, pad_id=5))
    q = rng.randint(0, 16, (64, 24)).astype(np.int32)
    packed = native.pack_u4(q)
    assert packed.dtype == np.uint32
    np.testing.assert_array_equal(packed, jnative.pack_u4(q))
    for k in (64, 61):
        np.testing.assert_array_equal(native.unpack_u4(packed, k), jnative.unpack_u4(packed, k))
        np.testing.assert_array_equal(native.unpack_u4(packed, k), q[:k])


def _parquet_dir(tmp_path, n_files=3, rows=5):
    import pandas as pd

    d = tmp_path / "corpus"
    d.mkdir()
    rng = np.random.RandomState(1)
    words = "kernel card token layer weight step loss the of a".split()
    for i in range(n_files):
        pd.DataFrame({"content": [" ".join(rng.choice(words, rng.randint(2, 30)))
                                  for _ in range(rows)]}).to_parquet(d / f"s{i}.parquet")
    return str(d)


def _take(ds, n):
    it = iter(ds)
    return [next(it) for _ in range(n)]


def _same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("rank,num_shards", [(0, 1), (0, 2), (1, 2)])
def test_falcon_matches_reference(tmp_path, rank, num_shards):
    """Items across the train files (shard ``rank`` of ``num_shards``), the
    validation file, and a resume from the state after 7 items."""
    d = _parquet_dir(tmp_path, n_files=5)
    tok = ByteTok()
    kw = dict(max_words=24, tokenizer=tok, rank=rank, num_shards=num_shards)
    port, ref = Falcon(d, **kw), JFalcon(d, **kw)
    assert port.files == ref.files and len(port.files) == (4 if num_shards == 1 else 2)
    _same_items(_take(port, 12), _take(ref, 12))
    assert port.state_dict() == ref.state_dict()
    val = dict(kw, rank=0, num_shards=1, split="val")
    _same_items(_take(Falcon(d, **val), 6), _take(JFalcon(d, **val), 6))
    port, ref = Falcon(d, **kw), JFalcon(d, **kw)
    _take(port, 7)
    state = port.state_dict()
    resumed, ref_resumed = Falcon(d, **kw), JFalcon(d, **kw)
    resumed.load_state_dict(state)
    ref_resumed.load_state_dict(state)
    _same_items(_take(resumed, 6), _take(ref_resumed, 6))
    _same_items(_take(resumed, 0), [])


def test_falcon_packed_and_batched(tmp_path):
    d = tmp_path / "packed"
    d.mkdir()
    rng = np.random.RandomState(2)
    for i in range(3):
        with open(d / f"p{i}.pkl", "wb") as f:
            pickle.dump(rng.randint(1, 500, (4 + i, 16)).tolist(), f)
    port, ref = FalconPacked(str(d)), JFalconPacked(str(d))
    assert port.files == ref.files
    _same_items(_take(port, 9), _take(ref, 9))
    _same_items(_take(FalconPacked(str(d), split="val"), 5),
                _take(JFalconPacked(str(d), split="val"), 5))
    batches = list(zip(range(3), batched(iter(FalconPacked(str(d))), 4)))
    assert [b.shape for _, b in batches] == [(4, 16)] * 3
    with pytest.raises(FileNotFoundError, match="pkl"):
        FalconPacked(str(tmp_path))


def test_generate_packed_data_matches_reference(tmp_path):
    d = _parquet_dir(tmp_path, n_files=1, rows=12)
    src = os.path.join(d, "s0.parquet")
    n = pack_file(src, str(tmp_path / "port.pkl"), ByteTok(), 32)
    m = jpack_file(src, str(tmp_path / "ref.pkl"), ByteTok(), 32)
    assert n == m > 4
    assert (tmp_path / "port.pkl").read_bytes() == (tmp_path / "ref.pkl").read_bytes()


def _tokenizer_json(path):
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tk = HFTok(models.BPE(unk_token=None))
    tk.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    tk.decoder = decoders.ByteLevel()
    tr = trainers.BpeTrainer(vocab_size=300, special_tokens=["<s>", "</s>"],
                             initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tk.train_from_iterator(["the quick brown fox jumps over the lazy dog"] * 40, tr)
    tk.save(str(path))
    return str(path)


def _recording(monkeypatch, train_module, jax_side, out):
    """Wrap ``train_module.make_train_step`` so each step appends its c_loss."""
    inner = train_module.make_train_step

    def make(*a, **k):
        step = inner(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            if jax_side:
                import jax

                jax.debug.callback(lambda c: out.append(float(c)), m["c_loss"])
            else:
                out.append(float(m["c_loss"]))
            return state, m

        return run

    monkeypatch.setattr(train_module, "make_train_step", make)


def test_main_pretrain_matches_reference(tmp_path, monkeypatch):
    """See the module docstring: 2 + 1 iterations in each package."""
    import accessory_tpu.train as jtrain
    import jax

    from accessory_tpu.checkpoint import save_checkpoint as jsave
    from accessory_tpu.main_pretrain import get_args_parser as jparser
    from accessory_tpu.main_pretrain import main as jmain
    from accessory_tpu.meta import MetaModel as JMetaModel

    import accessory_tpu_torch.train as ttrain
    from accessory_tpu_torch import main_pretrain
    from accessory_tpu_torch.tools.generate_packed_data import pack_tokens

    tok = _tokenizer_json(tmp_path / "tokenizer.json")
    cfg = tmp_path / "model.json"
    cfg.write_text(json.dumps({"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
                               "multiple_of": 32}))
    base = tmp_path / "base"
    jm = JMetaModel("llama", [str(cfg)], tok, max_seq_len=32, seed=3)
    jsave(str(base), jm.params)
    data = tmp_path / "packed"
    data.mkdir()
    rng = np.random.RandomState(4)
    for i in range(3):
        pack_tokens(rng.randint(2, jm.args.vocab_size, 32 * 6), str(data / f"p{i}.pkl"), 32)

    def argv(out, iters):
        return ["--llama_config", str(cfg), "--tokenizer_path", tok, "--data_meta_path",
                str(data), "--packed_data", "--pretrained_path", str(base), "--output_dir",
                str(out), "--batch_size", "2", "--max_words", "32", "--precision", "fp32",
                "--max_iters", str(iters), "--save_freq", "2", "--val_freq", "2",
                "--val_iters", "2", "--warmup_iters", "1", "--lr_decay_iters", "6",
                "--lr", "1e-3", "--log_every", "100", "--seed", "3"]

    losses = {"jax": [], "port": []}
    _recording(monkeypatch, jtrain, True, losses["jax"])
    _recording(monkeypatch, ttrain, False, losses["port"])
    for iters in (2, 3):
        jstate = jmain(jparser().parse_args(argv(tmp_path / "jout", iters)))
        jax.effects_barrier()
        state = main_pretrain.main(main_pretrain.get_args_parser().parse_args(
            argv(tmp_path / "tout", iters)), device="cpu")
        assert int(jstate.step) == state.step == iters
    assert len(losses["jax"]) == len(losses["port"]) == 3
    for got, want in zip(losses["port"], losses["jax"]):
        assert abs(got - want) <= TOL["float32"]["loss"] * abs(want), losses
    assert os.path.isdir(tmp_path / "tout" / "epoch0-iter2")
    ds = json.loads((tmp_path / "tout" / "epoch0-iter2" / "dataset-shard-0.json").read_text())
    assert ds == json.loads((tmp_path / "jout" / "epoch0-iter2" /
                             "dataset-shard-0.json").read_text()) == {"_file_idx": 0,
                                                                     "_curr_idx": 4}
    logs = [[json.loads(x) for x in (tmp_path / out / "log.txt").read_text().splitlines()]
            for out in ("tout", "jout")]
    assert [x["iter"] for x in logs[0]] == [x["iter"] for x in logs[1]] == [2]
    want = logs[1][0]["val_loss"]
    assert abs(logs[0][0]["val_loss"] - want) <= TOL["float32"]["loss"] * abs(want)


def test_main_pretrain_refuses_model_parallel(tmp_path):
    from accessory_tpu_torch import main_pretrain

    args = main_pretrain.get_args_parser().parse_args([
        "--tokenizer_path", "unused", "--data_meta_path", str(tmp_path),
        "--model_parallel_size", "2"])
    with pytest.raises(NotImplementedError, match="A10"):
        main_pretrain.main(args, tokenizer=ByteTok(), device="cpu")
