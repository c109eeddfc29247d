"""The port's parallel package without spawning: the logical-axis rules and
specs against the JAX package's, the mesh's size check, the discovery order
of ``init_distributed_mode`` (monkeypatched environments, no process group),
and a one-rank gloo group in this process, where the context-parallel train
step equals the plain one.

Specs compare as tuples (``tuple(jax PartitionSpec)`` against the port's
``PartitionSpec``, a tuple). The JAX side uses a mesh of the conftest's 8 CPU
devices; the port's spec functions read only a mesh's axis names and sizes,
so they get a stand-in with the same ones."""

import types

import numpy as np
import pytest
import torch.distributed as dist

from accessory_tpu_torch.parallel import distributed as pdist
from accessory_tpu_torch.parallel import mesh as pmesh

MESH_AXES = {"dp": 2, "cp": 2, "tp": 2}


def _axes_tuples():
    """Every logical-axes tuple of JAX ``llama.param_axes`` (LoRA and bias
    tuning on, so the PEFT leaves' axes count too)."""
    import jax

    from accessory_tpu.config import LLaMAArgs
    from accessory_tpu.models import llama as jllama

    args = LLaMAArgs(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
                     multiple_of=32, lora_rank=4, bias_tuning=True)
    leaves = jax.tree.leaves(jllama.param_axes(args), is_leaf=lambda x: isinstance(x, tuple))
    return sorted(set(leaves), key=repr)


def _jax_mesh():
    from accessory_tpu.parallel.mesh import make_mesh

    return make_mesh(dict(MESH_AXES, fsdp=1))


def _port_mesh():
    axes = dict(MESH_AXES, fsdp=1)
    return types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))


def test_rules_are_the_reference_rules():
    from accessory_tpu.parallel import mesh as jmesh

    assert pmesh.DEFAULT_RULES == jmesh.DEFAULT_RULES
    assert pmesh.INFERENCE_RULES == jmesh.INFERENCE_RULES


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "INFERENCE_RULES"])
@pytest.mark.parametrize("with_mesh", [False, True])
def test_logical_to_pspec_matches_jax(rules, with_mesh):
    from accessory_tpu.parallel import mesh as jmesh

    tuples = _axes_tuples() + [None, ("batch", "length"), ("experts", "embed", "expert_ffn")]
    jm, pm = (_jax_mesh(), _port_mesh()) if with_mesh else (None, None)
    assert len(tuples) > 8
    for axes in tuples:
        want = tuple(jmesh.logical_to_pspec(axes, getattr(jmesh, rules), jm))
        got = pmesh.logical_to_pspec(axes, getattr(pmesh, rules), pm)
        assert isinstance(got, pmesh.PartitionSpec) and tuple(got) == want, axes


def test_fit_spec_matches_jax():
    """Every logical-axes tuple with shapes that the mesh axes divide, do not
    divide, or that are shorter than the spec's dims."""
    from accessory_tpu.parallel import mesh as jmesh

    jm, pm = _jax_mesh(), _port_mesh()
    for axes in _axes_tuples():
        for shape in ([4] * len(axes), [3] * len(axes), [6, 5, 8][:len(axes)],
                      [8] * (len(axes) + 1)):
            spec = jmesh.logical_to_pspec(axes, jmesh.DEFAULT_RULES, jm)
            want = tuple(jmesh._fit_spec(spec, shape, jm))
            got = pmesh._fit_spec(pmesh.logical_to_pspec(axes, pmesh.DEFAULT_RULES, pm), shape,
                                  pm)
            assert tuple(got) == want, (axes, shape)


def test_make_mesh_size_error_as_the_reference():
    from accessory_tpu.parallel.mesh import make_mesh as jmake_mesh

    with pytest.raises(ValueError) as jerr:
        jmake_mesh({"dp": 3, "tp": 2})
    assert str(jerr.value) == "mesh {'dp': 3, 'tp': 2} needs 6 devices, have 8"
    with pytest.raises(ValueError, match=r"^mesh \{'dp': 3, 'tp': 2\} needs 6 devices, have 1$"):
        pmesh.make_mesh({"dp": 3, "tp": 2}, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        pdist.make_global_mesh(tp=2, device="cpu")


ENVS = {
    "torchrun": {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "WORLD_SIZE": "8",
                 "RANK": "5", "LOCAL_RANK": "1"},
    "slurm": {"SLURM_STEP_NODELIST": "node[3-4],node7", "SLURM_NPROCS": "4",
              "SLURM_PROCID": "2", "SLURM_LOCALID": "0"},
}


def test_discovery_order():
    both = dict(ENVS["torchrun"], **ENVS["slurm"])
    explicit = pdist._discover("file:///tmp/x", 2, 1, both)
    assert explicit == {"init_method": "file:///tmp/x", "world_size": 2, "rank": 1,
                        "local_rank": 1}
    assert pdist._discover(None, None, None, both) == {
        "init_method": "env://", "world_size": 8, "rank": 5, "local_rank": 1}
    assert pdist._discover(None, None, None, ENVS["slurm"]) == {
        "init_method": f"tcp://node:{pdist.DEFAULT_PORT}", "world_size": 4, "rank": 2,
        "local_rank": 0}
    assert pdist._discover(None, None, None, dict(ENVS["slurm"], MASTER_PORT="77"))[
        "init_method"] == "tcp://node:77"
    assert pdist._discover(None, None, None, {}) == {
        "init_method": None, "world_size": 1, "rank": 0, "local_rank": 0}


@pytest.mark.parametrize("env", ["torchrun", "slurm", "none"])
def test_init_distributed_mode_calls_init_process_group(env, monkeypatch):
    for name in set(ENVS["torchrun"]) | set(ENVS["slurm"]):
        monkeypatch.delenv(name, raising=False)
    for name, value in ENVS.get(env, {}).items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
    info = pdist.init_distributed_mode(device="cpu")
    (args, kw), = calls
    assert args == ("gloo",) and info["backend"] == "gloo"
    if env == "none":
        assert isinstance(kw["store"], dist.HashStore) and kw["world_size"] == 1
    else:
        want = pdist._discover(None, None, None, ENVS[env])
        assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
            want["init_method"], want["world_size"], want["rank"])


def test_one_rank_cp_step_equals_the_plain_step(monkeypatch):
    """World 1 (an in-memory store in this process), mesh (dp 1, cp 1, tp 1):
    the step with ``attn_fn=make_cp_attn_fn(mesh)`` (labels shifted up front,
    the row-26 plain version at offset 0) against the step without it, f32:
    loss to 1e-6 relative and every gradient to 1e-6 relative L2 (the loss
    sums its terms over one more, masked, position)."""
    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.parallel import init_distributed_mode, local_mesh, make_cp_attn_fn
    from accessory_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from accessory_tpu_torch.train.train_step import grads_of

    for name in set(ENVS["torchrun"]) | set(ENVS["slurm"]):
        monkeypatch.delenv(name, raising=False)
    args = LLaMAArgs(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=128,
                     multiple_of=32, max_seq_len=32, dtype="float32")
    rng = np.random.RandomState(0)
    batch = {"examples": rng.randint(1, 128, (2, 32)), "labels": rng.randint(0, 128, (2, 32))}
    assert not dist.is_initialized()
    info = init_distributed_mode(device="cpu")
    try:
        assert (info["rank"], info["world_size"], info["backend"]) == (0, 1, "gloo")
        mesh = local_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("dp", "fsdp", "ep", "cp", "tp")
        out = []
        for attn_fn in (None, make_cp_attn_fn(mesh)):
            params = llama.init_params(args, seed=0, device="cpu")
            tx = make_optimizer(params, 1e-2, weight_decay=0.0)
            step = make_train_step(llama, args, tx, remat=True, attn_fn=attn_fn, device="cpu")
            state, m = step(TrainState.create(params, tx), batch)
            out.append((m, grads_of(state)))
    finally:
        dist.destroy_process_group()
    (m0, g0), (m1, g1) = out
    assert abs(float(m1["c_loss"]) - float(m0["c_loss"])) <= 1e-6 * float(m0["c_loss"])
    assert float(m1["n_tokens"]) == float(m0["n_tokens"])
    assert g0.keys() == g1.keys()
    for k in g0:
        assert float((g1[k] - g0[k]).norm()) <= 1e-6 * float(g0[k].norm()), k


def test_seq_shard_is_the_one_split():
    from accessory_tpu_torch.parallel import seq_shard

    assert [seq_shard(12, 4, i) for i in range(4)] == [slice(0, 3), slice(3, 6), slice(6, 9),
                                                       slice(9, 12)]
    assert seq_shard(7, 1, 0) == slice(0, 7)
    for n, parts, index in ((10, 4, 0), (8, 4, 4), (8, 4, -1), (8, 0, 0)):
        with pytest.raises(ValueError, match="do not split"):
            seq_shard(n, parts, index)


def test_train_step_takes_only_a_cp_attn_fn():
    """Any other attn_fn (a partial of cp_attention included) would see this
    rank's whole batch and sequence: make_train_step refuses it."""
    import functools

    from accessory_tpu_torch.config import LLaMAArgs
    from accessory_tpu_torch.models import llama
    from accessory_tpu_torch.parallel import cp_attention
    from accessory_tpu_torch.train import make_optimizer, make_train_step

    args = LLaMAArgs(dim=64, n_layers=1, n_heads=4, n_kv_heads=2, vocab_size=128,
                     multiple_of=32, max_seq_len=32, dtype="float32")
    tx = make_optimizer(llama.init_params(args, seed=0, device="cpu"), 1e-2)
    mesh = _port_mesh()
    for fn in (functools.partial(cp_attention, mesh=mesh), lambda q, k, v: q):
        with pytest.raises(TypeError, match="make_cp_attn_fn"):
            make_train_step(llama, args, tx, attn_fn=fn, device="cpu")


def test_gradient_buckets_cover_every_leaf_once():
    """``_CPLayout.sum_all``: leaves flattened by dtype into buckets of at
    most ``BUCKET`` elements (a larger leaf alone), each bucket's all-reduce
    written back to its leaves; here the all-reduce doubles its buffer and
    counts its sizes."""
    import torch

    from accessory_tpu_torch.train.train_step import _CPLayout

    layout = object.__new__(_CPLayout)
    layout.groups, layout.BUCKET, sizes = [None], 8, []

    def fake_sum(t):
        sizes.append((t.dtype, t.numel()))
        return t.mul_(2)

    layout.sum = fake_sum
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(shape, generator=gen).to(dtype) for shape, dtype in
              (((2, 2), torch.float32), ((3,), torch.bfloat16), ((1, 3), torch.float32),
               ((9,), torch.float32), ((2,), torch.float32), ((2, 3), torch.bfloat16))]
    before = [t.clone() for t in leaves]
    layout.sum_all(leaves)
    for t, b in zip(leaves, before):
        assert torch.equal(t, 2 * b)
    assert sizes == [(torch.float32, 7), (torch.float32, 9), (torch.float32, 2),
                     (torch.bfloat16, 3), (torch.bfloat16, 6)]
