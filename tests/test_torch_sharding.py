"""The port's placements (`parallel.sharding`) held against the JAX
package's, and the tensor-parallel edge cases that need no training.

(a) Every parameter's spec: the port's `tree_partition_specs(model,
fsdp_size)` against JAX's `tree_partition_specs` of the flax tree with its
partitioning boxes, leaf by leaf through the bridge's names (a conv
kernel's torch ``[out, in, kh, kw]`` spec is JAX's ``[kh, kw, in, out]``
one permuted), for the decoder with and without LoRA, BERT, ViT, ResNet,
mnist and the DLRM, under `LOGICAL_RULES` and `RANKING_RULES`; and the
pure logic (`logical_to_spec`, `infer_fsdp_partition`) on grids.

(f) Out-of-vocabulary ids under the vocabulary-parallel embedding equal
one device: two gloo ranks (`torch.multiprocessing.spawn`, one spawn for
the module) hold a tp=2 decoder and BERT, cut from the one-device weights,
and their logits on ids outside the vocabulary are compared with the
one-device model's in this process. The dims tp does not divide raise a
ValueError naming the dim, before any parameter is cut.

This module imports JAX only inside functions: the spawned ranks import
it by name to find their program.
"""

import json
import re
import socket

import numpy as np
import pytest
import torch

from tf_yarn_tpu_torch.parallel import sharding as t_sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as t_tp

SEQ = 16
HIDDEN, CLASSES, FEATURES = (16,), 4, 16


def _jax_rules(name):
    from tf_yarn_tpu.parallel import sharding as j_sharding

    return getattr(j_sharding, name)


LOGICAL = [("embed", "mlp"), ("mlp", "embed"), ("embed", "heads"),
           ("heads", "embed"), ("embed", "kv"), ("vocab", "embed"),
           ("embed", "vocab"), (None, "embed"), ("embed", None),
           ("batch", "seq", None), ("layers", "embed", "mlp"),
           ("expert", "embed", "mlp"), ("conv_out",), ("stage", None)]


@pytest.mark.parametrize("rules", ["LOGICAL_RULES", "RANKING_RULES"])
@pytest.mark.parametrize("axes", LOGICAL, ids=lambda a: "-".join(map(str, a)))
def test_logical_to_spec_matches_jax(axes, rules):
    from tf_yarn_tpu.parallel import sharding as j_sharding

    want = j_sharding.logical_to_spec(axes, _jax_rules(rules))
    assert t_sharding.logical_to_spec(axes, getattr(t_sharding, rules)) \
        == tuple(want)


SHAPES = [(8,), (4, 6), (6, 4), (4, 4), (3, 5), (2, 8, 8), (16, 3, 3, 8),
          (5, 7, 9), ()]


@pytest.mark.parametrize("fsdp", [1, 2, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_infer_fsdp_partition_matches_jax(shape, fsdp):
    from tf_yarn_tpu.parallel import sharding as j_sharding

    want = j_sharding.infer_fsdp_partition(shape, fsdp)
    assert t_sharding.infer_fsdp_partition(shape, fsdp) == tuple(want)
    assert t_sharding._divisible_axis(shape, fsdp) == \
        j_sharding._divisible_axis(shape, fsdp)


def _families():
    """name -> (JAX model, example args, port model)."""
    import jax.numpy as jnp

    from tf_yarn_tpu.models import bert as j_bert
    from tf_yarn_tpu.models import dlrm as j_dlrm
    from tf_yarn_tpu.models import mnist as j_mnist
    from tf_yarn_tpu.models import resnet as j_resnet
    from tf_yarn_tpu.models import transformer as j_tt
    from tf_yarn_tpu.models import vit as j_vit
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import dlrm as t_dlrm
    from tf_yarn_tpu_torch.models import mnist as t_mnist
    from tf_yarn_tpu_torch.models import resnet as t_resnet
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit

    def decoder(lora):
        return (j_tt.Transformer(j_tt.TransformerConfig.tiny(
                    scan_layers=False, lora_rank=lora)),
                (jnp.zeros((1, SEQ), jnp.int32),),
                t_tt.Transformer(t_tt.TransformerConfig.tiny(
                    lora_rank=lora), device="cpu", trainable=True))

    return {
        "decoder": lambda: decoder(0),
        "decoder_lora": lambda: decoder(4),
        "bert": lambda: (j_bert.BertClassifier(j_bert.BertConfig.tiny()),
                         (jnp.zeros((2, SEQ), jnp.int32),),
                         t_bert.BertClassifier(t_bert.BertConfig.tiny(),
                                               device="cpu")),
        "vit": lambda: (j_vit.ViT(j_vit.ViTConfig.tiny()),
                        (jnp.zeros((2, 32, 32, 3), jnp.float32),),
                        t_vit.ViT(t_vit.ViTConfig.tiny(), device="cpu")),
        "resnet": lambda: (j_resnet.ResNet(j_resnet.ResNetConfig.tiny()),
                           (jnp.zeros((2, 32, 32, 3), jnp.float32),),
                           t_resnet.ResNet(t_resnet.ResNetConfig.tiny(),
                                           device="cpu")),
        "mnist": lambda: (j_mnist.DenseClassifier(hidden_sizes=HIDDEN,
                                                  num_classes=CLASSES),
                          (jnp.zeros((2, FEATURES), jnp.float32),),
                          t_mnist.DenseClassifier(FEATURES, HIDDEN, CLASSES,
                                                  device="cpu")),
        "dlrm": lambda: (j_dlrm.DLRM(j_dlrm.DLRMConfig.tiny()),
                         (jnp.zeros((1, 4), jnp.int32),
                          jnp.zeros((1, 4), jnp.float32)),
                         t_dlrm.DLRM(t_dlrm.DLRMConfig.tiny(), device="cpu")),
    }


def _port_name(path):
    """The port's parameter name of a flax leaf path (the bridges' rule:
    ``/`` read as ``.``, the decoder's ``layer_<i>/block`` as
    ``layers.<i>``)."""
    return re.sub(r"^layer_(\d+)\.block\.", r"layers.\1.",
                  path.replace("/", "."))


def _jax_specs(model, args, fsdp, rules):
    import jax
    from flax.core import unfreeze

    from tf_yarn_tpu.parallel import sharding as j_sharding
    from jax.sharding import PartitionSpec

    boxed = unfreeze(model.init(jax.random.PRNGKey(0), *args))["params"]
    specs = j_sharding.tree_partition_specs(boxed, fsdp, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda node: isinstance(node, PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[_port_name(name)] = tuple(spec)
    return out


@pytest.mark.parametrize("rules", ["LOGICAL_RULES", "RANKING_RULES"])
@pytest.mark.parametrize("family", ["decoder", "decoder_lora", "bert", "vit",
                                    "resnet", "mnist", "dlrm"])
def test_placements_match_jax_leaf_for_leaf(family, rules):
    j_model, args, t_model = _families()[family]()
    want = _jax_specs(j_model, args, 2, _jax_rules(rules))
    got = t_sharding.tree_partition_specs(t_model, 2,
                                          getattr(t_sharding, rules))
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        expected = want[name]
        if t_model.get_parameter(name).dim() == 4 and expected:
            # flax's [kh, kw, in, out] against torch's [out, in, kh, kw].
            expected = (expected[3], expected[2], expected[0], expected[1])
        assert spec == expected, name


def test_annotated_families_place_over_tp_and_the_rest_replicate():
    families = _families()
    tp_leaves = {}
    for family in families:
        model = families[family]()[2]
        tp_leaves[family] = sorted(
            name for name, dim in t_sharding.tp_dims(model).items()
            if dim is not None)
    assert tp_leaves["resnet"] == tp_leaves["mnist"] == tp_leaves["dlrm"] == []
    assert tp_leaves["decoder"] == tp_leaves["decoder_lora"]
    assert "embedding" in tp_leaves["decoder"] and "lm_head" in \
        tp_leaves["decoder"]
    # kv is replicated (the "kv": None rule); LoRA factors unannotated.
    assert not any(re.search(r"w[kv]\.|lora_", name)
                   for family in tp_leaves for name in tp_leaves[family])
    # Under RANKING_RULES the DLRM's table rows go over tp.
    dlrm = families["dlrm"]()[2]
    assert t_sharding.tp_dims(dlrm, t_sharding.RANKING_RULES) == {
        name: (0 if name == "embedding" else None)
        for name, _ in dlrm.named_parameters()}


@pytest.mark.parametrize("dim,size,index", [(0, 2, 0), (0, 2, 1), (1, 2, 1),
                                            (1, 4, 3), (None, 2, 1)])
def test_local_slice_takes_the_contiguous_shard(dim, size, index):
    tensor = torch.arange(64.0).reshape(8, 8)
    got = t_sharding.local_slice(tensor, dim, size, index)
    if dim is None:
        assert got is tensor
        return
    want = tensor.chunk(size, dim)[index]
    assert torch.equal(got, want)


# -- the dims tp does not divide ------------------------------------------


def _refusals():
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import transformer as t_tt
    from tf_yarn_tpu_torch.models import vit as t_vit

    def decoder(**kw):
        cfg = t_tt.TransformerConfig.tiny(**kw)
        return t_tt.Transformer(cfg, device="cpu")

    return {
        "n_heads": lambda: decoder(n_heads=3, d_model=48, n_kv_heads=1),
        "n_kv_heads": lambda: decoder(n_heads=6, d_model=48, n_kv_heads=3),
        "d_ff": lambda: decoder(d_ff=129),
        "vocab_size": lambda: decoder(vocab_size=255),
        "bert-n_heads": lambda: t_bert.BertClassifier(
            t_bert.BertConfig.tiny(n_heads=1), device="cpu"),
        "bert-d_ff": lambda: t_bert.BertClassifier(
            t_bert.BertConfig.tiny(d_ff=65), device="cpu"),
        "bert-vocab_size": lambda: t_bert.BertClassifier(
            t_bert.BertConfig.tiny(vocab_size=127), device="cpu"),
        "vit-n_heads": lambda: t_vit.ViT(t_vit.ViTConfig.tiny(n_heads=1),
                                         device="cpu"),
        "vit-d_ff": lambda: t_vit.ViT(t_vit.ViTConfig.tiny(d_ff=63),
                                      device="cpu"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_ragged_tp_shards_raise_naming_the_dim(case):
    model = _refusals()[case]()
    before = {n: p.shape for n, p in model.named_parameters()}
    dim = case.rpartition("-")[2]
    with pytest.raises(ValueError, match=f"{dim}=.*does not split over tp=2|"
                       f"{dim}=.*neither splits over tp=2"):
        t_tp.shard(model, t_tp.TensorParallel(None, 2, 1))
    # Checked before anything is cut or set.
    assert {n: p.shape for n, p in model.named_parameters()} == before
    assert all(getattr(m, "tp", None) is None for m in model.modules())


@pytest.mark.parametrize("heads,kv,tp,want", [
    # (n_heads, n_kv_heads, tp) -> each rank's (first kv head, count)
    (32, 8, 2, [(0, 4), (4, 4)]),
    (4, 2, 2, [(0, 1), (1, 1)]),
    (4, 2, 4, [(0, 1), (0, 1), (1, 1), (1, 1)]),
    (8, 1, 4, [(0, 1)] * 4),
    (4, 4, 2, [(0, 2), (2, 2)]),
])
def test_kv_span_keeps_each_query_heads_group(heads, kv, tp, want):
    got = [t_tp.kv_span(heads, kv, t_tp.TensorParallel(None, tp, r))
           for r in range(tp)]
    assert got == want
    group = heads // kv
    for rank, (first, count) in enumerate(got):
        local = heads // tp
        q_heads = range(rank * local, (rank + 1) * local)
        # Each local query head reads kv head q // group, at its local
        # group's index.
        assert {q // group for q in q_heads} == set(range(first, first + count))


# -- out-of-vocabulary ids at tp=2, in two ranks ---------------------------


def _oov_ids(vocab):
    return torch.tensor([[0, vocab - 1, vocab, vocab + 7, -1, -vocab,
                          -vocab - 3, 5, 2 * vocab, 1, 3, vocab // 2 + 1,
                          vocab // 2 - 1, 9, 4, -2]])


def _one_device_models():
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.models import common
    from tf_yarn_tpu_torch.models import transformer as t_tt

    decoder = t_tt.make_model(t_tt.TransformerConfig.tiny(
        dtype=torch.float32, lora_rank=4), seed=3, device="cpu",
        trainable=True)
    with torch.no_grad():  # nonzero lora_b: every factor gets a gradient
        gen = torch.Generator().manual_seed(5)
        for name, param in decoder.named_parameters():
            if name.endswith("lora_b"):
                param.copy_(torch.randn(param.shape, generator=gen) * 0.05)
    full = t_tt.make_model(t_tt.TransformerConfig.tiny(
        dtype=torch.float32), seed=6, device="cpu", trainable=True)
    bert = common.init_weights(
        t_bert.BertClassifier(t_bert.BertConfig.tiny(dtype=torch.float32),
                              device="cpu"), torch.Generator().manual_seed(4))
    return {"decoder": decoder, "decoder_full": full, "bert": bert}


def _inputs(family):
    return _oov_ids(128 if family == "bert" else 256)


def _outputs(models):
    with torch.no_grad():
        return {family: model(_inputs(family))
                for family, model in models.items()}


def _grads(models):
    """Each trained parameter's gradient of the logits' weighted sum
    (weights fixed by a seed, so no two logits weigh alike)."""
    out = {}
    for family, model in models.items():
        model.zero_grad()
        logits = model(_inputs(family))
        weights = torch.randn(logits.shape,
                              generator=torch.Generator().manual_seed(7))
        (logits * weights).sum().backward()
        out[family] = {name: param.grad.clone()
                       for name, param in model.named_parameters()
                       if param.grad is not None}
    return out


def _oov_rank(rank, world, port, out):
    import torch.distributed as dist

    from tf_yarn_tpu_torch.parallel import mesh as t_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = t_mesh.build_mesh(t_mesh.MeshSpec(tp=world), "cpu")
        models = _one_device_models()
        shapes = {}
        for name, model in models.items():
            whole = {k: v.clone() for k, v in model.state_dict().items()}
            sliced = t_sharding.shard_like_annotated(model, whole, mesh)
            assert t_tp.parallelize(model, mesh) is not None
            # The restore-side twin cuts a one-device state as parallelize
            # cut the model.
            local = model.state_dict()
            assert sorted(sliced) == sorted(local)
            assert all(torch.equal(sliced[k], local[k]) for k in local)
            shapes[name] = {n: list(p.shape)
                            for n, p in model.named_parameters()}
        got = _outputs(models)
        # A forward and backward of each, with every collective counted:
        # the tp layers call all_reduce and nothing else.
        calls = {}
        for name in SPIED:
            inner = getattr(dist, name)

            def spy(*args, _name=name, _inner=inner, **kwargs):
                calls[_name] = calls.get(_name, 0) + 1
                return _inner(*args, **kwargs)

            setattr(dist, name, spy)
        grads = _grads(models)
        torch.save({"outputs": got, "grads": grads}, f"{out}-{rank}.pt")
        with open(f"{out}-{rank}.json", "w") as fh:
            json.dump({"shapes": shapes, "calls": calls,
                       "dims": {name: model.tp_dims
                                for name, model in models.items()}}, fh)
    finally:
        dist.destroy_process_group()


SPIED = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
         "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
         "all_to_all_single", "gather", "scatter", "reduce", "send", "recv")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def oov_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("oov") / "out")
    torch.multiprocessing.spawn(_oov_rank, args=(2, _free_port(), out),
                                nprocs=2, join=True)
    return [(torch.load(f"{out}-{r}.pt"), json.load(open(f"{out}-{r}.json")))
            for r in range(2)]


@pytest.mark.parametrize("family", ["decoder", "decoder_full", "bert"])
def test_out_of_vocabulary_ids_at_tp2_equal_one_device(oov_ranks, family):
    want = _outputs(_one_device_models())[family]
    for got, _ in oov_ranks:
        # f32; the head's logits are gathered exactly, the block sums
        # regroup.
        np.testing.assert_allclose(got["outputs"][family].numpy(),
                                   want.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(oov_ranks[0][0]["outputs"][family],
                       oov_ranks[1][0]["outputs"][family])


@pytest.mark.parametrize("family", ["decoder", "decoder_full", "bert"])
def test_tp2_gradients_are_one_devices(oov_ranks, family):
    """The gradient rule, gradient by gradient: a replicated parameter a
    rank reads in part (LoRA factors, column biases, wk/wv) gets its
    partial gradients summed over tp, one every rank reads whole (norm
    scales, row biases, the pooler) does not — so each rank holds the
    one-device gradient, or its slice of it for a sharded parameter."""
    want = _grads(_one_device_models())[family]
    dims = oov_ranks[0][1]["dims"][family]
    for rank, (got, _) in enumerate(oov_ranks):
        grads = got["grads"][family]
        assert sorted(grads) == sorted(want)
        for name, grad in grads.items():
            if name.endswith("wk.bias"):
                # Softmax cannot see a key bias: its gradient is rounding
                # noise in both (tests/test_torch_zoo.py).
                continue
            expected = want[name]
            if dims[name] is not None:
                expected = expected.chunk(2, dims[name])[rank]
            # f32 sums regrouped over the K split and the ranks: 1e-5 of
            # the gradient's scale; a missed or doubled tp sum is off by
            # a whole partial.
            scale = float(expected.abs().max()) or 1.0
            np.testing.assert_allclose(grad.numpy(), expected.numpy(),
                                       rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=name)
    trained = {"decoder": "lora_", "decoder_full": "scale", "bert": "bias"}
    assert any(trained[family] in name for name in want)


def test_tp_layers_use_all_reduce_only(oov_ranks):
    for _, record in oov_ranks:
        calls = record["calls"]
        assert set(calls) == {"all_reduce"} and calls["all_reduce"] > 0


def test_tp2_ranks_hold_their_halves(oov_ranks):
    shapes = oov_ranks[0][1]["shapes"]
    assert shapes == oov_ranks[1][1]["shapes"]
    assert shapes["decoder_full"]["embedding"] == [128, 64]
    decoder = shapes["decoder"]
    assert decoder["embedding"] == [128, 64]
    assert decoder["lm_head"] == [64, 128]
    assert decoder["layers.0.attn.wq.kernel"] == [64, 32]
    assert decoder["layers.0.attn.wo.kernel"] == [32, 64]
    assert decoder["layers.0.mlp.w_down.kernel"] == [64, 64]
    # Replicated: kv projections, LoRA factors, norm scales.
    assert decoder["layers.0.attn.wk.kernel"] == [64, 32]
    assert decoder["layers.0.attn.wq.lora_b"] == [4, 64]
    assert decoder["layers.0.attn_norm.scale"] == [64]
    bert = shapes["bert"]
    assert bert["encoder.token_embedding"] == [64, 32]
    assert bert["encoder.layer_0.wq.kernel"] == [32, 16]
    assert bert["encoder.layer_0.wk.kernel"] == [32, 32]
    assert bert["encoder.layer_0.ffn_in.kernel"] == [32, 32]
    assert bert["encoder.layer_0.ffn_out.bias"] == [32]
    assert bert["encoder.position_embedding"] == [64, 32]

