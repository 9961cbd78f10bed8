"""Sequence parallelism (ring and Ulysses attention over ``sp``) held
against the JAX package.

(a) The attention backends: four gloo ranks (`torch.multiprocessing.
spawn`, one spawn for the module's cases) run `ops.attention.attention`
with ``impl="ring"``, ``"ulysses"`` and ``"ulysses_flash"`` over meshes
of ``sp=4``, ``dp=2 x sp=2`` (GQA) and ``sp=2 x tp=2`` (each tp rank on
its heads: one kv head, which Ulysses repeats to lcm(1, 2)), inputs
replicated over ``sp`` as JAX's ``shard_map`` takes them; the output and
the gradients of q, k and v (of ``sum(out · w)``, w seeded) against
JAX's `ring_attention_sharded` / `ulysses_attention_sharded` on its
virtual CPU devices at the same mesh, each rank's rows and heads. Plus
the no-mesh reduction to `xla_attention`, the ``n_heads % sp`` error
text and the ``key_padding_mask`` refusal.

(b) `train_and_evaluate`: the decoder (LoRA, or full weights), BERT
without a padding mask and ViT (24² images: 10 positions, which sp=2
splits) trained 3 steps by the port's spawned ranks at ``dp=2 x sp=2``,
``fsdp=2 x sp=2``, ``sp=2 x tp=2`` and ``sp=2`` and by the JAX package at
the same MeshSpec, from the same flax variables (`tests/_parallel_jobs.
py`). The
decoder's ranks compute their block of the sequence through the whole
model (ring, Ulysses with xla or flash inside, xla over the gathered
sequence; the chunked loss; a padded batch whose mask weighs the loss);
the encoders compute the whole sequence and cut only attention. Also:
the ranks' parameters (or FSDP2 shards) bitwise equal where the mesh
replicates them, the checkpoint in the one-device format, the
``train/sp_collective`` spans and histogram, the mesh log.

Tolerances (f32; the ranks sum in another order than XLA): outputs 1e-5
absolute, losses 1e-5 relative, gradients 1e-4 absolute, the final
parameters 1e-5 relative and 1e-6 absolute.

This module imports JAX only inside functions: the spawned ranks import
it by name to find their program.
"""

import os

import numpy as np
import pytest
import torch

import _parallel_jobs as pj

OUT_ATOL, GRAD_ATOL, LOSS_RTOL = 1e-5, 1e-4, 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
WORLD = 4

# (impl, mesh, causal, shape (B, S, H, Hkv, D))
ATTENTION = {
    "ring-sp4-causal": ("ring", {"sp": 4}, True, (2, 32, 4, 4, 8)),
    "ring-sp4": ("ring", {"sp": 4}, False, (2, 32, 4, 4, 8)),
    "ulysses-sp4-causal": ("ulysses", {"sp": 4}, True, (2, 32, 4, 2, 8)),
    "ulysses-sp4": ("ulysses", {"sp": 4}, False, (2, 32, 4, 2, 8)),
    "ring-dp2-sp2-gqa": ("ring", {"dp": 2, "sp": 2}, True, (4, 32, 4, 2, 8)),
    "ulysses-dp2-sp2-gqa": ("ulysses", {"dp": 2, "sp": 2}, True,
                            (4, 32, 4, 2, 8)),
    "ring-sp2-tp2": ("ring", {"sp": 2, "tp": 2}, True, (2, 32, 4, 2, 8)),
    "ulysses-sp2-tp2": ("ulysses", {"sp": 2, "tp": 2}, True,
                        (2, 32, 4, 2, 8)),
    "ulysses_flash-sp4": ("ulysses_flash", {"sp": 4}, True,
                          (2, 64, 4, 2, 16)),
    "ulysses_flash-dp2-sp2": ("ulysses_flash", {"dp": 2, "sp": 2}, False,
                              (2, 64, 4, 2, 16)),
}


def attention_inputs(shape, seed=0):
    b, s, h, hkv, d = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _rank_slices(mesh, shape):
    """The rank's rows (its data group's share) and its query and kv
    heads (its tp shard) of the global inputs."""
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
    from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib

    b, _, h, hkv, _ = shape
    index, count = mesh_lib.data_group(mesh)
    rows = slice(index * b // count, (index + 1) * b // count)
    tp = tp_lib.TensorParallel.of(mesh, "tp")
    if tp is None:
        return rows, slice(0, h), slice(0, hkv)
    start, length = tp.span(h, "n_heads")
    first, n_kv = tp_lib.kv_span(h, hkv, tp)
    return rows, slice(start, start + length), slice(first, first + n_kv)


def _attention_ranks(rank, world, port, out_dir):
    import torch.distributed as dist

    from tf_yarn_tpu_torch import telemetry
    from tf_yarn_tpu_torch.ops import attention as t_attention
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
    from tf_yarn_tpu_torch.parallel import ulysses

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    out = {}
    try:
        for name, (impl, fields, causal, shape) in ATTENTION.items():
            mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(**fields), "cpu")
            mesh_lib.set_current_mesh(mesh)
            rows, heads, kv_heads = _rank_slices(mesh, shape)
            q, k, v, w = (torch.from_numpy(a) for a in attention_inputs(shape))
            q = q[rows, :, heads].clone().requires_grad_()
            k = k[rows, :, kv_heads].clone().requires_grad_()
            v = v[rows, :, kv_heads].clone().requires_grad_()
            got = t_attention.attention(q, k, v, impl=impl, causal=causal)
            (got * w[rows, :, heads]).sum().backward()
            out[name] = {"out": got.detach(), "dq": q.grad, "dk": k.grad,
                         "dv": v.grad}
        # Ulysses refuses heads that do not split over sp.
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(sp=4), "cpu")
        mesh_lib.set_current_mesh(mesh)
        x = torch.zeros(1, 8, 3, 4)
        try:
            ulysses.ulysses_attention_sharded(x, x, x)
        except ValueError as err:
            out["heads_error"] = str(err)
        out["spans"] = sorted({(s.name, s.args["op"], s.args["direction"])
                               for s in telemetry.get_tracer().records()
                               if s.name == "train/sp_collective"})
        torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))
    finally:
        mesh_lib.set_current_mesh(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def attention_ranks(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("sp_attention"))
    torch.multiprocessing.spawn(_attention_ranks,
                                args=(WORLD, pj.free_port(), out_dir),
                                nprocs=WORLD, join=True)
    return [torch.load(os.path.join(out_dir, f"rank-{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def jax_attention(impl, fields, causal, shape):
    """JAX's sharded backend at the mesh: the output and the gradients of
    q, k, v of sum(out · w)."""
    import jax
    import jax.numpy as jnp

    from tf_yarn_tpu.ops.attention import attention
    from tf_yarn_tpu.parallel import mesh as j_mesh

    spec = j_mesh.MeshSpec(**fields)
    mesh = j_mesh.build_mesh(spec, j_mesh.select_devices(
        spec.total_devices, platform="cpu"))
    q, k, v, w = (jnp.asarray(a) for a in attention_inputs(shape))
    j_mesh.set_current_mesh(mesh)
    try:
        def loss(q, k, v):
            out = attention(q, k, v, impl=impl, causal=causal)
            return (out * w).sum(), out

        # Jitted: one compile, where eager shard_map takes ~40 s a case.
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    finally:
        j_mesh.set_current_mesh(None)
    return [np.asarray(a) for a in (out, *grads)]


def _mesh_of(fields, rank):
    """A rank's (dp, sp, tp) coordinate in a row-major mesh of `fields`."""
    dp, sp, tp = (fields.get(a, 1) for a in ("dp", "sp", "tp"))
    return rank // (sp * tp), (rank // tp) % sp, rank % tp


@pytest.mark.parametrize("case", list(ATTENTION))
def test_attention_matches_jax(attention_ranks, case):
    impl, fields, causal, shape = ATTENTION[case]
    want = jax_attention(impl, fields, causal, shape)
    b, _, h, hkv, _ = shape
    dp = fields.get("dp", 1)
    tp = fields.get("tp", 1)
    for rank, ranks_out in enumerate(attention_ranks):
        got = ranks_out[case]
        d, _, t = _mesh_of(fields, rank)
        rows = slice(d * b // dp, (d + 1) * b // dp)
        heads = slice(t * h // tp, (t + 1) * h // tp)
        # The tp shard's own kv heads (Hkv splits over tp in these cases).
        kv = slice(t * hkv // tp, (t + 1) * hkv // tp)
        np.testing.assert_allclose(got["out"].numpy(),
                                   want[0][rows, :, heads], atol=OUT_ATOL,
                                   rtol=0, err_msg=f"rank {rank} out")
        for key, ref in (("dq", want[1][rows, :, heads]),
                         ("dk", want[2][rows, :, kv]),
                         ("dv", want[3][rows, :, kv])):
            np.testing.assert_allclose(got[key].numpy(), ref, atol=GRAD_ATOL,
                                       rtol=0, err_msg=f"rank {rank} {key}")


def test_ulysses_heads_error_and_spans(attention_ranks):
    import jax.numpy as jnp

    from tf_yarn_tpu.parallel import mesh as j_mesh
    from tf_yarn_tpu.parallel.ulysses import ulysses_attention_sharded

    spec = j_mesh.MeshSpec(sp=4)
    j_mesh.set_current_mesh(j_mesh.build_mesh(spec, j_mesh.select_devices(
        4, platform="cpu")))
    try:
        x = jnp.zeros((1, 8, 3, 4))
        with pytest.raises(ValueError) as err:
            ulysses_attention_sharded(x, x, x)
    finally:
        j_mesh.set_current_mesh(None)
    for out in attention_ranks:
        assert out["heads_error"] == str(err.value)
        # Both collectives, both ways, under their span.
        assert {(op, d) for _, op, d in out["spans"]} == {
            ("ring_shift", "forward"), ("ring_shift", "backward"),
            ("all_to_all", "forward"), ("all_to_all", "backward")}


@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses_flash"])
def test_no_mesh_reduces_to_xla(impl):
    """Without a registered mesh each backend is plain xla attention, as
    the JAX sharded wrappers are."""
    import jax.numpy as jnp

    from tf_yarn_tpu.ops.attention import attention as j_attention
    from tf_yarn_tpu_torch.ops import attention as t_attention
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib.set_current_mesh(None)
    q, k, v, _ = attention_inputs((2, 16, 4, 2, 8), seed=1)
    got = t_attention.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                impl=impl)
    want = t_attention.xla_attention(*(torch.from_numpy(a)
                                       for a in (q, k, v)))
    assert torch.equal(got, want)
    ref = j_attention(*(jnp.asarray(a) for a in (q, k, v)), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=OUT_ATOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses", "ulysses_flash"])
def test_key_padding_mask_refused_as_jax(impl):
    """A padded batch needs xla attention in both packages (BERT with a
    mask under sp raises this)."""
    import jax.numpy as jnp

    from tf_yarn_tpu.ops.attention import attention as j_attention
    from tf_yarn_tpu_torch.models import bert as t_bert
    from tf_yarn_tpu_torch.ops import attention as t_attention

    q, k, v, _ = attention_inputs((2, 16, 4, 4, 8))
    with pytest.raises(NotImplementedError) as want:
        j_attention(*(jnp.asarray(a) for a in (q, k, v)), impl=impl,
                    key_padding_mask=jnp.ones((2, 16)))
    with pytest.raises(NotImplementedError) as got:
        t_attention.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              impl=impl, key_padding_mask=torch.ones(2, 16))
    assert str(got.value) == str(want.value)
    model = t_bert.make_model(t_bert.BertConfig.tiny(attention_impl=impl,
                                                     dtype=torch.float32),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="key_padding_mask"):
        model(torch.zeros(2, 16, dtype=torch.long),
              attention_mask=torch.ones(2, 16))


# -- (b) train_and_evaluate ---------------------------------------------------

DEC = dict(model="decoder", lora=pj.LORA)
JOBS_4 = {
    "dp2_sp2_ring": dict(DEC, impl="ring", mesh={"dp": 2, "sp": 2}),
    "dp2_sp2_ulysses_full": dict(DEC, lora=0, impl="ulysses",
                                 mesh={"dp": 2, "sp": 2}),
    "sp2_tp2_ulysses": dict(DEC, impl="ulysses", mesh={"sp": 2, "tp": 2}),
    "sp2_tp2_ring": dict(DEC, impl="ring", mesh={"sp": 2, "tp": 2}),
    "fsdp2_sp2_ring": dict(DEC, impl="ring", mesh={"fsdp": 2, "sp": 2}),
}
JOBS_2 = {
    "sp2_ulysses_flash": dict(DEC, impl="ulysses_flash", mesh={"sp": 2}),
    "sp2_ring_chunked": dict(DEC, lora=0, impl="ring", mesh={"sp": 2},
                             chunk=96),
    "sp2_ring_mask": dict(DEC, impl="ring", mesh={"sp": 2}, mask=True),
    "sp2_xla": dict(DEC, impl="xla", mesh={"sp": 2}),
    "vit_sp2_ring": dict(model="vit", impl="ring", mesh={"sp": 2}),
    "bert_sp2_ulysses": dict(model="bert", impl="ulysses", mesh={"sp": 2}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sequence_parallel"))
    jobs, boxed = pj.prepare(tmp, {**JOBS_4, **JOBS_2})
    port = pj.run_port(tmp, 4, [jobs[n] for n in JOBS_4])
    port.update(pj.run_port(tmp, 2, [jobs[n] for n in JOBS_2]))
    return {name: (job, port[name], pj.jax_run(job, boxed[name]))
            for name, job in jobs.items()}


def _replica_groups(job, world):
    """Ranks whose parameters are the same tensors: every rank, or those
    of one fsdp and tp index (their shards; the mesh's dims are
    (pp, dp, fsdp, sp, tp), row-major)."""
    fsdp, sp, tp = (job["mesh"].get(a, 1) for a in ("fsdp", "sp", "tp"))
    key = lambda r: ((r // (sp * tp)) % fsdp, r % tp)
    return [[r for r in range(world) if key(r) == (f, t)]
            for f in range(fsdp) for t in range(tp)]


@pytest.mark.parametrize("name", list(JOBS_4) + list(JOBS_2))
def test_train_matches_jax(runs, name):
    job, ranks, ref = runs[name]
    for rank, out in enumerate(ranks):
        assert sorted(out["losses"]) == sorted(ref["losses"])
        for step, loss in ref["losses"].items():
            assert out["losses"][step] == pytest.approx(loss, rel=LOSS_RTOL), \
                (rank, step)
    # The whole parameters from the one-device checkpoint rank 0 wrote.
    from tf_yarn_tpu_torch import checkpoint as t_ckpt

    saved = t_ckpt.restore_checkpoint(job["model_dir"], 3,
                                      map_location="cpu")["params"]
    assert sorted(saved) == sorted(ref["params"])
    for key, want in ref["params"].items():
        if key.endswith("wk.bias"):
            continue  # softmax cannot see it: rounding noise either way
        torch.testing.assert_close(saved[key].float(), want, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, msg=key)
    world = len(ranks)
    for group in _replica_groups(job, world):
        first = ranks[group[0]]["state"]
        for r in group[1:]:
            for key, value in first.items():
                assert torch.equal(ranks[r]["state"][key], value), (r, key)


@pytest.mark.parametrize("name", ["dp2_sp2_ring", "sp2_tp2_ulysses",
                                  "vit_sp2_ring"])
def test_telemetry_and_mesh_log(runs, name):
    job, ranks, _ = runs[name]
    for out in ranks:
        assert out["mesh"] == {"pp": 1, "dp": job["mesh"].get("dp", 1),
                               "fsdp": 1, "sp": 2,
                               "tp": job["mesh"].get("tp", 1), "ep": 1}
        assert out["mesh_devices"] == float(len(ranks))
        assert "train/sp_collective_seconds" in out["histograms"]
        ops = out["spans"]["train/sp_collective"]
        assert set(ops) == {"ring_shift" if job["impl"] == "ring"
                            else "all_to_all"}
        # The decoder's gradients are its block's share: summed over sp.
        summed = out["spans"].get("train/grad_allreduce", {}).get("sp", 0)
        assert summed == (3 if job["model"] == "decoder" else 0)
