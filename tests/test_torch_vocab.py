"""Token ids outside the vocabulary, held against the JAX package.

The JAX package's gather reads an id as jnp indexing does: a negative id
counts once from the end, and the result is clamped to the table. The
port's embeddings (`models.transformer.vocab_index`) do the same, so a
prompt with such ids is served like any other instead of failing its
tick and every stream on the grid. Tiny f32 decoder with int8 KV
(vocabulary 256) and bridged weights, on the dense, paged gather and
paged fused grids and through `engine.generate`; the BERT encoder's token
and segment embeddings likewise. The JAX side runs its plain norms (its
fused RMSNorm has no batching rule under the dense step's vmap); the
port's norms give the plain f32 norm's numbers either way.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_yarn_tpu_torch.models import bert as t_bert
from tf_yarn_tpu_torch.models import transformer as tt
from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
from tf_yarn_tpu_torch.models.weights import _bridge_by_name, from_flax
from tf_yarn_tpu_torch.serving.request import SamplingParams
from tf_yarn_tpu_torch.serving.scheduler import SlotScheduler

BUCKETS = (4, 8, 16)
MAX_NEW = 6
MAX_SEQ = 64
VOCAB = 256
PROMPTS = [list(range(3, 10)), [1, VOCAB], [1, 2]]
# The JAX scheduler's stream for PROMPTS[1] on every grid.
JAX_STREAM_1 = [138, 0, 133, 139, 213, 138]
GRIDS = {"fused": dict(kv_layout="paged", decode_attention="fused"),
         "gather": dict(kv_layout="paged", decode_attention="gather"),
         "dense": dict(kv_layout="dense")}


@functools.lru_cache(maxsize=None)
def _weights():
    import flax.linen as nn

    from tf_yarn_tpu.models import transformer as jt

    cfg = jt.TransformerConfig.tiny(
        dtype=jnp.float32, kv_cache_dtype="int8", fused_norms=False,
        scan_layers=False, remat=False, max_seq_len=MAX_SEQ)
    model = jt.Transformer(cfg)
    params = nn.meta.unbox(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    return model, params


@functools.lru_cache(maxsize=None)
def _port_model():
    _, params = _weights()
    cfg = tt.TransformerConfig.tiny(dtype=torch.float32, max_seq_len=MAX_SEQ,
                                    kv_cache_dtype="int8")
    assert cfg.vocab_size == VOCAB
    model = tt.Transformer(cfg, device="cpu")
    model.load_state_dict(
        from_flax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return model


def _serve(scheduler, params):
    """Submit every prompt, tick to the end; (streams, finish reasons)."""
    try:
        responses = [scheduler.submit(p, params) for p in PROMPTS]
        for _ in range(200):
            if all(r.done for r in responses):
                break
            scheduler.tick()
        return ([r.result(timeout=1) for r in responses],
                [r.finish_reason for r in responses])
    finally:
        scheduler.close()


def test_vocab_index_wraps_once_then_clamps():
    """jnp's reading of ids on a 4-row table: 4 and 1000 give row 3, -1
    row 3, -7 and -5 row 0."""
    ids = torch.tensor([4, 1000, -1, -7, -5, 0, 2], dtype=torch.int32)
    got = tt.vocab_index(ids, 4)
    assert got.tolist() == [3, 3, 3, 0, 0, 0, 2]
    table = jnp.arange(4)
    assert got.tolist() == np.asarray(table[jnp.asarray(ids.numpy())]).tolist()
    assert got.dtype == ids.dtype


@pytest.mark.parametrize("grid", list(GRIDS))
def test_out_of_vocabulary_prompt_streams_equal_jax(grid):
    """Three concurrent prompts, one of them with id V: every grid serves
    all three to length, each stream equal to the JAX scheduler's."""
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine
    from tf_yarn_tpu.serving.request import SamplingParams as JaxParams
    from tf_yarn_tpu.serving.scheduler import SlotScheduler as JaxScheduler

    model, params = _weights()
    knobs = dict(max_slots=3, block_size=8, **GRIDS[grid])
    ref, ref_reasons = _serve(
        JaxScheduler(JaxEngine(model, batch_buckets=(1, 2, 4),
                               prompt_buckets=BUCKETS), params, **knobs),
        JaxParams(max_new_tokens=MAX_NEW))
    got, reasons = _serve(
        SlotScheduler(DecodeEngine(_port_model(), prompt_buckets=BUCKETS),
                      **knobs),
        SamplingParams(max_new_tokens=MAX_NEW))
    assert ref[1] == JAX_STREAM_1
    assert got == ref
    assert reasons == ref_reasons == ["length"] * len(PROMPTS)


@pytest.mark.parametrize("prompt", [[[1, VOCAB]], [[1, -300]],
                                    [[VOCAB + 7, 2, -VOCAB - 3]]],
                         ids=["V", "neg300", "mixed"])
def test_out_of_vocabulary_generate_equals_jax(prompt):
    from tf_yarn_tpu.models.decode_engine import DecodeEngine as JaxEngine

    model, params = _weights()
    ref = JaxEngine(model, batch_buckets=(1, 2, 4),
                    prompt_buckets=BUCKETS).generate(params, prompt, 4)
    got = DecodeEngine(_port_model(), prompt_buckets=BUCKETS).generate(
        prompt, 4)
    assert got.tolist() == np.asarray(ref).tolist()


def test_out_of_vocabulary_bert_tokens_and_segments_equal_jax():
    """The encoder's token ids (vocabulary 128) and segment ids (2
    segments) outside their tables: the pooled output equals JAX's
    (f32 sums in another order: 1e-5)."""
    import flax.linen as nn

    from tf_yarn_tpu.models import bert as j_bert

    jcfg = j_bert.BertConfig.tiny(dtype=jnp.float32)
    tcfg = t_bert.BertConfig.tiny(dtype=torch.float32)
    tokens = np.array([[1, 128, -1, 500, 7, -200, 3, 9],
                       [0, 127, 64, -128, -129, 2, 1000, 5]], np.int32)
    segments = np.array([[0, 1, 2, -1, 5, -3, 1, 0],
                         [1, 0, -2, 3, 0, 1, -1, 2]], np.int32)
    jmodel = j_bert.BertEncoder(jcfg)
    variables = nn.meta.unbox(jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(segments)))
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(tokens),
                                  jnp.asarray(segments)))
    encoder = t_bert.BertEncoder(tcfg, torch.device("cpu"))
    encoder.load_state_dict(_bridge_by_name(
        jax.tree_util.tree_map(np.asarray, variables), encoder))
    with torch.no_grad():
        got = encoder(torch.from_numpy(tokens), torch.Generator(),
                      segments=torch.from_numpy(segments)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
