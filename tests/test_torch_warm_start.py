"""The prefix warm start in the port (`PrefixCache.export_entries`/
`register_imported`/`evictable_blocks`, `SlotScheduler.export_hot_prefixes`/
`import_prefixes`, `encode_block_wire`/`decode_block_wire` and GET/POST
``/v1/blocks``), held against the JAX package on the tiny f32 decoder
with bridged weights and int8 KV: the cache halves, the round trip,
hot-first clipping and refusals with the JAX package's results and
messages, the codec (a bf16 leaf byte for byte as the JAX package writes
it), and the wire across packages both ways — a JAX donor's blocks, in
both of its layer layouts, serve the port the JAX donor's stream, and a
port donor's serve the JAX scheduler the port's. Then the HTTP routes
between two port servers, and one suspend/resume over /v1/generate."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_swap import BATCH, INTER, Side, drive
from tf_yarn_tpu_torch.serving import paging as port_paging
from tf_yarn_tpu_torch.serving.server import (
    ServingServer,
    decode_block_wire,
    encode_block_wire,
)

# Prefill 8 of 13 tokens at block 4: two whole blocks, two entries.
PROMPT = np.random.RandomState(5).randint(0, 256, (13,)).tolist()
OTHER = np.random.RandomState(6).randint(0, 256, (13,)).tolist()
FUSED = dict(kv_layout="paged", decode_attention="fused", block_size=4)


def served(side, prompts=(PROMPT,), max_new=6, **grid):
    """A scheduler that served `prompts` one after another, and their
    streams: its prefix cache holds their whole prefill blocks."""
    scheduler = side.scheduler(max_slots=2, **dict(FUSED, **grid))
    streams = []
    for prompt in prompts:
        response = scheduler.submit(prompt, side.params(
            max_new_tokens=max_new))
        drive(scheduler, [response])
        streams.append(response.result(timeout=1))
    return scheduler, streams


def stream_on(scheduler, side, prompt, max_new=6):
    hits = scheduler.stats()["prefix_cache"]["hits"]
    response = scheduler.submit(prompt, side.params(max_new_tokens=max_new))
    drive(scheduler, [response])
    return response.result(timeout=1), \
        scheduler.stats()["prefix_cache"]["hits"] - hits


def over_json(wire, encode, decode):
    return decode(json.loads(json.dumps(encode(wire))))


# -- the cache's halves -----------------------------------------------------

def test_cache_export_import_and_evictable_match_jax():
    from tf_yarn_tpu.serving import paging as jax_paging

    def run(module):
        out = []
        pool = module.BlockPool(num_blocks=12, block_size=4)
        cache = module.PrefixCache(pool, capacity=8)
        cold, hot = tuple(range(100, 108)), tuple(range(8))
        ids_cold, ids_hot = pool.allocate(2), pool.allocate(2)
        out.append(cache.register(cold, 8, ids_cold))
        out.append(cache.register(hot, 8, ids_hot))
        out.append(cache.evictable_blocks())
        cache.lookup(cold, max_tokens=7)  # moves cold's first entry to MRU
        out.append(cache.export_entries())
        out.append(cache.export_entries(limit=1))
        out.append(cache.export_entries(limit=0))
        try:
            cache.export_entries(limit=-1)
        except ValueError as exc:
            out.append(str(exc))
        out.append([pool.refcount(b) for b in range(12)])
        pool.release(ids_hot)  # the slot retires: its blocks are evictable
        out.append(cache.evictable_blocks())
        fresh = pool.allocate(2)
        out.append(cache.register_imported(b"\x01" * 16, fresh))
        out.append(cache.register_imported(b"\x01" * 16, fresh))
        out.append([pool.refcount(b) for b in fresh])
        pool.release(fresh)
        out.append((cache.evictable_blocks(), cache.cached_blocks,
                    cache.entries))
        out.append(module.PrefixCache(pool, 0).register_imported(b"k", []))
        out.append(cache.export_entries())
        return out

    assert run(port_paging) == run(jax_paging)


# -- the scheduler's round trip ---------------------------------------------

def test_export_import_round_trip_streams_equal():
    port = Side("port")
    donor, (stream,) = served(port)
    wire = donor.export_hot_prefixes()
    assert (wire["schema_version"], wire["block_size"], wire["n_blocks"],
            len(wire["entries"]), wire["group_width"]) == (1, 4, 2, 2, 2)
    receiver, _ = served(port, prompts=())
    result = receiver.import_prefixes(
        over_json(wire, encode_block_wire, decode_block_wire))
    assert result == {"imported_blocks": 2, "registered_entries": 2,
                      "skipped_entries": 0}
    # The same content keys again: nothing new, and the second copy's
    # blocks go back to the pool.
    assert receiver.import_prefixes(wire)["registered_entries"] == 0
    assert receiver.stats()["block_pool"]["used_blocks"] == 2
    got, hits = stream_on(receiver, port, PROMPT)
    assert got == stream and hits == 1
    for scheduler in (donor, receiver):
        scheduler.close()


def test_import_clips_hot_first_like_jax():
    results = []
    for side in (Side("jax"), Side("port")):
        donor, _ = served(side, prompts=(PROMPT, OTHER), max_new=2)
        wire = donor.export_hot_prefixes()
        assert wire["n_blocks"] == 4 and len(wire["entries"]) == 4
        # Two usable blocks: the hottest entries that fit win.
        receiver = side.scheduler(max_slots=1, num_blocks=3, **FUSED)
        result = receiver.import_prefixes(wire)
        results.append((result, receiver.stats()["block_pool"],
                        receiver.stats()["prefix_cache"]))
        for scheduler in (donor, receiver):
            scheduler.close()
    assert results[0] == results[1]
    assert results[1][0] == {"imported_blocks": 2, "registered_entries": 2,
                             "skipped_entries": 2}


def test_import_refusals_match_jax():
    messages = []
    for side in (Side("jax"), Side("port")):
        donor, _ = served(side)
        wire = donor.export_hot_prefixes()
        receiver = side.scheduler(max_slots=1, **FUSED)
        found = []
        with pytest.raises(ValueError) as err:
            receiver.import_prefixes(dict(wire, block_size=16))
        found.append(str(err.value))
        dense = side.scheduler(max_slots=1, kv_layout="dense")
        for call in (dense.export_hot_prefixes,
                     lambda: dense.import_prefixes(wire)):
            with pytest.raises(ValueError) as err:
                call()
            found.append(str(err.value))
        assert receiver.stats()["block_pool"]["used_blocks"] == 0
        messages.append(found)
        for scheduler in (donor, receiver, dense):
            scheduler.close()
    assert messages[0] == messages[1]


def test_import_refuses_a_foreign_pool_layout_with_nothing_allocated():
    port = Side("port")
    donor, _ = served(port)
    wire = donor.export_hot_prefixes()
    receiver = port.scheduler(max_slots=1, **FUSED)
    leaves = wire["groups"][0]["leaves"]
    for broken in (leaves[:3],  # a bf16 pool's three leaves
                   [None] + [leaf[:, :, :, :, :1] for leaf in leaves[1:]]):
        bad = dict(wire, groups=[dict(wire["groups"][0], leaves=broken)])
        with pytest.raises(ValueError, match="block wire"):
            receiver.import_prefixes(bad)
    assert receiver.stats()["block_pool"]["used_blocks"] == 0
    donor.close()
    receiver.close()


# -- the codec ----------------------------------------------------------------

def test_block_wire_codec_round_trips_and_bf16_matches_jax():
    import ml_dtypes

    from tf_yarn_tpu.serving.server import encode_block_wire as jax_encode

    rng = np.random.RandomState(0)
    bits = rng.randint(-2 ** 15, 2 ** 15, (2, 1, 3, 4), dtype=np.int16)
    leaves = [None,
              torch.from_numpy(rng.randint(-127, 128, (2, 3), dtype=np.int8)),
              torch.from_numpy(rng.randn(3, 2).astype(np.float32)),
              torch.from_numpy(bits.copy()).view(torch.bfloat16)]
    wire = {"schema_version": 1, "block_size": 4, "group_width": 3,
            "n_blocks": 3, "entries": [{"key": "00", "blocks": [0]}],
            "groups": [{"n_blocks": 3, "leaves": leaves}]}
    encoded = encode_block_wire(wire)
    decoded = decode_block_wire(json.loads(json.dumps(encoded)))
    assert decoded["entries"] == wire["entries"]
    got = decoded["groups"][0]["leaves"]
    assert got[0] is None
    for mine, theirs in zip(got[1:], leaves[1:]):
        assert mine.dtype == theirs.dtype
        assert torch.equal(mine.view(torch.uint8), theirs.view(torch.uint8))
    # The JAX package's encoding of the same values, bf16 through
    # ml_dtypes, is the same JSON.
    jax_leaves = [None, leaves[1].numpy(), leaves[2].numpy(),
                  np.frombuffer(bits.tobytes(), ml_dtypes.bfloat16)
                  .reshape(bits.shape)]
    jax_wire = dict(wire, groups=[{"n_blocks": 3, "leaves": jax_leaves}])
    assert jax_encode(jax_wire) == encoded
    assert encoded["groups"][0]["leaves"][3]["dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="dtype"):
        decode_block_wire({"groups": [{"n_blocks": 1, "leaves": [
            {"dtype": "complex64", "shape": [1], "b64": ""}]}]})


# -- across packages -----------------------------------------------------------

@pytest.mark.parametrize("scan_layers,n_layers", [(True, 2), (False, 12)],
                         ids=["scanned", "unscanned-12"])
def test_jax_wire_serves_the_port_the_jax_stream(scan_layers, n_layers):
    from tf_yarn_tpu.serving.server import encode_block_wire as jax_encode

    jax_side = Side("jax", n_layers=n_layers, scan_layers=scan_layers)
    port = Side("port", n_layers=n_layers, scan_layers=scan_layers)
    donor, (stream,) = served(jax_side)
    wire = over_json(donor.export_hot_prefixes(), jax_encode,
                     decode_block_wire)
    assert wire["group_width"] == 16  # the JAX donor pads to its tables
    receiver = port.scheduler(max_slots=2, **FUSED)
    result = receiver.import_prefixes(wire)
    assert result == {"imported_blocks": 2, "registered_entries": 2,
                      "skipped_entries": 0}
    got, hits = stream_on(receiver, port, PROMPT)
    assert hits == 1 and got == stream
    for scheduler in (donor, receiver):
        scheduler.close()


def test_port_wire_serves_jax_the_port_stream():
    from tf_yarn_tpu.serving.server import decode_block_wire as jax_decode

    jax_side = Side("jax", scan_layers=True)
    port = Side("port", scan_layers=True)
    donor, (stream,) = served(port)
    wire = over_json(donor.export_hot_prefixes(), encode_block_wire,
                     jax_decode)
    assert wire["group_width"] == 2 < 64 // 4  # no padding rows shipped
    receiver = jax_side.scheduler(max_slots=2, **FUSED)
    assert receiver.import_prefixes(wire) == {
        "imported_blocks": 2, "registered_entries": 2, "skipped_entries": 0}
    got, hits = stream_on(receiver, jax_side, PROMPT)
    assert hits == 1 and got == stream
    for scheduler in (donor, receiver):
        scheduler.close()


# -- HTTP ----------------------------------------------------------------------

def _call(port, path, body=None):
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body,
        headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(request, timeout=60) as reply:
            return reply.status, reply.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def test_http_blocks_between_port_servers():
    port = Side("port")
    donor, (stream,) = served(port)
    receiver = port.scheduler(max_slots=2, **FUSED)
    servers = [ServingServer(s, "127.0.0.1", 0) for s in (donor, receiver)]
    for server in servers:
        server.start()
    try:
        status, payload = _call(servers[0].port, "/v1/blocks")
        assert status == 200
        status, body = _call(servers[1].port, "/v1/blocks", payload)
        assert status == 200
        assert json.loads(body) == {"imported_blocks": 2,
                                    "registered_entries": 2,
                                    "skipped_entries": 0}
        got, hits = stream_on(receiver, port, PROMPT)
        assert got == stream and hits == 1
        status, body = _call(servers[0].port, "/v1/blocks?limit=1")
        assert status == 200 and len(json.loads(body)["entries"]) == 1
        status, body = _call(servers[0].port, "/v1/blocks?limit=0")
        assert status == 200 and json.loads(body)["n_blocks"] == 0
        assert _call(servers[0].port, "/v1/blocks?limit=x")[0] == 400
        assert _call(servers[1].port, "/v1/blocks", b"not json")[0] == 400
        broken = json.loads(payload)
        broken["groups"][0]["leaves"][1]["b64"] = "AAAA"
        assert _call(servers[1].port, "/v1/blocks",
                     json.dumps(broken).encode())[0] == 400
        foreign = dict(json.loads(payload), block_size=16)
        status, body = _call(servers[1].port, "/v1/blocks",
                             json.dumps(foreign).encode())
        assert status == 409 and b"block_size" in body
    finally:
        for server in servers:
            server.stop()
        donor.close()
        receiver.close()


def test_http_blocks_409_on_dense_replica():
    dense = Side("port").scheduler(max_slots=1, kv_layout="dense")
    server = ServingServer(dense, "127.0.0.1", 0)
    server.start()
    try:
        status, body = _call(server.port, "/v1/blocks")
        assert status == 409 and b"paged" in body
        status, body = _call(server.port, "/v1/blocks", b"{}")
        assert status == 409 and b"paged" in body
    finally:
        server.stop()
        dense.close()


def _wait(condition, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not condition():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_http_suspend_resume_greedy_streams_equal_jax():
    """The batch request ticks alone; the interactive one is queued
    before the loop starts, so it displaces the batch stream."""
    jax_side, port = Side("jax"), Side("port")
    grid = dict(max_slots=2, num_blocks=5, kv_host_blocks=8,
                kv_layout="paged", decode_attention="fused")
    expected = []
    for prompt, max_new, tier in ((BATCH, 20, "batch"),
                                  (INTER, 8, "interactive")):
        solo = jax_side.scheduler(**grid)
        response = solo.submit(prompt, jax_side.params(
            max_new_tokens=max_new), tier=tier)
        drive(solo, [response])
        expected.append(response.result(timeout=1))
        solo.close()
    scheduler = port.scheduler(**grid)
    server = ServingServer(scheduler, "127.0.0.1", 0)
    server.start()
    replies = {}

    def post(name, prompt, max_new, tier):
        replies[name] = _call(server.port, "/v1/generate", json.dumps(
            {"prompt": prompt, "max_new_tokens": max_new,
             "tier": tier}).encode())

    threads = [threading.Thread(target=post, args=args) for args in
               (("batch", BATCH, 20, "batch"),
                ("inter", INTER, 8, "interactive"))]
    try:
        threads[0].start()
        _wait(lambda: scheduler.queue.depth == 1, "the batch request")
        for _ in range(3):
            scheduler.tick()
        threads[1].start()
        _wait(lambda: scheduler.queue.depth == 1, "the interactive request")
        scheduler.start()
        for thread in threads:
            thread.join(timeout=120)
            assert not thread.is_alive()
        got = []
        for name in ("batch", "inter"):
            status, body = replies[name]
            assert status == 200, body
            got.append(json.loads(body)["tokens"])
        assert got == expected
        swap = scheduler.stats()["swap"]
        assert swap["suspends"] == swap["resumes"] == 1
    finally:
        server.stop()
        scheduler.close()
