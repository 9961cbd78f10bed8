"""Online ranking: micro-batched DLRM scoring behind /v1/rank — the
port's counterpart of examples/ranking_example.py.

Builds a tiny DLRM, starts the ranking stack in this process (the
fill-or-timeout `MicroBatchScheduler` and the threaded HTTP frontend,
the pieces the ``rank`` task runs through the launcher), fires a burst of
concurrent requests of mixed row counts, and prints each request's
scores and the scheduler's snapshot: ``ticks`` come out below the
request count (requests coalesced into shared forwards) and the engine
runs a handful of bucketed forwards (``forward_buckets``).

Every score is held against a direct forward of the same weights on the
exact, unpadded batch: micro-batching and ceil-padding to a bucket are
performance decisions, not accuracy decisions. The script prints whether
each request's scores are bitwise the direct forward's and requires
them within RANK_RTOL: a matrix product sums in an order that depends
on its row count (one row takes the BLAS's matrix-vector path), so a row
scored in a coalesced tick can differ from the same row scored alone in
the last bit, in this package as in the JAX one.

    python examples_torch/ranking_example.py [--tp]

``--tp`` serves the model as a tensor-parallel replica
(`serving.tp_replica` with `ranker_shard`): the stacked embedding
table's rows split over two ranks, one all-reduce of the looked-up rows
a forward, and the scores still bitwise the one-device forward's; the
printout shows a rank's parameter bytes. The JAX example puts the ranks
on 2 virtual CPU devices; here both share the one card (or the CPU) over
gloo, since NCCL refuses two ranks on one device, and a host with a card
a rank would take NCCL.

The model is built on the card unless ``EXAMPLE_PLATFORM=cpu``.
"""

import http.client
import json
import os
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# On the card unless EXAMPLE_PLATFORM=cpu; a tp follower inherits it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")
DEVICE = "cpu" if os.environ["TPU_YARN_PLATFORM"] == "cpu" else "cuda"
# f32 scores of order 1: a few ulps of a different summation order.
RANK_RTOL = 1e-6


def main(tp: bool = False) -> None:
    import numpy as np
    import torch

    from tf_yarn_tpu_torch.models.dlrm import DLRMConfig, make_model
    from tf_yarn_tpu_torch.models.rank_engine import RankEngine, build_rank_fn
    from tf_yarn_tpu_torch.ranking import MicroBatchScheduler, RankServer

    # float32, so the JSON round trip is exact and the bitwise check
    # below compares the served floats to the direct forward directly.
    config = DLRMConfig.tiny(dtype=torch.float32)
    model = make_model(config, seed=0, device=DEVICE)
    buckets = dict(batch_buckets=(1, 2, 4, 8))
    replica = None
    if tp:
        # The embedding-sharded replica: the table's rows over the tp
        # ranks, the rest replicated — what the rank task does from
        # RankingExperiment(mesh_spec=MeshSpec(tp=2)).
        from tf_yarn_tpu_torch import MeshSpec
        from tf_yarn_tpu_torch.serving import tp_replica

        state = {name: value.cpu() for name, value in
                 model.state_dict().items()}
        replica = tp_replica.start(MeshSpec(tp=2))
        engine = replica.load(config, builder=tp_replica.ranker_shard,
                              state=state, **buckets)
    else:
        engine = RankEngine(model, **buckets)

    # max_wait_ms=5 is the coalescing window: a request waits up to 5 ms
    # for company before its tick fires.
    scheduler = MicroBatchScheduler(engine, max_batch=8, max_wait_ms=5.0)
    warmed = engine.warmup(max_batch=8)
    scheduler.start()
    server = RankServer(scheduler)
    server.start()
    stats0 = scheduler.stats()
    print(f"ranking on {server.endpoint} (max_batch=8, max_wait_ms=5.0, "
          f"{warmed} buckets warmed"
          + (f", tp={stats0['tp_degree']}: "
             f"{stats0['params_hbm_bytes_per_device']} param bytes/device"
             if tp else "") + ")")

    rng = np.random.RandomState(0)
    n_tables = len(config.table_sizes)
    bodies = []
    for batch in (1, 3, 2, 4, 1, 3):
        bodies.append({
            "cat": rng.randint(0, 1_000_000, (batch, n_tables)).tolist(),
            "dense": rng.randn(batch, config.n_dense).round(3).tolist(),
        })
    results = {}

    def call(index):
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.port, timeout=300
        )
        conn.request(
            "POST", "/v1/rank", json.dumps(bodies[index]),
            {"Content-Type": "application/json"},
        )
        results[index] = json.loads(conn.getresponse().read())
        conn.close()

    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()

        # The parity oracle: the one-device model's forward on the exact
        # (unpadded, uncoalesced) batch.
        direct = build_rank_fn(model, has_dense=True)
        for index, body in enumerate(bodies):
            reply = results[index]
            with torch.inference_mode():
                want = direct(
                    torch.as_tensor(body["cat"], dtype=torch.int32,
                                    device=DEVICE),
                    torch.as_tensor(body["dense"], dtype=torch.float32,
                                    device=DEVICE),
                ).float().cpu().numpy()
            got = np.asarray(reply["scores"], np.float32)
            bitwise = np.array_equal(got, want)
            print(f"request {index}: rows={len(body['cat'])} -> "
                  f"{[round(s, 4) for s in reply['scores']]} "
                  f"({reply['finish_reason']}, bitwise={bitwise})")
            assert len(got) == len(want) and np.allclose(
                got, want, rtol=RANK_RTOL, atol=0), (
                f"request {index} diverged from the direct forward: {got} "
                f"against {want}")

        stats = scheduler.stats()
        print(f"\n{stats['requests_total']} requests, {stats['rows_scored']} "
              f"rows in {stats['ticks']} ticks "
              f"(avg {stats['avg_batch_rows']} rows/tick — coalescing); "
              f"engine: {stats['rank_engine']['forward_buckets']} bucketed "
              f"forwards over {stats['rank_engine']['calls']} calls")
    finally:
        server.stop()
        scheduler.close()
        if replica is not None:
            replica.close()


if __name__ == "__main__":
    main(tp="--tp" in sys.argv[1:])
