"""Online serving: continuous batching over a slot grid — the port's
counterpart of examples/serving_example.py.

Builds a tiny decoder, starts the serving stack in this process (the
slot scheduler and the threaded HTTP frontend, the pieces the
``serving`` task runs through the launcher), fires a burst of
concurrent requests of mixed prompt and output lengths, and prints each
stream and the scheduler's tick trace: a slot freed by a short request
is re-admitted while longer ones still decode.

    python examples_torch/serving_example.py [--spec | --tp | fleet]

``--spec`` turns on speculative decoding: the n-gram self-drafter
proposes tokens a slot, one windowed step verifies them, and the
repeated-structure request lands several tokens a tick.

``--tp`` serves the same model as a tensor-parallel replica
(`serving.tp_replica`): its weights and paged KV pool cut by heads over
two ranks, this process the leader and one follower spawned. The JAX
example puts the two ranks on 2 virtual CPU devices; here both share
the one card (or the CPU) over gloo, since NCCL refuses two ranks on one
device, and a host with a card a rank would take NCCL. The printout
shows a rank's KV bytes against the whole cache's.

``fleet`` runs two replicas behind a router: requests go through the
router's ``/v1/generate``, then one replica is stopped and the other
keeps serving (health ejection and failover).

Every replica here is one device. The model is built on the card unless
``EXAMPLE_PLATFORM=cpu``.
"""

import http.client
import json
import os
import sys
import threading
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# On the card unless EXAMPLE_PLATFORM=cpu; a tp follower inherits it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")
DEVICE = "cpu" if os.environ["TPU_YARN_PLATFORM"] == "cpu" else "cuda"


def _model():
    from tf_yarn_tpu_torch.models.transformer import TransformerConfig, make_model

    config = TransformerConfig.tiny(max_seq_len=64, scan_layers=False)
    return make_model(config, seed=0, device=DEVICE)


def _post(port: int, body: dict) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    reply = json.loads(conn.getresponse().read())
    conn.close()
    return reply


def main(spec: bool = False, tp: bool = False) -> None:
    import numpy as np

    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.serving import ServingServer, SlotScheduler

    model = _model()
    buckets = dict(batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 16))
    replica = None
    if tp:
        # The tensor-parallel replica: every rank fills its heads of the
        # weights from the one-device state dict — what the serving task
        # does from ServingExperiment(mesh_spec=MeshSpec(tp=2)).
        from tf_yarn_tpu_torch import MeshSpec
        from tf_yarn_tpu_torch.serving import tp_replica

        state = {name: value.cpu() for name, value in
                 model.state_dict().items()}
        config = model.config
        del model
        replica = tp_replica.start(MeshSpec(tp=2))
        engine = replica.load(config, state=state, **buckets)
    else:
        engine = DecodeEngine(model, **buckets)

    # Paged KV: a pool of 8-token blocks instead of one max_seq_len cache
    # a slot (11 blocks against the dense grid's 17), with a prefix cache
    # sharing repeated prompt prefixes. --spec adds 3 n-gram drafts a
    # slot a tick, verified in one windowed step.
    scheduler = SlotScheduler(
        engine, max_slots=2,
        kv_layout="paged", block_size=8, num_blocks=11,
        spec_k=3 if spec else 0,
    )
    scheduler.start()
    server = ServingServer(scheduler, "127.0.0.1", 0)
    server.start()
    stats0 = scheduler.stats()
    print(f"serving on {server.endpoint} (grid of {scheduler.max_slots} "
          f"paged slots, {stats0['kv_cache_hbm_bytes']} KV bytes"
          + (f", spec_k={scheduler.spec_k}" if spec else "")
          + (f", tp={stats0['tp_degree']}: "
             f"{stats0['kv_cache_hbm_bytes_per_device']} KV bytes/device"
             if tp else "") + ")")

    rng = np.random.RandomState(0)
    motif = rng.randint(0, 256, 3)
    bodies = [
        {"prompt": rng.randint(0, 256, 5).tolist(), "max_new_tokens": 3},
        # Repeated structure: with --spec the n-gram drafter reads the
        # motif and this request lands several tokens a tick.
        {"prompt": np.tile(motif, 3).tolist(), "max_new_tokens": 12},
        {"prompt": rng.randint(0, 256, 3).tolist(), "max_new_tokens": 6},
        {"prompt": rng.randint(0, 256, 7).tolist(), "max_new_tokens": 8},
    ]
    results = {}

    def call(index):
        results[index] = _post(server.port, bodies[index])

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()

        for index, body in enumerate(bodies):
            reply = results[index]
            print(
                f"request {index}: P={len(body['prompt'])} "
                f"max_new={body['max_new_tokens']} -> {reply['tokens']} "
                f"({reply['finish_reason']}, ttft {reply['ttft_s']:.3f}s)"
            )
            assert len(reply["tokens"]) == body["max_new_tokens"], reply

        print("\ntick trace (admit/retire interleaving = continuous batching):")
        for entry in scheduler.trace:
            if entry["admitted"] or entry["retired"]:
                print(f"  {entry}")
        if spec:
            accepted = [n for t in scheduler.trace
                        for n in t.get("accepted", {}).values()]
            stats = scheduler.stats()["spec"]
            print(f"\nspeculative: accept_rate={stats['accept_rate']}, "
                  f"max tokens landed in one tick="
                  f"{max(accepted) if accepted else 0}")
    finally:
        server.stop()
        scheduler.close()
        if replica is not None:
            replica.close()


def fleet() -> None:
    """Two serving replicas behind a fleet router: discovery through the
    KV endpoint events, health-probed admission, least-loaded balancing,
    and failover when one replica stops — the pieces `fleet_topology`
    launches, in one process."""
    import numpy as np

    from tf_yarn_tpu_torch import event
    from tf_yarn_tpu_torch.coordination.kv import InProcessKV
    from tf_yarn_tpu_torch.fleet import ReplicaRegistry, RouterServer, make_policy
    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.serving import ServingServer, SlotScheduler

    # One engine shared by both replicas' grids.
    engine = DecodeEngine(
        _model(), batch_buckets=(1, 2, 4), prompt_buckets=(4, 8, 16)
    )
    kv = InProcessKV()
    replicas = []
    for index in range(2):
        scheduler = SlotScheduler(engine, max_slots=2)
        scheduler.start()
        server = ServingServer(scheduler, "127.0.0.1", 0)
        server.start()
        task = f"serving:{index}"
        # The discovery protocol the launcher's serving tasks speak.
        event.serving_endpoint_event(kv, task, server.endpoint)
        replicas.append((task, scheduler, server))
        print(f"replica {task} on {server.endpoint}")

    registry = ReplicaRegistry(
        kv, tasks=[task for task, _, _ in replicas], probe_interval_s=0.2
    )
    registry.refresh(force=True)
    router = RouterServer(
        registry, make_policy("least_loaded"), "127.0.0.1", 0, retries=3
    )
    router.start()
    print(f"router on {router.endpoint} "
          f"({len(registry.healthy())} replicas healthy)")

    def ask(tag):
        rng = np.random.RandomState(zlib.crc32(tag.encode()) % 2**16)
        reply = _post(router.port, {"prompt": rng.randint(0, 256, 5).tolist(),
                                    "max_new_tokens": 6})
        print(f"  {tag}: {reply['tokens']} ({reply['finish_reason']})")
        assert len(reply["tokens"]) == 6, reply

    try:
        print("\nfour requests through the router:")
        for index in range(4):
            ask(f"request {index}")
        print("routed:", router.stats()["routed_requests"])

        task0, scheduler0, server0 = replicas[0]
        print(f"\nstopping {task0}: the fleet keeps serving")
        server0.stop()
        scheduler0.close()
        for index in range(3):
            ask(f"after-stop {index}")
        stats = router.stats()
        print("routed:", stats["routed_requests"])
        states = {t: r["state"] for t, r in stats["replicas"].items()}
        print("replica states:", states)
        assert states[replicas[1][0]] == "healthy", states
    finally:
        router.stop()
        for _task, scheduler, server in replicas[1:]:
            server.stop()
            scheduler.close()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "fleet":
        fleet()
    else:
        main(spec="--spec" in sys.argv[1:], tp="--tp" in sys.argv[1:])
