"""Synchronous data parallelism — the port's counterpart of
examples/collective_allreduce_example.py.

Data parallelism is a mesh axis: two ranks (a chief and a worker of
`allreduce_topology`) train the BERT-tiny classifier at
``MeshSpec(dp=2)``, the model replicated and DDP all-reducing the
gradients after every backward, each rank on its half of the batch.

    python examples_torch/collective_allreduce_example.py

Mesh: ``dp=2`` over two ranks. The JAX example runs ``dp=8`` over 8
virtual CPU devices; one card a rank would run ``dp`` = the number of
cards, over NCCL. Here both ranks share the one card (or the CPU) and
the group talks gloo, since NCCL refuses two ranks on one device.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")


def experiment_fn():
    from tf_yarn_tpu_torch import MeshSpec
    from tf_yarn_tpu_torch.models import bert

    return bert.make_experiment(
        bert.BertConfig.tiny(),
        train_steps=40,
        batch_size=64,
        seq_len=32,
        mesh_spec=MeshSpec(dp=2),  # pure DP: params replicated, grads all-reduced
        log_every_steps=10,
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import allreduce_topology, run_on_gpu

    metrics = run_on_gpu(
        experiment_fn, allreduce_topology(nb_workers=1), name="allreduce_dp"
    )
    print("run metrics:", metrics)
    ranks = sorted(metrics.container_duration)
    assert ranks == ["chief:0", "worker:0"], ranks
