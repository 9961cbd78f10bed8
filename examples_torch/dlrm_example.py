"""Deep CTR (DLRM) on the Criteo-clicks shape — the port's counterpart
of examples/dlrm_example.py, the deep sibling of
linear_classifier_example.py.

8 categorical tables live in one stacked embedding parameter, dense
features feed a bottom MLP, and the pairwise feature interaction is one
batched matmul; trained with adagrad in one launched worker.

    python examples_torch/dlrm_example.py

Mesh: one rank on one card. The JAX example runs
``MeshSpec(dp=2, fsdp=4)`` on 8 virtual CPU devices; the 32,768-row
table fits one card, and FSDP2 over gloo on a shared card is not a path
the port takes (ROADMAP "The card").
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")


def experiment_fn():
    from tf_yarn_tpu_torch.models import dlrm

    config = dlrm.DLRMConfig(
        table_sizes=(4096,) * 8,
        embed_dim=32,
        n_dense=8,
        bottom_mlp=(128,),
        top_mlp=(128,),
    )
    return dlrm.make_experiment(
        config,
        train_steps=120,
        batch_size=512,
        learning_rate=0.1,
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    metrics = run_on_gpu(
        experiment_fn, {"worker": TaskSpec(instances=1)}, name="dlrm"
    )
    print("run metrics:", metrics)
