"""Side-car evaluation and TensorBoard — the port's counterpart of
examples/evaluator_sidecar_example.py.

Three tasks: a worker training with periodic checkpoints, an evaluator
polling the checkpoint dir and evaluating each new one, and a
TensorBoard service advertising its URL through the KV store (the
driver logs it once).

    python examples_torch/evaluator_sidecar_example.py

Mesh: one rank. The JAX example trains at ``MeshSpec(fsdp=8)`` on 8
virtual CPU devices and puts the evaluator on the CPU; here the worker
and the evaluator are each placed as every task is, on the card (or the
CPU with ``EXAMPLE_PLATFORM=cpu``), and one card holds the model whole.
"""

import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_sidecar_demo")


def experiment_fn():
    from tf_yarn_tpu_torch.models import mnist

    return mnist.make_experiment(
        model_dir=MODEL_DIR,
        train_steps=60,
        batch_size=64,
        checkpoint_every_steps=20,
        log_every_steps=20,
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import NodeLabel, TaskSpec, run_on_gpu

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn,
        {
            "worker": TaskSpec(instances=1),
            "evaluator": TaskSpec(instances=1, label=NodeLabel.CPU),
            "tensorboard": TaskSpec(
                instances=1,
                label=NodeLabel.CPU,
                tb_model_dir=MODEL_DIR,
                tb_termination_timeout_seconds=0,
            ),
        },
        env={"TPU_YARN_EVAL_IDLE_TIMEOUT": "60"},
        name="sidecar_demo",
    )
    print("run metrics:", metrics)
    done = sorted(os.listdir(os.path.join(MODEL_DIR, "eval-done")))
    print("evaluated:", done)
    assert any("60" in name for name in done), done
