"""KerasExperiment-shaped run — the port's counterpart of
examples/mnist_keras_example.py.

A dense MNIST-style classifier through the Keras experiment surface:
separate feature and target streams, a validation stream, checkpoints
to model_dir, trained by the port's loop in one launched worker.

    python examples_torch/mnist_keras_example.py

Mesh: one rank on one card. The JAX example shards the model over
``MeshSpec(fsdp=8)`` on 8 virtual CPU devices; one card holds this model
whole, and FSDP2 over gloo on a shared card is not a path the port
takes (ROADMAP "The card"), so the run has no mesh.
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

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_mnist_keras")


def experiment_fn():
    import numpy as np

    from tf_yarn_tpu_torch import KerasExperiment, TrainParams
    from tf_yarn_tpu_torch.models import common, mnist

    rng = np.random.RandomState(0)

    def features():
        while True:
            yield {"x": rng.randn(64, 784).astype(np.float32)}

    def targets():
        while True:
            yield rng.randint(0, 10, 64).astype(np.int32)

    def validation():
        for _ in range(4):
            yield {
                "x": rng.randn(64, 784).astype(np.float32),
                "y": rng.randint(0, 10, 64).astype(np.int32),
            }

    return KerasExperiment(
        model=None,
        init_fn=lambda device, seed: mnist.make_model(seed=seed,
                                                      device=device),
        model_dir=MODEL_DIR,
        train_params=TrainParams(
            train_steps=50, checkpoint_every_steps=25, log_every_steps=10
        ),
        input_data_fn=features,
        target_data_fn=targets,
        validation_data_fn=validation,
        optimizer=mnist.adam(1e-3),
        loss_fn=common.classification_loss,
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn,
        {"worker": TaskSpec(instances=1)},
        name="mnist_keras",
    )
    print("run metrics:", metrics)
    checkpoints = sorted(os.listdir(MODEL_DIR))
    print("checkpoints in", MODEL_DIR, checkpoints)
    assert "ckpt-50" in checkpoints, checkpoints
