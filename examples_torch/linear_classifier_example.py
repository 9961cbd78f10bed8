"""Estimator-shaped run — the port's counterpart of
examples/linear_classifier_example.py.

Hashed sparse logistic regression through the `ExperimentSpec(estimator,
train_spec, eval_spec)` triple: the reference's LinearClassifier-on-clicks
workflow, trained with adagrad in one launched worker.

    python examples_torch/linear_classifier_example.py

Mesh: one rank on one card. The JAX example shards the weight table
over ``MeshSpec(fsdp=8)`` on 8 virtual CPU devices; 2^16 rows fit one
card many times over, and FSDP2 over gloo on a shared card is not a path
the port takes (ROADMAP "The card").
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

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_linear")


def experiment_fn():
    import numpy as np

    from tf_yarn_tpu_torch import Estimator, EvalSpec, ExperimentSpec, TrainSpec
    from tf_yarn_tpu_torch.models import common
    from tf_yarn_tpu_torch.models.linear import (HashedLinearClassifier,
                                                 LinearConfig)

    config = LinearConfig(n_buckets=2**16, n_features=26)
    rng = np.random.RandomState(0)
    hot = rng.randint(0, config.n_buckets, 128)

    def batches(seed):
        r = np.random.RandomState(seed)
        while True:
            x = r.randint(0, config.n_buckets, (512, config.n_features))
            y = (np.isin(x, hot).sum(axis=1) > 0).astype(np.int32)
            yield {"x": x.astype(np.int32), "y": y}

    estimator = Estimator(
        model=None,
        loss_fn=common.binary_logistic_loss,
        optimizer=common.adagrad(0.1),
        model_dir=MODEL_DIR,
        init_fn=lambda device, seed: HashedLinearClassifier(config, device),
    )
    return ExperimentSpec(
        estimator=estimator,
        train_spec=TrainSpec(input_fn=lambda: batches(0), max_steps=100),
        eval_spec=EvalSpec(input_fn=lambda: batches(1), steps=5),
    )


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn, {"worker": TaskSpec(instances=1)}, name="linear_clf"
    )
    print("run metrics:", metrics)
