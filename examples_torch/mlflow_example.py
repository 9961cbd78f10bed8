"""MLflow end to end, with a post-run assertion that the metrics landed
— the port's counterpart of examples/mlflow_example.py.

Configures a file-backed MLflow tracking store, trains a small dense
classifier through `run_on_gpu` in one launched worker, then reads the
run back through `MlflowClient` and asserts the training metrics were
recorded.

    python examples_torch/mlflow_example.py

Without the `mlflow` package (neither the CPU test machine nor the card's
image has it) the port's `utils.mlflow` shim makes every call a no-op:
the run still completes, and the script says why it could not assert.

Mesh: one rank on one card. The JAX example shards the model over
``MeshSpec(fsdp=8)`` on 8 virtual CPU devices; one card holds it whole,
and FSDP2 over gloo on a shared card is not a path the port takes
(ROADMAP "The card").
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

MODEL_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_mlflow_example")
TRACKING_DIR = os.path.join(tempfile.gettempdir(), "gpu_yarn_mlflow_store")


def experiment_fn():
    import numpy as np

    from tf_yarn_tpu_torch import TorchExperiment, TrainParams
    from tf_yarn_tpu_torch.models import common, mnist

    rng = np.random.RandomState(0)

    def batches():
        while True:
            yield {
                "x": rng.randn(64, 784).astype(np.float32),
                "y": rng.randint(0, 10, 64).astype(np.int32),
            }

    return TorchExperiment(
        model=None,
        init_fn=lambda device, seed: mnist.make_model(seed=seed,
                                                      device=device),
        model_dir=MODEL_DIR,
        train_params=TrainParams(
            train_steps=40, checkpoint_every_steps=20, log_every_steps=10
        ),
        train_input_fn=batches,
        optimizer=mnist.adam(1e-3),
        loss_fn=common.classification_loss,
    )


def main() -> None:
    try:
        import mlflow
    except ImportError:
        mlflow = None
        print("mlflow not installed: running with the no-op shim "
              "(no post-run assertion possible)")

    run_id = None
    if mlflow is not None:
        mlflow.set_tracking_uri(f"file://{TRACKING_DIR}")
        mlflow.set_experiment("gpu_yarn_mlflow_example")
        run = mlflow.start_run()
        run_id = run.info.run_id

    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    shutil.rmtree(MODEL_DIR, ignore_errors=True)  # a fresh run
    metrics = run_on_gpu(
        experiment_fn,
        {"worker": TaskSpec(instances=1)},
        name="mlflow_example",
    )
    print("run metrics:", metrics)

    if mlflow is None:
        return
    mlflow.end_run()

    # Read the run back out of the tracking store and check that the
    # training metrics landed.
    from mlflow.tracking import MlflowClient

    client = MlflowClient()
    logged = client.get_run(run_id).data.metrics
    print("mlflow metrics:", sorted(logged))
    step_keys = [k for k in logged if k.startswith("steps_per_sec")]
    assert step_keys, f"no steps_per_sec_* metric in mlflow run: {sorted(logged)}"
    history = client.get_metric_history(run_id, step_keys[0])
    assert history, "metric history empty"
    print(f"asserted: {step_keys[0]} logged {len(history)} point(s) "
          f"to {mlflow.get_tracking_uri()}")


if __name__ == "__main__":
    main()
