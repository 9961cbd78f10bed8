"""One rank's preemption flag drains every rank — the port's mirror of the
JAX package's `tests/test_multihost.py::
test_preemption_drain_agreed_across_hosts`.

A chief and a worker are launched (``TPU_YARN_PLATFORM=cpu``: gloo ranks
on the CPU) on the same experiment as the JAX test, with the port's
mnist classifier: 10 steps at ``MeshSpec(dp=2)``, the preemption flag
polled every 3 steps, and one rank flagged once, when it reads its third
batch. Both ranks must drain at the same step on the poll cadence (the
checkpoint there is the first), the attempt is retried as PREEMPTED, and
the retry resumes to step 10.
"""

import os

import pytest

from tf_yarn_tpu_torch import checkpoint as t_ckpt
from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.client import run_on_gpu
from tf_yarn_tpu_torch.topologies import TaskSpec


@pytest.mark.parametrize("flagged", [1, 0])
def test_preemption_drain_agreed_across_ranks(tmp_path, flagged):
    model_dir = str(tmp_path / "model")
    marker = str(tmp_path / "preempted-once")

    def experiment_fn():
        from tf_yarn_tpu_torch.experiment import TorchExperiment, TrainParams
        from tf_yarn_tpu_torch.models import common, mnist
        from tf_yarn_tpu_torch.parallel.mesh import MeshSpec

        def input_fn(start_step=0):
            import os

            import torch.distributed as dist

            from tf_yarn_tpu_torch import preemption

            def gen():
                base = common.synthetic_classification_iter(4, 16, 4)
                n = 0
                for batch in base:
                    n += 1
                    # Only the flagged rank ever sees the "signal", once.
                    if (n == 3 and dist.get_rank() == flagged
                            and not os.path.exists(marker)):
                        open(marker, "w").close()
                        preemption.request()
                    yield batch

            return gen()

        return TorchExperiment(
            model=None,
            init_fn=lambda device, seed: mnist.make_model(16, (16,), 4, seed,
                                                          device),
            optimizer=mnist.adam(1e-2),
            loss_fn=common.classification_loss,
            train_input_fn=input_fn,
            train_params=TrainParams(
                train_steps=10, log_every_steps=2,
                # The drain must land on a multiple of 3: the agreement
                # is cadence-gated, not per step.
                drain_poll_every_steps=3),
            mesh_spec=MeshSpec(dp=2),
            model_dir=model_dir,
        )

    retries = telemetry.get_registry().counter("driver/retries_total",
                                               kind="PREEMPTED")
    before = retries.value
    metrics = run_on_gpu(
        experiment_fn,
        {"chief": TaskSpec(instances=1), "worker": TaskSpec(instances=1)},
        env={"TPU_YARN_PLATFORM": "cpu"},
        nb_retries=1,
        poll_every_secs=0.3,
    )
    assert os.path.exists(marker), "preemption never injected"
    assert metrics.total_training_duration is not None
    assert retries.value - before == 1
    steps = t_ckpt.list_checkpoint_steps(model_dir)
    assert steps[-1] == 10
    # The drain checkpoint sits on the poll cadence, not the flag step.
    assert steps[0] % 3 == 0 and steps[0] < 10, steps
    # Written once, by rank 0: no other tree beside the checkpoints.
    assert sorted(os.listdir(model_dir)) == sorted(
        [f"ckpt-{s}" for s in steps]
        + (["tb"] if os.path.isdir(os.path.join(model_dir, "tb")) else []))
