"""Generic fn-of-rank mode — the port's counterpart of
examples/distributed_fn_example.py.

The experiment is a function receiving `TaskParameters`: no model
plumbing, every process does what it wants with its rank. Two workers of
two processes each make four ranks; each writes its line to a file the
driver reads back.

    python examples_torch/distributed_fn_example.py

Nothing here touches a device, so the run is the same with or without
``EXAMPLE_PLATFORM=cpu``.
"""

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["PYTHONPATH"] = REPO + os.pathsep + os.environ.get("PYTHONPATH", "")
# On the card unless EXAMPLE_PLATFORM=cpu; the launched tasks inherit it.
os.environ["TPU_YARN_PLATFORM"] = os.environ.get("EXAMPLE_PLATFORM", "cuda")


def experiment_fn(out_dir):
    def run(params):
        line = (f"hello from {params.task_type}:{params.task_id} "
                f"rank={params.rank}/{params.world_size} "
                f"master={params.master_addr}:{params.master_port}")
        print(line)
        with open(os.path.join(out_dir, f"rank-{params.rank}"), "w") as fh:
            fh.write(line)

    return run


if __name__ == "__main__":
    from tf_yarn_tpu_torch import TaskSpec, run_on_gpu

    with tempfile.TemporaryDirectory() as out_dir:
        run_on_gpu(
            lambda: experiment_fn(out_dir),
            {"worker": TaskSpec(instances=2, nb_proc_per_worker=2)},
            custom_task_module="tf_yarn_tpu_torch.tasks.distributed",
            name="distributed_fn",
        )
        lines = [open(os.path.join(out_dir, name)).read()
                 for name in sorted(os.listdir(out_dir))]
    for line in lines:
        print(line)
    assert len(lines) == 4, f"expected 4 ranks, got {lines}"
    print("distributed_fn_example OK: 4 ranks ran")
