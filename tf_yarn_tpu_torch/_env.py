"""Task-type -> task-program mapping — tf_yarn_tpu/_env.py with the
modules under ``tf_yarn_tpu_torch.tasks``.

Each task instance runs ``python -m <module>``; `custom_task_module`
keeps the seam for other task programs (``tasks.distributed``). The
worker, distributed, serving, prefill and rank programs exist in the
port; `client.run_on_gpu` refuses the evaluator, tensorboard and router
task types before it launches anything (ROADMAP.md Queue 1 items 4 and
6).
"""

from __future__ import annotations

from typing import Optional

WORKER_MODULE = "tf_yarn_tpu_torch.tasks.worker"
TENSORBOARD_MODULE = "tf_yarn_tpu_torch.tasks.tensorboard"
EVALUATOR_MODULE = "tf_yarn_tpu_torch.tasks.evaluator"
SERVING_MODULE = "tf_yarn_tpu_torch.tasks.serving"
ROUTER_MODULE = "tf_yarn_tpu_torch.tasks.router"
RANK_MODULE = "tf_yarn_tpu_torch.tasks.rank"
PREFILL_MODULE = "tf_yarn_tpu_torch.tasks.prefill"


def gen_task_module(task_type: str, custom_task_module: Optional[str] = None) -> str:
    if task_type == "tensorboard":
        return TENSORBOARD_MODULE
    if task_type == "evaluator":
        return EVALUATOR_MODULE
    if task_type == "serving":
        return custom_task_module or SERVING_MODULE
    if task_type == "router":
        return custom_task_module or ROUTER_MODULE
    if task_type == "rank":
        return custom_task_module or RANK_MODULE
    if task_type == "prefill":
        return custom_task_module or PREFILL_MODULE
    return custom_task_module or WORKER_MODULE
