"""KV-store key and environment names — a copy of
tf_yarn_tpu/constants.py.

The keys and the ``TPU_YARN_*`` variable names are the contract between
the driver and every task program; they stay the JAX package's, so both
packages speak the same KV and event protocol.
"""

# JSON list of "type:id" strings for all tasks that belong to the training
# cluster proper (evaluator/tensorboard excluded, like the reference's
# KV_CLUSTER_INSTANCES written at client.py:170-176).
KV_CLUSTER_INSTANCES = "cluster_instances"

# cloudpickled experiment function posted by the driver
# (reference: client.py:536, read back at _task_commons.py:55-63).
KV_EXPERIMENT_FN = "experiment_fn"

# JSON-serialized mesh / parallelism spec for the run (the JAX package's
# name; the port's experiment carries its `parallel.mesh.MeshSpec`).
KV_MESH_SPEC = "mesh_spec"

# Retry counter exported to every task so metric keys from different
# attempts are distinguishable (reference: TF_YARN_N_TRY, client.py:119).
ENV_N_TRY = "TPU_YARN_N_TRY"

# Identity of a task process: "type:id" (the reference derives identity
# from SKEIN_CONTAINER_ID, _task_commons.py:70-72; we set it explicitly).
ENV_TASK_KEY = "TPU_YARN_TASK"

# host:port of the coordination (KV/event) service.
ENV_COORDINATOR = "TPU_YARN_COORDINATOR"

# Directory where the task runtime writes its log file (harvested by the
# driver like YARN log URLs, reference: _task_commons.py:26-34).
ENV_LOG_DIR = "TPU_YARN_LOG_DIR"

# Number of processes spawned per host for the task (reference:
# nb_proc_per_worker, topologies.py:54-94).
ENV_NB_PROC = "TPU_YARN_NB_PROC"

# Elastic relaunch (resilience.elastic / docs/Resilience.md): set by the
# driver when an attempt was resized after a capacity failure. WORKERS is
# the worker count this attempt runs with, MAX the full-capacity count —
# the train loop refits the declared mesh onto the devices it actually
# has when these disagree (mesh.resize_mesh_spec) and reports the
# `train/degraded` gauge from the ratio.
ENV_ELASTIC_WORKERS = "TPU_YARN_ELASTIC_WORKERS"
ENV_ELASTIC_MAX_WORKERS = "TPU_YARN_ELASTIC_MAX_WORKERS"


def elastic_env_vars(task_type: str) -> tuple:
    """(count var, max var) the driver sets for a resized task type.

    'worker' keeps the legacy names above — train loops already read
    them — and every other elastic task type (``serving``, ``rank``:
    the fleet autoscaler's relaunch path) gets a derived pair, e.g.
    ``TPU_YARN_ELASTIC_SERVING`` / ``TPU_YARN_ELASTIC_MAX_SERVING``.
    """
    if task_type == "worker":
        return ENV_ELASTIC_WORKERS, ENV_ELASTIC_MAX_WORKERS
    suffix = task_type.upper().replace("-", "_")
    return (
        f"TPU_YARN_ELASTIC_{suffix}",
        f"TPU_YARN_ELASTIC_MAX_{suffix}",
    )
