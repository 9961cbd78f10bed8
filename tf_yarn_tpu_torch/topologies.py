"""Task topology: resource specs, identities, validators and presets —
counterpart of tf_yarn_tpu/topologies.py, counting GPUs.

A :class:`TaskSpec` describes every instance of one task type: how many
hosts (``instances``), the GPUs each contributes (``chips_per_host``, at
most 8: an HGX H100 host) and the Python processes a host runs
(``nb_proc_per_worker``). ``NodeLabel.GPU`` is the reference tf-yarn's
own label, which the JAX package's ``NodeLabel.TPU`` replaced
(tf_yarn_tpu/topologies.py:15). The validators are the JAX package's,
so the same specs get the same verdict in both packages.

Ported presets: `single_server_topology`, `allreduce_topology`,
`serving_topology`, `disaggregated_topology`, `ranking_topology` and the
fleets, `fleet_topology` and `mixed_fleet_topology`, whose CPU ``router``
task (tasks/router.py) fronts the replicas. The slice presets
(`SLICE_TYPES`, `tpu_slice_topology`; ROADMAP.md Queue 1 item 5) are not
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, NamedTuple, Optional

# Per-host caps (the JAX package's, tf_yarn_tpu/topologies.py:26-28);
# an HGX H100 host carries 8 GPUs.
MAX_HOST_MEMORY_GIB = 448
MAX_HOST_VCORES = 224
MAX_CHIPS_PER_HOST = 8

ALL_TASK_TYPES = {
    "chief", "worker", "evaluator", "tensorboard", "serving", "router",
    "rank", "prefill",
}


class NodeLabel(Enum):
    """Placement constraint for a task: CPU side-cars reserve no GPU;
    GPU tasks reserve `chips_per_host` GPUs on each of their hosts."""

    CPU = ""
    GPU = "gpu"


class TaskKey(NamedTuple):
    """Identity of one task instance."""

    type: str
    id: int

    def to_kv_str(self) -> str:
        return f"{self.type}:{self.id}"

    @classmethod
    def from_kv_str(cls, value: str) -> "TaskKey":
        task_type, _, task_id = value.partition(":")
        return cls(task_type, int(task_id))


class TaskInstance(NamedTuple):
    """A TaskKey plus its process count."""

    key: TaskKey
    nb_proc: int

    def to_kv_str(self) -> str:
        return self.key.to_kv_str()


@dataclass
class TaskSpec:
    """Resources for every instance of one task type: ``instances``
    hosts, ``chips_per_host`` GPUs each, ``nb_proc_per_worker`` Python
    processes a host (1 for the worker program: one process drives the
    host's GPU)."""

    memory_gib: int = 16
    vcores: int = 8
    instances: int = 1
    chips_per_host: int = 0
    nb_proc_per_worker: int = 1
    label: NodeLabel = NodeLabel.CPU
    # The tensorboard task's knobs (topologies.py:110-112): the linger
    # after training (negative: the default 30 s), the served directory
    # (default: the experiment's model_dir) and extra CLI arguments.
    tb_termination_timeout_seconds: int = -1
    tb_model_dir: Optional[str] = None
    tb_extra_args: Optional[str] = None

    def __post_init__(self) -> None:
        if self.memory_gib > MAX_HOST_MEMORY_GIB:
            raise ValueError(
                f"memory_gib={self.memory_gib} exceeds host cap {MAX_HOST_MEMORY_GIB}"
            )
        if self.vcores > MAX_HOST_VCORES:
            raise ValueError(
                f"vcores={self.vcores} exceeds host cap {MAX_HOST_VCORES}"
            )
        if not 0 <= self.chips_per_host <= MAX_CHIPS_PER_HOST:
            raise ValueError(
                f"chips_per_host={self.chips_per_host} outside [0, {MAX_CHIPS_PER_HOST}]"
            )
        if self.label is NodeLabel.GPU and self.chips_per_host == 0:
            raise ValueError("GPU-labelled tasks must reserve at least one GPU")
        if self.label is NodeLabel.CPU and self.chips_per_host > 0:
            raise ValueError("CPU-labelled tasks cannot reserve GPUs")
        if self.instances < 0 or self.nb_proc_per_worker < 1:
            raise ValueError("instances must be >= 0 and nb_proc_per_worker >= 1")

    @property
    def total_chips(self) -> int:
        return self.instances * self.chips_per_host


TaskSpecs = Dict[str, TaskSpec]


def _check_general_topology(task_specs: TaskSpecs) -> None:
    """Structural validation (tf_yarn_tpu/topologies.py:121): worker-only
    topologies are valid, rank 0 of the lowest-ordered task type acts as
    chief."""
    unknown = set(task_specs) - ALL_TASK_TYPES
    if unknown:
        raise ValueError(
            f"unknown task types {sorted(unknown)}; expected a subset of "
            f"{sorted(ALL_TASK_TYPES)} (note: there is no 'ps' task — "
            "optimizer state is sharded over the mesh instead)"
        )
    if "chief" in task_specs and task_specs["chief"].instances > 1:
        raise ValueError("at most one chief is allowed")
    if not any(
        t in task_specs and task_specs[t].instances > 0
        for t in ("chief", "worker", "serving", "rank")
    ):
        raise ValueError(
            "need at least one chief, worker, serving, or rank instance"
        )
    for task_type in ("evaluator", "tensorboard"):
        if task_type in task_specs and task_specs[task_type].instances > 1:
            raise ValueError(f"at most one {task_type} is allowed")
        if task_type in task_specs and task_specs[task_type].label is NodeLabel.GPU:
            raise ValueError(f"{task_type} is a CPU side-car; it cannot reserve GPUs")
    if "router" in task_specs:
        router = task_specs["router"]
        if router.label is NodeLabel.GPU:
            raise ValueError(
                "router is a CPU frontend; it cannot reserve GPUs"
            )
        n_upstream = sum(
            task_specs[t].instances
            for t in ("serving", "rank") if t in task_specs
        )
        if router.instances > 0 and n_upstream < 1:
            raise ValueError(
                "a router task needs at least one serving or rank replica "
                "to route to — add a 'serving' or 'rank' spec with "
                "instances >= 1"
            )
    if "prefill" in task_specs and task_specs["prefill"].instances > 0:
        # A prefill tier's output is KV blocks pulled by decode replicas,
        # never client responses.
        if task_specs.get("serving", TaskSpec(instances=0)).instances < 1:
            raise ValueError(
                "a prefill tier needs at least one serving (decode) "
                "replica to consume its KV blocks — add a 'serving' "
                "spec with instances >= 1"
            )


def check_topology(task_specs: TaskSpecs) -> None:
    _check_general_topology(task_specs)


def compute_nb_hosts(task_specs: TaskSpecs) -> int:
    return sum(spec.instances for spec in task_specs.values())


def compute_nb_chips(task_specs: TaskSpecs) -> int:
    """GPUs the topology reserves."""
    return sum(spec.total_chips for spec in task_specs.values())


def single_server_topology(
    memory_gib: int = 32, vcores: int = 16, chips: int = 1
) -> TaskSpecs:
    """One chief driving `chips` local GPUs."""
    specs = {
        "chief": TaskSpec(
            memory_gib=memory_gib,
            vcores=vcores,
            instances=1,
            chips_per_host=chips,
            label=NodeLabel.GPU,
        )
    }
    check_topology(specs)
    return specs


def allreduce_topology(
    nb_workers: int = 2,
    memory_gib: int = 32,
    vcores: int = 16,
    chips_per_host: int = 4,
    with_evaluator: bool = False,
) -> TaskSpecs:
    """Synchronous data parallelism: a chief and `nb_workers` workers,
    each host `chips_per_host` GPUs (the JAX package's preset)."""
    specs: TaskSpecs = {
        "chief": TaskSpec(
            memory_gib=memory_gib,
            vcores=vcores,
            instances=1,
            chips_per_host=chips_per_host,
            label=NodeLabel.GPU,
        ),
        "worker": TaskSpec(
            memory_gib=memory_gib,
            vcores=vcores,
            instances=nb_workers,
            chips_per_host=chips_per_host,
            label=NodeLabel.GPU,
        ),
    }
    if with_evaluator:
        specs["evaluator"] = TaskSpec(
            memory_gib=memory_gib, vcores=vcores, instances=1, label=NodeLabel.CPU
        )
    check_topology(specs)
    return specs


def serving_topology(
    instances: int = 1,
    memory_gib: int = 32,
    vcores: int = 16,
    chips_per_host: int = 1,
) -> TaskSpecs:
    """`instances` independent online-serving replicas, each driving
    `chips_per_host` local GPUs. Each restores the checkpoint, serves its
    own slot grid and advertises its endpoint through the KV store."""
    if instances < 1:
        raise ValueError(f"instances must be >= 1, got {instances}")
    specs: TaskSpecs = {
        "serving": TaskSpec(
            memory_gib=memory_gib,
            vcores=vcores,
            instances=instances,
            chips_per_host=chips_per_host,
            label=NodeLabel.GPU if chips_per_host else NodeLabel.CPU,
        )
    }
    check_topology(specs)
    return specs


def fleet_topology(
    nb_replicas: int = 2,
    memory_gib: int = 32,
    vcores: int = 16,
    chips_per_host: int = 1,
    router_memory_gib: int = 8,
    router_vcores: int = 4,
) -> TaskSpecs:
    """A serving fleet: one CPU ``router`` frontend balancing
    ``/v1/generate`` over `nb_replicas` serving replicas, each exactly as
    `serving_topology` makes it. The router finds them through their KV
    ``serving_endpoint`` advertisements and ejects unhealthy or draining
    ones; clients dial its one endpoint (``{task}/router_endpoint``)."""
    specs = serving_topology(
        instances=nb_replicas,
        memory_gib=memory_gib,
        vcores=vcores,
        chips_per_host=chips_per_host,
    )
    specs["router"] = TaskSpec(
        memory_gib=router_memory_gib,
        vcores=router_vcores,
        instances=1,
        label=NodeLabel.CPU,
    )
    check_topology(specs)
    return specs


def disaggregated_topology(
    n_prefill: int = 1,
    n_decode: int = 1,
    memory_gib: int = 32,
    vcores: int = 16,
    decode_chips_per_host: int = 1,
    prefill_chips_per_host: int = 1,
    prefill_memory_gib: Optional[int] = None,
) -> TaskSpecs:
    """Disaggregated serving: `n_prefill` prefill replicas feeding
    `n_decode` decode replicas over the KV block wire. Prefill replicas
    advertise ``{task}/prefill_endpoint``; decode replicas find them in
    the KV store and pull, and with no prefill replica they prefill
    locally. The two pools size independently."""
    if n_prefill < 0 or n_decode < 1:
        raise ValueError(
            f"need n_decode >= 1 and n_prefill >= 0, got "
            f"n_prefill={n_prefill}, n_decode={n_decode}"
        )
    specs = serving_topology(
        instances=n_decode,
        memory_gib=memory_gib,
        vcores=vcores,
        chips_per_host=decode_chips_per_host,
    )
    if n_prefill:
        specs["prefill"] = TaskSpec(
            memory_gib=(prefill_memory_gib if prefill_memory_gib
                        is not None else memory_gib),
            vcores=vcores,
            instances=n_prefill,
            chips_per_host=prefill_chips_per_host,
            label=NodeLabel.GPU if prefill_chips_per_host
            else NodeLabel.CPU,
        )
    check_topology(specs)
    return specs


def ranking_topology(
    instances: int = 1,
    memory_gib: int = 32,
    vcores: int = 16,
    chips_per_host: int = 1,
) -> TaskSpecs:
    """`instances` independent online-ranking replicas, each loading the
    model, ticking its micro-batch loop and advertising a
    ``rank_endpoint`` through the KV store."""
    if instances < 1:
        raise ValueError(f"instances must be >= 1, got {instances}")
    specs: TaskSpecs = {
        "rank": TaskSpec(
            memory_gib=memory_gib,
            vcores=vcores,
            instances=instances,
            chips_per_host=chips_per_host,
            label=NodeLabel.GPU if chips_per_host else NodeLabel.CPU,
        )
    }
    check_topology(specs)
    return specs


def mixed_fleet_topology(
    nb_serving: int = 1,
    nb_rank: int = 1,
    memory_gib: int = 32,
    vcores: int = 16,
    chips_per_host: int = 1,
    router_memory_gib: int = 8,
    router_vcores: int = 4,
) -> TaskSpecs:
    """A mixed fleet: one router dispatching by path, ``/v1/generate`` to
    decode replicas and ``/v1/rank`` to ranking replicas. The registry
    knows each replica's kind from the KV key it advertised under, so a
    rank request never lands on a generate replica."""
    if nb_serving < 1 or nb_rank < 1:
        raise ValueError(
            f"need at least one replica of each kind, got "
            f"nb_serving={nb_serving}, nb_rank={nb_rank}"
        )
    specs = serving_topology(
        instances=nb_serving,
        memory_gib=memory_gib,
        vcores=vcores,
        chips_per_host=chips_per_host,
    )
    specs.update(ranking_topology(
        instances=nb_rank,
        memory_gib=memory_gib,
        vcores=vcores,
        chips_per_host=chips_per_host,
    ))
    specs["router"] = TaskSpec(
        memory_gib=router_memory_gib,
        vcores=router_vcores,
        instances=1,
        label=NodeLabel.CPU,
    )
    check_topology(specs)
    return specs
