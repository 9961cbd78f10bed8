"""Worker-host discovery for `SshBackend` — counterpart of
tf_yarn_tpu/discovery.py.

Placement means *finding* the machines a run's tasks go to. The sources,
in the JAX package's priority order:

1. ``TPU_YARN_WORKER_HOSTS`` env — an explicit comma-separated host list
   (the deliberate operator override; the port keeps the JAX package's
   ``TPU_YARN_*`` names).
2. GCE metadata of the current VM — ``worker-network-endpoints`` (every
   worker's IP as the third ``:``-field).
3. Ambient ``TPU_PROCESS_ADDRESSES``/``TPU_WORKER_HOSTNAMES`` env vars
   (ranked below metadata because some images pre-set localhost
   placeholders).
4. ``gcloud compute tpus tpu-vm describe`` — a driver outside the slice.

Returns :class:`tf_yarn_tpu_torch.backends.GpuHost` entries ordered by
worker index (worker 0 = the chief's host).
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
from typing import List, Optional

_logger = logging.getLogger(__name__)

ENV_WORKER_HOSTS = "TPU_YARN_WORKER_HOSTS"
_METADATA_HOST = "metadata.google.internal"
_METADATA_URL = (
    "http://{host}/computeMetadata/v1/instance/attributes/{key}"
)


def _get_metadata(key: str, timeout: float = 2.0) -> Optional[str]:
    """One GCE metadata attribute, or None off-GCP (fast timeout)."""
    import urllib.error
    import urllib.request

    host = os.environ.get("GCE_METADATA_IP", _METADATA_HOST)
    request = urllib.request.Request(
        _METADATA_URL.format(host=host, key=key),
        headers={"Metadata-Flavor": "Google"},
    )
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            if resp.status == 200:
                return resp.read().decode()
    except (urllib.error.URLError, OSError, TimeoutError) as exc:
        _logger.debug("metadata %s unavailable: %s", key, exc)
    return None


def _hosts_from_vars(*variables: str) -> Optional[List[str]]:
    for var in variables:
        raw = os.environ.get(var)
        if raw:
            hosts = [h.strip().split(":")[0] for h in raw.split(",") if h.strip()]
            if hosts:
                _logger.info("worker hosts from %s: %s", var, hosts)
                return hosts
    return None


def _hosts_from_env() -> Optional[List[str]]:
    """The deliberate operator override only. Ambient libtpu/GKE vars
    (TPU_PROCESS_ADDRESSES/TPU_WORKER_HOSTNAMES) rank *below* metadata —
    images pre-set them to localhost-ish values."""
    return _hosts_from_vars(ENV_WORKER_HOSTS)


def _hosts_from_ambient_env() -> Optional[List[str]]:
    return _hosts_from_vars("TPU_PROCESS_ADDRESSES", "TPU_WORKER_HOSTNAMES")


def _hosts_from_metadata() -> Optional[List[str]]:
    raw = _get_metadata("worker-network-endpoints")
    if not raw:
        return None
    hosts = []
    for entry in raw.split(","):
        fields = entry.split(":")
        # "<version>:<worker-id>:<ip>..." — IP is the third field (the
        # parse the JAX package and jax itself apply).
        if len(fields) >= 3 and fields[2]:
            hosts.append(fields[2])
    if hosts:
        _logger.info("worker hosts from metadata: %s", hosts)
    return hosts or None


def _hosts_from_gcloud(
    tpu_name: str, zone: Optional[str], project: Optional[str]
) -> Optional[List[str]]:
    cmd = [
        "gcloud", "compute", "tpus", "tpu-vm", "describe", tpu_name,
        "--format", "json",
    ]
    if zone:
        cmd += ["--zone", zone]
    if project:
        cmd += ["--project", project]
    try:
        out = subprocess.run(
            cmd, capture_output=True, check=True, timeout=60
        ).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        _logger.debug("gcloud describe failed: %s", exc)
        return None
    endpoints = json.loads(out).get("networkEndpoints", [])
    hosts = [e.get("ipAddress") for e in endpoints if e.get("ipAddress")]
    if hosts:
        _logger.info("worker hosts from gcloud %s: %s", tpu_name, hosts)
    return hosts or None


def discover_gpu_hosts(
    tpu_name: Optional[str] = None,
    zone: Optional[str] = None,
    project: Optional[str] = None,
):
    """All worker hosts as GpuHost, index order (`discover_tpu_vm_hosts`
    of the JAX package)."""
    from tf_yarn_tpu_torch.backends import GpuHost

    hosts = _hosts_from_env() or _hosts_from_metadata() or _hosts_from_ambient_env()
    if hosts is None and tpu_name:
        hosts = _hosts_from_gcloud(tpu_name, zone, project)
    if not hosts:
        raise RuntimeError(
            "cannot discover worker hosts: set TPU_YARN_WORKER_HOSTS, run "
            "on a GCE VM (metadata), or pass tpu_name for gcloud lookup"
        )
    return [GpuHost(host, index) for index, host in enumerate(hosts)]
