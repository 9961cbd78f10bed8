"""The port's worker-host discovery and coordinator address held against
the JAX package's (tests/test_discovery.py): the same environments, GCE
metadata and `gcloud` fakes give the same hosts in the same order. Every
test here fakes the metadata server (autouse), so nothing is ever asked
of the network."""

import json
import subprocess
from unittest import mock

import pytest

from tf_yarn_tpu import discovery as j_discovery
from tf_yarn_tpu_torch import client as t_client
from tf_yarn_tpu_torch import discovery as t_discovery
from tf_yarn_tpu_torch.backends import GpuHost, LocalBackend, SshBackend

AMBIENT = (j_discovery.ENV_WORKER_HOSTS, "TPU_PROCESS_ADDRESSES",
           "TPU_WORKER_HOSTNAMES")


@pytest.fixture(autouse=True)
def metadata(monkeypatch):
    """A fake GCE metadata server for both packages: {key: value}."""
    served = {}
    for var in AMBIENT:
        monkeypatch.delenv(var, raising=False)
    for module in (j_discovery, t_discovery):
        monkeypatch.setattr(module, "_get_metadata",
                            lambda key, timeout=2.0: served.get(key))
    return served


def _hosts(module, *args, **kwargs):
    found = (module.discover_gpu_hosts if module is t_discovery
             else module.discover_tpu_vm_hosts)(*args, **kwargs)
    return [(h.hostname, h.worker_index) for h in found]


SCENARIOS = {
    "env_override": ({j_discovery.ENV_WORKER_HOSTS:
                      "10.0.0.1, 10.0.0.2,10.0.0.3"}, {}),
    "env_override_with_ports": ({j_discovery.ENV_WORKER_HOSTS:
                                 "h-0:22,h-1:22"}, {}),
    "env_beats_metadata": ({j_discovery.ENV_WORKER_HOSTS: "a,b"},
                           {"worker-network-endpoints": "v:0:10.0.0.9"}),
    "gke_hostnames": ({"TPU_WORKER_HOSTNAMES": "t-0.ns,t-1.ns"}, {}),
    "gke_addresses": ({"TPU_PROCESS_ADDRESSES": "10.1.0.1:8476,10.1.0.2:8476"},
                      {}),
    "metadata_beats_ambient": ({"TPU_PROCESS_ADDRESSES": "localhost:8476"},
                               {"worker-network-endpoints": "v:0:10.0.0.9"}),
    "metadata": ({}, {"worker-network-endpoints":
                      "v2-8:0:10.164.0.2,v2-8:1:10.164.0.3"}),
    "metadata_short_entries": ({}, {"worker-network-endpoints":
                                    "v:0,v:1:10.2.0.1,v:2:"}),
}


@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_discovered_hosts_equal_jax(case, metadata, monkeypatch):
    env, served = SCENARIOS[case]
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    metadata.update(served)
    port = _hosts(t_discovery)
    assert port == _hosts(j_discovery)
    assert [index for _, index in port] == list(range(len(port)))


def test_hosts_from_gcloud_equal_jax(monkeypatch):
    payload = {"networkEndpoints": [
        {"ipAddress": "10.0.1.1"}, {"ipAddress": "10.0.1.2"}, {},
    ]}
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        result = mock.Mock()
        result.stdout = json.dumps(payload).encode()
        return result

    monkeypatch.setattr(subprocess, "run", fake_run)
    port = _hosts(t_discovery, "my-tpu", zone="us-central2-b", project="p")
    assert port == _hosts(j_discovery, "my-tpu", zone="us-central2-b",
                          project="p")
    assert port == [("10.0.1.1", 0), ("10.0.1.2", 1)]
    assert calls[0] == calls[1] == [
        "gcloud", "compute", "tpus", "tpu-vm", "describe", "my-tpu",
        "--format", "json", "--zone", "us-central2-b", "--project", "p"]


def test_gcloud_failure_and_exhausted_sources_raise(monkeypatch):
    def failing(cmd, **kwargs):
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(subprocess, "run", failing)
    for module in (t_discovery, j_discovery):
        with pytest.raises(RuntimeError, match="TPU_YARN_WORKER_HOSTS"):
            _hosts(module)
        with pytest.raises(RuntimeError, match="tpu_name"):
            _hosts(module, "gone-tpu")


def test_advertise_explicit_hostport():
    backend = SshBackend(hosts=[GpuHost("h", 0)])
    assert t_client._advertised_endpoint(
        "127.0.0.1:9000", backend, "10.1.2.3:1234") == "10.1.2.3:1234"
    # A bare host keeps the server's port.
    assert t_client._advertised_endpoint(
        "0.0.0.0:9000", backend, "127.0.0.1") == "127.0.0.1:9000"


def test_advertise_remote_loopback_rewritten(monkeypatch):
    monkeypatch.setattr(t_client, "_routable_host", lambda: "10.9.8.7")
    backend = SshBackend(hosts=[GpuHost("h", 0)])
    assert t_client._advertised_endpoint(
        "0.0.0.0:9000", backend, None) == "10.9.8.7:9000"
    assert t_client._advertised_endpoint(
        "127.0.0.1:9000", backend, None) == "10.9.8.7:9000"
    # An explicitly routable bind passes through untouched.
    assert t_client._advertised_endpoint(
        "10.0.0.5:9000", backend, None) == "10.0.0.5:9000"
    assert t_client._advertised_endpoint(
        "127.0.0.1:9000", LocalBackend(), None) == "127.0.0.1:9000"
    assert (SshBackend.is_remote, LocalBackend.is_remote,
            t_client.SliceBackend.is_remote) == (True, False, True)


def test_ssh_backend_resolves_hosts_via_discovery(monkeypatch):
    monkeypatch.setenv(t_discovery.ENV_WORKER_HOSTS, "a,b,c")
    backend = SshBackend()  # no hosts given
    assert [h.hostname for h in backend._resolve_hosts()] == ["a", "b", "c"]
    backend._last_assignment = {"worker:1": "b", "chief:0": "a"}
    backend.note_lost_tasks(["worker:1", "evaluator:0"])
    assert backend.dead_hosts == ["b"]
    assert [h.hostname for h in backend._resolve_hosts()] == ["a", "c"]
    backend.note_lost_tasks(["chief:0"])
    backend._dead_hosts.add("c")
    with pytest.raises(RuntimeError, match="blacklisted"):
        backend._resolve_hosts()
