"""The port's deployment: ``deploy_torch/``, ``docker_torch/`` and
``deploy_torch.sh``.

The counterparts of ``tests/test_deploy.py``'s 8 cases on the port's files,
then what ties the manifests to the port: every env name they set is one
that ``gpumounter_tpu_torch/config.py`` reads (or one of the NVIDIA
runtime's two), the worker pods carry the label the master selects, the pool
namespace is the config's, the worker tolerates ``nvidia.com/gpu`` and books
none, the sharded replicas advertise their names under the headless service,
each image copies the port alone and its entry module imports, the worker's
build stage compiles the native layer as the port builds it, and the
daemons' builders serve an add and a remove with torch and numpy blocked:
the images' contents suffice.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

import yaml

from gpumounter_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy_torch")
DOCKER = os.path.join(REPO, "docker_torch")
#: what the NVIDIA container runtime reads, beside the port's config
NVIDIA_RUNTIME_ENV = {"NVIDIA_VISIBLE_DEVICES", "NVIDIA_DRIVER_CAPABILITIES"}
ENTRY_MODULES = {"master": "gpumounter_tpu_torch.master.main",
                 "worker": "gpumounter_tpu_torch.worker.main"}


def _load(name):
    with open(os.path.join(DEPLOY, name)) as f:
        return list(yaml.safe_load_all(f))


def _one(name, kind):
    (doc,) = [d for d in _load(name) if d["kind"] == kind]
    return doc


def _containers():
    """(file, container) for every container of every workload manifest."""
    for name in sorted(os.listdir(DEPLOY)):
        for doc in _load(name):
            spec = doc.get("spec", {}).get("template", {}).get("spec", {})
            for container in spec.get("containers", []):
                yield name, container


def _config_line(field: str) -> str:
    """The line of config.py that declares `field`."""
    with open(os.path.join(REPO, "gpumounter_tpu_torch", "config.py")) as f:
        (line,) = [line for line in f if line.lstrip().startswith(f"{field}:")]
    return line


def _config_env_names() -> set[str]:
    with open(os.path.join(REPO, "gpumounter_tpu_torch", "config.py")) as f:
        return set(re.findall(r'_env\(\s*"([A-Z0-9_]+)"', f.read()))


# --- the counterparts of tests/test_deploy.py ---

def test_all_manifests_parse():
    for name in os.listdir(DEPLOY):
        docs = _load(name)
        assert docs, name
        for doc in docs:
            assert doc.get("apiVersion") and doc.get("kind"), (name, doc)


def test_worker_daemonset_privileges():
    (ds,) = _load("worker-daemonset.yaml")
    spec = ds["spec"]["template"]["spec"]
    assert spec["hostPID"] is True
    container = spec["containers"][0]
    assert container["securityContext"]["privileged"] is True
    mounts = {m["mountPath"] for m in container["volumeMounts"]}
    env = {e["name"]: e.get("value") for e in container["env"]}
    assert {"/sys/fs/cgroup", "/var/lib/kubelet/pod-resources", "/dev",
            env["TPUMOUNTER_LEDGER_DIR"]} <= mounts
    assert spec["nodeSelector"] == {"gpu-mounter-enable": "enable"}


def test_rbac_not_cluster_admin():
    docs = _load("rbac.yaml")
    for doc in docs:
        if doc["kind"] == "ClusterRoleBinding":
            assert doc["roleRef"]["name"] != "cluster-admin"
    kinds = {d["kind"] for d in docs}
    assert {"ServiceAccount", "ClusterRole", "ClusterRoleBinding", "Role",
            "RoleBinding"} <= kinds


def test_pool_namespace_matches_config():
    (ns,) = _load("namespace.yaml")
    assert ns["metadata"]["name"] == Config().pool_namespace == "gpu-pool"
    slave_role = next(d for d in _load("rbac.yaml")
                      if d["kind"] == "Role" and d["metadata"]["name"].endswith("slave-pods"))
    assert slave_role["metadata"]["namespace"] == Config().pool_namespace


def test_master_service_port_mapping():
    (svc,) = _load("service.yaml")
    port = svc["spec"]["ports"][0]
    assert (port["port"], port["targetPort"]) == (80, Config().master_port)
    master = _one("master-deployment.yaml", "Deployment")
    assert svc["spec"]["selector"].items() <= master["spec"]["template"]["metadata"][
        "labels"].items()


def test_deploy_sh_usage():
    proc = subprocess.run([os.path.join(REPO, "deploy_torch.sh")],
                          capture_output=True, text=True)
    assert proc.returncode == 2
    assert "deploy|redeploy|uninstall" in proc.stderr
    with open(os.path.join(REPO, "deploy_torch.sh")) as f:
        script = f.read()
    assert "kubectl label node <node> gpu-mounter-enable=enable" in script
    for manifest in re.findall(r"deploy_torch/[\w.-]+\.yaml", script):
        assert os.path.exists(os.path.join(REPO, manifest)), manifest


def test_sharded_master_statefulset():
    """Stable StatefulSet identity, shard count == replicas, a replica id
    from the pod's name, an advertise URL for redirects declared after the
    variable it substitutes."""
    sts = _one("master-statefulset-sharded.yaml", "StatefulSet")
    spec = sts["spec"]
    container = spec["template"]["spec"]["containers"][0]
    env = {e["name"]: e for e in container["env"]}
    assert int(env["TPUMOUNTER_SHARD_COUNT"]["value"]) == spec["replicas"]
    assert env["TPUMOUNTER_REPLICA_ID"]["valueFrom"]["fieldRef"][
        "fieldPath"] == "metadata.name"
    assert "TPUMOUNTER_ADVERTISE_URL" in env
    assert int(env["MASTER_HTTP_CONCURRENCY"]["value"]) > 0
    names = [e["name"] for e in container["env"]]
    assert names.index("TPUMOUNTER_REPLICA_ID") < names.index("TPUMOUNTER_ADVERTISE_URL")


def test_rbac_grants_shard_leases():
    docs = _load("rbac.yaml")
    lease_rules = [
        rule
        for doc in docs if doc["kind"] == "Role"
        for rule in doc.get("rules", [])
        if "coordination.k8s.io" in rule.get("apiGroups", [])]
    assert lease_rules, "no Lease RBAC for shard leader election"
    assert {"get", "create", "update"} <= set(lease_rules[0]["verbs"])


# --- what ties the manifests to the port ---

def test_every_env_name_is_one_the_port_reads():
    known = _config_env_names()
    assert {"GPU_RESOURCE_NAME", "TPUMOUNTER_AUTH_TOKEN_FILE", "TPUMOUNTER_LEDGER_DIR",
            "TPUMOUNTER_REPLICA_ID"} <= known  # the parse found the multi-line calls
    seen = set()
    for name, container in _containers():
        for entry in container.get("env", []):
            seen.add(entry["name"])
            assert entry["name"] in known | NVIDIA_RUNTIME_ENV, (name, entry["name"])
            assert not entry["name"].startswith("TPU_"), (name, entry["name"])
    assert NVIDIA_RUNTIME_ENV <= seen


def test_worker_pods_carry_the_label_the_master_selects():
    cfg = Config()
    selector = dict(term.split("=", 1) for term in cfg.worker_label_selector.split(","))
    ds = _one("worker-daemonset.yaml", "DaemonSet")
    assert ds["metadata"]["namespace"] == cfg.worker_namespace
    assert selector.items() <= ds["spec"]["template"]["metadata"]["labels"].items()
    assert ds["spec"]["selector"]["matchLabels"].items() <= \
        ds["spec"]["template"]["metadata"]["labels"].items()


def test_the_worker_tolerates_gpus_and_books_none():
    cfg = Config()
    spec = _one("worker-daemonset.yaml", "DaemonSet")["spec"]["template"]["spec"]
    assert any(t["key"] == cfg.gpu_resource_name and t["operator"] == "Exists"
               for t in spec["tolerations"])
    for container in spec["containers"]:
        resources = container.get("resources", {})
        for part in ("limits", "requests"):
            assert cfg.gpu_resource_name not in resources.get(part, {}), container["name"]
        env = {e["name"]: e.get("value") for e in container["env"]}
        assert env["GPU_RESOURCE_NAME"] == cfg.gpu_resource_name
        assert (env["NVIDIA_VISIBLE_DEVICES"], env["NVIDIA_DRIVER_CAPABILITIES"]) == \
            ("all", "utility")


def test_the_statefulset_advertises_under_its_headless_service():
    sts = _one("master-statefulset-sharded.yaml", "StatefulSet")
    svc = next(d for d in _load("master-statefulset-sharded.yaml")
               if d["kind"] == "Service" and d["metadata"]["name"] == sts["spec"]["serviceName"])
    assert svc["spec"]["clusterIP"] == "None"
    assert svc["spec"]["selector"].items() <= sts["spec"]["template"]["metadata"][
        "labels"].items()
    env = {e["name"]: e.get("value")
           for e in sts["spec"]["template"]["spec"]["containers"][0]["env"]}
    ns = sts["metadata"]["namespace"]
    assert env["TPUMOUNTER_ADVERTISE_URL"] == (
        f"http://$(TPUMOUNTER_REPLICA_ID).{svc['metadata']['name']}.{ns}.svc:"
        f"{Config().master_port}")


def _dockerfile(role: str) -> list[tuple[str, str]]:
    """(instruction, rest) of each line of docker_torch/<role>/Dockerfile."""
    with open(os.path.join(DOCKER, role, "Dockerfile")) as f:
        text = f.read().replace("\\\n", " ")
    return [tuple(line.split(None, 1)) for line in text.splitlines()
            if line.strip() and not line.lstrip().startswith("#")]


def _stages(role: str) -> list[list[tuple[str, str]]]:
    """The Dockerfile's stages, each its lines from its FROM on."""
    stages = []
    for op, rest in _dockerfile(role):
        if op == "FROM":
            stages.append([])
        stages[-1].append((op, rest))
    return stages


def test_each_image_copies_the_port_alone_and_runs_its_daemon():
    """The image's last stage: the port, grpcio and, from the worker's build
    stage only, the native layer's artifacts."""
    for role, module in ENTRY_MODULES.items():
        lines = _stages(role)[-1]
        assert [rest for op, rest in lines if op == "FROM"] == ["python:3.12-slim"]
        assert [rest for op, rest in lines if op == "RUN"] == ["pip install --no-cache-dir grpcio"]
        assert [rest for op, rest in lines if op == "COPY" and not rest.startswith("--from=")
                ] == ["gpumounter_tpu_torch/ gpumounter_tpu_torch/"]
        (entry,) = [rest for op, rest in lines if op == "ENTRYPOINT"]
        assert entry == f'["python", "-m", "{module}"]'
        commands = [c["command"] for _, c in _containers() if c.get("command")
                    and c["command"][-1] == module]
        assert commands and all(c == ["python", "-m", module] for c in commands), role
    for _, container in _containers():
        assert container["command"][-1] in ENTRY_MODULES.values()
    assert len(_stages("master")) == 1


def test_the_worker_image_builds_the_native_layer_from_the_port_sources():
    """The worker's build stage compiles each of the native layer's sources
    with the flags ``native`` builds it with, and the image's env points the
    config's variables at the artifacts the last stage copies."""
    from gpumounter_tpu_torch import native

    build, final = _stages("worker")
    assert build[0] == ("FROM", "python:3.12-slim AS build")
    assert ("COPY", "gpumounter_tpu_torch/native/ native/") in build
    compiles = [cmd.split() for op, rest in build if op == "RUN"
                for cmd in rest.split("&&") if cmd.split()[0] == "g++"]
    built = {}
    for cmd in compiles:
        out = cmd[cmd.index("-o") + 1]
        source = cmd[-1]
        (kind,) = [k for k, a in native.ARTIFACTS.items() if f"native/{a[0]}" == source]
        assert tuple(cmd[1:cmd.index("-o")]) == native.flags(kind), cmd
        built[kind] = out
    assert set(built) == set(native.ARTIFACTS)
    assert {a[0] for a in native.ARTIFACTS.values()} <= set(
        os.listdir(os.path.join(REPO, "gpumounter_tpu_torch", "native")))
    copied = {}
    for op, rest in final:
        if op == "COPY" and rest.startswith("--from=build "):
            src, dest = rest.split()[1:]
            copied[os.path.basename(src)] = os.path.join(dest, os.path.basename(src))
    (env,) = [rest for op, rest in final if op == "ENV"]
    env = dict(pair.split("=", 1) for pair in env.split())
    for kind, artifact in native.ARTIFACTS.items():
        name = re.search(r'_env\("([A-Z_]+)"', _config_line(artifact[4])).group(1)
        assert env[name] == copied[built[kind]], (kind, name)


#: with torch and numpy blocked, as the images hold neither: the worker's
#: gRPC server and ops port from worker.main's builders, the master's app and
#: HTTP server as master.main builds them, over a fake host of 2 GPUs; one
#: add and one remove over HTTP
_BLOCKED_DAEMONS = r'''
import sys
for name in ("torch", "numpy"):
    sys.modules[name] = None
import json, os, tempfile, threading, urllib.parse, urllib.request
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.master import main as master_main
from gpumounter_tpu_torch.rpc.client import WorkerClient
from gpumounter_tpu_torch.testing.cluster import FakeCluster
from gpumounter_tpu_torch.worker import main as worker_main

root = tempfile.mkdtemp()
cfg = Config(auth_mode="token", auth_token="deploy-test-secret")
cluster = FakeCluster.with_fake_gpus(os.path.join(root, "node"), 2, cfg=cfg)
dev = os.path.join(root, "tenant-dev")
os.makedirs(dev)
server = worker_main.build_server(cluster.service(dev, kubelet="grpc", node=cluster.node_name),
                                  address="127.0.0.1:0")
server.start()
cluster.register_worker("10.0.0.1", node=cluster.node_name)
ops = worker_main.serve_ops(0, cfg, host="127.0.0.1")
app = master_main.MasterApp(cluster.kube, cfg=cfg, worker_client_factory=lambda address:
                            WorkerClient(f"127.0.0.1:{server.bound_port}",
                                         token=cfg.auth_token, cfg=cfg))
httpd = master_main.build_http_server(app, port=0, host="127.0.0.1")
threading.Thread(target=httpd.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{httpd.server_address[1]}"


def http(method, path, form=None):
    data = urllib.parse.urlencode(form).encode() if form is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Authorization": f"Bearer {cfg.auth_token}"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read().decode()


pod = cluster.add_target_pod("tenant")
added = http("GET", "/addgpu/namespace/default/pod/tenant/gpu/1/isEntireMount/false")
(uuid,) = [u for u, owner in cluster.assignment.items() if owner is not None]
node = cluster.backend.device_by_uuid(uuid).basename
mounted = node in os.listdir(dev)
removed = http("POST", "/removegpu/namespace/default/pod/tenant/force/false", {"uuids": uuid})
with urllib.request.urlopen(f"http://127.0.0.1:{ops.server_address[1]}/healthz") as resp:
    healthz = resp.read().decode()
httpd.shutdown()
ops.shutdown()
app.close()
server.stop(None)
cluster.stop()
print(json.dumps({"added": added, "mounted": mounted, "removed": removed,
                  "gone": node not in os.listdir(dev), "free": cluster.free_gpu_count(),
                  "healthz": healthz,
                  "blocked": [n for n in ("torch", "numpy") if sys.modules.get(n) is not None]}))
'''


def test_the_daemons_serve_with_torch_and_numpy_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_DAEMONS], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-4000:]
    got = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert got == {"added": [200, "Add GPU Success\n"], "mounted": True,
                   "removed": [200, "Remove 1 GPUs Success\n"], "gone": True, "free": 2,
                   "healthz": "ok\n", "blocked": []}, got
