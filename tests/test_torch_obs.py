"""The trace and audit core, the Events and the log filter, on the reference's
and on the port's, and both threaded through the mount path and the master.

Each case runs one program on both packages and compares what they give,
ids and times masked: the span trees (names, parents, status, attributes),
``parse_wire_context`` on the same strings (garbage too), the ring's
evictions, the JSONL sinks, the audit records and ``query_from_params`` on
the same records and parameters, the Event manifests, the JSON log line. The
mounter's failpoint sites and spans run on both packages' mounters over fake
backends (the reference's ``TPU`` read as ``GPU``); then one scripted add,
remove, failed add and rolled-back slice through both masters and their gRPC
workers (``tests/torch_slice_stacks.py``): HTTP codes, span trees, audit
operations and outcomes, and what stays mounted.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
import urllib.request

import pytest
from conftest import AUTH_HEADER
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture
from torch_slice_stacks import build_stacks, gpu_words

from gpumounter_tpu.config import Config as RefConfig
from gpumounter_tpu.device.backend import FakeDeviceBackend as RefBackend
from gpumounter_tpu.faults import failpoints as ref_failpoints
from gpumounter_tpu.k8s import events as ref_events
from gpumounter_tpu.k8s.fake import FakeKubeClient as RefKube
from gpumounter_tpu.k8s.types import Pod as RefPod
from gpumounter_tpu.obs import audit as ref_audit
from gpumounter_tpu.obs import sinks as ref_sinks
from gpumounter_tpu.obs import trace as ref_trace
from gpumounter_tpu.utils import log as ref_log
from gpumounter_tpu.utils.metrics import MOUNT_ROLLBACK_FAILURES as REF_ROLLBACK_FAILURES
from gpumounter_tpu.worker.mounter import MountTarget as RefTarget
from gpumounter_tpu.worker.mounter import TpuMounter
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import FakeDeviceBackend
from gpumounter_tpu_torch.faults import failpoints
from gpumounter_tpu_torch.k8s import events
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.k8s.types import Pod
from gpumounter_tpu_torch.obs import audit, sinks, trace
from gpumounter_tpu_torch.utils import log
from gpumounter_tpu_torch.utils.metrics import MOUNT_ROLLBACK_FAILURES
from gpumounter_tpu_torch.worker.mounter import GpuMounter, MountTarget

TRACE = {"reference": ref_trace, "port": trace}
AUDIT = {"reference": ref_audit, "port": audit}


def _words(value):
    """The reference's words as the port's, in any nested value."""
    if isinstance(value, str):
        return gpu_words(value).replace("addtpu", "addgpu")
    if isinstance(value, dict):
        return {_words(k): _words(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_words(v) for v in value)
    return value


def _masked_tree(spans: list[dict]) -> list[tuple]:
    """(name, parent's name, status, error type, attrs) of each span in
    start order; ids and times masked."""
    names = {s["span_id"]: s["name"] for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: s["start"]):
        out.append((s["name"], names.get(s["parent_id"], "<root>" if not s["parent_id"]
                                         else "<remote>"),
                    s["status"], s.get("error", "").split(":")[0], s.get("attrs", {})))
    return out


# --- the trace core ---

def _span_program(mod):
    """Nested spans, an error, an injected crash, set_attrs, a thread that
    re-attaches the context, a deferred block published and one dropped, a
    span under a wire parent and one under garbage."""
    fp = ref_failpoints if mod is ref_trace else failpoints
    tracer = mod.Tracer(ring_capacity=64)
    with mod.span("root", tracer=tracer, op="add") as root:
        with mod.span("child", tracer=tracer, n=1):
            mod.set_attrs(pool_hit=1, n=2)
        with pytest.raises(ValueError):
            with mod.span("fails", tracer=tracer):
                raise ValueError("bad")
        with pytest.raises(fp.CrashError):
            with mod.span("crashes", tracer=tracer):
                fp.arm("x", "1*crash(dies)")
                fp.fire("x")
        ctx = mod.current()
        seen = []

        def worker():
            with mod.attached(ctx), mod.span("in-thread", tracer=tracer, node="n1"):
                seen.append(mod.current_trace_id())

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert seen == [root.trace_id] and mod.wire_context().startswith(root.trace_id)
        with mod.deferred(tracer) as kept:
            with mod.span("deferred-kept", tracer=tracer):
                pass
        kept.publish()
        with mod.deferred(tracer):
            with mod.span("deferred-dropped", tracer=tracer):
                pass
        open_inside = tracer.open_spans()
    wire = "0123456789abcdef0123456789abcdef-0123456789abcdef"
    with mod.span("remote-child", tracer=tracer, wire_parent=wire) as remote:
        assert remote.trace_id == wire.split("-")[0]
    with mod.span("garbage-parent", tracer=tracer, wire_parent="not-a-context"):
        pass
    assert mod.wire_context() == "" and mod.current() is None
    return open_inside, tracer.open_spans(), tracer.ring.snapshot()


def test_the_span_tree_is_the_references():
    got = {name: _span_program(mod) for name, mod in TRACE.items()}
    ref_open, ref_after, ref_spans = got["reference"]
    open_inside, after, spans = got["port"]
    assert (open_inside, after) == (ref_open, ref_after) == (["root"], [])
    assert _masked_tree(spans) == _masked_tree(ref_spans)
    assert [s["name"] for s in spans] == [s["name"] for s in ref_spans]  # export order
    assert all(set(s) == set(r) for s, r in zip(spans, ref_spans, strict=True))


WIRE_STRINGS = [
    "0123456789abcdef0123456789abcdef-0123456789abcdef", "0123456789abcdef-01234567",
    "  0123456789abcdef0123456789abcdef-0123456789abcdef  ", "0123456789ABCDEF-01234567",
    "0123456789abcde-01234567", "0123456789abcdef-0123456", "0123456789abcdef0123456789abcdef0-01234567",
    "0123456789abcdef_01234567", "0123456789abcdef-01234567-89", "g123456789abcdef-01234567",
    "", None, 123, b"0123456789abcdef-01234567", ["x"], "-", "garbage", "a" * 4096,
]


@pytest.mark.parametrize("raw", WIRE_STRINGS, ids=range(len(WIRE_STRINGS)))
def test_parse_wire_context_is_the_references(raw):
    got = {name: mod.parse_wire_context(raw) for name, mod in TRACE.items()}
    assert (None if got["port"] is None else (got["port"].trace_id, got["port"].span_id)) == \
        (None if got["reference"] is None
         else (got["reference"].trace_id, got["reference"].span_id))
    assert (trace.TRACE_HEADER, trace.RESPONSE_HEADER) == (ref_trace.TRACE_HEADER,
                                                           ref_trace.RESPONSE_HEADER)


def test_the_ring_evicts_and_counts_as_the_references():
    from gpumounter_tpu.obs.trace import TRACE_RING_EVICTIONS as REF_EVICTIONS
    from gpumounter_tpu_torch.obs.trace import TRACE_RING_EVICTIONS
    got = {}
    for (name, mod), counter in zip(TRACE.items(), (REF_EVICTIONS, TRACE_RING_EVICTIONS),
                                    strict=True):
        tracer = mod.Tracer(ring_capacity=3)
        before = counter.total()
        for i in range(7):
            with mod.span(f"s{i}", tracer=tracer):
                pass
        tid = tracer.ring.snapshot()[-1]["trace_id"]
        payload = mod.trace_payload(tid, tracer)
        got[name] = (counter.total() - before, [s["name"] for s in tracer.ring.snapshot()],
                     [s["name"] for s in tracer.ring.tail(2)], [s["name"] for s in
                                                                payload["spans"]],
                     mod.trace_payload("f" * 32, tracer))
        tracer.ring.set_capacity(1)
        got[name] += ([s["name"] for s in tracer.ring.snapshot()],)
    assert got["port"] == got["reference"]
    assert got["port"][0] == 4


def test_the_jsonl_sinks_write_and_disable_themselves_as_the_references(tmp_path):
    got = {}
    for name, mod in TRACE.items():
        path = tmp_path / f"{name}.jsonl"
        tracer = mod.Tracer()
        tracer.configure_jsonl(str(path))
        with mod.span("a", tracer=tracer, k="v"), mod.span("b", tracer=tracer):
            pass
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        sink_mod = ref_sinks if mod is ref_trace else sinks
        broken = sink_mod.JsonlSink("x", str(tmp_path / "no-such-dir" / "f.jsonl"))
        broken.write({"a": 1})
        broken_after = broken.broken
        broken.configure(str(tmp_path / f"{name}-again.jsonl"))
        broken.write({"a": 1})
        got[name] = (_masked_tree(lines), broken_after, broken.broken,
                     (tmp_path / f"{name}-again.jsonl").read_text())
    assert got["port"] == got["reference"]
    assert got["port"][1:3] == (True, False)


# --- the audit trail ---

def _audit_program(mod, fp):
    log_ = mod.AuditLog(capacity=16)
    tracer_mod = ref_trace if mod is ref_audit else trace
    with mod.audited("worker.AddGPU", actor="rpc", namespace="ns", pod="p",
                     idempotency_key="k1", log=log_) as rec:
        rec["chips"] = ["b", "a"]
        rec["outcome"] = "Success"
    with pytest.raises(KeyError):
        with mod.audited("worker.RemoveGPU", actor="rpc", namespace="ns", pod="p",
                         chips=["a"], log=log_, why="x"):
            raise KeyError("gone")
    with pytest.raises(fp.CrashError):
        with mod.audited("worker.AddGPU", actor="rpc", namespace="ns", pod="q", log=log_):
            fp.arm("c", "1*crash(mid-phase)")
            fp.fire("c")
    with tracer_mod.span("http.add"):
        with mod.audited("http.add", actor="http", namespace="ns", pod="p", log=log_) as rec:
            rec["outcome"] = "http 200"
    log_.record("plain", trace_id="t" * 32, outcome="ok", extra=1)
    for i in range(20):  # past the capacity: the oldest go
        log_.record(f"bulk.{i}", outcome="ok")
    return log_


QUERIES = [{}, {"op": ["worker."]}, {"op": ["http."]}, {"outcome": ["error"]},
           {"outcome": ["Success"], "pod": ["p"]}, {"pod": ["q"]}, {"namespace": ["ns"]},
           {"limit": ["1"]}, {"limit": ["3"], "op": ["bulk."]}, {"op": ["x", "worker."]},
           {"trace": ["t" * 32]}, {"limit": ["0"]}]


def _masked_records(records: list[dict]) -> list[dict]:
    return [{**r, "seq": None, "at": None, "duration_s": None,
             "trace_id": bool(r["trace_id"]) if r["trace_id"] != "t" * 32 else r["trace_id"]}
            for r in records]


def test_the_audit_records_and_queries_are_the_references():
    logs = {"reference": _audit_program(ref_audit, ref_failpoints),
            "port": _audit_program(audit, failpoints)}
    assert _masked_records(logs["port"].snapshot()) == \
        _masked_records(logs["reference"].snapshot())
    for params in QUERIES:
        got = {name: mod.query_from_params(params, logs[name]) for name, mod in AUDIT.items()}
        assert _masked_records(got["port"]["records"]) == \
            _masked_records(got["reference"]["records"]), params
    for mod, log_ in ((ref_audit, logs["reference"]), (audit, logs["port"])):
        with pytest.raises(ValueError):
            mod.query_from_params({"limit": ["many"]}, log_)


def test_configure_sizes_the_stores_from_config(tmp_path):
    cfg = Config(trace_ring_capacity=5, audit_capacity=3, flight_capacity=4,
                 audit_jsonl=str(tmp_path / "audit.jsonl"),
                 trace_jsonl=str(tmp_path / "trace.jsonl"),
                 flight_jsonl=str(tmp_path / "flight.jsonl"))
    ref = RefConfig()
    for key in ("trace_jsonl", "audit_jsonl", "trace_ring_capacity", "audit_capacity",
                "flight_capacity", "flight_jsonl"):
        assert getattr(Config(), key) == getattr(ref, key), key
    from gpumounter_tpu_torch.obs import flight
    trace.configure(cfg)
    audit.configure(cfg)
    flight.configure(cfg)
    flight.install()
    with trace.span("configured"):
        for i in range(5):
            audit.AUDIT.record(f"op{i}", outcome="ok")
    assert len(audit.AUDIT.snapshot()) == 3
    assert len(flight.FLIGHT.snapshot()) == 4
    assert [json.loads(x)["name"] for x in (tmp_path / "trace.jsonl").read_text().splitlines()] \
        == ["configured"]
    assert len((tmp_path / "audit.jsonl").read_text().splitlines()) == 5
    assert len((tmp_path / "flight.jsonl").read_text().splitlines()) == 6
    trace.TRACER.ring.set_capacity(2048)
    audit.AUDIT.set_capacity(4096)
    flight.FLIGHT.set_capacity(4096)


# --- Events and the log line ---

def _pod(mod, name="tenant"):
    return mod({"metadata": {"name": name, "namespace": "ns", "uid": "u-1"}})


class _Down:
    def create_event(self, namespace, manifest):
        raise ConnectionError("API server down")


def test_the_event_manifests_are_the_references():
    from gpumounter_tpu.obs.flight import FLIGHT as REF_FLIGHT
    from gpumounter_tpu_torch.obs.flight import FLIGHT
    got = {}
    for name, ev, kube, pod, flight in (("reference", ref_events, RefKube(), _pod(RefPod),
                                         REF_FLIGHT),
                                        ("port", events, FakeKubeClient(), _pod(Pod), FLIGHT)):
        flight.reset()
        ev.post_pod_event(kube, pod, "GPUMounted", "hot-mounted 1 GPU(s): x")
        ev.post_pod_event(kube, pod, "GPUSliceRollback", "y" * 2000, event_type="Warning",
                          component="tpumounter-master")
        ev.post_pod_event(_Down(), pod, "GPUMountFailed", "z", event_type="Warning")
        manifests = []
        for ns, m in kube.events_posted:
            prefix, _, suffix = m["metadata"]["name"].rpartition(".")
            assert len(suffix) == 8 and m["firstTimestamp"] == m["lastTimestamp"]
            manifests.append((ns, {**m, "metadata": {**m["metadata"], "name": prefix},
                                   "firstTimestamp": None, "lastTimestamp": None}))
        records = [{**r, "seq": None, "at": None} for r in flight.snapshot()]
        got[name] = (manifests, records)
    assert got["port"] == got["reference"]
    assert [r["details"]["posted"] for r in got["port"][1]] == [True, True, False]


def test_the_json_log_line_carries_the_trace_id_as_the_references():
    got = {}
    for name, mod, tr in (("reference", ref_log, ref_trace), ("port", log, trace)):
        formatter, stamp = mod.JsonFormatter(), (ref_log._TraceIdFilter() if mod is ref_log
                                                 else log.TraceIdFilter())
        lines = []
        for inside in (False, True):
            record = logging.LogRecord("gpumounter.x", logging.INFO, __file__, 1, "msg %s",
                                       ("a",), None)
            if inside:
                with tr.span("logged") as ctx:
                    stamp.filter(record)
                    tid = ctx.trace_id
            else:
                stamp.filter(record)
            line = json.loads(formatter.format(record))
            lines.append({**line, "ts": None, "trace_id": line.get("trace_id") == tid
                          if inside else line.get("trace_id")})
        got[name] = lines
    assert got["port"] == got["reference"]
    assert got["port"][1]["trace_id"] is True and got["port"][0]["trace_id"] is None


# --- the mounter's sites and spans ---

class _Mounters:
    """Both packages' mounters over fake backends of `n`, each target a
    directory with a stand-in v1 cgroup, each with a fake kube for Events."""

    def __init__(self, root, n):
        self.sides = {}
        for name, backend_cls, mounter_cls, target_cls, pod_cls, kube, cfg in (
                ("reference", RefBackend, TpuMounter, RefTarget, RefPod, RefKube(),
                 RefConfig().replace(cgroup_version="1", mount_concurrency=1)),
                ("port", FakeDeviceBackend, GpuMounter, MountTarget, Pod, FakeKubeClient(),
                 Config(cgroup_version="1"))):
            backend = backend_cls.create(os.path.join(root, name, "host"), n)
            dev = os.path.join(root, name, "dev")
            cgroup = os.path.join(root, name, "cgroup")
            os.makedirs(dev)
            os.makedirs(cgroup)
            for f in ("cgroup.procs", "devices.allow", "devices.deny"):
                open(os.path.join(cgroup, f), "w").close()
            mounter = mounter_cls(backend, cfg=cfg, kube=kube)
            target = target_cls(dev_dir=dev, cgroup_dirs=[cgroup], description="ns/tenant",
                                pod=_pod(pod_cls))
            self.sides[name] = (backend, mounter, target, kube, dev, cgroup)

    def run(self, name, script) -> dict:
        """script(mounter, target, devices): its exception's type, the spans,
        the GPU nodes left, what the stand-in cgroup files hold, the Events."""
        backend, mounter, target, kube, dev, cgroup = self.sides[name]
        mod = TRACE[name]
        mod.TRACER.reset()
        devices = backend.list_devices()
        raised = None
        try:
            script(mounter, target, devices)
        except Exception as exc:  # noqa: BLE001 — compared
            raised = type(exc).__name__
        files = {}
        for f in ("devices.allow", "devices.deny"):
            with open(os.path.join(cgroup, f)) as fh:
                files[f] = bool(fh.read().strip())
        nodes = [os.path.exists(os.path.join(dev, d.basename)) for d in devices]
        reasons = [(m["reason"], m["type"]) for _, m in kube.events_posted]
        assert mod.TRACER.open_spans() == []
        return _words({"raised": raised, "spans": [t[:4] for t in
                                                   _masked_tree(mod.TRACER.ring.snapshot())],
                       "nodes": nodes, "cgroup": files, "events": reasons})


def _mount(n):
    return lambda m, t, devs: m.mount_many(t, devs[:n])


def _unmount(m, t, devs):
    """The port's batch unmount, or the reference's one GPU at a time."""
    if isinstance(m, GpuMounter):
        m.unmount_many(t, devs, force=True)
    else:
        for dev in devs:
            m.unmount(t, dev, force=True)


def _mount_then_unmount(m, t, devs):
    m.mount_many(t, devs[:1])
    _unmount(m, t, devs[:1])


MOUNTER_CASES = {
    "mount ok": ({}, _mount(1)),
    "after_grant error": ({"worker.mount.after_grant": "1*error(boom)"}, _mount(1)),
    "before_grant crash": ({"worker.mount.before_grant": "1*crash(dies)"}, _mount(1)),
    "after_grant crash: no undo": ({"worker.mount.after_grant": "1*crash(dies)"}, _mount(1)),
    "mknod error": ({"worker.mount.mknod": "1*error(boom)"}, _mount(1)),
    "a grant's undo fails": ({"worker.mount.after_grant": "1*error(boom)",
                              "worker.mount.rollback": "1*error(undo)"}, _mount(1)),
    "rollback skipped": ({"worker.addgpu.rollback.skip": "return(true)",
                          "worker.mount.mknod": "1*error(boom)"}, _mount(1)),
    "unmount ok": ({}, _mount_then_unmount),
    "unmount before_revoke error": ({"worker.unmount.before_revoke": "1*error(boom)"},
                                    _mount_then_unmount),
    "unmount before_revoke crash": ({"worker.unmount.before_revoke": "1*crash(dies)"},
                                    _mount_then_unmount),
}


@pytest.mark.parametrize("case", list(MOUNTER_CASES))
def test_the_mounters_sites_and_spans_are_the_references(tmp_path, case):
    schedule, script = MOUNTER_CASES[case]
    mounters = _Mounters(str(tmp_path), 2)
    failures = {"reference": REF_ROLLBACK_FAILURES.total(), "port": MOUNT_ROLLBACK_FAILURES.total()}
    got = {}
    for name, fp in (("reference", ref_failpoints), ("port", failpoints)):
        armed = {k.replace("addgpu", "addtpu") if name == "reference" else k: v
                 for k, v in schedule.items()}
        with fp.armed(armed):
            got[name] = mounters.run(name, script)
    assert got["port"] == got["reference"]
    assert MOUNT_ROLLBACK_FAILURES.total() - failures["port"] == \
        REF_ROLLBACK_FAILURES.total() - failures["reference"]


def test_one_mknod_span_a_batch_where_the_reference_has_one_a_gpu(tmp_path):
    """The port enters the namespace once a batch: a mount of 2 has one
    mount.mknod and one mount.verify span, whose device names both UUIDs;
    the reference has one of each a GPU. A failure at the 2nd GPU's mknod
    site ends the same: the first was injected, then rolled back; a crash
    there leaves the first injected and undoes nothing, on both."""
    mounters = _Mounters(str(tmp_path), 2)
    ref = mounters.run("reference", _mount(2))
    port = mounters.run("port", _mount(2))
    assert [s[0] for s in ref["spans"]] == ["mount.cgroup_grant", "mount.mknod", "mount.verify",
                                            "mount.mknod", "mount.verify"]
    assert [s[0] for s in port["spans"]] == ["mount.cgroup_grant", "mount.mknod", "mount.verify"]
    port_spans = trace.TRACER.ring.snapshot()
    uuids = [d.uuid for d in mounters.sides["port"][0].list_devices()]
    assert port_spans[1]["attrs"]["device"] == ",".join(uuids)
    assert port["nodes"] == ref["nodes"] == [True, True]
    for name, fp in (("reference", ref_failpoints), ("port", failpoints)):
        backend, mounter, target = mounters.sides[name][:3]
        _unmount(mounter, target, backend.list_devices())
        with fp.armed({"worker.mount.mknod": "1*pass->1*error(boom)"}):
            got = mounters.run(name, _mount(2))
        assert got["raised"] == "MountError" and got["nodes"] == [False, False], (name, got)
        assert [s[:3] for s in got["spans"]][-1] == ("mount.rollback", "<root>", "ok")
    crashed = {}
    for name, fp in (("reference", ref_failpoints), ("port", failpoints)):
        with fp.armed({"worker.mount.mknod": "1*pass->1*crash(dies)"}):
            crashed[name] = mounters.run(name, _mount(2))
        crashed[name].pop("spans")
    assert crashed["port"] == crashed["reference"]
    assert crashed["port"]["raised"] == "CrashError" and crashed["port"]["nodes"] == [True, False]


# --- one scripted run through both masters and their workers ---

@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    built = build_stacks(str(tmp_path_factory.mktemp("obs-stacks")))
    yield built
    for stack in built.values():
        stack.close()


def _request(stack, method, path, form=None, payload=None):
    """(status, body, the response's trace id) of one request."""
    headers = dict(AUTH_HEADER)
    data = None
    if form is not None:
        data = "&".join(f"{k}={v}" for k, v in form.items()).encode()
    if payload is not None:
        data = json.dumps(payload).encode()
    req = urllib.request.Request(stack.base + path, data=data, method=method, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode(), resp.headers.get("X-Tpumounter-Trace")
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode(), exc.headers.get("X-Tpumounter-Trace")


def _scripted_run(name, stack) -> list:
    """An add, its remove, a failed add and a rolled-back slice; each step's
    status, span tree and audit records (operation, outcome class)."""
    mod, fp = (ref_trace, ref_failpoints) if name == "reference" else (trace, failpoints)
    audit_mod = ref_audit if name == "reference" else audit
    kind = "tpu" if name == "reference" else "gpu"
    tag = name[:3]
    stack.add_pod(f"obs-{tag}", "host-0")
    stack.add_pod(f"sl-a-{tag}", "host-1")
    stack.add_pod(f"sl-b-{tag}", "host-2")
    out = []

    def step(status, body, tid):
        # the error's type is left out: a refused call is typed in the port
        # (RpcCallError, ServiceError) where the reference's is grpc's
        spans = mod.trace_payload(tid)["spans"]
        records = [(r["operation"], r["outcome"].split(":")[0])
                   for r in reversed(audit_mod.AUDIT.query(trace_id=tid))]
        out.append(_words((status, [t[:3] for t in _masked_tree(spans)], records)))
        return body

    status, body, tid = _request(stack, "GET", f"/add{kind}/namespace/default/pod/obs-{tag}/"
                                               f"{kind}/1/isEntireMount/false")
    step(status, body, tid)
    # the worker's record names the GPUs the add mounted
    (uuids,) = [r["chips"] for r in audit_mod.AUDIT.query(trace_id=tid, operation="worker.")]
    held = stack.visible("host-0")
    step(*_request(stack, "POST", f"/remove{kind}/namespace/default/pod/obs-{tag}/force/false",
                   form={"uuids": ",".join(uuids)}))
    with fp.armed({"worker.mount.after_grant": "1*error(injected)"}):
        step(*_request(stack, "GET", f"/add{kind}/namespace/default/pod/obs-{tag}/{kind}/1/"
                                     "isEntireMount/false"))
    with fp.armed({"worker.mount.mknod": "1*pass->1*error(injected 2nd)"}):
        status, body, tid = _request(stack, "POST", "/addslice", payload={
            "pods": [{"namespace": "default", "pod": f"sl-a-{tag}"},
                     {"namespace": "default", "pod": f"sl-b-{tag}"}],
            "chipsPerHost" if name == "reference" else "gpusPerHost": 1, "isEntireMount": False})
    spans = mod.trace_payload(tid)["spans"]
    out.append(_words((status, sorted((s["name"], s["status"]) for s in spans),
                       sorted((r["operation"], r["outcome"].split(":")[0])
                              for r in audit_mod.AUDIT.query(trace_id=tid)))))
    out.append(("left mounted", held, {n: stack.visible(n) for n in ("host-0", "host-1",
                                                                      "host-2")}))
    kube = stack.cluster.kube
    reasons = sorted(_words(m["reason"]) for _, m in kube.events_posted
                     if m["involvedObject"]["name"].endswith(tag))
    out.append(("events", reasons))
    return out


def test_a_scripted_run_through_both_masters_is_the_references(stacks):
    got = {name: _scripted_run(name, stack) for name, stack in stacks.items()}
    for ref_step, port_step in zip(got["reference"], got["port"], strict=True):
        assert port_step == ref_step
    add, remove, failed, rolled_back, left, reasons = got["port"]
    assert add[0] == 200 and [s[0] for s in add[1]] == [
        "http.add", "k8s.get_pod", "rpc.AddGPU", "worker.AddGPU", "mount.slave_pod_schedule",
        "mount.cgroup_grant", "mount.mknod", "mount.verify"]
    assert add[2] == [("worker.AddGPU", "Success"), ("http.add", "http 200")]
    assert failed[0] == 500 and ("mount.rollback", "worker.AddGPU", "ok") in failed[1]
    assert rolled_back[0] == 500 and left[2] == {"host-0": 0, "host-1": 0, "host-2": 0}
    assert "GPUSliceRollback" in reasons[1]
    assert trace.TRACER.open_spans() == []


def _call_outcome(stack, fp, schedule) -> tuple:
    """An add of 1 GPU to a pod that does not exist, over the node's client,
    under `schedule`: its answer or its error's class and status code, and
    the retries counted."""
    from gpumounter_tpu.rpc.resilience import RPC_RETRIES as REF_RETRIES
    from gpumounter_tpu_torch.rpc.resilience import RPC_RETRIES
    counter = REF_RETRIES if fp is ref_failpoints else RPC_RETRIES
    before = counter.total()
    with fp.armed(schedule), stack.client("host-3") as client:
        try:
            answer = stack.add(client, "no-such-pod", 1)[0]
        except Exception as exc:  # noqa: BLE001 — compared
            code = getattr(exc, "code", None)
            code = code() if callable(code) else code
            answer = (type(exc).__name__ if "Deadline" in type(exc).__name__ else "refused",
                      getattr(code, "name", code))
    return answer, counter.total() - before


@pytest.mark.parametrize("schedule", [{"rpc.client.call": "1*unavailable(drop)"},
                                      {"rpc.client.deadline": "return(0.05)",
                                       "worker.rpc": "delay(0.2)"},
                                      {"worker.rpc": "1*error(refused at the top)"},
                                      {"worker.rpc": "1*delay(0.01)"}],
                         ids=["dropped", "deadline", "worker.rpc error", "worker.rpc delay"])
def test_the_client_and_worker_sites_act_as_the_references(stacks, schedule):
    """A dropped attempt is retried (one retry) and answered; a deadline of
    50 ms against a worker that takes 200 ms fails as DeadlineExceeded after
    its two retries; an error at the worker's top is refused as UNKNOWN."""
    got = {name: _call_outcome(stack, ref_failpoints if name == "reference" else failpoints,
                               schedule) for name, stack in stacks.items()}
    assert got["port"] == got["reference"]
    assert got["port"][0] in ("PodNotFound", ("DeadlineExceededError", "DEADLINE_EXCEEDED"),
                              ("refused", "UNKNOWN"))


def test_the_trace_route_serves_the_local_ring_where_the_reference_assembles(stacks):
    """The port's /trace/<id> answers ``trace_payload`` from this process's
    ring (the worker ops port's contract), where the reference's master
    assembles its spans with the workers' that its fleet collector gathered
    (``obs/assembly.py``, not ported yet). In one process the ring already
    holds both halves: the master's http.add and the worker's mount spans."""
    got = {}
    for name, stack in stacks.items():
        kind, tag = ("tpu", "ref") if name == "reference" else ("gpu", "por")
        stack.add_pod(f"tr-{tag}", "host-3")
        status, _, tid = _request(stack, "GET", f"/add{kind}/namespace/default/pod/tr-{tag}/"
                                                f"{kind}/1/isEntireMount/false")
        assert status == 200
        status, body, _ = _request(stack, "GET", f"/trace/{tid}")
        got[name] = (status, json.loads(body))
        (uuids,) = [r["chips"] for r in (ref_audit if name == "reference" else audit)
                    .AUDIT.query(trace_id=tid, operation="worker.")]
        assert _request(stack, "POST", f"/remove{kind}/namespace/default/pod/tr-{tag}/force/"
                                       "false", form={"uuids": ",".join(uuids)})[0] == 200
    status, payload = got["port"]
    assert status == 200 and payload == trace.trace_payload(payload["trace"])
    assert {"http.add", "worker.AddGPU", "mount.mknod"} <= {s["name"] for s in payload["spans"]}
    ref_status, ref_payload = got["reference"]
    assert ref_status == 200 and {"complete", "spans"} <= set(ref_payload)
    assert set(ref_payload) != set(payload)


def test_obs_check_on_the_cpu():
    """``entry.obs_check`` as the card's phase runs it, here on the fake
    host of 8 GPUs over the worker's gRPC server: the traced round trip,
    the faults, each ending with the GPU addable again, and the costs."""
    from gpumounter_tpu_torch import entry

    report = entry.obs_check("cpu", fake_gpus=8, repeats=1)
    assert report["live"] is None
    flows = report["fake"]
    rt = flows["round_trip"]
    assert len(rt["trace_ids"]) == 1 and sorted(rt["span_ms"]) == sorted(entry.ADD_TRACE)
    assert rt["events"] == ["GPUMounted", "GPUUnmounted"]
    ag = flows["after_grant"]
    assert ag["status"] == 500 and ag["outcomes"]["http.add"] == ["http 500"]
    assert ag["revoke"] == []  # the fake host has no cgroup
    assert flows["dropped_call"]["retries"] == 1 and flows["slice_admission"]["status"] == 500
    assert len(flows["again"]["add_ms"]) == 1
    assert report["two_gpu_mknod"]["status"] == 500
    assert trace.TRACER.open_spans() == [] and failpoints.active() == {}
    assert min(report["costs"].values()) > 0


_GPU_RULE = "c 195:0 "


@pytest.mark.parametrize("files, held, before, verdict", [
    ({"devices.deny": "c 195:0 rw"}, None, None, "the stand-in's devices.deny holds 'c 195:0 rw'"),
    ({"devices.deny": ""}, None, None, "not verified: neither devices.list nor"),
    ({"devices.deny": "c 195:1 rw"}, None, None, RuntimeError),
    ({"devices.list": "c 1:3 rwm\n"}, ["c 1:3 rwm", "c 195:0 rw"], ["c 1:3 rwm"],
     "devices.list as before the add, without 'c 195:0'"),
    ({"devices.list": "c 1:3 rwm\nc 195:0 rw\n"}, ["c 1:3 rwm", "c 195:0 rw"], ["c 1:3 rwm"],
     RuntimeError),
    ({"devices.list": "c 1:3 rwm\nc 1:5 rwm\n"}, ["c 1:3 rwm", "c 195:0 rw"], ["c 1:3 rwm"],
     RuntimeError),
    ({"devices.list": "a *:* rwm\n"}, ["a *:* rwm"], ["a *:* rwm"],
     "not verified: devices.list did not show the grant"),
], ids=["stand-in revoked", "stand-in silent", "stand-in other rule", "list revoked",
        "list still grants", "list changed", "list allows all"])
def test_the_v1_revoke_verdict_of_the_rolled_back_add(tmp_path, files, held, before, verdict):
    """phase 13's after-grant fault judges the v1 revoke only by what reads
    back: devices.list where it showed the grant, a stand-in's devices.deny,
    else "not verified"; a rule left behind raises."""
    from gpumounter_tpu_torch.entry import _v1_revoked

    for name, text in files.items():
        (tmp_path / name).write_text(text)
    if verdict is RuntimeError:
        with pytest.raises(RuntimeError, match="after the rollback"):
            _v1_revoked(str(tmp_path), held, before, _GPU_RULE)
    else:
        assert _v1_revoked(str(tmp_path), held, before, _GPU_RULE).startswith(verdict)
