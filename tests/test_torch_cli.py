"""The port's CLI (``gpumounter_tpu_torch/cli.py``), held to the reference's.

  * Request parity, verb by verb: each remote verb and each of its exit
    branches runs through the reference's ``cli.main`` and the port's against
    scripted stdlib masters that record every request (method, path,
    Authorization, body) and answer canned (status, body) pairs. The port's
    argv and its master's answers go through the rename map of ROADMAP §3
    ("The CLI in its NVIDIA form"): the routes /addgpu, /removegpu and
    /batch/addgpu (whose targets count "gpus"), the flags --gpus, --min-gpus
    and --gpu. Held equal: the recorded requests (the reference's mapped),
    the exit codes, stdout exactly and stderr, both with the CLI's own
    words mapped ("chip" -> "GPU", "--chip" -> "--gpu"); a master's body
    is printed as it is on both sides.
  * The reference's 17 CLI cases, each against the port's own ``MasterApp``
    (or, as the reference's, against a stubbed ``_http``), with the
    reference's exit codes.
  * The traps: ``bulk-add`` with a count mounts that many GPUs on a fake
    host and sends "gpus"; the CLI never calls /addtpu; a dead replica
    before a live one fails over through ``MasterEndpoints``.
  * The local verbs on ``FakeDeviceBackend``: ``devices``, ``mount --gpus
    2``, ``unmount``, and a busy ``unmount`` exiting 2.
  * Importing the CLI loads no torch, numpy or grpc; ``entry.cli_check`` on
    the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from conftest import TEST_AUTH_TOKEN
from torch_obs_reset import reset_port_obs  # noqa: F401 — the autouse fixture

from gpumounter_tpu import cli as ref_cli
from gpumounter_tpu_torch import cli
from gpumounter_tpu_torch.config import Config
from gpumounter_tpu_torch.device.backend import FakeDeviceBackend
from gpumounter_tpu_torch.k8s.fake import FakeKubeClient
from gpumounter_tpu_torch.master.app import MasterApp, build_http_server
from gpumounter_tpu_torch.obs import audit, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN, READ = "cli-mutate-secret", "cli-read-secret"
#: a port nothing listens on: every request to it is refused
DEAD = "http://127.0.0.1:9"


# --- the scripted master ---

class _Scripted:
    """A stdlib master that records (method, path, Authorization, body) of
    each request and answers from `answers`: (method, path) -> a list of
    (status, body), consumed in order, the last one repeated; "drop" closes
    the connection without an answer. Anything unscripted is 404."""

    def __init__(self, answers: dict):
        self.answers = {k: list(v) for k, v in answers.items()}
        self.requests: list[tuple] = []
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length).decode() if length else ""
                outer.requests.append((self.command, self.path,
                                       self.headers.get("Authorization"), body))
                queue = outer.answers.get((self.command, self.path), [(404, "no route\n")])
                answer = queue.pop(0) if len(queue) > 1 else queue[0]
                if answer == "drop":
                    self.close_connection = True
                    return
                status, text = answer
                payload = text.encode()
                self.send_response(status)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_PUT = do_DELETE = _serve

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever, kwargs={"poll_interval": 0.01},
                         daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _run(main, argv) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of `main(argv)` in this process, as the
    interpreter would exit: SystemExit(str) prints it and exits 1. The CLI's
    logger is left unconfigured and logging is off meanwhile, so that no
    log line reaches either stream."""
    out, err = io.StringIO(), io.StringIO()
    logging.disable(logging.CRITICAL)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                code = main(argv)
            except SystemExit as exc:
                code = exc.code
                if isinstance(code, str):
                    print(code, file=sys.stderr)
                    code = 1
                code = 0 if code is None else code
    finally:
        logging.disable(logging.NOTSET)
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(autouse=True)
def _no_logger_setup(monkeypatch):
    monkeypatch.setattr(ref_cli, "init_logger", lambda: None)
    monkeypatch.setattr(cli, "init_logger", lambda: None)


# --- the rename map (ROADMAP §3) ---

_FLAGS = {"--chips": "--gpus", "--min-chips": "--min-gpus", "--chip": "--gpu"}


def _port_argv(argv: list[str]) -> list[str]:
    return [_FLAGS.get(a, a) for a in argv]


def _port_path(path: str) -> str:
    path = re.sub(r"^/addtpu/(.*)/tpu/(\d+)/", r"/addgpu/\1/gpu/\2/", path)
    return path.replace("/removetpu/", "/removegpu/").replace("/batch/addtpu", "/batch/addgpu")


def _parsed(body: str):
    """A request's body as its JSON value where it is JSON, else its text."""
    try:
        return json.loads(body)
    except ValueError:
        return body


def _port_request(request: tuple) -> tuple:
    method, path, auth, body = request
    if path == "/batch/addtpu":
        for target in body["targets"]:
            if "chips" in target:
                target["gpus"] = target.pop("chips")
    return method, _port_path(path), auth, body


def _port_words(text: str) -> str:
    """The CLI's own words in the port's: a flag first, then the noun."""
    return text.replace("--chip", "--gpu").replace("chip", "GPU")


def _masked(text: str, bodies: list[str]) -> str:
    """`text` with each master's body (as printed, or re-rendered as the
    migration's journal) replaced by a marker: bodies are printed as they
    are, so the word map must not touch them."""
    for i, body in sorted(enumerate(bodies), key=lambda b: -len(b[1])):
        renders = [body.rstrip()]
        with contextlib.suppress(ValueError):
            renders.insert(0, json.dumps(json.loads(body), indent=1))
        for render in renders:
            if render:
                text = text.replace(render, f"<body {i}>")
    return text


def _parity(argv: list[str], answers: dict, masters: str = "{m}") -> dict:
    """`argv` (with "{m}" for the master's URL) through both CLIs, each
    against a scripted master of `answers` (the port's at the port's
    paths); asserts the parity and returns the port's observation."""
    bodies = [b for queue in answers.values() for a in queue if a != "drop" for b in [a[1]]]
    seen = {}
    for side in ("reference", "port"):
        script = answers if side == "reference" else {
            (m, _port_path(p)): v for (m, p), v in answers.items()}
        master = _Scripted(script)
        try:
            args = [a.replace("{m}", masters.replace("{m}", master.base)) for a in argv]
            main = ref_cli.main if side == "reference" else cli.main
            code, out, err = _run(main, args if side == "reference" else _port_argv(args))
            requests = [(m, p.replace(master.base, ""), a, _parsed(b))
                        for m, p, a, b in master.requests]
        finally:
            master.stop()
        out, err = _masked(out, bodies), _masked(err, bodies)
        if side == "reference":
            requests = [_port_request(r) for r in requests]
            out, err = _port_words(out), _port_words(err)
        seen[side] = {"code": code, "stdout": out, "stderr": err, "requests": requests}
    assert seen["port"] == seen["reference"], (argv, seen)
    return seen["port"]


def _j(obj) -> str:
    return json.dumps(obj, indent=1) + "\n"


BEARER, READ_BEARER = f"Bearer {TOKEN}", f"Bearer {READ}"
T = ["--token", TOKEN]
ADD = "/addtpu/namespace/default/pod/p/tpu/2/isEntireMount/false"
REMOVE = "/removetpu/namespace/default/pod/p/force/false"

# --- the scenarios: every remote verb and each of its exit branches ---

_TRACE_DONE = {"op": "http.add", "wall_ms": 12.5, "nodes": ["node-a"], "complete": True,
               "spans": [{"name": "http.add"}],
               "critical_path": [{"phase": "admission", "ms": 1.25, "share": 0.1},
                                 {"phase": "rpc", "ms": 11.25, "share": 0.9}],
               "dominant": {"phase": "rpc", "share": 0.9}}


def _cold(attrs: dict | None) -> dict:
    spans = [{"name": "mount.slave_pod_schedule", "attrs": attrs or {}}]
    return {**_TRACE_DONE, "spans": spans, "dominant": {"phase": "slave_pod_schedule",
                                                        "share": 0.887}}


def _capacity(verdict="admissible", satisfiable=True, intents=1, blocking=()):
    return {"fleet": {"free": 3, "total": 8, "warm": 1, "fenced": 0,
                      "fragmentation_index": 0.25, "largest_block": 3, "hosts": 1,
                      "hosts_reporting": 1},
            "feasibility": {"nvidia-h100-80gb-4": {
                "verdict": verdict, "hosts_admissible_now": 0, "hosts_needed": 1,
                "hosts_after_defrag": 1, "blocking_hosts": list(blocking)},
                "nvidia-h100-80gb-1": {"verdict": "admissible", "hosts_admissible_now": 1,
                                       "hosts_needed": 1, "hosts_after_defrag": 1}},
            "headroom": {"forecast": "tight", "free_chips": 3, "queue_depth": 2,
                         "tokens_per_s": 1200.5, "tenants": 2},
            "demand": {"intents": intents, "desired_chips": 9, "actual_chips": 1, "gap": 8,
                       "satisfiable": satisfiable}}


def _slo(fast, slow, breached=False):
    return {"windows_s": {"fast": 300, "slow": 3600}, "burn_threshold": 2.0,
            "objectives": [{"name": "mount-latency-50ms", "burn_fast": fast,
                            "burn_slow": slow, "breached": breached},
                           {"name": "mount-success", "burn_fast": 0.0, "burn_slow": 0.0}]}


def _tenants(open_windows=()):
    return {"tenants": {"team-a/trainer": {
        "steps": 40, "tokens_per_s": 5120.0,
        "disruption": {"total_seconds": 0.2, "total_windows": 1 + len(open_windows),
                       "by_cause": {"migration": {"windows": 1, "p95_ms": 200.0}},
                       "open": [{"cause": c, "age_s": 1.5, "trace_id": "tr-2"}
                                for c in open_windows]}},
        "team-b/serve": {"steps": 3, "tokens_per_s": 10.0, "disruption": {}}}}


def _api(state="healthy", pending=0):
    return {"api": {"state": state, "sinceS": 4.2, "consecutiveFailures": 3,
                    "lastError": "PartitionError: gone"},
            "store": {"writeBehind": {"pending": pending}}}


def _shares(load=100):
    return {"weight_capacity": 100,
            "chips": {"GPU-0a": {"node": "node-a", "tenants": 2, "load": load,
                                 "profiles": ["decode", "prefill"]},
                      "GPU-0b": {"node": "node-b", "tenants": 1, "load": 40}},
            "totals": {"shares": 3, "chips": 2, "shared_chips": 1}}


def _journal(outcome=None, phase="quiesce"):
    j = {"id": "mig-1", "phase": phase,
         "phase_durations_s": {"quiesce": 0.5, "snapshot": 1.25, "remount": 0.75}}
    if outcome:
        j["outcome"] = outcome
    return json.dumps(j)


MIG = ["migrate", "start", "--master", "{m}", *T, "--pod", "a", "--dest-pod", "b"]
WAIT = [*MIG, "--wait", "--wait-timeout", "30", "--poll-interval", "0.01"]
STARTED = {("POST", "/migrate"): [(200, json.dumps({"id": "mig-1", "phase": "pending"}))]}

SCENARIOS = {
    # add / remove
    "add ok": (["add", "--master", "{m}", "--pod", "p", "--num", "2", *T],
               {("GET", ADD): [(200, "Add GPU Success\n")]}),
    "add insufficient": (["add", "--master", "{m}", "--pod", "p", "--num", "2", *T],
                         {("GET", ADD): [(500, "Insufficient GPU on Node: n\n")]}),
    "add entire, namespace": (["add", "--master", "{m}", "--namespace", "ml", "--pod", "p",
                               "--entire", *T],
                              {("GET", "/addtpu/namespace/ml/pod/p/tpu/1/isEntireMount/true"):
                               [(200, "Add GPU Success\n")]}),
    "add, no credentials": (["add", "--master", "{m}", "--pod", "p", "--num", "2",
                             "--token", ""],
                            {("GET", ADD): [(401, "missing or invalid bearer token\n")]}),
    "add, the env's token": (["add", "--master", "{m}", "--pod", "p", "--num", "2"],
                             {("GET", ADD): [(200, "Add GPU Success\n")]}),
    "add, every replica dead": (["add", "--master", DEAD, "--pod", "p", *T], {}),
    "add, dead then live": (["add", "--master", "{m}", "--pod", "p", "--num", "2", *T],
                            {("GET", ADD): [(200, "Add GPU Success\n")]}),
    "remove ok": (["remove", "--master", "{m}", "--pod", "p", "--uuids", "U1,U2", *T],
                  {("POST", REMOVE): [(200, "Remove 2 GPUs Success\n")]}),
    "remove forced, refused": (["remove", "--master", "{m}", "--pod", "p", "--uuids", "U9",
                                "--force", *T],
                               {("POST", "/removetpu/namespace/default/pod/p/force/true"):
                                [(400, "Invalid UUIDs: U9\n")]}),
    # bulk-add
    "bulk-add all": (["bulk-add", "--master", "{m}", "--target", "ns/a:3", "--target", "b", *T],
                     {("POST", "/batch/addtpu"): [(200, json.dumps(
                         {"summary": {"total": 2, "success": 2}}))]}),
    "bulk-add partial, entire": (["bulk-add", "--master", "{m}", "--namespace", "jobs",
                                  "--target", "a:2", "--entire", *T],
                                 {("POST", "/batch/addtpu"): [(200, json.dumps(
                                     {"summary": {"total": 1, "success": 0}}))]}),
    "bulk-add refused": (["bulk-add", "--master", "{m}", "--target", "a", *T],
                         {("POST", "/batch/addtpu"): [(400, "too many targets\n")]}),
    "bulk-add unparseable": (["bulk-add", "--master", "{m}", "--target", "a", *T],
                             {("POST", "/batch/addtpu"): [(200, "not json")]}),
    "bulk-add bad count": (["bulk-add", "--master", "{m}", "--target", "a:x", *T], {}),
    # intents
    "intent set": (["intent", "set", "--master", "{m}", "--pod", "t", "--chips", "3",
                    "--min-chips", "1", "--priority", "2", *T],
                   {("PUT", "/intents/default/t"): [(200, json.dumps({"desiredChips": 3}))]}),
    "intent set, unknown pod": (["intent", "set", "--master", "{m}", "--pod", "t", "--chips",
                                 "3", *T], {("PUT", "/intents/default/t"): [(404, "no pod\n")]}),
    "intent get": (["intent", "get", "--master", "{m}", "--pod", "t", *T],
                   {("GET", "/intents/default/t"): [(200, json.dumps({"minChips": 1}))]}),
    "intent get, none": (["intent", "get", "--master", "{m}", "--pod", "t", *T], {}),
    "intent delete": (["intent", "delete", "--master", "{m}", "--namespace", "ml", "--pod", "t",
                       *T], {("DELETE", "/intents/ml/t"): [(200, '{"deleted": true}')]}),
    "intent delete, none": (["intent", "delete", "--master", "{m}", "--pod", "t", *T], {}),
    "intent list": (["intent", "list", "--master", "{m}", *T],
                    {("GET", "/intents"): [(200, json.dumps({"intents": []}))]}),
    "intent list, refused": (["intent", "list", "--master", "{m}", "--token", ""],
                             {("GET", "/intents"): [(401, "missing or invalid bearer token\n")]}),
    # migrate
    "migrate rejected": (MIG, {("POST", "/migrate"): [(400, "source == destination\n")]}),
    "migrate error": (MIG, {("POST", "/migrate"): [(500, "boom\n")]}),
    "migrate started": ([*MIG, "--checkpoint", "--dest-namespace", "ml"], STARTED),
    **{f"migrate --wait {outcome}": (WAIT, {**STARTED, ("GET", "/migrations/mig-1"): [
        (200, _journal()), (200, _journal(outcome, "done"))]})
       for outcome in ("succeeded", "rolled_back", "failed", "aborted")},
    "migrate --wait, a poll fails once": (WAIT, {**STARTED, ("GET", "/migrations/mig-1"): [
        "drop", (503, "restarting\n"), (200, _journal("succeeded", "done"))]}),
    "migrate --wait, never terminal": (
        [*MIG, "--wait", "--wait-timeout", "0.2", "--poll-interval", "0.05"],
        {**STARTED, ("GET", "/migrations/mig-1"): [(200, _journal())]}),
    "migrate status, all": (["migrate", "status", "--master", "{m}", *T],
                            {("GET", "/migrations"): [(200, json.dumps({"migrations": [
                                json.loads(_journal("succeeded", "done")),
                                json.loads(_journal())]}))]}),
    "migrate status, one": (["migrate", "status", "--master", "{m}", "--id", "mig-1", *T],
                            {("GET", "/migrations/mig-1"): [(200, _journal("failed", "done"))]}),
    "migrate status, unknown": (["migrate", "status", "--master", "{m}", "--id", "nope", *T],
                                {("GET", "/migrations/nope"): [(404, "no migration nope\n")]}),
    "migrate status, error": (["migrate", "status", "--master", "{m}", *T],
                              {("GET", "/migrations"): [(500, "boom\n")]}),
    "migrate status, unparseable": (["migrate", "status", "--master", "{m}", *T],
                                    {("GET", "/migrations"): [(200, "not json")]}),
    "migrate abort": (["migrate", "abort", "--master", "{m}", "--id", "mig-1", *T],
                      {("POST", "/migrations/mig-1/abort"): [(200, _journal())]}),
    "migrate abort, terminal": (["migrate", "abort", "--master", "{m}", "--id", "mig-1", *T],
                                {("POST", "/migrations/mig-1/abort"): [(409, "terminal\n")]}),
    "migrate abort, error": (["migrate", "abort", "--master", "{m}", "--id", "mig-1", *T],
                             {("POST", "/migrations/mig-1/abort"): [(500, "boom\n")]}),
    # audit, trace, why, timeline
    "audit filtered, read token": (
        ["audit", "--master", "{m}", "--read-token", READ, "--pod", "p", "--op", "worker.",
         "--outcome", "Success", "--limit", "5"],
        {("GET", "/audit?pod=p&op=worker.&outcome=Success&limit=5"): [(200, '{"records": []}')]}),
    "audit, both tokens": (["audit", "--master", "{m}", *T, "--read-token", READ],
                           {("GET", "/audit?limit=100"): [(200, '{"records": []}')]}),
    "audit error": (["audit", "--master", "{m}", *T, "--trace", "t1"],
                    {("GET", "/audit?trace=t1&limit=100"): [(500, "boom\n")]}),
    "trace": (["trace", "--master", "{m}", *T, "abc"],
              {("GET", "/trace/abc"): [(200, json.dumps(_TRACE_DONE))]}),
    "trace unknown": (["trace", "--master", "{m}", *T, "abc"],
                      {("GET", "/trace/abc"): [(404, "unknown trace abc\n")]}),
    "trace error": (["trace", "--master", "{m}", *T, "abc"],
                    {("GET", "/trace/abc"): [(500, "boom\n")]}),
    "why": (["why", "--master", "{m}", *T, "abc"],
            {("GET", "/trace/abc"): [(200, json.dumps(_TRACE_DONE))],
             ("GET", "/health/nodes"): [(200, json.dumps({"nodes": {"node-a": {
                 "state": "healthy"}}}))]}),
    "why, quarantined node": (["why", "--master", "{m}", *T, "abc"],
                              {("GET", "/trace/abc"): [(200, json.dumps(_TRACE_DONE))],
                               ("GET", "/health/nodes"): [(200, json.dumps({"nodes": {
                                   "node-a": {"state": "quarantined", "reason": "slow"}}}))]}),
    "why, quarantined without a reason": (
        ["why", "--master", "{m}", *T, "abc"],
        {("GET", "/trace/abc"): [(200, json.dumps(_TRACE_DONE))],
         ("GET", "/health/nodes"): [(200, json.dumps({"nodes": {"node-a": {
             "state": "quarantined"}}}))]}),
    "why, no health plane": (["why", "--master", "{m}", *T, "abc"],
                             {("GET", "/trace/abc"): [(200, json.dumps(_TRACE_DONE))],
                              ("GET", "/health/nodes"): [(200, '{"nodes": [1]}')]}),
    "why, starvation": (["why", "--master", "{m}", *T, "abc"],
                        {("GET", "/trace/abc"): [(200, json.dumps(_cold(
                            {"pool_hit": 1, "pool_gap": 2, "pool_enabled": True})))]}),
    "why, pool disabled": (["why", "--master", "{m}", *T, "abc"],
                           {("GET", "/trace/abc"): [(200, json.dumps(_cold(
                               {"pool_hit": 0, "pool_gap": 2, "pool_enabled": False})))]}),
    "why, adopted warm": (["why", "--master", "{m}", *T, "abc"],
                          {("GET", "/trace/abc"): [(200, json.dumps(_cold(
                              {"pool_hit": 2, "pool_gap": 0, "pool_enabled": True})))]}),
    "why, cause unknown": (["why", "--master", "{m}", *T, "abc"],
                           {("GET", "/trace/abc"): [(200, json.dumps(_cold(None)))]}),
    "why, incomplete": (["why", "--master", "{m}", *T, "abc"],
                        {("GET", "/trace/abc"): [(200, json.dumps(
                            {**_TRACE_DONE, "nodes": [], "complete": False,
                             "orphans": ["s1"], "missing_worker_halves": ["r1", "r2"]}))]}),
    "why, unknown": (["why", "--master", "{m}", *T, "abc"],
                     {("GET", "/trace/abc"): [(404, "unknown trace abc\n")]}),
    "why, error": (["why", "--master", "{m}", *T, "abc"],
                   {("GET", "/trace/abc"): [(500, "boom\n")]}),
    "why, unparseable": (["why", "--master", "{m}", *T, "abc"],
                         {("GET", "/trace/abc"): [(200, "not json")]}),
    "timeline": (["timeline", "--master", "{m}", *T, "--node", "n1", "--kind", "span",
                  "--since", "1.5", "--until", "9", "--limit", "3"],
                 {("GET", "/timeline?node=n1&kind=span&from=1.5&to=9&limit=3"): [
                     (200, json.dumps({"records": [
                         {"at": 1.25, "kind": "span", "node": "n1", "summary": "http.add",
                          "trace_id": "t1"},
                         {"at": 2.5, "kind": "audit", "summary": "worker.AddGPU"}]}))]}),
    "timeline error": (["timeline", "--master", "{m}", *T],
                       {("GET", "/timeline?limit=500"): [(500, "boom\n")]}),
    "timeline unparseable": (["timeline", "--master", "{m}", *T],
                             {("GET", "/timeline?limit=500"): [(200, "not json")]}),
    # the panes
    "fleet, stale nodes": (["fleet", "--master", "{m}", *T],
                           {("GET", "/fleet"): [(200, json.dumps({"nodes": {
                               "node-1": {"stale": False},
                               "node-dark": {"stale": True, "stale_age_s": 120.0,
                                             "error": "RpcError: unreachable"},
                               "node-never": {"stale": True}}}))]}),
    "fleet error": (["fleet", "--master", "{m}", *T], {("GET", "/fleet"): [(500, "boom\n")]}),
    "fleet unparseable": (["fleet", "--master", "{m}", *T],
                          {("GET", "/fleet"): [(200, "not json")]}),
    "slo ok": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(200, json.dumps(
        _slo(0.5, 0.25)))]}),
    "slo fast hot": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(200, json.dumps(
        _slo(3.0, 1.0)))]}),
    "slo slow elevated": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(200, json.dumps(
        _slo(1.0, 2.5)))]}),
    "slo breach": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(200, json.dumps(
        _slo(4.0, 3.0, breached=True)))]}),
    "slo error": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(500, "boom\n")]}),
    "slo unparseable": (["slo", "--master", "{m}", *T], {("GET", "/slo"): [(200, "[")]}),
    "tenants": (["tenants", "--master", "{m}", *T],
                {("GET", "/tenants"): [(200, json.dumps(_tenants()))]}),
    "tenants, an open window": (["tenants", "--master", "{m}", *T],
                                {("GET", "/tenants"): [(200, json.dumps(
                                    _tenants(["evacuation"])))]}),
    "tenants, one": (["tenants", "--master", "{m}", *T, "--tenant", "team-b/serve"],
                     {("GET", "/tenants"): [(200, json.dumps(_tenants(["heal"])))]}),
    "tenants, absent": (["tenants", "--master", "{m}", *T, "--tenant", "nope"],
                        {("GET", "/tenants"): [(200, json.dumps(_tenants()))]}),
    "tenants error": (["tenants", "--master", "{m}", *T], {("GET", "/tenants"): [(500, "x\n")]}),
    "tenants unparseable": (["tenants", "--master", "{m}", *T],
                            {("GET", "/tenants"): [(200, "not json")]}),
    "capacity ok": (["capacity", "--master", "{m}", *T],
                    {("GET", "/capacity"): [(200, json.dumps(_capacity()))]}),
    "capacity, demand unsatisfiable": (["capacity", "--master", "{m}", *T],
                                       {("GET", "/capacity"): [(200, json.dumps(
                                           _capacity(satisfiable=False)))]}),
    "capacity, no intents": (["capacity", "--master", "{m}", *T],
                             {("GET", "/capacity"): [(200, json.dumps(
                                 _capacity(satisfiable=False, intents=0)))]}),
    "capacity, shape infeasible": (
        ["capacity", "--master", "{m}", *T, "--accel-type", "nvidia-h100-80gb-4"],
        {("GET", "/capacity?accel_type=nvidia-h100-80gb-4"): [(200, json.dumps(
            _capacity("infeasible", blocking=["node-a", "node-b"])))]}),
    "capacity, shape after defrag": (
        ["capacity", "--master", "{m}", *T, "--accel-type", "nvidia-h100-80gb-4"],
        {("GET", "/capacity?accel_type=nvidia-h100-80gb-4"): [(200, json.dumps(
            _capacity("admissible-after-defrag", satisfiable=False)))]}),
    "capacity, shape unknown": (
        ["capacity", "--master", "{m}", *T, "--accel-type", "v5litepod-4"],
        {("GET", "/capacity?accel_type=v5litepod-4"): [(404, "unknown accelerator type\n")]}),
    "capacity error": (["capacity", "--master", "{m}", *T],
                       {("GET", "/capacity"): [(404, "not here\n")]}),
    "capacity unparseable": (["capacity", "--master", "{m}", *T],
                             {("GET", "/capacity"): [(200, "not json")]}),
    "apihealth healthy": (["apihealth", "--master", "{m}", *T],
                          {("GET", "/apihealth"): [(200, json.dumps(_api()))]}),
    "apihealth degraded": (["apihealth", "--master", "{m}", *T],
                           {("GET", "/apihealth"): [(200, json.dumps(_api("degraded")))]}),
    "apihealth, writes pending": (["apihealth", "--master", "{m}", *T],
                                  {("GET", "/apihealth"): [(200, json.dumps(_api(pending=2)))]}),
    "apihealth error": (["apihealth", "--master", "{m}", *T],
                        {("GET", "/apihealth"): [(401, "no\n")]}),
    "apihealth unparseable": (["apihealth", "--master", "{m}", *T],
                              {("GET", "/apihealth"): [(200, "not json")]}),
    "shards": (["shards", "--master", "{m}", "--read-token", READ],
               {("GET", "/shards"): [(200, '{"shardCount": 1}')]}),
    "shards error": (["shards", "--master", "{m}", *T], {("GET", "/shards"): [(500, "boom\n")]}),
    "recovery healthy": (["recovery", "--master", "{m}", *T],
                         {("GET", "/recovery"): [(200, json.dumps({"nodes": {
                             "n1": {"status": "alive"}}}))]}),
    **{f"recovery {status}": (["recovery", "--master", "{m}", *T],
                              {("GET", "/recovery"): [(200, json.dumps({"nodes": {
                                  "n1": {"status": "alive"}, "n2": {"status": status}}}))]})
       for status in ("suspect", "evacuated")},
    "recovery error": (["recovery", "--master", "{m}", *T],
                       {("GET", "/recovery"): [(500, "boom\n")]}),
    "recovery unparseable": (["recovery", "--master", "{m}", *T],
                             {("GET", "/recovery"): [(200, "not json")]}),
    "recovery --evacuate": (["recovery", "--master", "{m}", *T, "--read-token", READ,
                             "--evacuate", "n2"],
                            {("POST", "/recovery/evacuate/n2"): [(200, '{"evacuated": "n2"}')]}),
    "recovery --evacuate refused": (["recovery", "--master", "{m}", *T, "--evacuate", "n2"],
                                    {("POST", "/recovery/evacuate/n2"): [(409, "alive\n")]}),
    "health": (["health", "--master", "{m}", *T],
               {("GET", "/health/nodes"): [(200, json.dumps({"nodes": {
                   "n1": {"state": "healthy"}}}))]}),
    "health, quarantined": (["health", "--master", "{m}", *T],
                            {("GET", "/health/nodes"): [(200, json.dumps({"nodes": {
                                "n1": {"state": "quarantined"}}}))]}),
    "health, quarantined but evacuated": (["health", "--master", "{m}", *T],
                                          {("GET", "/health/nodes"): [(200, json.dumps({
                                              "nodes": {"n1": {"state": "quarantined",
                                                               "evacuated": True}}}))]}),
    "health error": (["health", "--master", "{m}", *T],
                     {("GET", "/health/nodes"): [(500, "boom\n")]}),
    "health unparseable": (["health", "--master", "{m}", *T],
                           {("GET", "/health/nodes"): [(200, "not json")]}),
    "health --quarantine": (["health", "--master", "{m}", *T, "--quarantine", "n1",
                             "--reason", "slow canaries"],
                            {("POST", "/health/quarantine/n1"): [(200, '{"state": "q"}')]}),
    "health --release refused": (["health", "--master", "{m}", *T, "--release", "n1",
                                  "--reason", "ignored"],
                                 {("POST", "/health/quarantine/n1"): [(409, "not q\n")]}),
    "health --quarantine error": (["health", "--master", "{m}", *T, "--quarantine", "n1"],
                                  {("POST", "/health/quarantine/n1"): [(500, "boom\n")]}),
    "defrag": (["defrag", "--master", "{m}", *T],
               {("GET", "/defrag"): [(200, json.dumps({"gates": {"api_ok": True}}))]}),
    "defrag, API gated": (["defrag", "--master", "{m}", *T],
                          {("GET", "/defrag"): [(200, json.dumps({"gates": {"api_ok": False}}))]}),
    "defrag, SLO gated": (["defrag", "--master", "{m}", *T],
                          {("GET", "/defrag"): [(200, json.dumps({"gates": {
                              "api_ok": True, "slo_burning": True}}))]}),
    "defrag error": (["defrag", "--master", "{m}", *T], {("GET", "/defrag"): [(500, "x\n")]}),
    "defrag unparseable": (["defrag", "--master", "{m}", *T],
                           {("GET", "/defrag"): [(200, "not json")]}),
    "defrag --plan": (["defrag", "--master", "{m}", *T, "--plan", "--target-block", "8"],
                      {("POST", "/defrag/plan"): [(200, '{"id": "p1"}')]}),
    "defrag --plan refused": (["defrag", "--master", "{m}", *T, "--plan"],
                              {("POST", "/defrag/plan"): [(409, "stale snapshot\n")]}),
    "defrag --run degraded": (["defrag", "--master", "{m}", *T, "--run", "--plan-id", "p1"],
                              {("POST", "/defrag/run"): [(503, "api degraded\n")]}),
    "defrag --run error": (["defrag", "--master", "{m}", *T, "--run"],
                           {("POST", "/defrag/run"): [(500, "boom\n")]}),
    "defrag --pause": (["defrag", "--master", "{m}", *T, "--pause"],
                       {("POST", "/defrag/pause"): [(200, '{"paused": true}')]}),
    "autoscale": (["autoscale", "--master", "{m}", *T],
                  {("GET", "/autoscale"): [(200, json.dumps({"gates": {"api_ok": True},
                                                             "paused": False}))]}),
    "autoscale, paused": (["autoscale", "--master", "{m}", *T],
                          {("GET", "/autoscale"): [(200, json.dumps({"paused": True}))]}),
    "autoscale, gated": (["autoscale", "--master", "{m}", *T],
                         {("GET", "/autoscale"): [(200, json.dumps({"gates": {
                             "slo_burning": True}}))]}),
    "autoscale error": (["autoscale", "--master", "{m}", *T],
                        {("GET", "/autoscale"): [(500, "boom\n")]}),
    "autoscale unparseable": (["autoscale", "--master", "{m}", *T],
                              {("GET", "/autoscale"): [(200, "not json")]}),
    "autoscale --pause": (["autoscale", "--master", "{m}", *T, "--pause"],
                          {("POST", "/autoscale/pause"): [(200, '{"paused": true}')]}),
    "autoscale --resume refused": (["autoscale", "--master", "{m}", *T, "--resume"],
                                   {("POST", "/autoscale/resume"): [(409, "not paused\n")]}),
    "autoscale --evaluate degraded": (["autoscale", "--master", "{m}", *T, "--evaluate"],
                                      {("POST", "/autoscale/evaluate"): [(503, "degraded\n")]}),
    "autoscale --evaluate error": (["autoscale", "--master", "{m}", *T, "--evaluate"],
                                   {("POST", "/autoscale/evaluate"): [(500, "boom\n")]}),
    "shares": (["shares", "--master", "{m}", *T],
               {("GET", "/shares"): [(200, json.dumps(_shares()))]}),
    "shares, overbooked": (["shares", "--master", "{m}", *T],
                           {("GET", "/shares"): [(200, json.dumps(_shares(130)))]}),
    "shares error": (["shares", "--master", "{m}", *T], {("GET", "/shares"): [(500, "x\n")]}),
    "shares unparseable": (["shares", "--master", "{m}", *T],
                           {("GET", "/shares"): [(200, "not json")]}),
    "shares --admit": (["shares", "--master", "{m}", *T, "--admit", "--pod", "prefill",
                        "--profile", "prefill", "--chips", "2", "--weight", "60",
                        "--rate-budget", "8", "--chip", "G0=node-a", "--chip", "G1=node-b"],
                       {("POST", "/shares"): [(200, '{"admitted": []}')]}),
    "shares --admit refused": (["shares", "--master", "{m}", *T, "--admit", "--pod", "p",
                                "--weight", "90"],
                               {("POST", "/shares"): [(409, "409 no headroom\n")]}),
    "shares --admit error": (["shares", "--master", "{m}", *T, "--admit", "--pod", "p"],
                             {("POST", "/shares"): [(500, "boom\n")]}),
    "shares --admit without a pod": (["shares", "--master", "{m}", *T, "--admit"], {}),
    "shares --admit, bad candidate": (["shares", "--master", "{m}", *T, "--admit", "--pod",
                                       "p", "--chip", "nodeless"], {}),
    "shares --release": (["shares", "--master", "{m}", *T, "--release", "--namespace", "ml",
                          "--pod", "p"], {("DELETE", "/shares/ml/p"): [(200, '{"released": []}')]}),
    "shares --release, none held": (["shares", "--master", "{m}", *T, "--release", "--pod",
                                     "gone"], {("DELETE", "/shares/default/gone"): [
                                         (404, "404 gone holds no shares\n")]}),
}

#: the exit code each scenario must end in (both CLIs)
EXITS = {
    "add ok": 0, "add insufficient": 1, "add entire, namespace": 0, "add, no credentials": 1,
    "add, the env's token": 0, "add, every replica dead": 1, "add, dead then live": 0,
    "remove ok": 0, "remove forced, refused": 1, "bulk-add all": 0,
    "bulk-add partial, entire": 1, "bulk-add refused": 1, "bulk-add unparseable": 1,
    "bulk-add bad count": 1, "intent set": 0, "intent set, unknown pod": 1, "intent get": 0,
    "intent get, none": 1, "intent delete": 0, "intent delete, none": 1, "intent list": 0,
    "intent list, refused": 1, "migrate rejected": 2, "migrate error": 1, "migrate started": 0,
    "migrate --wait succeeded": 0, "migrate --wait rolled_back": 3,
    "migrate --wait failed": 3, "migrate --wait aborted": 3,
    "migrate --wait, a poll fails once": 0, "migrate --wait, never terminal": 1,
    "migrate status, all": 0, "migrate status, one": 0, "migrate status, unknown": 2,
    "migrate status, error": 1, "migrate status, unparseable": 0, "migrate abort": 0,
    "migrate abort, terminal": 2, "migrate abort, error": 1,
    "audit filtered, read token": 0, "audit, both tokens": 0, "audit error": 1, "trace": 0,
    "trace unknown": 2, "trace error": 1, "why": 0, "why, quarantined node": 0,
    "why, quarantined without a reason": 0, "why, no health plane": 0, "why, starvation": 0,
    "why, pool disabled": 0, "why, adopted warm": 0, "why, cause unknown": 0,
    "why, incomplete": 3, "why, unknown": 2, "why, error": 1, "why, unparseable": 1,
    "timeline": 0, "timeline error": 1, "timeline unparseable": 1, "fleet, stale nodes": 0,
    "fleet error": 1, "fleet unparseable": 1, "slo ok": 0, "slo fast hot": 0,
    "slo slow elevated": 0, "slo breach": 3, "slo error": 1, "slo unparseable": 1,
    "tenants": 0, "tenants, an open window": 3, "tenants, one": 0, "tenants, absent": 2,
    "tenants error": 1, "tenants unparseable": 1, "capacity ok": 0,
    "capacity, demand unsatisfiable": 3, "capacity, no intents": 0,
    "capacity, shape infeasible": 3, "capacity, shape after defrag": 0,
    "capacity, shape unknown": 2, "capacity error": 1, "capacity unparseable": 1,
    "apihealth healthy": 0, "apihealth degraded": 3, "apihealth, writes pending": 3,
    "apihealth error": 1, "apihealth unparseable": 1, "shards": 0, "shards error": 1,
    "recovery healthy": 0, "recovery suspect": 3, "recovery evacuated": 3,
    "recovery error": 1, "recovery unparseable": 1, "recovery --evacuate": 0,
    "recovery --evacuate refused": 1, "health": 0, "health, quarantined": 3,
    "health, quarantined but evacuated": 0, "health error": 1, "health unparseable": 1,
    "health --quarantine": 0, "health --release refused": 2, "health --quarantine error": 1,
    "defrag": 0, "defrag, API gated": 3, "defrag, SLO gated": 3, "defrag error": 1,
    "defrag unparseable": 1, "defrag --plan": 0, "defrag --plan refused": 2,
    "defrag --run degraded": 2, "defrag --run error": 1, "defrag --pause": 0,
    "autoscale": 0, "autoscale, paused": 3, "autoscale, gated": 3, "autoscale error": 1,
    "autoscale unparseable": 1, "autoscale --pause": 0, "autoscale --resume refused": 2,
    "autoscale --evaluate degraded": 2, "autoscale --evaluate error": 1, "shares": 0,
    "shares, overbooked": 3, "shares error": 1, "shares unparseable": 1,
    "shares --admit": 0, "shares --admit refused": 2, "shares --admit error": 1,
    "shares --admit without a pod": 2, "shares --admit, bad candidate": 2,
    "shares --release": 0, "shares --release, none held": 1,
}

#: the replica lists other than the scripted master alone
MASTERS = {"add, dead then live": f"{DEAD},{{m}}"}


def test_every_scenario_has_its_exit_and_every_verb_is_covered():
    assert set(SCENARIOS) == set(EXITS)
    verbs = {argv[0] if argv[0] not in ("intent", "migrate") else " ".join(argv[:2])
             for argv, _ in SCENARIOS.values()}
    parser_verbs = set()
    for action in cli.build_parser()._subparsers._group_actions:
        for name, sub in action.choices.items():
            nested = [a for a in sub._actions if isinstance(a, argparse._SubParsersAction)]
            parser_verbs |= ({f"{name} {n}" for n in nested[0].choices} if nested else {name})
    local = {"devices", "probe", "mount", "unmount"}
    assert verbs == parser_verbs - local


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_request_parity(name, monkeypatch):
    monkeypatch.setenv("TPUMOUNTER_AUTH_TOKEN", TEST_AUTH_TOKEN)
    argv, answers = SCENARIOS[name]
    seen = _parity(argv, answers, MASTERS.get(name, "{m}"))
    assert seen["code"] == EXITS[name], seen
    auths = {r[2] for r in seen["requests"]}
    if "--token" not in argv:
        assert auths <= {f"Bearer {TEST_AUTH_TOKEN}", READ_BEARER}, seen
    elif argv[argv.index("--token") + 1] == "":
        assert auths == {None}, seen
    else:
        assert auths <= {BEARER, READ_BEARER}, seen


def test_the_port_speaks_the_port_routes_and_keys():
    """The parity's rename map, pinned on the port's own requests: /addgpu,
    /removegpu, /batch/addgpu with "gpus", the intent and shares bodies with
    the reference's keys."""
    seen = _parity(*SCENARIOS["bulk-add all"])
    (method, path, _, body), = seen["requests"]
    assert (method, path) == ("POST", "/batch/addgpu")
    assert body == {"targets": [{"namespace": "ns", "pod": "a", "gpus": 3},
                                            {"namespace": "default", "pod": "b"}]}
    seen = _parity(*SCENARIOS["add ok"])
    assert seen["requests"][0][1] == "/addgpu/namespace/default/pod/p/gpu/2/isEntireMount/false"
    seen = _parity(*SCENARIOS["remove ok"])
    assert seen["requests"][0][1::2] == ("/removegpu/namespace/default/pod/p/force/false",
                                         "uuids=U1%2CU2")
    seen = _parity(*SCENARIOS["intent set"])
    assert seen["requests"][0][3] == {"desiredChips": 3, "minChips": 1, "priority": 2}
    seen = _parity(*SCENARIOS["shares --admit"])
    body = seen["requests"][0][3]
    assert (body["chips"], body["inventory"]) == (2, {"G0": "node-a", "G1": "node-b"})


# --- the traps ---

def _cluster_stack(tmp_path, gpus: int):
    from gpumounter_tpu_torch.entry import _MasterStack
    from gpumounter_tpu_torch.testing.cluster import FakeCluster
    cluster = FakeCluster.with_fake_gpus(str(tmp_path / "fake"), gpus)
    dev = tmp_path / "container-dev"
    dev.mkdir()
    return _MasterStack(cluster, {cluster.node_name: str(dev)}), cluster, str(dev)


def test_bulk_add_with_a_count_mounts_that_many_gpus(tmp_path):
    stack, cluster, dev = _cluster_stack(tmp_path, 4)
    with stack:
        pod = cluster.add_target_pod("serve-a")
        cluster.add_target_pod("serve-b")
        code, out, err = _run(cli.main, ["bulk-add", "--master", stack.base, "--target",
                                         "default/serve-a:3", "--target", "serve-b"])
        assert code == 0, (out, err)
        answer = json.loads(out)
        assert (answer["summary"]["total"], answer["summary"]["success"]) == (2, 2)
        assert [len(r["uuids"]) for r in answer["results"]] == [3, 1]
        assert len(stack.held(cluster.node_name, pod)) == 3 and cluster.free_gpu_count() == 0
        # both pods mount into the node's one container directory here
        assert [n for n in sorted(os.listdir(dev)) if re.fullmatch(r"nvidia\d+", n)] == [
            "nvidia0", "nvidia1", "nvidia2", "nvidia3"]


def test_the_cli_never_calls_the_tpu_routes():
    with open(cli.__file__) as f:
        source = f.read()
    assert "/addtpu" not in source and "/removetpu" not in source
    assert "/batch/addtpu" not in source and "/tpu/" not in source
    for name in ("add ok", "remove ok", "bulk-add all"):
        master = _Scripted({})
        try:
            argv = [a.replace("{m}", master.base) for a in SCENARIOS[name][0]]
            _run(cli.main, _port_argv(argv))
        finally:
            master.stop()
        assert all("tpu" not in path for _, path, _, _ in master.requests), master.requests


def test_a_dead_replica_before_a_live_one_fails_over(tmp_path):
    stack, cluster, dev = _cluster_stack(tmp_path, 2)
    with stack:
        cluster.add_target_pod("p")
        code, out, err = _run(cli.main, ["add", "--master", f"{DEAD},{stack.base}", "--pod", "p"])
        assert (code, out) == (0, "Add GPU Success\n"), err
        code, out, err = _run(cli.main, ["add", "--master", DEAD, "--pod", "p"])
        assert code == 1 and out == ""
        assert err.startswith("error: no master endpoint reachable") and err.count("\n") == 1


# --- the local verbs on a fake host ---

@pytest.fixture()
def fake_host(tmp_path, monkeypatch):
    backend = FakeDeviceBackend.create(str(tmp_path / "fakedev"), 4)
    monkeypatch.setenv("FAKE_DEVICE_DIR", backend.root)
    target = tmp_path / "container-dev"
    target.mkdir()
    return backend, str(target)


def test_devices_lists_the_reference_keys(fake_host):
    backend, _ = fake_host
    code, out, _ = _run(cli.main, ["devices"])
    assert code == 0
    listed = json.loads(out)
    assert [d["uuid"] for d in listed] == [d.uuid for d in backend.list_devices()]
    assert all(set(d) == {"index", "uuid", "path", "major", "minor"} for d in listed)
    with open(backend.list_devices()[1].device_path, "rb"):
        code, out, _ = _run(cli.main, ["devices", "--busy"])
    listed = json.loads(out)
    assert listed[1]["holder_pids"] == [os.getpid()] and listed[0]["holder_pids"] == []


def test_probe_reports_the_port_keys(fake_host, monkeypatch, tmp_path):
    """`probe` names the native layer's artifacts, the configured ones or
    where the build puts them, and whether each is there; it builds
    nothing."""
    from gpumounter_tpu_torch import native
    monkeypatch.setenv("GPU_IDENTITY_SOURCE", "procfs")
    code, out, _ = _run(cli.main, ["probe"])
    report = json.loads(out)
    assert code == 0
    assert set(report) == {"identity_source", "nvml", "gpus", "cgroup_version",
                           "cgroup_driver", "nsexec", "nsexec_built", "native_lib",
                           "native_lib_built"}
    assert (report["identity_source"], report["gpus"], report["nsexec"],
            report["native_lib"]) == ("procfs", 4, str(native.artifact_path("nsexec")),
                                      str(native.artifact_path("native_lib")))
    assert report["nvml"] in ("loaded", "unavailable")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("TPUMOUNTER_NSEXEC", str(tmp_path / "prebuilt-nsexec"))
    code, out, _ = _run(cli.main, ["probe"])
    report = json.loads(out)
    assert (report["nsexec"], report["nsexec_built"]) == (str(tmp_path / "prebuilt-nsexec"),
                                                          False)
    assert (report["native_lib"], report["native_lib_built"]) == (
        str(native.artifact_path("native_lib")), False)
    assert not (tmp_path / "build").exists()


def test_mount_then_unmount_and_a_busy_unmount(fake_host):
    backend, target = fake_host
    base = ["--target-dev", target]
    code, out, err = _run(cli.main, ["mount", *base, "--gpus", "2"])
    assert code == 0, err
    mounted = [json.loads(line)["mounted"] for line in out.splitlines()]
    assert mounted == [d.uuid for d in backend.list_devices()[:2]]
    assert {"nvidia0", "nvidia1"} <= set(os.listdir(target))
    code, _, err = _run(cli.main, ["mount", *base, "--gpus", "5"])
    assert (code, err) == (1, "error: only 4 GPU(s) available\n")
    code, _, err = _run(cli.main, ["mount", *base, "--uuid", "GPU-nope"])
    assert (code, err) == (1, "error: no device with uuid GPU-nope\n")
    first, second = mounted
    with open(os.path.join(target, "nvidia1"), "rb"):
        code, out, err = _run(cli.main, ["unmount", *base, "--uuid", first, "--uuid", second])
    assert code == 2 and err.startswith("busy: ")
    assert [json.loads(line)["unmounted"] for line in out.splitlines()] == [first]
    assert "nvidia1" in os.listdir(target) and "nvidia0" not in os.listdir(target)
    code, out, _ = _run(cli.main, ["unmount", *base, "--uuid", second, "--uuid", "GPU-nope"])
    assert code == 1 and json.loads(out)["unmounted"] == second
    assert "nvidia1" not in os.listdir(target)


def test_a_busy_unmount_with_force_goes_through(fake_host):
    backend, target = fake_host
    (dev,) = backend.list_devices()[:1]
    assert _run(cli.main, ["mount", "--target-dev", target, "--uuid", dev.uuid])[0] == 0
    holder = subprocess.Popen([sys.executable, "-c", "import sys, time\n"
                               f"f = open({os.path.join(target, 'nvidia0')!r}, 'rb')\n"
                               "print('held', flush=True)\ntime.sleep(60)"],
                              stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "held"
        code, _, err = _run(cli.main, ["unmount", "--target-dev", target, "--uuid", dev.uuid])
        assert code == 2 and str(holder.pid) in err
        code, out, _ = _run(cli.main, ["unmount", "--target-dev", target, "--uuid", dev.uuid,
                                       "--force"])
        assert code == 0 and json.loads(out)["unmounted"] == dev.uuid
        assert holder.wait(timeout=30) != 0  # the holder was killed
    finally:
        if holder.poll() is None:
            holder.kill()
            holder.wait()


# --- imports ---

def test_importing_the_cli_loads_no_torch_numpy_or_grpc():
    prog = ("import sys, gpumounter_tpu_torch.cli\n"
            "print(sorted(m for m in ('torch', 'numpy', 'grpc') if m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert (out.returncode, out.stdout.strip()) == (0, "[]"), out.stderr[-2000:]


def test_the_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "gpumounter_tpu_torch.cli", "add", "--master",
                          DEAD, "--pod", "p", "--token", "x"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 1 and out.stdout == ""
    assert out.stderr.splitlines()[-1].startswith("error: no master endpoint reachable")


# --- the reference's 17 CLI cases, against the port ---

@contextlib.contextmanager
def _served(app):
    httpd = build_http_server(app, port=0, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cli_apihealth_verb():
    """test_api_health.py::test_cli_apihealth_verb."""
    fake = FakeKubeClient()
    app = MasterApp(fake, cfg=Config(api_health_degraded_failures=2,
                                     api_health_down_after_s=60.0))
    try:
        with _served(app) as base:
            assert _run(cli.main, ["apihealth", "--master", base])[0] == 0
            fake.set_partitioned(True)
            for _ in range(2):
                with pytest.raises(Exception):
                    app.kube.get_pod("default", "x")
            fake.set_partitioned(False)
            # the route reads no API: the verdict stays until two successes
            assert _run(cli.main, ["apihealth", "--master", base])[0] == 3
    finally:
        app.close()


def test_why_and_timeline_cli(tmp_path):
    """test_assembly.py::test_why_and_timeline_cli."""
    from gpumounter_tpu_torch.entry import _add_path
    stack, cluster, _ = _cluster_stack(tmp_path, 4)
    with stack:
        pod = cluster.add_target_pod("asm-pod")
        status, body, _, tid = stack.traced("GET", _add_path(pod, 1))
        assert status == 200, body
        code, out, _ = _run(cli.main, ["why", "--master", stack.base, tid])
        assert code == 0, out
        assert "dominant phase:" in out
        assert "slave_pod_schedule" in out or "cgroup_grant" in out
        assert _run(cli.main, ["why", "--master", stack.base, "feedface"])[0] == 2
        code, out, _ = _run(cli.main, ["timeline", "--master", stack.base, "--trace", tid])
        assert code == 0
        records = json.loads(out[out.index("{"):])["records"]
        assert {"span", "audit"} <= {r["kind"] for r in records}, records
        stamps = [r["at"] for r in records]
        assert stamps == sorted(stamps)


def test_cli_token_flag_and_broken_file(tmp_path, monkeypatch):
    """test_auth.py::test_cli_token_flag_and_broken_file."""
    assert cli._remote_token(argparse.Namespace(token="abc")) == "abc"
    assert cli._remote_token(argparse.Namespace(token="")) is None
    monkeypatch.setenv("TPUMOUNTER_AUTH_TOKEN", "")
    monkeypatch.setenv("TPUMOUNTER_AUTH_TOKEN_FILE", str(tmp_path / "missing"))
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as exc:
        cli._remote_token(argparse.Namespace(token=None))
    assert exc.value.code == 2
    assert "unreadable" in err.getvalue() and err.getvalue().count("\n") == 1


def _capacity_payload(verdict="admissible", satisfiable=True):
    """test_capacity.py's _cli_payload, keyed by the port's shape."""
    return {"fleet": {"free": 4, "total": 8, "warm": 0, "fenced": 0,
                      "fragmentation_index": 0.0, "largest_block": 4, "hosts": 1,
                      "hosts_reporting": 1},
            "feasibility": {"nvidia-h100-80gb-4": {
                "verdict": verdict, "hosts_admissible_now": 1, "hosts_needed": 1,
                "hosts_after_defrag": 1, "blocking_hosts": []}},
            "headroom": {"forecast": "ok", "free_chips": 4, "queue_depth": 0,
                         "tokens_per_s": 0, "tenants": 0},
            "demand": {"intents": 1, "desired_chips": 9, "actual_chips": 1, "gap": 8,
                       "satisfiable": satisfiable}}


def _stubbed(monkeypatch, argv, status, payload, calls=None):
    """`argv` through the port's parser with ``_http`` answering (status,
    payload) and no token resolution, as the reference's stubbed cases."""
    def fake_http(args, method, path, form=None, token=None, json_body=None):
        if calls is not None:
            calls.append((method, path, json_body))
        return status, payload if isinstance(payload, str) else json.dumps(payload)

    monkeypatch.setattr(cli, "_http", fake_http)
    monkeypatch.setattr(cli, "_obs_token", lambda args: None)
    monkeypatch.setattr(cli, "_remote_token", lambda args: None)
    parsed = cli.build_parser().parse_args(argv)
    return parsed.fn(parsed)


def test_cli_capacity_exit_codes(monkeypatch, capsys):
    """test_capacity.py::test_cli_capacity_exit_codes."""
    cap = ["capacity", "--master", "http://x"]
    accel = ["--accel-type", "nvidia-h100-80gb-4"]
    assert _stubbed(monkeypatch, cap, 200, _capacity_payload()) == 0
    assert _stubbed(monkeypatch, cap + accel, 200, _capacity_payload("infeasible")) == 3
    assert _stubbed(monkeypatch, cap + accel, 200,
                    _capacity_payload("admissible-after-defrag")) == 0
    assert _stubbed(monkeypatch, cap + ["--accel-type", "bogus"], 404, {}) == 2
    assert _stubbed(monkeypatch, cap, 200, _capacity_payload(satisfiable=False)) == 3
    assert "DEMAND UNSATISFIABLE" in capsys.readouterr().err


def test_cli_why_names_pool_starvation(monkeypatch, capsys):
    """test_capacity.py::test_cli_why_names_pool_starvation."""
    def run(hit, gap, enabled):
        doc = {"op": "http.add", "wall_ms": 100.0, "nodes": ["n"], "complete": True,
               "roots": 1, "critical_path": [{"phase": "slave_pod_schedule", "ms": 88.7,
                                              "share": 0.887}],
               "dominant": {"phase": "slave_pod_schedule", "share": 0.887},
               "phases": {"slave_pod_schedule": 88.7},
               "spans": [{"name": "mount.slave_pod_schedule",
                          "attrs": {"pool_hit": hit, "pool_gap": gap, "pool_enabled": enabled}}]}
        rc = _stubbed(monkeypatch, ["why", "--master", "http://x", "deadbeef"], 200, doc)
        return rc, capsys.readouterr().out

    rc, out = run(0, 2, True)
    assert rc == 0 and "warm-pool starvation" in out
    rc, out = run(0, 2, False)
    assert "scheduler wait" in out and "warm pool disabled" in out
    rc, out = run(2, 0, True)
    assert "scheduler wait" in out


def test_intent_cli_verbs():
    """test_elastic_intents.py::test_intent_cli_verbs."""
    kube = FakeKubeClient()
    kube.create_pod("default", {"metadata": {"name": "trainer", "namespace": "default"},
                                "spec": {"containers": [{"name": "main"}]}})
    app = MasterApp(kube, cfg=Config())
    try:
        with _served(app) as base:
            common = ["--master", base, "--pod", "trainer"]
            assert _run(cli.main, ["intent", "set", *common, "--gpus", "3", "--min-gpus", "1",
                                   "--priority", "2"])[0] == 0
            assert _run(cli.main, ["intent", "get", *common])[0] == 0
            assert _run(cli.main, ["intent", "list", "--master", base])[0] == 0
            assert _run(cli.main, ["intent", "delete", *common])[0] == 0
            assert _run(cli.main, ["intent", "get", *common])[0] == 1  # gone now
    finally:
        app.close()


def _rollup(count=0, buckets=()):
    """test_fleet.py's _rollup."""
    return {"fleet": {"mount_count": count, "mount_buckets": [list(b) for b in buckets],
                      "mount_success": 0.0, "mount_error": 0.0},
            "master": {"heals": 0.0, "heal_failures": 0.0}}


def test_fleet_and_slo_cli_verbs():
    """test_fleet.py::test_fleet_and_slo_cli_verbs."""
    app = MasterApp(FakeKubeClient(), cfg=Config(fleet_scrape_interval_s=3600.0))
    try:
        with _served(app) as base:
            code, out, _ = _run(cli.main, ["fleet", "--master", base])
            assert code == 0 and '"fleet"' in out and '"nodes"' in out
            code, out, _ = _run(cli.main, ["slo", "--master", base])
            assert code == 0 and "mount-latency-50ms" in out
            clock = [0.0]
            app.slo.clock = lambda: clock[0]
            app.slo.ingest(_rollup(count=10, buckets=[(0.05, 0), (0.1, 10)]))
            assert _run(cli.main, ["slo", "--master", base])[0] == 3
    finally:
        app.close()


def test_cli_exit_codes(tmp_path):
    """test_migrate.py::test_cli_exit_codes."""
    from test_torch_migrate import NODE_A, NODE_B, _port_stack, _wait_for

    with _port_stack(tmp_path) as side:
        base, cluster = side.base, side.cluster
        cluster.add_target_pod("trainer-a", node=NODE_A)
        cluster.add_target_pod("trainer-b", node=NODE_B)
        start = ["migrate", "start", "--master", base]
        assert _run(cli.main, [*start, "--pod", "trainer-a", "--dest-pod",
                               "trainer-a"])[0] == cli.EXIT_REJECTED
        assert _run(cli.main, [*start, "--pod", "ghost", "--dest-pod",
                               "trainer-b"])[0] == cli.EXIT_REJECTED
        # mid-flight: the destination full -> rolled back -> exit 3
        assert _run(cli.main, ["add", "--master", base, "--pod", "trainer-a", "--num",
                               "4"])[0] == 0
        res = cluster.cfg.gpu_resource_name
        cluster.kube.create_pod("default", {
            "metadata": {"name": "hog", "namespace": "default"},
            "spec": {"nodeSelector": {"kubernetes.io/hostname": NODE_B},
                     "containers": [{"name": "main", "resources": {
                         "limits": {res: "6"}, "requests": {res: "6"}}}]}})
        _wait_for(lambda: cluster.free_gpu_count(NODE_B) == 0, 5.0, "hog pod never scheduled")
        assert _run(cli.main, [*start, "--pod", "trainer-a", "--dest-pod", "trainer-b",
                               "--wait", "--wait-timeout", "30", "--poll-interval",
                               "0.1"])[0] == cli.EXIT_FAILED
        assert _run(cli.main, ["migrate", "status", "--master", base])[0] == cli.EXIT_OK
        assert _run(cli.main, ["migrate", "status", "--master", base, "--id",
                               "nope"])[0] == cli.EXIT_REJECTED


def test_audit_and_trace_cli_verbs():
    """test_obs.py::test_audit_and_trace_cli_verbs."""
    app = MasterApp(FakeKubeClient(), cfg=Config())
    with trace.span("cli-op") as ctx:
        audit.AUDIT.record("worker.AddGPU", namespace="default", pod="cli-pod",
                           chips=["GPU-cli1"], outcome="Success")
    try:
        with _served(app) as base:
            code, out, _ = _run(cli.main, ["audit", "--master", base, "--pod", "cli-pod",
                                           "--op", "worker."])
            assert code == 0 and "GPU-cli1" in out and ctx.trace_id in out
            code, out, _ = _run(cli.main, ["trace", ctx.trace_id, "--master", base])
            assert code == 0 and "cli-op" in out
            assert _run(cli.main, ["trace", "0" * 32, "--master", base])[0] == 2
    finally:
        app.close()


def _inject_tenants(app, tenants: dict, stale_node: bool = False) -> None:
    """test_tenant_telemetry.py's _inject_tenants: a collected rollup
    planted, so that the routes serve without live workers."""
    entry = {"address": "10.0.0.1:1200", "collected_at": time.time(), "mode": "rpc",
             "tenants": tenants, "mount": {"count": 0}, "breaker": "closed"}
    nodes = {"node-1": entry}
    if stale_node:
        nodes["node-dark"] = {"address": "10.0.0.2:1200", "stale": True,
                              "error": "RpcError: unreachable",
                              "collected_at": time.time() - 120.0, "tenants": {}}
        nodes["node-never"] = {"address": "10.0.0.3:1200", "stale": True,
                               "error": "RpcError: unreachable", "tenants": {}}
    with app.fleet._lock:
        app.fleet._nodes = nodes
        app.fleet._collected_at = time.time()


def test_cli_tenants_fleet_and_slo_verbs():
    """test_tenant_telemetry.py::test_cli_tenants_fleet_and_slo_verbs."""
    from test_tenant_telemetry import FakeClock

    from gpumounter_tpu_torch.torchside.telemetry import CAUSE_MIGRATION, TenantTelemetry
    app = MasterApp(FakeKubeClient(), cfg=Config(fleet_scrape_interval_s=3600.0))
    clock = FakeClock()
    tel = TenantTelemetry(tenant="team-a/trainer", namespace="default", pod="trainer",
                          clock=clock, stall_min_s=1.0, stall_factor=10.0)
    tel.begin_disruption(CAUSE_MIGRATION, trace_id="tr-1", detail="m1")
    clock.advance(0.2)
    tel.end_disruption(CAUSE_MIGRATION)
    _inject_tenants(app, {"team-a/trainer": tel.snapshot()}, stale_node=True)
    try:
        with _served(app) as base:
            code, out, err = _run(cli.main, ["tenants", "--master", base])
            assert code == 0 and "team-a/trainer" in out and "migration: 1x" in err
            assert _run(cli.main, ["tenants", "--master", base, "--tenant", "nope"])[0] == 2
            tel.begin_disruption("evacuation", trace_id="tr-2")
            _inject_tenants(app, {"team-a/trainer": tel.snapshot()})
            code, _, err = _run(cli.main, ["tenants", "--master", base])
            assert code == 3 and "OPEN: evacuation" in err
            _inject_tenants(app, {}, stale_node=True)
            code, out, err = _run(cli.main, ["fleet", "--master", base])
            assert code == 0
            assert json.loads(out[out.index("{"):])["nodes"]["node-dark"]["stale"]
            assert "STALE: node node-dark" in err
            code, _, err = _run(cli.main, ["slo", "--master", base])
            assert code == 0
            assert "mount-latency-50ms: burn" in err
            assert "(fast)" in err and "(slow)" in err and "threshold 2.0x" in err
    finally:
        app.close()


SHARES = ["shares", "--master", "http://master:39100"]


def test_cli_shares_books_pane(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_books_pane."""
    calls = []
    rc = _stubbed(monkeypatch, SHARES, 200, {
        "weight_capacity": 100,
        "chips": {"GPU-0": {"node": "node-a", "tenants": 2, "load": 100,
                            "profiles": ["decode", "prefill"]}},
        "totals": {"shares": 2, "chips": 1, "shared_chips": 1}}, calls)
    assert rc == 0 and calls == [("GET", "/shares", None)]
    err = capsys.readouterr().err
    assert "GPU-0 on node-a: 2 tenant(s), load 100/100" in err
    assert "OVERBOOKED" not in err and "2 share(s) over 1 GPU(s), 1 co-located" in err


def test_cli_shares_exit_3_on_overbooked_chip(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_exit_3_on_overbooked_chip."""
    rc = _stubbed(monkeypatch, SHARES, 200, {
        "weight_capacity": 100,
        "chips": {"GPU-0": {"node": "node-a", "tenants": 3, "load": 130, "profiles": []}},
        "totals": {}})
    assert rc == 3 and "OVERBOOKED" in capsys.readouterr().err


def test_cli_shares_admit_posts_inventory(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_admit_posts_inventory, with --gpus and
    --gpu; the body keeps the reference's keys."""
    calls = []
    rc = _stubbed(monkeypatch, SHARES + ["--admit", "--pod", "prefill", "--profile", "prefill",
                                         "--gpus", "2", "--weight", "60", "--rate-budget", "8",
                                         "--gpu", "c0=node-a", "--gpu", "c1=node-b"],
                  200, {"admitted": []}, calls)
    assert rc == 0
    method, path, body = calls[0]
    assert (method, path) == ("POST", "/shares")
    assert body["inventory"] == {"c0": "node-a", "c1": "node-b"}
    assert body["weight"] == 60 and body["rate_budget"] == 8 and body["chips"] == 2


def test_cli_shares_admit_409_exits_2(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_admit_409_exits_2."""
    assert _stubbed(monkeypatch, SHARES + ["--admit", "--pod", "p", "--weight", "90"],
                    409, "409 no headroom") == 2


def test_cli_shares_admit_requires_pod(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_admit_requires_pod."""
    monkeypatch.setattr(cli, "_http", lambda *a, **k: pytest.fail("no HTTP call without --pod"))
    parsed = cli.build_parser().parse_args(SHARES + ["--admit"])
    assert parsed.fn(parsed) == 2
    assert "--pod is required" in capsys.readouterr().err


def test_cli_shares_bad_chip_spec_exits_2(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_bad_chip_spec_exits_2, as --gpu."""
    monkeypatch.setattr(cli, "_http", lambda *a, **k: pytest.fail("no HTTP call on a bad --gpu"))
    parsed = cli.build_parser().parse_args(SHARES + ["--admit", "--pod", "p", "--gpu",
                                                     "nodeless"])
    assert parsed.fn(parsed) == 2
    assert "bad --gpu" in capsys.readouterr().err


def test_cli_shares_release(monkeypatch, capsys):
    """test_vchip.py::test_cli_shares_release."""
    calls = []
    rc = _stubbed(monkeypatch, SHARES + ["--release", "--pod", "p"], 200, {"released": []},
                  calls)
    assert rc == 0 and calls[0][:2] == ("DELETE", "/shares/default/p")
    assert _stubbed(monkeypatch, SHARES + ["--release", "--pod", "gone"], 404,
                    "404 gone holds no shares") == 1


# --- the card's check, on the CPU ---

def test_cli_check_on_the_cpu():
    from gpumounter_tpu_torch.entry import cli_check
    report = cli_check("cpu", fake_gpus=8, repeats=2)
    assert report["live"] is None and len(report["import_ms"]) == 2
    f = report["fake"]
    assert f["probe"]["gpus"] == 8 and os.getpid() in f["devices"]["holder_pids"]
    assert len(f["cli_add_ms"]) == len(f["cli_remove_ms"]) == len(f["http_add_ms"]) == 2
    assert f["refusal"] is None and len(f["uuids"]) == 1
    assert f["capacity"]["exit"] == 0 and f["capacity"]["fleet"]["held"] == 1
    assert f["dominant"].endswith("% of wall time)")
    assert {"devices", "probe", "add", "audit", "trace", "why", "remove", "fleet",
            "apihealth", "shards"} <= set(f["verb_ms"])

