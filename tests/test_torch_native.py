"""The port's native layer (``gpumounter_tpu_torch/native/``): the compiled
namespace helper held against its plain version ``nsutil/nsexec.py``, the
native /proc scan against the plain scan, the reference's
``tests/test_native.py`` cases as the port has them, and a failed build,
which raises and falls back to nothing.

Both helpers run against this process's own mount namespace (setns into it
needs CAP_SYS_ADMIN) and make nodes under tmp_path (mknod needs CAP_MKNOD);
each skips where the host refuses it.
"""

from __future__ import annotations

import errno
import os
import shutil
import stat as statmod
import subprocess
import sys
import textwrap

import pytest

from gpumounter_tpu_torch import native
from gpumounter_tpu_torch.device.backend import scan_proc_for_device, scan_proc_for_device_plain
from gpumounter_tpu_torch.device.gpu import GpuDevice
from gpumounter_tpu_torch.nsutil import ns

HELPERS = {"compiled": ns._helper_argv, "plain": ns.plain_helper_argv}
#: a name with a space, quotes, a backslash, a non-ASCII letter and a byte
#: that is not UTF-8 (as this process decodes a path): the report carries it
ODD_NAME = 'gpu "x" \\ é\udcff'
NULL_RDEV = os.stat("/dev/null").st_rdev
FULL_RDEV = os.stat("/dev/full").st_rdev


@pytest.fixture(scope="module")
def mknod_capable(tmp_path_factory) -> bool:
    """Actual mknod capability: root without CAP_MKNOD (a user namespace)
    gets a PermissionError."""
    probe = tmp_path_factory.mktemp("mknod-probe") / "probe-node"
    try:
        os.mknod(probe, 0o666 | statmod.S_IFCHR, NULL_RDEV)
    except OSError:
        return False
    os.unlink(probe)
    return True


def _ns_path() -> str:
    return f"/proc/{os.getpid()}/ns/mnt"


def _run(helper: str, ns_path: str, ops: list, umask: int = 0o022) -> tuple[int, dict]:
    old = os.umask(umask)
    try:
        code, report, stderr = ns.run_helper(HELPERS[helper](ns_path, ops))
    finally:
        os.umask(old)
    assert report is not None, (code, stderr)
    if report.get("stage") == "enter" and ns_path == _ns_path():
        pytest.skip(f"no namespace entry here: {report['message']}")
    return code, report


def _failure(stage: str, what: str, filename: str, err: int) -> tuple[int, dict]:
    return 1, {"stage": stage, "errno": err, "strerror": os.strerror(err), "filename": filename,
               "message": f"{what} {filename}: {os.strerror(err)}"}


def _node(path) -> tuple[int, int]:
    st = os.stat(path)
    assert statmod.S_ISCHR(st.st_mode)
    return st.st_mode & 0o7777, st.st_rdev


# --- (a) the compiled helper and the plain one, case by case ---

def _mknod_with_parents(tmp):
    node = str(tmp / ODD_NAME / "sub" / "nvidia0")
    ops = [["mknod", node, os.major(FULL_RDEV), os.minor(FULL_RDEV), 0o666]]

    def check():
        assert _node(node) == (0o666, FULL_RDEV)  # chmod undid the umask
        for parent in (tmp / ODD_NAME, tmp / ODD_NAME / "sub"):
            assert os.stat(parent).st_mode & 0o777 == 0o755
    return _ns_path(), ops, (0, {"results": [None]}), check


def _mknod_twice(tmp):
    node = str(tmp / "nvidia1")
    op = ["mknod", node, os.major(FULL_RDEV), os.minor(FULL_RDEV), 0o666]
    return _ns_path(), [op, op], (0, {"results": [None, None]}), \
        lambda: _node(node) == (0o666, FULL_RDEV)


def _unlink_absent(tmp):
    return _ns_path(), [["unlink", str(tmp / "absent")]], (0, {"results": [None]}), None


def _missing(tmp):
    (tmp / "there").write_text("")
    paths = [str(tmp / "there"), str(tmp / "absent"), str(tmp / ODD_NAME), "/"]
    return _ns_path(), [["missing", paths], ["missing", []]], \
        (0, {"results": [paths[1:3], []]}), None


def _enter_failure(tmp):
    # a namespace of another type: setns(fd, CLONE_NEWNS) refuses it
    ns_path = f"/proc/{os.getpid()}/ns/net"
    return ns_path, [["missing", ["/unreached"]]], \
        _failure("enter", "setns", ns_path, errno.EINVAL), None


def _enter_no_process(tmp):
    ns_path = "/proc/0/ns/mnt"
    return ns_path, [], _failure("enter", "open", ns_path, errno.ENOENT), None


def _op_failure_unlink(tmp):
    (tmp / "a-dir").mkdir()
    done = str(tmp / "gone")
    open(done, "w").close()
    return _ns_path(), [["unlink", done], ["unlink", str(tmp / "a-dir")], ["unlink", done]], \
        _failure("op", "unlink", str(tmp / "a-dir"), errno.EISDIR), \
        lambda: not os.path.exists(done)


def _op_failure_parent(tmp):
    (tmp / "a-file").write_text("")
    node = str(tmp / "a-file" / "sub" / "nvidia0")
    return _ns_path(), [["mknod", node, 1, 7, 0o666]], \
        _failure("op", "mknod", str(tmp / "a-file" / "sub"), errno.ENOTDIR), None


CASES = {"mknod with parents, mode 0666 under umask 022": _mknod_with_parents,
         "a second mknod of the same node": _mknod_twice,
         "unlink of an absent node": _unlink_absent,
         "missing": _missing,
         "enter failure (a net namespace)": _enter_failure,
         "enter failure (no such process)": _enter_no_process,
         "op failure (unlink of a directory)": _op_failure_unlink,
         "op failure (a parent that is a file)": _op_failure_parent}
MKNOD_CASES = {"mknod with parents, mode 0666 under umask 022", "a second mknod of the same node"}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("helper", list(HELPERS))
def test_each_helper_gives_the_expected_results_and_reports(helper, case, tmp_path,
                                                            mknod_capable):
    if case in MKNOD_CASES and not mknod_capable:
        pytest.skip("no CAP_MKNOD here")
    ns_path, ops, want, check = CASES[case](tmp_path)
    assert _run(helper, ns_path, ops) == want
    if check is not None:
        assert check() is not False


@pytest.mark.parametrize("case", list(CASES))
def test_the_compiled_and_plain_helpers_agree_field_by_field(case, tmp_path, mknod_capable):
    if case in MKNOD_CASES and not mknod_capable:
        pytest.skip("no CAP_MKNOD here")
    got = {}
    for helper in HELPERS:
        tmp = tmp_path / helper
        tmp.mkdir()
        ns_path, ops, _, _ = CASES[case](tmp)
        code, report = _run(helper, ns_path, ops)
        got[helper] = (code, _renamed(report, str(tmp)))
    assert got["compiled"] == got["plain"]


def _renamed(value, tmp: str):
    """`value` with each helper's own directory named alike."""
    if isinstance(value, dict):
        return {k: _renamed(v, tmp) for k, v in value.items()}
    if isinstance(value, list):
        return [_renamed(v, tmp) for v in value]
    return value.replace(tmp, "TMP") if isinstance(value, str) else value


def test_a_helper_without_cap_mknod_reports_eperm_at_the_op(tmp_path):
    if shutil.which("setpriv") is None:
        pytest.skip("setpriv is needed to drop CAP_MKNOD")
    node = str(tmp_path / "nvidia3")
    ops = [["mknod", node, 195, 3, 0o666]]
    for helper in HELPERS:
        argv = ["setpriv", "--bounding-set=-mknod", "--inh-caps=-mknod", "--",
                *HELPERS[helper](_ns_path(), ops)]
        code, report, stderr = ns.run_helper(argv)
        if report is None:
            pytest.skip(f"setpriv refused here: {stderr.strip()}")
        if report.get("stage") == "enter":
            pytest.skip(f"no namespace entry here: {report['message']}")
        assert (code, report) == _failure("op", "mknod", node, errno.EPERM), helper


# --- (b) the reference's tests/test_native.py cases as the port has them ---

@pytest.mark.parametrize("helper", list(HELPERS))
@pytest.mark.parametrize("args", [[], ["/proc/self/ns/mnt", "mknod", "/x", "1"],
                                  ["/proc/self/ns/mnt", "mknod", "/x", "1", "x", "666"],
                                  ["/proc/self/ns/mnt", "mknod", "/x", "1", "3", "888"],
                                  ["/proc/self/ns/mnt", "missing", "3", "/a"],
                                  ["/proc/self/ns/mnt", "kill", "9"]],
                         ids=["no-args", "short-mknod", "bad-minor", "bad-mode",
                              "short-missing", "unknown-op"])
def test_the_helper_usage_exit_code(helper, args):
    argv = HELPERS[helper]("", [])[:-1] + args
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2 and proc.stdout == "" and "usage:" in proc.stderr


@pytest.mark.parametrize("helper", list(HELPERS))
def test_the_helper_mknods_and_unlinks_in_its_own_namespace(helper, tmp_path, mknod_capable):
    if not mknod_capable:
        pytest.skip("no CAP_MKNOD here")
    node = str(tmp_path / "nvidia9")
    major, minor = os.major(NULL_RDEV), os.minor(NULL_RDEV)
    mknod = ["mknod", node, major, minor, 0o666]
    assert _run(helper, _ns_path(), [mknod, mknod, ["missing", [node]]]) == (
        0, {"results": [None, None, []]})
    assert _node(node) == (0o666, NULL_RDEV)
    assert _run(helper, _ns_path(), [["unlink", node], ["unlink", node], ["missing", [node]]]) \
        == (0, {"results": [None, None, [node]]})


def test_the_helper_through_nsutil_one_exec_a_batch(tmp_path, monkeypatch, mknod_capable):
    """nsutil execs the compiled helper, never an interpreter on nsexec.py:
    one exec for the nodes of 2 GPUs and their companion, one for their
    removal, one for a ProbeGPU's look."""
    if not mknod_capable:
        pytest.skip("no CAP_MKNOD here")
    from gpumounter_tpu_torch.device.gpu import CompanionNode
    major, minor = os.major(NULL_RDEV), os.minor(NULL_RDEV)
    devs = [GpuDevice(index=i, device_path=f"/dev/nvidia{i}", major=major, minor=minor,
                      uuid=f"GPU-{i}", companions=[CompanionNode("nvidiactl", major, minor)])
            for i in range(2)]
    execs = []
    run = subprocess.run
    monkeypatch.setattr(ns.subprocess, "run", lambda argv, **kw: execs.append(argv[0])
                        or run(argv, **kw))
    try:
        missing = ns.inject_device_files(str(tmp_path), devs, pid=os.getpid())
    except ns.NamespaceError as exc:
        pytest.skip(f"no namespace entry here: {exc}")
    assert missing == []
    assert sorted(os.listdir(tmp_path)) == ["nvidia0", "nvidia1", "nvidiactl"]
    assert ns.device_node_exists(str(tmp_path / "nvidia1"), pid=os.getpid())
    ns.remove_device_files(str(tmp_path), devs, pid=os.getpid())
    assert sorted(os.listdir(tmp_path)) == ["nvidiactl"]
    assert execs == [native.helper_path()] * 3
    assert os.path.dirname(execs[0]) == str(native.BUILD_DIR)


# --- (c) the native scan against the plain scan ---

HOLDER = textwrap.dedent("""
    import sys, time
    held = [open(path, "rb") for path in sys.argv[1:]]
    print("holding", flush=True)
    time.sleep(120)
""")


def test_the_native_scan_finds_what_the_plain_scan_finds(tmp_path, mknod_capable):
    """A child holds a regular file open and, where mknod works, a fake
    character device (a node of /dev/full's numbers, which few processes
    hold); both scans, over the same /proc, find the same PIDs: by path, by
    rdev, by both."""
    target = tmp_path / "held-file"
    target.write_text("x")
    held = [str(target)]
    fake = tmp_path / "fake-nvidia0"
    if mknod_capable:
        os.mknod(fake, 0o666 | statmod.S_IFCHR, FULL_RDEV)
        held.append(str(fake))
    child = subprocess.Popen([sys.executable, "-c", HOLDER, *held], stdout=subprocess.PIPE,
                             text=True)
    try:
        assert child.stdout.readline().strip() == "holding"
        queries = [(None, None, str(target)), (0, 0, str(target)),
                   (None, None, str(tmp_path / "not-held"))]
        if mknod_capable:
            queries += [(os.major(FULL_RDEV), os.minor(FULL_RDEV), ""),
                        (os.major(FULL_RDEV), os.minor(FULL_RDEV), str(fake)),
                        (None, None, str(fake))]
        for query in queries:
            got = sorted(scan_proc_for_device(*query))
            want = sorted(scan_proc_for_device_plain(*query))
            assert got == want, query
            assert (child.pid in got) == (query[2] != str(tmp_path / "not-held")), query
    finally:
        child.kill()
        child.wait(timeout=30)


def test_the_native_scan_reads_the_given_proc_root(tmp_path):
    """A made /proc: PIDs 10 and 30 hold the target, 20 another file; the
    entries that are no PID, and a PID without fd/, are passed over."""
    target, other = tmp_path / "target", tmp_path / "other"
    target.write_text("")
    other.write_text("")
    proc = tmp_path / "proc"
    for pid, links in {"10": [other, target], "20": [other], "30": [target], "self": [target],
                       "4x": [target]}.items():
        (proc / pid / "fd").mkdir(parents=True)
        for fd, link in enumerate(links):
            os.symlink(link, proc / pid / "fd" / str(fd))
    (proc / "40").mkdir()
    for query in [(None, None, str(target)), (None, None, str(other)), (None, None, "")]:
        got = scan_proc_for_device(*query, proc_root=str(proc))
        assert sorted(got) == sorted(scan_proc_for_device_plain(*query, proc_root=str(proc)))
    assert sorted(scan_proc_for_device(None, None, str(target), proc_root=str(proc))) == [10, 30]
    assert scan_proc_for_device(None, None, str(target), proc_root=str(tmp_path / "absent")) \
        == scan_proc_for_device_plain(None, None, str(target),
                                      proc_root=str(tmp_path / "absent")) == []
    with pytest.raises(NotADirectoryError):
        scan_proc_for_device(None, None, str(target), proc_root=str(target))


def test_the_native_scan_grows_its_buffer(tmp_path, monkeypatch):
    """More holders than the first buffer holds: the scan calls again with
    the count it was told."""
    target = tmp_path / "target"
    target.write_text("")
    proc = tmp_path / "proc"
    for pid in range(1, 301):
        (proc / str(pid) / "fd").mkdir(parents=True)
        os.symlink(target, proc / str(pid) / "fd" / "0")
    got = scan_proc_for_device(None, None, str(target), proc_root=str(proc))
    assert sorted(got) == list(range(1, 301))


# --- (d) no fallback ---

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The native layer pointed at an empty build directory of its own, so
    that its first use builds; the checkout's artifacts stay as they are."""
    build_dir = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", build_dir)
    monkeypatch.delenv("TPUMOUNTER_NSEXEC", raising=False)
    monkeypatch.delenv("TPUMOUNTER_NATIVE_LIB", raising=False)
    return build_dir


def test_a_failed_build_raises_from_the_namespace_entry_and_the_scan(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "/bin/false")
    execs = []
    monkeypatch.setattr(ns.subprocess, "run", lambda argv, **kw: execs.append(argv))
    with pytest.raises(native.NativeError, match="native layer build failed:\n/bin/false "):
        ns.run_in_mount_ns(os.getpid(), [["missing", ["/"]]])
    with pytest.raises(native.NativeError, match="native layer build failed:\n/bin/false "):
        scan_proc_for_device(None, None, "/")
    assert execs == []  # nothing ran in place of the helper
    assert os.listdir(fresh_build) == []  # no half-built artifact left


def test_a_compile_error_names_the_compilers_output(fresh_build, tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")
    sources = tmp_path / "sources"
    shutil.copytree(native.SOURCE_DIR, sources)
    (sources / "nsexec.cpp").write_text("int main() { return undeclared; }\n")
    monkeypatch.setattr(native, "SOURCE_DIR", sources)
    with pytest.raises(native.NativeError, match="undeclared") as exc:
        native.helper_path()
    assert "nsexec.cpp" in str(exc.value) and "-Werror" in str(exc.value)


def test_no_compiler_is_named(fresh_build, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(native.NativeError, match="no C\\+\\+ compiler 'no-such-compiler'"):
        native.library()


def test_configured_artifacts_are_used_and_a_missing_one_raises(fresh_build, tmp_path,
                                                                monkeypatch):
    built = native.build(build_dir=tmp_path / "prebuilt")
    monkeypatch.setenv("TPUMOUNTER_NSEXEC", str(built["nsexec"]))
    monkeypatch.setenv("TPUMOUNTER_NATIVE_LIB", str(built["native_lib"]))
    assert native.helper_path() == str(built["nsexec"])
    assert native.library()._name == str(built["native_lib"])
    assert os.path.exists(fresh_build) is False  # nothing built at the default place
    monkeypatch.setenv("TPUMOUNTER_NSEXEC", str(tmp_path / "absent"))
    with pytest.raises(native.NativeError, match="nsexec_bin is set to .*absent"):
        ns.run_in_mount_ns(os.getpid(), [])


def test_a_helper_that_cannot_be_executed_is_named(tmp_path, monkeypatch):
    not_executable = tmp_path / "gpumounter-nsexec"
    not_executable.write_text("")
    monkeypatch.setenv("TPUMOUNTER_NSEXEC", str(not_executable))
    with pytest.raises(native.NativeError, match="cannot exec the namespace helper"):
        ns.run_in_mount_ns(os.getpid(), [])


CONCURRENT_BUILDS = textwrap.dedent("""
    import sys, threading
    from pathlib import Path
    from gpumounter_tpu_torch import native
    out = []
    threads = [threading.Thread(target=lambda: out.append(native.build(build_dir=Path(sys.argv[1]))))
               for _ in range(2)]
    [t.start() for t in threads]
    [t.join(timeout=240) for t in threads]
    assert len(out) == 2 and out[0] == out[1], out
    print(native.scan_device_holders(None, None, "/nothing-holds-this"))
""")


def test_concurrent_first_builds_do_not_race(tmp_path):
    """Two processes of two threads each build into one empty directory at
    once: each gets whole artifacts, and the directory holds one of each
    and no temporary file. (Two processes, not more: the compilers' burst
    lands on the other workers' timing tests.)"""
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_BUILDS, str(build_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
             for _ in range(2)]
    for proc in procs:
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
    assert sorted(os.listdir(build_dir)) == sorted(
        native.artifact_path(kind, build_dir).name for kind in native.ARTIFACTS)
    helper = native.artifact_path("nsexec", build_dir)
    assert subprocess.run([str(helper)], capture_output=True).returncode == 2
