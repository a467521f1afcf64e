"""The port's ``utils/file_mgr.py`` against the reference's: the cases of
``tests/test_file_mgr.py`` and the ``file_mgr.command`` cases of
``tests/test_resilience.py``, each run on both packages' ``FileMgr`` /
``CommandBackend`` with the reference's asserts, and the two packages'
return values held equal."""

import sys
import time

import pytest

from paddlebox_tpu.obs.hub import reset_hub as j_reset_hub
from paddlebox_tpu.resilience import faults as jfaults
from paddlebox_tpu.resilience import retry as jretry
from paddlebox_tpu.utils import file_mgr as jfm

from paddlebox_tpu_torch.obs.hub import reset_hub
from paddlebox_tpu_torch.resilience import faults, retry
from paddlebox_tpu_torch.utils import file_mgr as fm

PKGS = {"port": (fm, faults, retry, reset_hub),
        "jax": (jfm, jfaults, jretry, j_reset_hub)}


def _both(scenario, tmp_path):
    """``scenario(pkg, root)`` in each package under its own directory;
    the two results must be equal."""
    got = {}
    for name, pkg in PKGS.items():
        root = tmp_path / name
        root.mkdir()
        got[name] = scenario(pkg, root)
    assert got["port"] == got["jax"]
    return got["port"]


def _nosleep(retry_mod, **kw):
    kw.setdefault("base_delay", 0.001)
    kw.setdefault("sleep", lambda s: None)
    return retry_mod.RetryPolicy(**kw)


def _shim(tmp_path, body: str) -> list:
    sh = tmp_path / "shim.py"
    sh.write_text("import os, shutil, sys\nargs = sys.argv[1:]\n" + body)
    return [sys.executable, str(sh)]


def test_split_scheme():
    for path in ("/a/b", "file:///a", "hdfs://nn/a"):
        assert fm.split_scheme(path) == jfm.split_scheme(path)
    assert fm.split_scheme("/a/b") == ("file", "/a/b")
    assert fm.split_scheme("file:///a") == ("file", "/a")
    assert fm.split_scheme("hdfs://nn/a") == ("hdfs", "nn/a")


def test_local_roundtrip(tmp_path):
    def scenario(pkg, base):
        mgr = pkg[0].FileMgr()
        root = base / "store"
        out = [mgr.makedir(str(root))]
        src = base / "model.bin"
        src.write_bytes(b"x" * 128)
        remote = str(root / "day1" / "model.bin")
        out += [mgr.upload(str(src), remote), mgr.exists(remote),
                mgr.file_size(remote), mgr.count(str(root)),
                mgr.dus(str(root)), mgr.list_dir(str(root / "day1")),
                mgr.list_info(str(root / "day1"))]
        back = base / "restored.bin"
        out += [mgr.download(remote, str(back)), back.read_bytes()]
        renamed = str(root / "day1" / "model_v2.bin")
        out += [mgr.rename(remote, renamed), mgr.exists(remote),
                mgr.exists(renamed), mgr.truncate(renamed, 16),
                mgr.file_size(renamed), mgr.touch(str(root / "marker")),
                mgr.exists(str(root / "marker")), mgr.remove(str(root)),
                mgr.exists(str(root))]
        return out

    out = _both(scenario, tmp_path)
    assert out == [True, True, True, 128, 1, 128, ["model.bin"],
                   [("model.bin", 128)], True, b"x" * 128, True, False,
                   True, True, 16, True, True, True, False]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_unknown_scheme_raises(name):
    mgr = PKGS[name][0].FileMgr()
    with pytest.raises(KeyError):
        mgr.exists("afs://cluster/path")


def test_command_backend_registration(tmp_path):
    """A CommandBackend registered for a scheme is dispatched to; the
    'CLI' is a shim emulating ``hadoop fs -test/-put/-mv``."""
    shim = tmp_path / "fsshim.py"
    shim.write_text(
        "import os, shutil, sys\n"
        "def strip(p):\n"
        "    assert p.startswith('afs://'), p\n"
        "    return p[len('afs://'):]\n"
        "args = sys.argv[1:]\n"
        "if args[0] == '-test':\n"
        "    sys.exit(0 if os.path.exists(strip(args[2])) else 1)\n"
        "if args[0] == '-put':\n"
        "    dst = strip(args[2])\n"
        "    os.makedirs(os.path.dirname(dst), exist_ok=True)\n"
        "    shutil.copy(args[1], dst); sys.exit(0)\n"
        "if args[0] == '-mv':\n"
        "    os.replace(strip(args[1]), strip(args[2])); sys.exit(0)\n"
        "sys.exit(2)\n")

    def scenario(pkg, base):
        mgr = pkg[0].FileMgr()
        mgr.init(scheme="afs", command=[sys.executable, str(shim)])
        src = base / "f.txt"
        src.write_text("hi")
        dst = base / "remote" / "f.txt"
        out = [mgr.upload(str(src), f"afs://{dst}"),
               mgr.exists(f"afs://{dst}"),
               mgr.exists(f"afs://{base}/nope")]
        with pytest.raises(NotImplementedError):
            mgr.truncate(f"afs://{dst}", 1)
        return out

    assert _both(scenario, tmp_path) == [True, True, False]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_finalize_resets(name):
    mgr = PKGS[name][0].FileMgr()
    mgr.init(scheme="afs", command=["true"])
    mgr.finalize()
    with pytest.raises(KeyError):
        mgr.list_dir("afs://x")


def test_command_transient_failure_retried(tmp_path):
    """``file_mgr.command:fail:nth=1`` is retried through: one fault
    fired, one retry and one injected fault booked on each hub."""
    def scenario(pkg, base):
        fmod, fl, rt, reset = pkg
        hub = reset()
        try:
            plan = fl.FaultPlan.parse("file_mgr.command:fail:nth=1")
            be = fmod.CommandBackend(["true"], retry=_nosleep(
                rt, site="file_mgr.command", max_attempts=3))
            with fl.installed(plan):
                out = [be.exists("afs://whatever")]
            return out + [
                plan.stats()["file_mgr.command:fail"]["fired"],
                hub.counter("pbox_retry_attempts_total").value(
                    site="file_mgr.command"),
                hub.counter("pbox_faults_injected_total").value(
                    site="file_mgr.command", kind="fail")]
        finally:
            reset()

    assert _both(scenario, tmp_path) == [True, 1, 1, 1]


def test_command_timeout_is_transient(tmp_path):
    def scenario(pkg, base):
        fmod, _, rt, _ = pkg
        be = fmod.CommandBackend(["bash", "-c", "sleep 5", "shim"],
                                 timeout=0.2,
                                 retry=_nosleep(rt, site="file_mgr.command",
                                                max_attempts=2))
        t0 = time.monotonic()
        with pytest.raises(rt.RetryExhausted) as ei:
            be._run("-ls", "x")
        assert isinstance(ei.value.last, fmod.TransientCommandError)
        assert isinstance(ei.value.last, rt.TransientError)
        assert time.monotonic() - t0 < 3.0
        return ["timed out" in str(ei.value.last), ei.value.attempts]

    assert _both(scenario, tmp_path) == [True, 2]


def test_exists_distinguishes_absent_from_failure(tmp_path):
    cmd = _shim(tmp_path,
                "if args[0] == '-test':\n"
                "    p = args[2]\n"
                "    sys.exit(1 if 'absent' in p else "
                "(0 if 'present' in p else 2))\n"
                "sys.exit(2)\n")

    def scenario(pkg, base):
        fmod, _, rt, _ = pkg
        be = fmod.CommandBackend(cmd, retry=_nosleep(
            rt, site="file_mgr.command", max_attempts=2))
        out = [be.exists("afs://present/file"),
               be.exists("afs://absent/file")]
        # rc=2 (cluster trouble) must RAISE, never report "does not exist"
        with pytest.raises(rt.RetryExhausted) as ei:
            be.exists("afs://broken/file")
        assert isinstance(ei.value.last, fmod.TransientCommandError)
        return out + [ei.value.attempts]

    assert _both(scenario, tmp_path) == [True, False, 2]


def test_upload_puts_tmp_then_renames(tmp_path):
    def scenario(pkg, base):
        fmod, _, rt, _ = pkg
        oplog = base / "ops.log"
        cmd = _shim(base,
                    f"open({str(oplog)!r}, 'a').write(' '.join(args) + "
                    "'\\n')\n"
                    "def strip(p):\n"
                    "    assert p.startswith('afs://'), p\n"
                    "    return p[len('afs://'):]\n"
                    "if args[0] == '-put':\n"
                    "    dst = strip(args[2])\n"
                    "    os.makedirs(os.path.dirname(dst), exist_ok=True)\n"
                    "    shutil.copy(args[1], dst); sys.exit(0)\n"
                    "if args[0] == '-mv':\n"
                    "    os.replace(strip(args[1]), strip(args[2]))\n"
                    "    sys.exit(0)\n"
                    "sys.exit(2)\n")
        be = fmod.CommandBackend(cmd, retry=_nosleep(rt, max_attempts=1))
        src = base / "model.bin"
        src.write_bytes(b"payload")
        dst = base / "remote" / "model.bin"
        out = [be.upload(str(src), f"afs://{dst}"), dst.read_bytes()]
        ops = [line.split() for line in oplog.read_text().splitlines()]
        assert ops[0][0] == "-put" and ".tmp-" in ops[0][2]
        assert ops[1][0] == "-mv" and ops[1][2] == f"afs://{dst}"
        assert not any(".tmp-" in str(p)
                       for p in (base / "remote").iterdir())
        return out + [[op[0] for op in ops]]

    assert _both(scenario, tmp_path) == [True, b"payload", ["-put", "-mv"]]
