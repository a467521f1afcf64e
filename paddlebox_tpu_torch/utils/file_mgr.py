"""File manager: an AFS/HDFS-style storage facade (the port's copy of
``paddlebox_tpu/utils/file_mgr.py``; host-only code).

Reference: ``BoxFileMgr`` (fleet/box_wrapper.h:1016-1041, bound at
pybind/box_helper_py.cc:167-216) wraps the closed ``boxps::PaddleFileMgr``
with: init, list_dir, makedir, exists, download, upload, remove,
file_size, dus, truncate, touch, rename, list_info, count, finalize.
The reference also shells out to ``hadoop fs`` for dataset IO.

One ``FileMgr`` facade over scheme-registered backends. ``file://`` (and
bare paths) are implemented in full; remote schemes (afs://, hdfs://,
gs://) register either a real backend or a ``CommandBackend`` that
shells out to a configured CLI (the way the reference drives hadoop),
so production storage plugs in without changes to the callers.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Tuple

from paddlebox_tpu_torch.resilience.retry import TransientError
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def split_scheme(path: str) -> Tuple[str, str]:
    if "://" in path:
        scheme, rest = path.split("://", 1)
        return scheme, rest
    return "file", path


class LocalBackend:
    """POSIX filesystem backend (the file:// scheme and bare paths)."""

    def list_dir(self, path: str) -> List[str]:
        return sorted(os.listdir(path))

    def list_info(self, path: str) -> List[Tuple[str, int]]:
        out = []
        for name in sorted(os.listdir(path)):
            p = os.path.join(path, name)
            out.append((name, os.path.getsize(p) if os.path.isfile(p) else 0))
        return out

    def makedir(self, path: str) -> bool:
        os.makedirs(path, exist_ok=True)
        return True

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def download(self, remote: str, local: str) -> bool:
        if os.path.abspath(remote) != os.path.abspath(local):
            shutil.copy2(remote, local)
        return True

    def upload(self, local: str, remote: str) -> bool:
        if os.path.abspath(remote) != os.path.abspath(local):
            os.makedirs(os.path.dirname(remote) or ".", exist_ok=True)
            shutil.copy2(local, remote)
        return True

    def remove(self, path: str) -> bool:
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        return True

    def file_size(self, path: str) -> int:
        return os.path.getsize(path)

    def dus(self, path: str) -> int:
        total = 0
        for root, _, files in os.walk(path):
            for f in files:
                total += os.path.getsize(os.path.join(root, f))
        return total

    def truncate(self, path: str, size: int = 0) -> bool:
        with open(path, "ab") as f:
            f.truncate(size)
        return True

    def touch(self, path: str) -> bool:
        open(path, "ab").close()
        return True

    def rename(self, src: str, dst: str) -> bool:
        os.replace(src, dst)
        return True

    def count(self, path: str) -> int:
        if os.path.isfile(path):
            return 1
        n = 0
        for _, _, files in os.walk(path):
            n += len(files)
        return n


class TransientCommandError(TransientError):
    """A CLI invocation failed transiently (nonzero rc, timeout, or the
    binary itself failed to launch) — retryable by RetryPolicy."""


class CommandBackend:
    """Remote storage driven by a CLI (``hadoop fs`` style), mirroring the
    reference's pipe-command approach to AFS/HDFS. Only the operations the
    pipeline needs are mapped; unmapped ops raise NotImplementedError.

    Receives the FULL URI (scheme included) — hadoop-style CLIs resolve
    scheme-less paths relative to the user's remote home dir.

    Resilience: every invocation runs under a
    ``RetryPolicy`` (FLAGS.retry_* knobs unless one is passed) with a
    subprocess timeout (``FLAGS.command_timeout_sec``) so a hung CLI is
    killed and retried instead of wedging the pipeline; the
    ``file_mgr.command`` fault-injection seam fires before each spawn."""

    wants_full_uri = True

    def __init__(self, cmd_prefix: List[str], retry=None,
                 timeout: Optional[float] = None) -> None:
        from paddlebox_tpu_torch.config import FLAGS
        from paddlebox_tpu_torch.resilience.retry import RetryPolicy
        self.prefix = list(cmd_prefix)
        self.timeout = (FLAGS.command_timeout_sec if timeout is None
                        else timeout)
        self.retry = retry or RetryPolicy.from_flags(
            site="file_mgr.command")

    def _run_once(self, *args: str) -> Tuple[int, str, str]:
        """One CLI invocation → (rc, stdout, stderr). Spawn failures and
        timeouts surface as TransientCommandError (retryable); the rc is
        returned raw so callers can classify (``-test`` rc=1 means
        "absent", not "broken")."""
        from paddlebox_tpu_torch.resilience.faults import inject
        inject("file_mgr.command", op=args[0] if args else "")
        cmd = self.prefix + list(args)
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True,
                timeout=self.timeout if self.timeout > 0 else None)
        except subprocess.TimeoutExpired as e:
            raise TransientCommandError(
                f"{' '.join(cmd)}: timed out after {self.timeout}s") from e
        except OSError as e:
            raise TransientCommandError(f"{' '.join(cmd)}: {e}") from e
        return proc.returncode, proc.stdout, proc.stderr

    def _run(self, *args: str) -> str:
        """Invoke the CLI under the retry policy; any nonzero rc is
        treated as transient and retried up to the policy's caps."""
        def attempt() -> str:
            rc, out, err = self._run_once(*args)
            if rc != 0:
                raise TransientCommandError(
                    f"{' '.join(self.prefix + list(args))}: rc={rc}: {err}")
            return out
        return self.retry.call(attempt)

    def list_dir(self, path: str) -> List[str]:
        return [line.split()[-1].rsplit("/", 1)[-1]
                for line in self._run("-ls", path).splitlines()
                if line and not line.startswith("Found")]

    def exists(self, path: str) -> bool:
        """``-test -e`` semantics: rc=0 present, rc=1 absent. Any OTHER
        failure (connection refused, CLI crash, timeout) is retried and
        ultimately RAISES — reporting a flaky cluster as "file does not
        exist" silently corrupts checkpoint/dataset decisions."""
        def attempt() -> bool:
            rc, _, err = self._run_once("-test", "-e", path)
            if rc == 0:
                return True
            if rc == 1:
                return False
            raise TransientCommandError(
                f"{' '.join(self.prefix)} -test -e {path}: rc={rc}: {err}")
        return self.retry.call(attempt)

    def download(self, remote: str, local: str) -> bool:
        self._run("-get", remote, local)
        return True

    def upload(self, local: str, remote: str) -> bool:
        """Crash-safe put: write a ``.tmp`` remote name, then rename —
        mirroring the local ``os.replace`` convention checkpoints rely
        on, so a crash mid-upload never leaves a torn final file."""
        tmp = f"{remote}.tmp-{os.getpid()}"
        self._run("-put", local, tmp)
        try:
            self._run("-mv", tmp, remote)
        except BaseException:
            try:  # best-effort: don't litter tmp files on failure
                self._run("-rm", "-r", tmp)
            except Exception:
                log.warning("orphan upload temp left behind: %s", tmp)
            raise
        return True

    def rename(self, src: str, dst: str) -> bool:
        self._run("-mv", src, dst)
        return True

    def remove(self, path: str) -> bool:
        self._run("-rm", "-r", path)
        return True

    def makedir(self, path: str) -> bool:
        self._run("-mkdir", "-p", path)
        return True

    def __getattr__(self, name: str) -> Callable:
        raise NotImplementedError(
            f"CommandBackend has no mapping for '{name}'")


class FileMgr:
    """Scheme-dispatching facade; API mirrors BoxFileMgr's binding."""

    def __init__(self) -> None:
        self._backends: Dict[str, object] = {"file": LocalBackend()}
        self._initialized = False

    def init(self, fs_name: str = "", fs_ugi: str = "",
             conf_path: str = "", scheme: str = "",
             command: Optional[List[str]] = None) -> bool:
        """Configure a remote backend; e.g.
        ``init(scheme="hdfs", command=["hadoop", "fs"])``."""
        if scheme and command:
            self._backends[scheme] = CommandBackend(command)
        self._initialized = True
        return True

    def register_backend(self, scheme: str, backend: object) -> None:
        self._backends[scheme] = backend

    def _resolve(self, path: str) -> Tuple[object, str]:
        scheme, rest = split_scheme(path)
        if scheme not in self._backends:
            raise KeyError(f"no backend for scheme '{scheme}://' "
                           f"(registered: {sorted(self._backends)})")
        backend = self._backends[scheme]
        if getattr(backend, "wants_full_uri", False):
            return backend, path
        return backend, rest

    # -- BoxFileMgr surface -------------------------------------------------

    def list_dir(self, path: str) -> List[str]:
        b, p = self._resolve(path)
        return b.list_dir(p)

    def list_info(self, path: str) -> List[Tuple[str, int]]:
        b, p = self._resolve(path)
        return b.list_info(p)

    def makedir(self, path: str) -> bool:
        b, p = self._resolve(path)
        return b.makedir(p)

    def exists(self, path: str) -> bool:
        b, p = self._resolve(path)
        return b.exists(p)

    def download(self, remote: str, local: str) -> bool:
        b, p = self._resolve(remote)
        return b.download(p, local)

    def upload(self, local: str, remote: str) -> bool:
        b, p = self._resolve(remote)
        return b.upload(local, p)

    def remove(self, path: str) -> bool:
        b, p = self._resolve(path)
        return b.remove(p)

    def file_size(self, path: str) -> int:
        b, p = self._resolve(path)
        return b.file_size(p)

    def dus(self, path: str) -> int:
        b, p = self._resolve(path)
        return b.dus(p)

    def truncate(self, path: str, size: int = 0) -> bool:
        b, p = self._resolve(path)
        return b.truncate(p, size)

    def touch(self, path: str) -> bool:
        b, p = self._resolve(path)
        return b.touch(p)

    def rename(self, src: str, dst: str) -> bool:
        bs, ps = self._resolve(src)
        bd, pd = self._resolve(dst)
        if bs is not bd:
            raise ValueError("rename across schemes is not supported")
        return bs.rename(ps, pd)

    def count(self, path: str) -> int:
        b, p = self._resolve(path)
        return b.count(p)

    def finalize(self) -> None:
        self._backends = {"file": LocalBackend()}
        self._initialized = False
