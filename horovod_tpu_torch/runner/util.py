"""Launcher utilities: HMAC secrets, safe process execution.
The port's copy of ``horovod_tpu/runner/util.py``.

Reference parity: `horovod/runner/common/util/secret.py` (HMAC tokens),
`safe_shell_exec.py` (process-group-safe spawn/terminate).
"""

import hashlib
import hmac
import os
import secrets as _secrets
import signal
import subprocess
import time

GRACEFUL_TERMINATION_TIME_S = 5.0


def make_secret_key() -> bytes:
    return _secrets.token_bytes(32)


def sign(key: bytes, payload: bytes) -> str:
    return hmac.new(key, payload, hashlib.sha256).hexdigest()


def check_signature(key: bytes, payload: bytes, signature: str) -> bool:
    return hmac.compare_digest(sign(key, payload), signature)


def safe_exec(command, env=None, stdout=None, stderr=None, stdin=None):
    """Spawn `command` in its own process group so the whole tree can be
    terminated (reference: safe_shell_exec.py)."""
    return subprocess.Popen(command, env=env, stdout=stdout, stderr=stderr,
                            stdin=stdin, preexec_fn=os.setsid)


def terminate(proc, timeout=GRACEFUL_TERMINATION_TIME_S):
    """SIGTERM the process group, escalate to SIGKILL after `timeout`."""
    if proc.poll() is not None:
        return
    try:
        pgid = os.getpgid(proc.pid)
    except OSError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except OSError:
        pass
    deadline = time.time() + timeout
    while proc.poll() is None and time.time() < deadline:
        time.sleep(0.05)
    if proc.poll() is None:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
