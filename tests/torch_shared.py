"""One reference run shared by every test file of a pytest session that
repeats it, across xdist workers: the first process to ask for a key
computes it under a file lock and pickles the result; the others wait on
the lock and read it.  Keys name the whole computation (scenario, config
repr, frames digest), so a shared result is the one each file would have
computed.  Outside xdist (no ``PYTEST_XDIST_TESTRUNUID``) it is a plain
per-process memo."""
from __future__ import annotations

import fcntl
import hashlib
import os
import pickle
import tempfile

_MEMO = {}


def _directory():
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return None
    path = os.path.join(tempfile.gettempdir(), f"proslam-shared-{run}")
    os.makedirs(path, exist_ok=True)
    return path


def digest(*parts) -> str:
    """A key from reprs and numpy arrays (their bytes, dtype and shape)."""
    h = hashlib.sha256()
    for part in parts:
        if hasattr(part, "tobytes") and hasattr(part, "dtype"):
            h.update(f"{part.dtype}{part.shape}".encode())
            h.update(part.tobytes())
        elif isinstance(part, (list, tuple)):
            h.update(digest(*part).encode())
        else:
            h.update(repr(part).encode())
    return h.hexdigest()


def shared(key: str, compute):
    """``compute()``'s result, computed once per session for ``key``."""
    if key in _MEMO:
        return _MEMO[key]
    where = _directory()
    if where is None:
        _MEMO[key] = compute()
        return _MEMO[key]
    data = os.path.join(where, key + ".pkl")
    with open(os.path.join(where, key + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(data):
                with open(data, "rb") as f:
                    value = pickle.load(f)
            else:
                value = compute()
                with open(data + ".tmp", "wb") as f:
                    pickle.dump(value, f)
                os.replace(data + ".tmp", data)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _MEMO[key] = value
    return value
