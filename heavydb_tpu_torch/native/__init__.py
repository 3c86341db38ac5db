"""Native (C++) host extensions: the string dictionary and the CSV parser.

Each builds with g++ from its source beside this file on first use; if the
toolchain is unavailable the callers fall back to pure-Python (or pandas)
implementations.
"""

from __future__ import annotations

import os
import subprocess
import threading

_HERE = os.path.dirname(__file__)
_LOCK = threading.Lock()
_EXTS: dict = {}


def _load_ext(stem: str, flags=()):
    """The CPython extension built from `<stem>.cpp`, or None.  Built once
    a process, under a lock, into a content-addressed `_<stem>_<sha>.so`
    (git-ignored), so a stale or foreign build is never picked up."""
    with _LOCK:
        if stem in _EXTS:
            return _EXTS[stem]
        _EXTS[stem] = None
        import hashlib
        import importlib.util
        import sysconfig

        src = os.path.join(_HERE, f"{stem}.cpp")
        try:
            with open(src, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
        except OSError:
            return None
        out = os.path.join(_HERE, f"_{stem}_{digest}.so")
        if not os.path.exists(out):
            inc = sysconfig.get_path("include")
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *flags,
                     f"-I{inc}", src, "-o", out],
                    check=True, capture_output=True, timeout=180,
                )
            except Exception:
                return None
        try:
            spec = importlib.util.spec_from_file_location(f"_{stem}", out)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _EXTS[stem] = mod
        except Exception:
            pass
        return _EXTS[stem]


def load_strdict_ext():
    """The native string dictionary (strdict_ext.cpp) or None."""
    return _load_ext("strdict_ext")


def load_csv_ext():
    """The native CSV parser (csv_ext.cpp, multi-threaded) or None."""
    return _load_ext("csv_ext", ("-pthread",))
