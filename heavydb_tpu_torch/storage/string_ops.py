"""Host-side string kernel implementations (reference StringOps/StringOps.h
op semantics), applied over dictionary entries to build translation maps.

A copy of heavydb_tpu/storage/string_ops.py; only the imports differ."""

from __future__ import annotations

import base64
import re
import urllib.parse
from typing import Optional, Tuple


def _substring(s: str, start, length=None) -> str:
    start = int(start)
    # SQL 1-based; negative wraps like HeavyDB/Postgres substr
    if start > 0:
        i = start - 1
    else:
        i = max(len(s) + start, 0) if start < 0 else 0
    if length is None:
        return s[i:]
    return s[i : i + int(length)]


# LLM_TRANSFORM backend (reference StringOps.h LLM_TRANSFORM calls an
# external model endpoint per distinct dictionary entry).  This build has
# no egress, so the backend is a user-registered callable:
# db.register_llm_transform(fn) with fn(text, prompt) -> str.
_LLM_TRANSFORM_FN = None


def set_llm_transform(fn) -> None:
    global _LLM_TRANSFORM_FN
    _LLM_TRANSFORM_FN = fn


def apply_op(s: str, name: str, args: Tuple) -> Optional[str]:
    if name == "IDENTITY":
        return s
    if name == "LLM_TRANSFORM":
        if _LLM_TRANSFORM_FN is None:
            from heavydb_tpu_torch.errors import NotSupported

            raise NotSupported(
                "LLM_TRANSFORM requires a backend: call "
                "db.register_llm_transform(fn) with fn(text, prompt) -> str"
            )
        return str(_LLM_TRANSFORM_FN(s, *[str(a) for a in args]))
    if name == "GREATEST":
        return max([s] + [str(a) for a in args])
    if name == "LEAST":
        return min([s] + [str(a) for a in args])
    if name in ("UPPER", "UCASE"):
        return s.upper()
    if name in ("LOWER", "LCASE"):
        return s.lower()
    if name == "INITCAP":
        return re.sub(r"[a-zA-Z]+", lambda m: m.group(0).capitalize(), s)
    if name == "REVERSE":
        return s[::-1]
    if name == "TRIM":
        return s.strip(args[0]) if args else s.strip()
    if name == "LTRIM":
        return s.lstrip(args[0]) if args else s.lstrip()
    if name == "RTRIM":
        return s.rstrip(args[0]) if args else s.rstrip()
    if name in ("SUBSTRING", "SUBSTR", "MID"):
        return _substring(s, *args)
    if name == "REPLACE":
        return s.replace(str(args[0]), str(args[1]))
    if name == "LPAD":
        width = int(args[0])
        pad = str(args[1]) if len(args) > 1 else " "
        if len(s) >= width:
            return s[:width]
        need = width - len(s)
        return (pad * need)[:need] + s
    if name == "RPAD":
        width = int(args[0])
        pad = str(args[1]) if len(args) > 1 else " "
        if len(s) >= width:
            return s[:width]
        need = width - len(s)
        return s + (pad * need)[:need]
    if name == "REPEAT":
        return s * int(args[0])
    if name == "SPLIT_PART":
        parts = s.split(str(args[0]))
        n = int(args[1])
        idx = n - 1 if n > 0 else len(parts) + n
        return parts[idx] if 0 <= idx < len(parts) else None
    if name == "REGEXP_REPLACE":
        repl = str(args[1]).replace("\\", "\\\\") if False else str(args[1])
        return re.sub(str(args[0]), repl, s)
    if name == "CONCAT":
        return s + str(args[0])
    if name == "PRECONCAT":
        return str(args[0]) + s
    if name == "OVERLAY":
        # OVERLAY(s PLACING r FROM start [FOR len]) — bound as
        # OVERLAY(s, r, start[, len]); 1-based start
        r = str(args[0])
        start = int(args[1])
        ln = int(args[2]) if len(args) > 2 else len(r)
        i = max(start - 1, 0)
        return s[:i] + r + s[i + ln:]
    if name == "JSON_VALUE":
        # simple JSONPath subset: $.a.b[0].c (reference JSON_VALUE op)
        import json as _json

        try:
            v = _json.loads(s)
        except _json.JSONDecodeError:
            return None
        path = str(args[0])
        if path.startswith("$"):
            path = path[1:]
        for part in re.findall(r"\.([A-Za-z_][\w]*)|\[(\d+)\]", path):
            key, idx = part
            try:
                v = v[key] if key else v[int(idx)]
            except (KeyError, IndexError, TypeError):
                return None
        if v is None or isinstance(v, (dict, list)):
            return None
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)
    if name == "REGEXP_SUBSTR":
        # REGEXP_SUBSTR(s, pattern[, position[, occurrence]])
        pat = str(args[0])
        pos = int(args[1]) if len(args) > 1 else 1
        occ = int(args[2]) if len(args) > 2 else 1
        ms = list(re.finditer(pat, s[max(pos - 1, 0):]))
        if len(ms) < occ or occ < 1:
            return None
        return ms[occ - 1].group(0)
    if name == "BASE64_ENCODE":
        return base64.b64encode(s.encode()).decode()
    if name == "BASE64_DECODE":
        try:
            return base64.b64decode(s.encode()).decode()
        except Exception:
            return None
    if name == "URL_ENCODE":
        return urllib.parse.quote(s, safe="")
    if name == "URL_DECODE":
        return urllib.parse.unquote(s)
    if name == "LEFT":
        n = int(args[0])
        return s[:n] if n > 0 else ""
    if name == "RIGHT":
        n = int(args[0])
        return s[-n:] if n > 0 else ""
    raise ValueError(f"unknown string op {name}")


def apply_chain(s: Optional[str], ops) -> Optional[str]:
    for name, args in ops:
        if s is None:
            return None
        s = apply_op(s, name, args)
    return s


def int_string_fn(s: str, fn: str, args: Tuple):
    """Integer-valued string kernels evaluated per dictionary entry
    (reference StringOps POSITION/REGEXP_COUNT/LEVENSHTEIN...)."""
    if fn == "POSITION":
        sub = str(args[0])
        start = int(args[1]) if len(args) > 1 else 1
        i = s.find(sub, max(start - 1, 0))
        return i + 1  # 0 = not found (1-based like the reference)
    if fn == "REGEXP_COUNT":
        pat = str(args[0])
        pos = int(args[1]) if len(args) > 1 else 1
        return len(re.findall(pat, s[max(pos - 1, 0):]))
    if fn == "LEVENSHTEIN":
        t = str(args[0])
        if len(s) < len(t):
            s, t = t, s
        prev = list(range(len(t) + 1))
        for i, cs in enumerate(s, 1):
            cur = [i]
            for j, ct in enumerate(t, 1):
                cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (cs != ct)))
            prev = cur
        return prev[-1]
    if fn == "JAROWINKLER":
        # reference StringOps.cpp compute_jaro_winkler_score × 100,
        # rounded to BIGINT; empty string → NULL
        t = str(args[0])
        if not s or not t:
            return None
        return round(_jaro_winkler(s, t) * 100)
    if fn == "HASH":
        # 53-bit JS-compatible hash (reference Hash::numericEval,
        # StringOps.cpp:335); empty string → NULL
        if not s:
            return None
        seed = int(args[0]) if args else 0
        M = 0xFFFFFFFF
        h1 = (0xDEADBEEF ^ (seed & M)) & M
        h2 = (0x41C6CE57 ^ (seed & M)) & M
        for ch in s.encode("utf-8", "surrogatepass"):
            h1 = ((h1 ^ ch) * 2654435761) & M
            h2 = ((h2 ^ ch) * 1597334677) & M
        h1 = ((h1 ^ (h1 >> 16)) * 2246822507) & M
        h1 = (h1 ^ (((h2 ^ (h2 >> 13)) * 3266489909) & M)) & M
        h2 = ((h2 ^ (h2 >> 16)) * 2246822507) & M
        h2 = (h2 ^ (((h1 ^ (h1 >> 13)) * 3266489909) & M)) & M
        return ((h2 & 0x1FFFFF) << 32) | h1
    raise ValueError(fn)


# Jaro-Winkler (reference StringOps.cpp:139-215: prefix length 4,
# scaling 0.1)
def _jaro_winkler(s1: str, s2: str) -> float:
    l1, l2 = len(s1), len(s2)
    if l1 == 0 or l2 == 0:
        return 0.0
    window = max(max(l1, l2) // 2 - 1, 0)
    m1 = [False] * l1
    m2 = [False] * l2
    matches = 0
    for i, c in enumerate(s1):
        lo = max(0, i - window)
        hi = min(i + window + 1, l2)
        for j in range(lo, hi):
            if not m2[j] and s2[j] == c:
                m1[i] = True
                m2[j] = True
                matches += 1
                break
    if matches == 0:
        return 0.0
    trans = 0
    j = 0
    for i in range(l1):
        if m1[i]:
            while not m2[j]:
                j += 1
            if s1[i] != s2[j]:
                trans += 1
            j += 1
    jaro = (matches / l1 + matches / l2
            + (matches - trans / 2.0) / matches) / 3.0
    l = 0
    for a, b in zip(s1[:4], s2[:4]):
        if a != b:
            break
        l += 1
    return jaro + l * 0.1 * (1 - jaro)
