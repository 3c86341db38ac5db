"""Helpers of the port's parity tests that run one scenario through both
packages: the JAX package (heavydb_tpu) and the port on the CPU
(heavydb_tpu_torch, device="cpu"), each in a directory of its own."""

import types

import pytest

import heavydb_tpu as hdt
import heavydb_tpu_torch as hdt_torch
from heavydb_tpu import config as jconfig
from heavydb_tpu import errors as jerrors
from heavydb_tpu_torch import config as tconfig
from heavydb_tpu_torch import errors as terrors

REF = types.SimpleNamespace(
    name="ref", pkg="heavydb_tpu", errors=jerrors, Config=jconfig.Config,
    connect=lambda path=None, **kw: hdt.connect(path, **kw))
PORT = types.SimpleNamespace(
    name="port", pkg="heavydb_tpu_torch", errors=terrors, Config=tconfig.Config,
    connect=lambda path=None, **kw: hdt_torch.connect(path, device="cpu", **kw))


def same(got, want) -> bool:
    """Equal, but floats (aggregates whose order of addition differs)
    within rtol 1e-9."""
    if isinstance(want, float) and isinstance(got, float):
        return got == pytest.approx(want, rel=1e-9, nan_ok=True)
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        return len(got) == len(want) and all(same(g, w) for g, w in zip(got, want))
    return got == want


def both(tmp_path, scenario):
    """scenario(pkg, directory) in each package, in a directory of its
    own: the port returns what the reference returns."""
    want = scenario(REF, str(tmp_path / "ref"))
    got = scenario(PORT, str(tmp_path / "port"))
    assert same(got, want), (got, want)
    return got


def raises_in_both(tmp_path, scenario):
    """scenario raises in both packages: the same error class by name,
    with the same message."""
    errs = []
    for pkg in (REF, PORT):
        with pytest.raises(Exception) as err:
            scenario(pkg, str(tmp_path / pkg.name))
        errs.append((type(err.value).__name__, str(err.value)))
    assert errs[0] == errs[1]
    return errs[1]
