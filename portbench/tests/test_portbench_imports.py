"""What a run loads: nothing of JAX or of the JAX package (whose name the
port's begins with), and a reference that loads nothing of the port."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

from portbench.harness import FORBIDDEN_MODULES
from portbench.spec import PKG, ROOT

# the yardstick: whatever computes the reference's answers
REFERENCE_FILES = (["compare.py", "refkit.py", "params.py"]
                   + [os.path.relpath(f, PKG) for f in glob.glob(os.path.join(PKG, "templates", "*", "*.py"))]
                   + [os.path.relpath(f, PKG) for f in glob.glob(os.path.join(PKG, "configs", "*.py"))])


def _py(code: str) -> str:
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_forbidden_names_compare_whole_top_level_names():
    assert set(FORBIDDEN_MODULES) >= {"jax", "jaxlib", "heavydb_tpu"}
    out = _py("""
        import sys, types
        from portbench.harness import forbidden_modules
        sys.modules["heavydb_tpu_torch_x"] = types.ModuleType("heavydb_tpu_torch_x")
        sys.modules["jaxfoo.bar"] = types.ModuleType("jaxfoo.bar")
        before = forbidden_modules()
        sys.modules["heavydb_tpu.api"] = types.ModuleType("heavydb_tpu.api")
        sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")
        print(before, forbidden_modules())
    """)
    assert out == "[] ['heavydb_tpu', 'jax']"


def test_a_run_loads_no_jax():
    out = _py("""
        import sys
        from portbench.harness import forbidden_modules, run
        out = run("synth.dashboard.c1", 9, 0.3, False, "cpu", scale=5e-5)
        assert out["correct"]
        tops = {m.split(".")[0] for m in sys.modules}
        print(forbidden_modules(), "heavydb_tpu_torch" in tops)
    """)
    assert out == "[] True"


def test_reference_imports_nothing_of_the_port():
    for rel in REFERENCE_FILES:
        tree = ast.parse(open(os.path.join(PKG, rel)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("heavydb_tpu_torch", "heavydb_tpu", "jax"), (rel, n)
    mods = ", ".join(repr(r) for r in REFERENCE_FILES)
    out = _py(f"""
        import os, sys
        from portbench.spec import PKG, load_module
        for i, rel in enumerate([{mods}]):
            load_module(os.path.join(PKG, rel), f"m{{i}}")
        print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"heavydb_tpu_torch", "heavydb_tpu", "jax"}}))
    """)
    assert out == "[]"

