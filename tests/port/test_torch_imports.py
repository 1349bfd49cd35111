"""The port's import rule: no module of repro_torch imports JAX or the
JAX package. Every module of the package (launch/dryrun.py among them)
is imported in a fresh interpreter, which then holds neither `jax` nor
`repro` in sys.modules."""
import json
import os
import pkgutil
import subprocess
import sys

import repro_torch

SRC = os.path.dirname(os.path.dirname(repro_torch.__file__))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_every_module_is_listed():
    names = _modules()
    for must in ("repro_torch.launch.dryrun", "repro_torch.launch.trace_cost",
                 "repro_torch.launch.trace_analysis",
                 "repro_torch.launch.mesh", "repro_torch.configs.base"):
        assert must in names


def test_no_module_imports_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        f"names = {_modules()!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": SRC}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["n"] == len(_modules())
    assert got["bad"] == []
