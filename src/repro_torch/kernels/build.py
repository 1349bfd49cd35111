"""Build the hand-written CUDA kernels and load them with ctypes.

Every `csrc/*.cu` file is one shared library with a plain C interface,
compiled by `nvcc` for Hopper (`sm_90a`) at first use into `_build/`
beside this file (listed in `.gitignore`). The library name carries a
digest of its source, of the local headers it includes (`#include
"x.cuh"`, followed recursively) and of the flags, so an edited source or
header rebuilds and an unchanged one is reused. `build_all()` starts
one `nvcc` per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
port, and there is no `nvcc` there.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else the toolkit's default
    install location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def sources() -> Dict[str, pathlib.Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def digest(src: pathlib.Path) -> str:
    """Digest of `src`, of every local header it includes (recursively,
    resolved beside the including file) and of the nvcc flags."""
    h = hashlib.sha256()
    seen = set()

    def feed(path: pathlib.Path):
        if path in seen:
            return
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        for name in _LOCAL_INCLUDE.findall(text):
            feed((path.parent / name.decode()).resolve())

    feed(src.resolve())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library_path(src: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"{src.stem}-{digest(src)}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, pathlib.Path]:
    """Compile the named kernels (default: all), in parallel, skipping
    those already built from the same source. Returns name -> library
    path; raises with the compiler's output when a build fails. The
    compiler's resource report (`-Xptxas -v`) lands in `<library>.log`."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, []
    for name in names:
        src = srcs[name]
        lib = _library_path(src)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def build_log(name: str) -> str:
    """The compiler output of the named kernel's current build."""
    return _library_path(sources()[name]).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use and loaded once per
    process."""
    return ctypes.CDLL(str(build_all([name])[name]))
