"""Build ``csrc/*.cu`` with ``nvcc`` at first use and load it with ``ctypes``.

Each source is compiled on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The library goes to ``immunostruct_tpu_torch/_build/`` (git-ignored), named
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds. The
compiler's report (registers, shared memory, spills per kernel) is printed
to standard error on every build and kept beside the library (``.log``);
``ptxas_readings`` reads it per kernel. ``build`` starts one nvcc per
missing library, all at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the CUDA kernels of immunostruct_tpu_torch need the "
                       "CUDA toolkit to build")


def _lib_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> None:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    whose library is missing, one nvcc process each, run in parallel."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        print(out, file=sys.stderr, end="")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}.cu:\n{out}")
        else:
            _lib_path(name).with_suffix(".log").write_text(out)
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))


def ptxas_readings(name: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads}} from the compiler's
    report of the built ``csrc/<name>.cu`` (else {}); a kernel is named by
    its function, its tile policy where it has one and its compute dtype
    (f32 or bf16) where it is a template on it."""
    log = _lib_path(name).with_suffix(".log")
    report = log.read_text() if log.exists() else ""
    readings = {}
    for part in report.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        key, rest = mangled, ""
        i = 0
        while i < len(mangled):               # <length><identifier> names
            m = re.match(r"\d+", mangled[i:])
            if m is None:
                i += 1
                continue
            start = i + m.end()
            ident = mangled[start:start + int(m.group())]
            i = start + len(ident)
            if ident.endswith(("kernel", "chunks", "reduce", "blocks")):
                key, rest = ident, mangled[i:]
                break
        tag = re.search(r"(EdgeTiles|ArcTiles)", rest)
        variant = re.match(r"ILi\d+ELi(\d+)E", rest)
        if tag:
            key += f"<{tag.group(1)}>"
        elif variant:
            key += f"<{variant.group(1)}>"
        elif rest.startswith("I13__nv_bfloat16"):
            key += "<bf16>"
        elif rest.startswith("If"):
            key += "<f32>"
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        readings[key] = dict(
            registers=int(regs.group(1)) if regs else None,
            spill_stores=int(spill.group(1)) if spill else None,
            spill_loads=int(spill.group(2)) if spill else None)
    return readings


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    build([name])
    return ctypes.CDLL(str(_lib_path(name)))
