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

``keyed_library`` and ``compile_libraries`` are the naming and install rule
every library of the package is built by (``featurize/native.py`` builds
the host featurizer with them).
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


def keyed_library(build_dir: Path, stem: str, inputs, flags) -> Path:
    """``build_dir/lib<stem>-<hash>.so``: the hash is of the bytes of
    ``inputs`` (the source, then the headers it includes) and of ``flags``,
    so an edit to any of them names a new library."""
    text = b"".join(Path(p).read_bytes() for p in inputs)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"lib{stem}-{digest}.so"


def compile_libraries(jobs) -> None:
    """Run ``compiler *flags -o <tmp> source`` for each job (what, lib,
    compiler, flags, source), all at once. Each library is written under a
    name of this process's and renamed into place when its compiler
    succeeds, with the compiler's report printed to standard error and kept
    beside it (``.log``). Raises RuntimeError with each failed build's
    command and output."""
    procs = []
    for what, lib, compiler, flags, source in jobs:
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(source)]
        procs.append((what, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for what, lib, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        print(out, file=sys.stderr, end="")
        if proc.returncode != 0:
            failed.append(f"building {what} failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def _lib_path(name: str) -> Path:
    return keyed_library(BUILD_DIR, name, [CSRC / f"{name}.cu",
                                           *sorted(CSRC.glob("*.cuh"))],
                         NVCC_FLAGS)


def build(names=None) -> None:
    """Compile ``csrc/<name>.cu`` for each name (default: every source)
    whose library is missing, one nvcc process each, run in parallel."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    compile_libraries([(f"{name}.cu", _lib_path(name), nvcc, NVCC_FLAGS,
                        CSRC / f"{name}.cu") for name in todo])


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
