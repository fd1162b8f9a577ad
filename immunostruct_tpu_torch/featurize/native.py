"""ctypes bindings for the native featurizer (counterpart of
``immunostruct_tpu/featurize/native.py``; source: native/featurizer.cc).

The library is built from ``native/featurizer.cc`` at first use, with the
host C++ compiler (``$CXX``, else g++), into the git-ignored
``immunostruct_tpu_torch/_build/``, named by a hash of the source and the
flags and installed by ``ops/_build.py``'s rule, as the kernels' libraries
are. The flags are
``native/Makefile``'s without ``-march=native``, which would tie the
library to the machine that built it (on another host an instruction it
lacks stops the process), and with ``-ffp-contract=off``, so that the
distances are the numpy path's, one rounded product and sum at a time. A
failed build raises with the compiler's output; nothing falls back to the
numpy path, which runs only when asked for (``use_native=False``).

The CA path's library emits each edge's two arcs together;
``native_featurize`` puts every arc in row-major (src, dst) order, the
numpy path's, so the two paths write the same graphs. ctypes calls release the GIL, so
``featurize_directory``'s thread pool runs structures in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import threading
from pathlib import Path

import numpy as np

from immunostruct_tpu_torch.featurize.edges import EdgeConfig
from immunostruct_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "featurizer.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
             "-ffp-contract=off", "-shared")

# class id -> 3-letter code (alphabetical one-letter order)
_CLASS_TO_RES3 = ["ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE",
                  "LYS", "LEU", "MET", "ASN", "PRO", "GLN", "ARG", "SER",
                  "THR", "VAL", "TRP", "TYR"]

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "parse_pdb_ca": [ctypes.c_char_p, ctypes.c_int, _F, _I, _I, _I, _F, _F,
                     ctypes.c_int],
    "build_edges": [_F, _I, _I, _I, ctypes.c_int, _F, _I, _I, ctypes.c_int],
    "build_edges_atomic": [ctypes.c_char_p, ctypes.c_int, _I, _I,
                           ctypes.c_int, _F, _I, _I, ctypes.c_int],
}


def _compiler() -> str:
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler ($CXX, g++ or c++) to build "
                           f"{SOURCE}; pass use_native=False (--no-native) "
                           "for the numpy path")
    return found


def library_path() -> Path:
    """Where the library of this source and these flags is kept."""
    return _build.keyed_library(BUILD_DIR, "featurizer", [SOURCE], CXX_FLAGS)


def build() -> Path:
    """Compile ``native/featurizer.cc`` unless its library is there; raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path()
    if not lib.exists():
        _build.compile_libraries([("the native featurizer", lib, _compiler(),
                                   CXX_FLAGS, SOURCE)])
    return lib


_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def _loaded() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return lib


def _load() -> ctypes.CDLL:
    """The library, built and loaded once (the featurizer's threads wait
    for the first build)."""
    with _LOAD_LOCK:
        return _loaded()


def native_featurize(path: str, edge_config: EdgeConfig = EdgeConfig(),
                     max_nodes: int = 4096, max_edges: int = 262144,
                     apply_subgraph_filter: bool = True) -> tuple:
    """Returns (coords, resnames, resnums, chains, edge_index), building the
    library at the first call."""
    lib = _load()
    coords = np.zeros((max_nodes, 3), np.float32)
    res_class = np.zeros((max_nodes,), np.int32)
    resnum = np.zeros((max_nodes,), np.int32)
    chain_id = np.zeros((max_nodes,), np.int32)
    donors = np.zeros((max_nodes,), np.float32)
    acceptors = np.zeros((max_nodes,), np.float32)

    def fp(a):
        return a.ctypes.data_as(_F)

    def ip(a):
        return a.ctypes.data_as(_I)

    n = lib.parse_pdb_ca(path.encode(), int(apply_subgraph_filter),
                         fp(coords), ip(res_class), ip(resnum), ip(chain_id),
                         fp(donors), fp(acceptors), max_nodes)
    if n < 0:
        raise RuntimeError(f"native parse_pdb_ca failed with code {n} for "
                           f"{path}")

    thresholds = np.asarray([edge_config.hbond_dist,
                             edge_config.hbond_sulfur_dist,
                             edge_config.hydrophobic_dist,
                             edge_config.ionic_dist], np.float32)
    src = np.zeros((max_edges,), np.int32)
    dst = np.zeros((max_edges,), np.int32)
    if edge_config.granularity == "atomic":
        e = lib.build_edges_atomic(path.encode(), int(apply_subgraph_filter),
                                   ip(resnum), ip(chain_id), n,
                                   fp(thresholds), ip(src), ip(dst),
                                   max_edges)
    else:
        e = lib.build_edges(fp(coords), ip(res_class), ip(resnum),
                            ip(chain_id), n, fp(thresholds), ip(src), ip(dst),
                            max_edges)
    if e == -1:
        raise RuntimeError(f"native build_edges_atomic could not read {path}")
    if e < 0:
        raise RuntimeError(
            f"native edge buffer overflow for {path} (raise max_edges)")

    order = np.lexsort((dst[:e], src[:e]))      # row-major, as np.nonzero
    resnames = [(_CLASS_TO_RES3[c] if 0 <= c < 20 else "UNK")
                for c in res_class[:n]]
    chains = [chr(c) for c in chain_id[:n]]
    edge_index = np.stack([src[:e][order], dst[:e][order]]).astype(np.int32)
    return coords[:n].copy(), resnames, resnum[:n].copy(), chains, edge_index
