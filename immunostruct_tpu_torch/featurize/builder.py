"""The offline featurizer: PDB -> graph arrays (counterpart of
``immunostruct_tpu/featurize/builder.py``).

Replaces the graphein-driven script
(reference: preprocessing/cancer_graph_construction_new_KBG.py:93-157):

  for each PDB:
    parse CA records -> the subgraph's residues 1-179 + 273-999 (HLA a1/a2
    + peptide, :103) -> edges (4 interaction types, :46-52) -> node
    features = 20-dim alphabetical one-hot + H-bond donor count + acceptor
    count (22 dims, :137-138; enc_dict :65-87 is the alphabetical one-letter
    one-hot, MASK = zeros) -> one .npz graph per structure.

A graph is named by the file's stem when that carries the 'Immuno' join
key, else by a key derived from the subgraph's sequence (with a warning,
once: such a name joins no property table). ``featurize_directory`` gives
each file its own ``try`` and appends each failure to ``error_log.txt``
(:151-157), over a thread pool.

A structure with no CA record in the subgraph's positions gives a graph of
no nodes (x [0, 22], coords [0, 3], edge_index [2, 0]) on both paths, as in
the JAX package. A residue number that does not parse raises on the numpy
path (int()'s message, to the error log); the native parser reads it as
residue 0, which the filter drops, as the JAX package's native path does.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Optional

import numpy as np

from immunostruct_tpu_torch.data.encoding import AA3_TO_1, RESIDUE_ONEHOT_INDEX
from immunostruct_tpu_torch.data.graphs import save_graph_npz
from immunostruct_tpu_torch.data.tables import get_hash
from immunostruct_tpu_torch.featurize.edges import (
    EdgeConfig, build_edges, build_edges_atomic,
)
from immunostruct_tpu_torch.featurize.pdb import (
    AtomTable, parse_pdb_atoms, parse_pdb_ca,
)

# sidechain H-bond donor/acceptor counts per residue (the loader cuts these
# two columns, preprocess.py:40-42)
RESIDUE_HBOND_DONORS = {
    "ARG": 3, "ASN": 1, "GLN": 1, "HIS": 1, "LYS": 1, "SER": 1, "THR": 1,
    "TRP": 1, "TYR": 1, "CYS": 1,
}
RESIDUE_HBOND_ACCEPTORS = {
    "ASP": 2, "GLU": 2, "ASN": 1, "GLN": 1, "HIS": 1, "SER": 1, "THR": 1,
    "TYR": 1, "MET": 1, "CYS": 1,
}

SUBGRAPH_POSITIONS = set(range(1, 180)) | set(range(273, 1000))

_WARNED_MISSING_KEY = False


def node_features(resnames: list[str]) -> np.ndarray:
    """[n, 22]: 20-dim alphabetical one-hot + donor count + acceptor count;
    an unknown residue (and the reference's MASK) has a zero one-hot."""
    x = np.zeros((len(resnames), 22), np.float32)
    for i, res in enumerate(resnames):
        one = AA3_TO_1.get(res)
        if one is not None:
            x[i, RESIDUE_ONEHOT_INDEX[one]] = 1.0
        x[i, 20] = RESIDUE_HBOND_DONORS.get(res, 0)
        x[i, 21] = RESIDUE_HBOND_ACCEPTORS.get(res, 0)
    return x


def _numpy_chain(path: str, edge_config: EdgeConfig):
    """(coords, resnames, resnums, chains, edge_index) on the numpy path."""
    ca = parse_pdb_ca(path)
    keep = [i for i, rn in enumerate(ca.resnums.tolist())
            if rn in SUBGRAPH_POSITIONS]
    coords = ca.coords[keep]
    resnames = [ca.resnames[i] for i in keep]
    resnums = ca.resnums[keep]
    chains = [ca.chains[i] for i in keep]
    if edge_config.granularity == "atomic":
        atoms = parse_pdb_atoms(path)
        akeep = [rn in SUBGRAPH_POSITIONS for rn in atoms.resnums.tolist()]
        atoms = AtomTable(
            coords=atoms.coords[np.asarray(akeep, bool)],
            atom_names=[a for a, k in zip(atoms.atom_names, akeep) if k],
            resnames=[r for r, k in zip(atoms.resnames, akeep) if k],
            resnums=atoms.resnums[np.asarray(akeep, bool)],
            chains=[c for c, k in zip(atoms.chains, akeep) if k])
        edge_index = build_edges_atomic(atoms, resnums, chains, edge_config)
    else:
        edge_index = build_edges(coords, resnames, resnums, chains,
                                 edge_config)
    return coords, resnames, resnums, chains, edge_index


def _derived_name(stem: str, resnames: list[str]) -> str:
    """A standalone name from the subgraph's sequence. It joins no property
    table (their keys hash the full HLA chain + peptide); a training
    corpus's PDB file names carry the Immuno<chain[-99:]_sha1[:5]> key, as
    the reference's do."""
    global _WARNED_MISSING_KEY
    seq = "".join(AA3_TO_1.get(r, "X") for r in resnames)
    if not _WARNED_MISSING_KEY:
        _WARNED_MISSING_KEY = True
        print(f"WARNING: {stem}.pdb (and possibly others) has no "
              "'Immuno' join key in its filename; derived standalone "
              "names that will NOT join property tables. "
              "(warning shown once)")
    return f"{stem}Immuno{seq[-99:]}_{get_hash(seq)[:5]}"


def featurize_pdb(path: str, edge_config: EdgeConfig = EdgeConfig(),
                  use_native: bool = True,
                  mask_percentage: float = 0.0,
                  mask_rng: Optional[np.random.Generator] = None):
    """One PDB -> (name, x [n,22], coords [n,3], edge_index [2,e]), through
    the native library (built at first use) or, with ``use_native=False``,
    the numpy path.

    ``mask_percentage`` zeroes the one-hot of that share of the *peptide*
    residues (residue number >= 273), the reference's optional peptide
    masking (cancer_graph_construction_new_KBG.py:20-31), drawn from
    ``mask_rng`` (default ``default_rng(0)``)."""
    if use_native:
        from immunostruct_tpu_torch.featurize.native import native_featurize
        chain = native_featurize(path, edge_config)
    else:
        chain = _numpy_chain(path, edge_config)
    coords, resnames, resnums, _, edge_index = chain
    x = node_features(resnames)

    if mask_percentage > 0:
        rng = mask_rng if mask_rng is not None else np.random.default_rng(0)
        pep_idx = np.nonzero(np.asarray(resnums) >= 273)[0]
        k = int(len(pep_idx) * mask_percentage / 100)
        if k > 0:
            picked = rng.choice(pep_idx, size=k, replace=False)
            x[picked, :20] = 0.0  # MASK = zero one-hot

    stem = os.path.splitext(os.path.basename(path))[0]
    name = stem if "Immuno" in stem else _derived_name(stem, resnames)
    return name, x, coords, edge_index


def featurize_directory(alphafold_folder: str, save_folder: str,
                        edge_config: EdgeConfig = EdgeConfig(),
                        workers: int = 8, use_native: bool = True,
                        error_log: Optional[str] = None) -> list[str]:
    """Featurize every .pdb in a folder, each file in its own ``try`` (a
    failure goes to ``error_log``, by default ``<save_folder>/
    error_log.txt``, and the rest go on); returns the written files."""
    os.makedirs(save_folder, exist_ok=True)
    error_log = error_log or os.path.join(save_folder, "error_log.txt")
    files = sorted(glob(os.path.join(alphafold_folder, "*.pdb")))
    written = []

    def one(path):
        stem = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(save_folder, stem + ".npz")
        try:
            name, x, coords, edge_index = featurize_pdb(
                path, edge_config, use_native=use_native)
            save_graph_npz(out_path, name=name, x=x, coords=coords,
                           edge_index=edge_index)
            return out_path, None
        except Exception as e:  # noqa: BLE001 - per-file fault tolerance
            return None, (f"Error creating graph {stem}. Encountered "
                          f"exception {e}")

    with ThreadPoolExecutor(max_workers=workers) as pool:
        for out_path, err in pool.map(one, files):
            if err is not None:
                print(err)
                with open(error_log, "a") as f:
                    f.write(err + "\n")
            else:
                written.append(out_path)
    return written
