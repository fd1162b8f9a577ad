"""Minimal PDB parsing: CA records per residue (counterpart of
``immunostruct_tpu/featurize/pdb.py``).

Replaces graphein's biopandas-backed ``read_pdb_to_dataframe`` +
``construct_graph`` front end (reference:
preprocessing/cancer_graph_construction_new_KBG.py:102-117) for what the
featurizer consumes: per-residue CA coordinates, residue names, chain ids
and residue numbers; and, for the atomic edge rules, every atom record.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CAChain:
    """Per-residue CA records, in file order (the first CA per (chain,
    residue number) wins, as drop_duplicates('residue_number'))."""

    coords: np.ndarray      # [n, 3] float32
    resnames: list[str]     # 3-letter codes
    resnums: np.ndarray     # [n] int32 author residue numbers
    chains: list[str]       # chain id per residue

    def __len__(self):
        return len(self.resnames)


@dataclasses.dataclass
class AtomTable:
    """Every ATOM/HETATM record (altloc-filtered), for the atomic edge
    rules: distances between the interacting atoms, mapped back to
    residue-level (CA) nodes."""

    coords: np.ndarray      # [m, 3] float32
    atom_names: list[str]
    resnames: list[str]
    resnums: np.ndarray     # [m] int32
    chains: list[str]

    def __len__(self):
        return len(self.atom_names)


def _records(path: str):
    """(line, atom name) of each ATOM/HETATM record long enough to hold
    coordinates (shorter ones are skipped, as the native parser skips them)
    whose altloc is blank or 'A'."""
    with open(path, "r") as f:
        for line in f:
            if not line.startswith(("ATOM", "HETATM")) or len(line) < 54:
                continue
            if line[16] not in (" ", "A"):
                continue
            yield line, line[12:16].strip()


def _xyz(line: str) -> tuple:
    return (float(line[30:38]), float(line[38:46]), float(line[46:54]))


def parse_pdb_atoms(path: str) -> AtomTable:
    """Every ATOM/HETATM record (the first altloc wins per atom)."""
    coords, names, resnames, resnums, chains = [], [], [], [], []
    seen = set()
    for line, atom_name in _records(path):
        chain, resnum = line[21], int(line[22:26])
        key = (chain, resnum, atom_name)
        if key in seen:
            continue
        seen.add(key)
        coords.append(_xyz(line))
        names.append(atom_name)
        resnames.append(line[17:20].strip())
        resnums.append(resnum)
        chains.append(chain)
    return AtomTable(coords=np.asarray(coords, np.float32).reshape(-1, 3),
                     atom_names=names, resnames=resnames,
                     resnums=np.asarray(resnums, np.int32), chains=chains)


def parse_pdb_ca(path: str) -> CAChain:
    """One CA record per (chain, residue number)."""
    coords, resnames, resnums, chains = [], [], [], []
    seen = set()
    for line, atom_name in _records(path):
        if atom_name != "CA":
            continue
        chain, resnum = line[21], int(line[22:26])
        if (chain, resnum) in seen:
            continue
        seen.add((chain, resnum))
        coords.append(_xyz(line))
        resnames.append(line[17:20].strip())
        resnums.append(resnum)
        chains.append(chain)
    return CAChain(coords=np.asarray(coords, np.float32).reshape(-1, 3),
                   resnames=resnames, resnums=np.asarray(resnums, np.int32),
                   chains=chains)
