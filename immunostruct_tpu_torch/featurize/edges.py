"""Edge construction rules (counterpart of
``immunostruct_tpu/featurize/edges.py``).

Vectorized numpy in place of graphein's edge functions (reference:
preprocessing/cancer_graph_construction_new_KBG.py:46-52:
add_peptide_bonds, add_hydrogen_bond_interactions,
add_hydrophobic_interactions, add_ionic_interactions), at CA granularity:

- peptide bonds: consecutive residue numbers within the same chain;
- hydrogen bonds: donor/acceptor-capable residue pairs with CA distance
  < 3.5 A (4.0 A when either side is sulfur-bearing CYS/MET);
- hydrophobic: both residues in the hydrophobic set, CA distance < 5.0 A;
- ionic: an oppositely charged pair (pos {ARG, LYS, HIS} x neg {ASP,
  GLU}), CA distance < 6.0 A.

``build_edges_atomic`` measures the same rules between the interacting
atoms and maps them to residue edges. Edges are undirected in graphein and
become both directed arcs after the PyG conversion (data/utils.py:63); both
functions emit both directions, once each, in row-major (src, dst) order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

HYDROPHOBIC = {"ALA", "VAL", "LEU", "ILE", "MET", "PHE", "TRP", "PRO", "TYR"}
POSITIVE = {"ARG", "LYS", "HIS"}
NEGATIVE = {"ASP", "GLU"}
SULFUR = {"CYS", "MET"}
# residues with sidechain H-bond donor / acceptor capability
HBOND_DONOR_RES = {"ARG", "ASN", "GLN", "HIS", "LYS", "SER", "THR", "TRP",
                   "TYR", "CYS"}
HBOND_ACCEPTOR_RES = {"ASP", "GLU", "ASN", "GLN", "HIS", "SER", "THR", "TYR",
                      "MET", "CYS"}


@dataclasses.dataclass(frozen=True)
class EdgeConfig:
    hbond_dist: float = 3.5
    hbond_sulfur_dist: float = 4.0
    hydrophobic_dist: float = 5.0
    ionic_dist: float = 6.0
    # 'ca': interaction distances on CA coordinates (the native library's
    # rules); 'atomic': distances between the interacting atoms, mapped to
    # residue edges (closer to graphein on all-atom PDBs)
    granularity: str = "ca"


def _rule_adjacency(d, hb_donor, hb_acceptor, sulfur, hydro, pos, neg,
                    config: EdgeConfig):
    """The H-bond, hydrophobic and ionic rules over a distance matrix."""
    hb_pair = ((hb_donor[:, None] & hb_acceptor[None, :])
               | (hb_acceptor[:, None] & hb_donor[None, :]))
    hb_thresh = np.where(sulfur[:, None] | sulfur[None, :],
                         config.hbond_sulfur_dist, config.hbond_dist)
    adj = hb_pair & (d < hb_thresh)
    adj |= (hydro[:, None] & hydro[None, :]) & (d < config.hydrophobic_dist)
    opposite = (pos[:, None] & neg[None, :]) | (neg[:, None] & pos[None, :])
    adj |= opposite & (d < config.ionic_dist)
    return adj


def _peptide_bonds(resnums: np.ndarray, chains) -> np.ndarray:
    chain_arr = np.asarray(chains)
    resnums = np.asarray(resnums)
    same_chain = chain_arr[:, None] == chain_arr[None, :]
    return same_chain & (np.abs(resnums[:, None] - resnums[None, :]) == 1)


def _arcs(adj: np.ndarray) -> np.ndarray:
    np.fill_diagonal(adj, False)
    adj |= adj.T  # symmetrize -> both directions
    src, dst = np.nonzero(adj)
    return np.stack([src, dst]).astype(np.int32)


def build_edges(coords: np.ndarray, resnames: list[str], resnums: np.ndarray,
                chains: list[str],
                config: EdgeConfig = EdgeConfig()) -> np.ndarray:
    """Returns [2, E] int32 edge_index with both arc directions."""
    if len(resnames) == 0:
        return np.zeros((2, 0), np.int32)
    names = np.asarray(resnames)
    d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
    adj = _peptide_bonds(resnums, chains)
    adj |= _rule_adjacency(
        d, np.isin(names, list(HBOND_DONOR_RES)),
        np.isin(names, list(HBOND_ACCEPTOR_RES)),
        np.isin(names, list(SULFUR)), np.isin(names, list(HYDROPHOBIC)),
        np.isin(names, list(POSITIVE)), np.isin(names, list(NEGATIVE)),
        config)
    return _arcs(adj)


# The atomic rules' atom sets (standard protein-chemistry assignments).
# sidechain H-bond donor/acceptor heavy atoms (backbone N and O count too)
HBOND_DONOR_ATOMS = {
    ("ARG", "NE"), ("ARG", "NH1"), ("ARG", "NH2"), ("ASN", "ND2"),
    ("GLN", "NE2"), ("HIS", "ND1"), ("HIS", "NE2"), ("LYS", "NZ"),
    ("SER", "OG"), ("THR", "OG1"), ("TRP", "NE1"), ("TYR", "OH"),
    ("CYS", "SG"),
}
HBOND_ACCEPTOR_ATOMS = {
    ("ASP", "OD1"), ("ASP", "OD2"), ("GLU", "OE1"), ("GLU", "OE2"),
    ("ASN", "OD1"), ("GLN", "OE1"), ("HIS", "ND1"), ("HIS", "NE2"),
    ("SER", "OG"), ("THR", "OG1"), ("TYR", "OH"), ("MET", "SD"),
    ("CYS", "SG"),
}
BACKBONE_ATOMS = {"N", "CA", "C", "O", "OXT"}
SULFUR_ATOMS = {"SD", "SG"}
IONIC_POSITIVE_ATOMS = {
    ("ARG", "NE"), ("ARG", "NH1"), ("ARG", "NH2"), ("LYS", "NZ"),
    ("HIS", "ND1"), ("HIS", "NE2"),
}
IONIC_NEGATIVE_ATOMS = {
    ("ASP", "OD1"), ("ASP", "OD2"), ("GLU", "OE1"), ("GLU", "OE2"),
}


def _pairs_to_residue_adj(adj_atoms, res_idx, n_res):
    """Atom-pair hits -> residue-level adjacency (self-pairs dropped)."""
    out = np.zeros((n_res, n_res), bool)
    ai, aj = np.nonzero(adj_atoms)
    ri, rj = res_idx[ai], res_idx[aj]
    keep = ri != rj
    out[ri[keep], rj[keep]] = True
    return out


def build_edges_atomic(atoms, ca_resnums: np.ndarray, ca_chains: list[str],
                       config: EdgeConfig = EdgeConfig()) -> np.ndarray:
    """[2, E] residue-level edge_index from atomic interaction distances.

    ``atoms``: an AtomTable (featurize/pdb.py) filtered to the CA
    subgraph's residues; ``ca_resnums``/``ca_chains`` give the residue
    nodes' order. Peptide bonds stay at residue granularity."""
    n_res = len(ca_resnums)
    res_of = {(c, int(r)): i
              for i, (c, r) in enumerate(zip(ca_chains, ca_resnums))}
    adj = _peptide_bonds(ca_resnums, ca_chains)

    if len(atoms):
        res_idx = np.asarray([res_of.get((c, int(r)), -1)
                              for c, r in zip(atoms.chains, atoms.resnums)],
                             np.int64)
        keep = res_idx >= 0
        coords = atoms.coords[keep]
        res_idx = res_idx[keep]
        keys = [(rn, an) for rn, an, k in
                zip(atoms.resnames, atoms.atom_names, keep.tolist()) if k]
        names = np.asarray([an for _, an in keys])
        d = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)

        donor = np.asarray([k in HBOND_DONOR_ATOMS or k[1] == "N"
                            for k in keys])
        acceptor = np.asarray([k in HBOND_ACCEPTOR_ATOMS or k[1] == "O"
                               for k in keys])
        sulfur = np.isin(names, list(SULFUR_ATOMS))
        resname_arr = np.asarray([rn for rn, _ in keys])
        hydro = (np.isin(resname_arr, list(HYDROPHOBIC))
                 & ~np.isin(names, list(BACKBONE_ATOMS))
                 & np.char.startswith(names.astype(str), "C"))
        pos = np.asarray([k in IONIC_POSITIVE_ATOMS for k in keys])
        neg = np.asarray([k in IONIC_NEGATIVE_ATOMS for k in keys])
        adj |= _pairs_to_residue_adj(
            _rule_adjacency(d, donor, acceptor, sulfur, hydro, pos, neg,
                            config), res_idx, n_res)
    return _arcs(adj)
