"""The offline featurizer: PDB files -> graph .npz files."""

from immunostruct_tpu_torch.featurize.builder import (
    RESIDUE_HBOND_ACCEPTORS, RESIDUE_HBOND_DONORS, featurize_directory,
    featurize_pdb,
)
from immunostruct_tpu_torch.featurize.edges import EdgeConfig, build_edges
from immunostruct_tpu_torch.featurize.pdb import parse_pdb_ca
