"""Offline featurization entry point (counterpart of
``immunostruct_tpu/cli/featurize.py``; reference:
preprocessing/cancer_graph_construction_new_KBG.py run over a folder of
AlphaFold PDBs): one .npz graph per structure.

Usage:
  python -m immunostruct_tpu_torch.cli.featurize \\
      --alphafold-folder data/alphafold_pdb_Cancer/ \\
      --save-folder data/graph_pyg_Cancer/ [--workers 8] [--no-native]

The native library is built from native/featurizer.cc at the first call
(a failed build stops the run); ``--no-native`` runs the numpy path
instead. Prints the structures written per second and which path ran.
"""

from __future__ import annotations

import argparse
import time

from immunostruct_tpu_torch.featurize import EdgeConfig, featurize_directory


def main(argv=None):
    p = argparse.ArgumentParser(description="PDB -> graph featurizer")
    p.add_argument("--alphafold-folder", required=True, type=str)
    p.add_argument("--save-folder", required=True, type=str)
    p.add_argument("--workers", default=1, type=int,
                   help="threads; the native library releases the GIL")
    p.add_argument("--no-native", action="store_true",
                   help="run the numpy path instead of the native library")
    p.add_argument("--edge-granularity", default="ca", choices=["ca", "atomic"],
                   help="'ca': interaction distances on CA coordinates; "
                        "'atomic': distances between the interacting atoms, "
                        "mapped to residue edges (closer to graphein on "
                        "all-atom PDBs)")
    args = p.parse_args(argv)

    use_native = not args.no_native
    t0 = time.perf_counter()
    written = featurize_directory(
        args.alphafold_folder, args.save_folder,
        edge_config=EdgeConfig(granularity=args.edge_granularity),
        workers=args.workers, use_native=use_native)
    dt = time.perf_counter() - t0
    rate = len(written) / dt if dt > 0 else float("inf")
    print(f"featurized {len(written)} structures in {dt:.2f}s ({rate:.1f}/s, "
          f"native={use_native})")
    return written


if __name__ == "__main__":
    main()
