"""Convert a legacy PyG ``.pt`` graph directory to the native .npz format
(counterpart of ``immunostruct_tpu/cli/convert_graphs.py``).

The reference's featurizer wrote one PyG ``Data`` per structure
(torch.save at cancer_graph_construction_new_KBG.py:143); this tool writes
each as a self-describing .npz graph, one ``try`` per file. A pickle that
references ``torch_geometric`` converts only where that package is
installed.

Usage:
  python -m immunostruct_tpu_torch.cli.convert_graphs \\
      --src data/graph_pyg_IEDB/ --dst data/graph_npz_IEDB/
"""

from __future__ import annotations

import argparse
import os

from immunostruct_tpu_torch.data.graphs import convert_pt_graph, save_graph_npz


def main(argv=None):
    p = argparse.ArgumentParser(description="Legacy .pt graph converter")
    p.add_argument("--src", required=True, type=str)
    p.add_argument("--dst", required=True, type=str)
    args = p.parse_args(argv)

    os.makedirs(args.dst, exist_ok=True)
    files = sorted(f for f in os.listdir(args.src) if f.endswith(".pt"))
    ok, failed = 0, 0
    for fname in files:
        try:
            name, x, coords, edge_index = convert_pt_graph(
                os.path.join(args.src, fname))
            save_graph_npz(os.path.join(args.dst, fname[:-3] + ".npz"),
                           name=name, x=x, coords=coords,
                           edge_index=edge_index)
            ok += 1
        except Exception as e:  # noqa: BLE001 - per-file fault tolerance
            failed += 1
            print(f"failed {fname}: {e}")
    print(f"converted {ok}/{len(files)} graphs -> {args.dst} ({failed} failed)")


if __name__ == "__main__":
    main()
