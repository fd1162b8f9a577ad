"""Corpus validation: graph/table/HLA consistency before training
(counterpart of ``immunostruct_tpu/cli/validate_data.py``).

Prints join coverage (how many table rows find a graph and how many graphs
are referenced), label balance, padding sizes, duplicates and the bytes of
the corpus on the device (``estimate_device_bytes``) against the
``--device-data`` budget of the card (``cli/common.py::
device_data_budget``; without a card the line says so); returns 0, or 1
when no row joins.

Usage:
  python -m immunostruct_tpu_torch.cli.validate_data \\
      --graph-dir data/graph_npz_IEDB/ --property-path data/props.tsv \\
      --hla-path data/HLA_27_seqs_csv.csv [--cancer]
"""

from __future__ import annotations

import argparse

import torch

from immunostruct_tpu_torch.cli.common import device_data_budget
from immunostruct_tpu_torch.config import Config, update_paths
from immunostruct_tpu_torch.data.dataset import ImmunoDataset
from immunostruct_tpu_torch.data.dedupe import find_duplicates
from immunostruct_tpu_torch.data.device_pipeline import estimate_device_bytes
from immunostruct_tpu_torch.data.graphs import load_graph_dir
from immunostruct_tpu_torch.data.tables import expand_hla, parse_property_table


def main(argv=None):
    p = argparse.ArgumentParser(description="Validate a training corpus")
    p.add_argument("--graph-dir", required=True, type=str)
    p.add_argument("--property-path", required=True, type=str)
    p.add_argument("--hla-path", required=True, type=str)
    p.add_argument("--cancer", action="store_true",
                   help="parse as a cancer table (mut_pep + raw allele format)")
    args = p.parse_args(argv)

    corpus = load_graph_dir(args.graph_dir)
    print(f"graphs: {len(corpus)} loaded "
          f"(max {corpus.max_nodes} nodes, {corpus.max_edges} directed edges)")

    _, _, imm, pairs = parse_property_table(args.property_path,
                                            cancer=args.cancer)
    print(f"property table: {len(pairs)} usable rows "
          f"({sum(v == 1 for v in imm.values())} immunogenic)")

    mapper = expand_hla(pairs, args.hla_path)
    keys = set(corpus.index())
    matched = sum(1 for v in mapper.values() if v[1] in keys)
    print(f"join coverage: {matched}/{len(mapper)} table rows have a graph "
          f"({matched / max(len(mapper), 1):.1%}); "
          f"{len({v[1] for v in mapper.values() if v[1] in keys})}/{len(corpus)} "
          f"graphs are referenced")

    if matched == 0:
        print("ERROR: no rows join — graph names and table chains disagree")
        return 1

    cfg = update_paths(Config())
    ds = ImmunoDataset.load(cfg, args.graph_dir, args.property_path,
                            args.hla_path, corpus=corpus, cancer=args.cancer)
    dupes, removable = find_duplicates(ds)
    g = ds.graphs
    print(f"dataset: {len(ds)} rows; padded graph shape "
          f"[{g.max_nodes} nodes x {g.max_edges} edges]; "
          f"seq lengths full={ds.seq_full.shape[1]} pep={ds.seq_pep.shape[1]}")
    print(f"class balance: {dict(ds.class_weights)}; "
          f"foreignness range [{ds.foreign_min:.3f}, {ds.foreign_max:.3f}]")
    print(f"duplicates: {dupes} (seq, props) collisions, "
          f"{len(removable)} exact graph duplicates")
    print(device_corpus_line(estimate_device_bytes(ds, full=True)))
    return 0


def device_corpus_line(need: int) -> str:
    """The corpus's device bytes judged against ``--device-data``'s
    budget for one dataset on CUDA device 0."""
    head = f"device-corpus estimate: {need / 1e6:.0f} MB ({need} B)"
    if not torch.cuda.is_available():
        return (f"{head}; no CUDA device here, so --device-data's budget "
                "(a share of the card's memory) is not judged")
    per_dataset, _ = device_data_budget("cuda:0")
    return (f"{head}; --device-data budget on "
            f"{torch.cuda.get_device_name(0)}: {per_dataset / (1 << 30):.2f} "
            f"GiB a dataset (fits: {need <= per_dataset})")


if __name__ == "__main__":
    raise SystemExit(main())
