"""Datasets: the joined (sequence, graph, property, label) corpora
(counterpart of ``immunostruct_tpu/data/dataset.py``; reference:
data/immmunopred_dataloader.py:17-100).

Dense numpy arrays ready for device streaming: unique graphs are stacked
once ([G, N, ...]) and rows carry a graph index; foreignness is min-max
normalized to [-1, 1] (immmunopred_dataloader.py:67-70). Comparative WT
rows get label 0 and foreignness at the corpus minimum, -1.0 under the
cancer side's normalization bounds (immmunopred_dataloader.py:182-183,
:208-214). The clinical dataset belongs to an entry point that is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter
from typing import Optional

import numpy as np
import torch

from immunostruct_tpu_torch.data.encoding import one_hot_encode_batch
from immunostruct_tpu_torch.data.graphs import GraphCorpus, load_graph_dir
from immunostruct_tpu_torch.data.tables import (
    expand_hla, parse_property_table, parse_property_tables_cancer_wt,
)


def seeded_split(n: int, fractions: tuple, seed: int):
    """``torch.utils.data.random_split(dataset, fractions, g)``'s folds:
    torch's randperm under the same manual seed, so the train/val/test
    folds are the reference run's (train_IEDB_wFT.py:56, :69)."""
    lengths = [int(np.floor(n * f)) for f in fractions]
    remainder = n - sum(lengths)
    for i in range(remainder):  # round-robin remainder, like torch
        lengths[i % len(lengths)] += 1
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).tolist()
    out, offset = [], 0
    for ln in lengths:
        out.append(np.asarray(perm[offset:offset + ln], np.int64))
        offset += ln
    return out


@dataclasses.dataclass
class GraphArrays:
    """Stacked unique graphs (see GraphCorpus.stack for shapes)."""
    node_onehot: np.ndarray
    coords: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray
    node_mask: np.ndarray
    num_nodes: np.ndarray

    @property
    def max_nodes(self) -> int:
        return self.node_onehot.shape[1]

    @property
    def max_edges(self) -> int:
        return self.edge_src.shape[1]


def _normalize_foreignness(f: np.ndarray):
    if np.isnan(f).any():
        # the reference dropnas on 'Foreignness_Score' but READS
        # 'smoothed_foreign' (preprocess.py:50-59): a NaN there would NaN
        # the min/max and every normalized target, so raise instead
        raise ValueError(
            f"{int(np.isnan(f).sum())}/{f.size} foreignness values are NaN "
            "(rows with NaN smoothed_foreign survive the reference's "
            "dropna columns); clean the property table before training")
    lo, hi = float(np.min(f)), float(np.max(f))
    norm = 2.0 * (f - (hi + lo) / 2.0) / (hi - lo) if hi > lo else np.zeros_like(f)
    return norm.astype(np.float32), lo, hi


@dataclasses.dataclass
class ImmunoDataset:
    """Single-modality dataset (ImmunoPredDataset parity).

    Arrays (M rows):
      seq_full [M, Lf, 21], seq_pep [M, Lp, 21], props [M, 2] (Mprop1/2),
      immuno [M], foreign_norm [M] in [-1, 1], graph_idx [M] -> graphs.
    """

    seq_full: np.ndarray
    seq_pep: np.ndarray
    props: np.ndarray
    immuno: np.ndarray
    foreign_norm: np.ndarray
    graph_idx: np.ndarray
    graphs: GraphArrays
    class_weights: Counter
    foreign_min: float
    foreign_max: float
    raw_chain: list[str]            # full peptide-HLA chains
    pep_len: np.ndarray             # real peptide length per row

    def __len__(self):
        return len(self.immuno)

    @classmethod
    def load(cls, config, graph_directory: str, property_path: str,
             hla_path: str, cancer: Optional[bool] = None) -> "ImmunoDataset":
        """The table's dialect: ``cancer``, or by default the reference's
        heuristic, the cancer dialect where the graph directory's path
        holds 'Cancer'."""
        if cancer is None:
            cancer = "Cancer" in graph_directory
        f_dict, fp2_dict, imm_dict, pep_pairs = parse_property_table(
            property_path, cancer)
        name_mapper = expand_hla(pep_pairs, hla_path)
        return cls.from_joined(config, load_graph_dir(graph_directory),
                               name_mapper, f_dict, fp2_dict, imm_dict)

    @classmethod
    def from_joined(cls, config, corpus: GraphCorpus, name_mapper: dict,
                    f_dict: dict, fp2_dict: dict, imm_dict: dict,
                    pairs: Optional[list] = None) -> "ImmunoDataset":
        """Two-sided join (preprocess.py:147-173). ``pairs``: the rows'
        pep_pairs in order, duplicates kept (the comparative twins: two
        cancer mutants can share one WT pep_pair, and each keeps its own
        aligned WT row); by default each pep_pair of ``name_mapper`` once."""
        corpus_index = corpus.index()
        items = (list(name_mapper.items()) if pairs is None
                 else [(p, name_mapper[p]) for p in pairs])
        rows = [(pair, v) for pair, v in items if v[1] in corpus_index]
        if not rows:
            raise ValueError(
                "sequence/graph join produced 0 rows: no pep_pair chain key "
                "matches any graph name. Check that the graph directory and "
                "the property/HLA tables belong to the same corpus (graph "
                f"count={len(corpus)}, table rows={len(name_mapper)}).")
        used_keys = sorted({v[1] for _, v in rows},
                           key=lambda k: corpus_index[k])
        print(f"new sequence table size: {len(rows)}, "
              f"removed {len(items) - len(rows)}")
        print(f"new graph list size: {len(used_keys)}, "
              f"removed {len(corpus) - len(used_keys)}")
        key_to_new = {k: i for i, k in enumerate(used_keys)}
        sub = corpus.subset([corpus_index[k] for k in used_keys])

        chains = [v[0] for _, v in rows]
        peps = [v[2] for _, v in rows]
        max_full = max(len(c) for c in chains)
        max_pep = max(len(p) for p in peps)

        immuno = np.asarray([imm_dict[pair] for pair, _ in rows], np.float32)
        foreign = np.asarray([f_dict[pair] for pair, _ in rows], np.float32)
        props = np.asarray([fp2_dict[pair] for pair, _ in rows], np.float32)
        graph_idx = np.asarray([key_to_new[v[1]] for _, v in rows], np.int32)

        foreign_norm, lo, hi = _normalize_foreignness(foreign)
        graphs = GraphArrays(**sub.stack(
            nodes_multiple=config.pad_nodes_multiple,
            edges_multiple=config.pad_edges_multiple))
        return cls(
            seq_full=one_hot_encode_batch(chains, max_full),
            seq_pep=one_hot_encode_batch(peps, max_pep),
            props=props, immuno=immuno, foreign_norm=foreign_norm,
            graph_idx=graph_idx, graphs=graphs,
            class_weights=Counter(immuno.tolist()),
            foreign_min=lo, foreign_max=hi,
            raw_chain=chains,
            pep_len=np.asarray([len(p) for p in peps], np.int32),
        )


@dataclasses.dataclass
class ComparativeDataset:
    """Paired cancer/WT dataset (ImmunoPredDatasetComparative parity): row i
    of ``cancer`` and of ``wt`` are one pair. Training reads the label and
    the foreignness from the cancer side."""

    cancer: ImmunoDataset
    wt: ImmunoDataset

    def __len__(self):
        return len(self.cancer)

    @property
    def class_weights(self) -> Counter:
        return self.cancer.class_weights

    @classmethod
    def load(cls, config, graph_directory_cancer: str, graph_directory_wt: str,
             property_path_cancer: str, property_path_wt: str,
             hla_path: str) -> "ComparativeDataset":
        corpus_c = load_graph_dir(graph_directory_cancer)
        corpus_w = load_graph_dir(graph_directory_wt)
        combined = parse_property_tables_cancer_wt(property_path_cancer,
                                                   property_path_wt)
        mapper_c = expand_hla([r["pep_pair_cancer"] for r in combined],
                              hla_path)
        mapper_w = expand_hla([r["pep_pair_wt"] for r in combined], hla_path)

        # keep rows whose cancer AND wt graphs both exist
        # (preprocess.py:188-266)
        keys_c, keys_w = set(corpus_c.index()), set(corpus_w.index())
        combined = [r for r in combined
                    if mapper_c[r["pep_pair_cancer"]][1] in keys_c
                    and mapper_w[r["pep_pair_wt"]][1] in keys_w]
        if not combined:
            raise ValueError("no cancer/WT rows survived the graph join")

        pairs_c = [r["pep_pair_cancer"] for r in combined]
        pairs_w = [r["pep_pair_wt"] for r in combined]
        cancer_ds = ImmunoDataset.from_joined(
            config, corpus_c, mapper_c,
            {p: r["smoothed_foreign"] for p, r in zip(pairs_c, combined)},
            {p: (r["Mprop1"], r["Mprop2"]) for p, r in zip(pairs_c, combined)},
            {p: r["immunogenicity"] for p, r in zip(pairs_c, combined)},
            pairs=pairs_c)

        # WT rows: label 0, foreignness at the corpus minimum
        # (immmunopred_dataloader.py:182-183); the row order follows the
        # combined table, so the twins align 1:1
        wt_min = min((r["smoothed_foreign"] for r in combined
                      if not math.isnan(r["smoothed_foreign"])),
                     default=math.nan)
        wt_ds = ImmunoDataset.from_joined(
            config, corpus_w, mapper_w, {p: wt_min for p in pairs_w},
            {p: (r["Mprop1_wt"], r["Mprop2_wt"])
             for p, r in zip(pairs_w, combined)},
            {p: 0.0 for p in pairs_w}, pairs=pairs_w)
        if len(cancer_ds) != len(wt_ds):
            raise ValueError(f"cancer/WT row mismatch: {len(cancer_ds)} vs "
                             f"{len(wt_ds)}")
        # the reference normalizes with ONE (min, max), the cancer side's,
        # class-wide (immmunopred_dataloader.py:208-214): from_joined
        # normalized the constant WT array against itself, so redo it with
        # the cancer bounds (WT reads -1.0)
        lo, hi = cancer_ds.foreign_min, cancer_ds.foreign_max
        wt_ds.foreign_min, wt_ds.foreign_max = lo, hi
        if hi > lo:
            norm_min = 2.0 * (wt_min - (hi + lo) / 2.0) / (hi - lo)
            wt_ds.foreign_norm = np.full_like(wt_ds.foreign_norm, norm_min)
        return cls(cancer=cancer_ds, wt=wt_ds)
