"""Seeded synthetic inputs (counterpart of ``immunostruct_tpu/data/synthetic.py``
``synthetic_corpus``/``synthetic_comparative_corpus``/
``synthetic_clinical_corpus``/``random_sample_batch``/
``random_comparative_batch``, ``immunostruct_tpu/serving.py``
``write_example`` and ``scripts/perf_sweep.py`` ``build_batch``).

The functions make the same ``np.random.default_rng`` calls in the same
order as the JAX package, so one seed gives bit-identical arrays in both
packages. The corpora write their tables with the ``csv`` module in the
layout pandas' ``to_csv`` gives them (header, shortest round-trip floats),
so for the same arguments both packages write the same files byte for
byte. ``write_corpus_pdbs`` (no JAX counterpart) writes a corpus's graphs
back as PDB files, the featurizer's input.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from immunostruct_tpu_torch.data.encoding import AA3_TO_1, AMINO_ACIDS
from immunostruct_tpu_torch.data.graphs import save_graph_npz
from immunostruct_tpu_torch.data.tables import get_hash, read_rows
from immunostruct_tpu_torch.structs import ComparativeBatch, SampleBatch

_HLA_NAMES = [f"HLA-A*{i:02d}:01" for i in range(1, 28)]


def _random_seq(rng, length: int) -> str:
    return "".join(rng.choice(list(AMINO_ACIDS), length))


def _make_graph(rng, seq: str, knn: int = 4, compact_tail: int = 0,
                tail_scale: float = 0.5):
    """A noisy helix of CA coordinates; chain bonds plus k-nearest-neighbour
    contacts, both directions."""
    n = len(seq)
    t = np.arange(n, dtype=np.float32)
    coords = np.stack([np.cos(t * 0.6), np.sin(t * 0.6), 0.5 * t], -1)
    coords = coords + 0.3 * rng.standard_normal((n, 3)).astype(np.float32)
    if compact_tail:
        # pull the peptide's residues toward their centroid: a signal in the
        # coordinates alone
        tail = coords[n - compact_tail:]
        coords[n - compact_tail:] = tail.mean(0) + tail_scale * (tail - tail.mean(0))

    onehot = np.zeros((n, 20), np.float32)
    for i, ch in enumerate(seq):
        onehot[i, AMINO_ACIDS.index(ch)] = 1.0
    hd = rng.integers(0, 3, (n, 1)).astype(np.float32)
    ha = rng.integers(0, 3, (n, 1)).astype(np.float32)
    x = np.concatenate([onehot, hd, ha], -1)  # 22 cols; loader cuts last 2

    src = list(range(n - 1)) + list(range(1, n))
    dst = list(range(1, n)) + list(range(n - 1))
    d2 = np.sum((coords[:, None] - coords[None]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :knn]
    for i in range(n):
        for j in nn[i]:
            src.extend([i, int(j)])
            dst.extend([int(j), i])
    edge_index = np.unique(np.stack([src, dst]), axis=1).astype(np.int32)
    return x, coords, edge_index


def _write_table(path: str, rows: list[dict], delimiter: str) -> None:
    """A header line and one line per row, as pandas' ``to_csv`` writes a
    frame of these columns (no index)."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter=delimiter, lineterminator="\n")
        writer.writerow(list(rows[0]))
        for row in rows:
            writer.writerow([repr(v) if isinstance(v, float) else v
                             for v in row.values()])


def _hla_table(root: str, rng, hla_len: int, shared_hla_path=None):
    """Write (or, where ``shared_hla_path`` exists, read and draw nothing)
    the HLA csv; returns (path, {allele: seq})."""
    if shared_hla_path and os.path.exists(shared_hla_path):
        return shared_hla_path, {r["allele"]: r["seqs"]
                                 for r in read_rows(shared_hla_path, ",")}
    hla_seqs = {name: _random_seq(rng, hla_len) for name in _HLA_NAMES[:4]}
    path = shared_hla_path or os.path.join(root, "HLA_seqs.csv")
    _write_table(path, [{"allele": a, "seqs": q}
                        for a, q in hla_seqs.items()], ",")
    return path, hla_seqs


def synthetic_corpus(root: str, num_samples: int = 32, hla_len: int = 48,
                     seed: int = 0, planted_signal: bool = False,
                     geometric_signal: bool = False):
    """Write a synthetic IEDB-dialect (graph dir, property tsv, hla csv)
    trio; returns (graph_dir, property_path, hla_path).

    Chains are ``hla_len`` + 8-10 residues. ``planted_signal`` makes labels
    learnable from the peptide's hydrophobic fraction; ``geometric_signal``
    plants the label in the coordinates alone (the peptide tail compacted);
    the two are exclusive."""
    if planted_signal and geometric_signal:
        raise ValueError("planted_signal and geometric_signal are exclusive")
    rng = np.random.default_rng(seed)
    graph_dir = os.path.join(root, "graph_pyg_IEDB")
    os.makedirs(graph_dir, exist_ok=True)

    hla_path, hla_seqs = _hla_table(root, rng, hla_len)

    rows = []
    for i in range(num_samples):
        allele = _HLA_NAMES[int(rng.integers(0, 4))]
        pep = _random_seq(rng, int(rng.integers(8, 11)))
        chain = hla_seqs[allele] + pep
        key = chain[-99:] + "_" + get_hash(chain)[:5]
        geo_label = int(rng.random() < 0.5) if geometric_signal else 0
        x, coords, ei = _make_graph(
            rng, chain, compact_tail=len(pep) if geo_label else 0)
        save_graph_npz(os.path.join(graph_dir, f"g{i:04d}.npz"),
                       name=f"synImmuno{key}", x=x, coords=coords,
                       edge_index=ei)
        if geometric_signal:
            immuno = geo_label
            foreign = float(rng.random())
            mprop1 = float(rng.random())
        elif planted_signal:
            hydrophobic = sum(c in "AVLIMFWPY" for c in pep) / len(pep)
            immuno = int(hydrophobic > 0.45)
            foreign = float(np.clip(hydrophobic + 0.1 * rng.standard_normal(), 0, 1))
            mprop1 = float(np.clip(hydrophobic + 0.2 * rng.standard_normal(), 0, 1))
        else:
            immuno = int(rng.random() < 0.4)
            foreign = float(rng.random())
            mprop1 = float(rng.random())
        rows.append({
            "immunogenicity": immuno,
            "smoothed_foreign": foreign,
            "Mprop1": mprop1,
            "Mprop2": float(rng.random()),
            "peptide": pep, "allele": allele,
            "Foreignness_Score": foreign,
        })

    property_path = os.path.join(root, "props_IEDB.tsv")
    _write_table(property_path, rows, "\t")
    return graph_dir, property_path, hla_path


def synthetic_comparative_corpus(root: str, num_samples: int = 24,
                                 hla_len: int = 48, seed: int = 0,
                                 shared_hla_path=None):
    """Write a paired cancer/WT corpus: both branches' graph dirs and the
    two cancer-dialect tables. WT peptides are single-point mutations of
    the cancer peptides. ``shared_hla_path`` reuses one HLA table across
    corpora (where the file exists; the Cancer curriculum needs it).
    Returns (graph_dir_cancer, graph_dir_wt, props_cancer, props_wt,
    hla_path)."""
    rng = np.random.default_rng(seed)
    dir_c = os.path.join(root, "graph_pyg_Cancer")
    dir_w = os.path.join(root, "graph_pyg_Cancer_WT")
    os.makedirs(dir_c, exist_ok=True)
    os.makedirs(dir_w, exist_ok=True)
    hla_path, hla_seqs = _hla_table(root, rng, hla_len, shared_hla_path)

    rows_c, rows_w = [], []
    for i in range(num_samples):
        allele_star = _HLA_NAMES[int(rng.integers(0, 4))]
        allele_raw = "HLA-" + allele_star.split("-")[1].replace(
            "*", "").replace(":", "")
        pep_c = _random_seq(rng, int(rng.integers(8, 11)))
        pos = int(rng.integers(0, len(pep_c)))
        sub = rng.choice([a for a in AMINO_ACIDS if a != pep_c[pos]])
        pep_w = pep_c[:pos] + str(sub) + pep_c[pos + 1:]

        for pep, d in ((pep_c, dir_c), (pep_w, dir_w)):
            chain = hla_seqs[allele_star] + pep
            key = chain[-99:] + "_" + get_hash(chain)[:5]
            x, coords, ei = _make_graph(rng, chain)
            save_graph_npz(os.path.join(d, f"g{i:04d}.npz"),
                           name=f"synImmuno{key}", x=x, coords=coords,
                           edge_index=ei)

        immuno = int(rng.random() < 0.5)
        foreign = float(rng.random())
        base = {"mut_pep": pep_c, "wt_pep": pep_w, "allele": allele_raw,
                "immunogenicity": immuno, "foreign": foreign}
        rows_c.append({**base, "smoothed_foreign": foreign,
                       "Mprop1": float(rng.random()),
                       "Mprop2": float(rng.random())})
        rows_w.append({**base, "Mprop1_wt": float(rng.random()),
                       "Mprop2_wt": float(rng.random())})

    props_c = os.path.join(root, "props_cancer.tsv")
    props_w = os.path.join(root, "props_wt.tsv")
    _write_table(props_c, rows_c, "\t")
    _write_table(props_w, rows_w, "\t")
    return dir_c, dir_w, props_c, props_w, hla_path


def synthetic_clinical_corpus(root: str, num_rows: int = 40,
                              num_patients: int = 8, hla_len: int = 48,
                              match_rate: float = 0.8, seed: int = 3):
    """Write a clinical cohort: the graph directory, the sequence table (one
    pMHC a row: patient, combo, mut_pep, hla_seq) and the outcomes table
    (one patient a row: Patient, RECIST, PFS/OS time and event, mut_load).

    A matched row gets a graph whose join key derives from hla_seq +
    mut_pep (the reference's clinical join, preprocess.py:302-313); the
    rest have no graph and become NaN rows, the placeholder path. Patients
    are ``mUC-<i>`` in the sequence table and ``BC-<i>`` in the outcomes
    table (``convert_patient_code``). Returns (graph_dir, seq_path,
    clin_path)."""
    rng = np.random.default_rng(seed)
    graph_dir = os.path.join(root, "graph_pyg_Clinical")
    os.makedirs(graph_dir, exist_ok=True)
    hla_seq = _random_seq(rng, hla_len)

    rows = []
    patients = [f"mUC-{i}" for i in range(num_patients)]
    for i in range(num_rows):
        pep = _random_seq(rng, int(rng.integers(8, 11)))
        if rng.random() < match_rate:
            chain = hla_seq + pep
            key = chain[-99:] + "_" + get_hash(chain)[:5]
            x, coords, ei = _make_graph(rng, chain)
            save_graph_npz(os.path.join(graph_dir, f"c{i:04d}.npz"),
                           name=f"synImmuno{key}", x=x, coords=coords,
                           edge_index=ei)
        rows.append({"patient": patients[i % num_patients],
                     "combo": f"combo{i}", "mut_pep": pep, "hla_seq": hla_seq})

    # the columns in the JAX package's draw order
    pfs_time = rng.random(num_patients) * 20
    os_time = rng.random(num_patients) * 30
    pfs_event = rng.integers(0, 2, num_patients)
    os_event = rng.integers(0, 2, num_patients)
    mut_load = rng.integers(10, 2000, num_patients)
    clin = [{"Patient": p.replace("mUC", "BC"), "RECIST": "PD",
             "PFS.Time": float(pfs_time[j]), "OS.Time": float(os_time[j]),
             "PFS.Event": int(pfs_event[j]), "OS.Event": int(os_event[j]),
             "mut_load": int(mut_load[j])}
            for j, p in enumerate(patients)]
    seq_path = os.path.join(root, "clinical_seq.tsv")
    clin_path = os.path.join(root, "clinical_outcomes.tsv")
    _write_table(seq_path, rows, "\t")
    _write_table(clin_path, clin, "\t")
    return graph_dir, seq_path, clin_path


def write_corpus_pdbs(graph_dir: str, pdb_dir: str, hla_len: int) -> list:
    """Write one CA-only PDB per graph of a synthetic corpus (the graphs'
    residues from their one-hot columns) into ``pdb_dir``; returns the
    paths. Each file is named by its graph's name, so it carries the
    Immuno join key and the featurized graph joins the corpus's table. Two
    chains: the HLA's ``hla_len`` residues (chain A, numbered 1..hla_len),
    then the peptide (chain C, numbered after them). The CAs lie on
    tests/test_featurize.py's helix: (2 cos t, 2 sin t, 0.4 * 3.8 t)."""
    res3 = {one: three for three, one in AA3_TO_1.items()}
    os.makedirs(pdb_dir, exist_ok=True)
    paths = []
    for fname in sorted(f for f in os.listdir(graph_dir)
                        if f.endswith(".npz")):
        with np.load(os.path.join(graph_dir, fname)) as z:
            name, x = str(z["name"]), z["x"]
        n = x.shape[0]
        t = np.arange(n)
        coords = np.stack([np.cos(t) * 2, np.sin(t) * 2, t * 3.8 * 0.4],
                          -1).astype(np.float32)
        path = os.path.join(pdb_dir, name + ".pdb")
        with open(path, "w") as f:
            for i in range(n):
                res = res3[AMINO_ACIDS[int(np.argmax(x[i, :20]))]]
                chain = "A" if i < hla_len else "C"
                f.write(f"ATOM  {i + 1:5d}  CA  {res} {chain}{i + 1:4d}    "
                        f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}"
                        f"{coords[i, 2]:8.3f}  1.00  0.00           C\n")
            f.write("END\n")
        paths.append(path)
    return paths


def random_sample_arrays(batch: int, nodes: int, edges: int, seq_len: int,
                         seed: int = 0) -> dict:
    """The flagship-shaped random batch as numpy arrays keyed by field name.

    Every edge is real (``edge_mask`` all True); indices are drawn uniformly,
    so self-loops occur."""
    rng = np.random.default_rng(seed)
    onehot = np.zeros((batch, nodes, 20), np.float32)
    for b in range(batch):
        onehot[b, np.arange(nodes), rng.integers(0, 20, nodes)] = 1.0
    coords = rng.standard_normal((batch, nodes, 3)).astype(np.float32)
    src = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
    dst = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
    return dict(
        node_feat=onehot, coords=coords, edge_src=src, edge_dst=dst,
        edge_feat=np.ones((batch, edges, 1), np.float32),
        edge_mask=np.ones((batch, edges), bool),
        node_mask=np.ones((batch, nodes), bool),
        num_nodes=np.full((batch,), nodes, np.int32),
        seq_onehot=rng.random((batch, seq_len, 21)).astype(np.float32),
        props=rng.random((batch, 2)).astype(np.float32),
        target=(rng.random(batch) > 0.5).astype(np.float32),
    )


def random_sample_batch(batch: int, nodes: int, edges: int, seq_len: int,
                        seed: int = 0,
                        device: torch.device | str = "cpu") -> SampleBatch:
    """``random_sample_arrays`` as a SampleBatch on ``device``."""
    return SampleBatch.from_numpy(
        random_sample_arrays(batch, nodes, edges, seq_len, seed), device)


def build_batch(batch: int, nodes: int, edges: int, seq_len: int,
                paired: bool = False,
                device: torch.device | str = "cpu") -> SampleBatch:
    """The kernel races' batch (counterpart of ``scripts/perf_sweep.py``
    ``build_batch``: the same draws from ``default_rng(0)``). Every edge is
    real. ``paired=True`` lays the random edges out mirror-paired (slot
    k + E/2 is the reverse of slot k, no self loops): a valid input for every
    kernel variant and the layout ``mega_variant='paired'`` requires."""
    rng = np.random.default_rng(0)
    onehot = np.zeros((batch, nodes, 20), np.float32)
    for b in range(batch):
        onehot[b, np.arange(nodes), rng.integers(0, 20, nodes)] = 1.0
    if paired:
        half = edges // 2
        s0 = rng.integers(0, nodes, (batch, half)).astype(np.int32)
        d0 = ((s0 + rng.integers(1, nodes, (batch, half))) % nodes
              ).astype(np.int32)
        esrc = np.concatenate([s0, d0], axis=1)
        edst = np.concatenate([d0, s0], axis=1)
    else:
        esrc = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
        edst = rng.integers(0, nodes, (batch, edges)).astype(np.int32)
    coords = rng.standard_normal((batch, nodes, 3)).astype(np.float32)
    return SampleBatch.from_numpy(dict(
        node_feat=onehot, coords=coords, edge_src=esrc, edge_dst=edst,
        edge_feat=np.ones((batch, edges, 1), np.float32),
        edge_mask=np.ones((batch, edges), bool),
        node_mask=np.ones((batch, nodes), bool),
        num_nodes=np.full((batch,), nodes, np.int32),
        seq_onehot=rng.random((batch, seq_len, 21)).astype(np.float32),
        props=rng.random((batch, 2)).astype(np.float32),
        target=(rng.random(batch) > 0.5).astype(np.float32)), device)


def random_comparative_batch(batch: int, nodes: int, edges: int,
                             seq_len: int, seed: int = 0,
                             device: torch.device | str = "cpu"
                             ) -> ComparativeBatch:
    """Cancer/WT twins: the cancer half from ``seed``, the WT half from
    ``seed + 1`` with the cancer half's (pair-level) target."""
    cancer = random_sample_batch(batch, nodes, edges, seq_len, seed, device)
    wt = random_sample_batch(batch, nodes, edges, seq_len, seed + 1, device)
    wt.target = cancer.target
    return ComparativeBatch(cancer=cancer, wt=wt)


def write_example(path, batch: int = 8, nodes: int = 32, edges: int = 128,
                  seq_len: int = 64) -> None:
    """Write a scoring request ``.npz`` (the serving request format)."""
    rng = np.random.default_rng(0)
    onehot = np.zeros((batch, nodes, 20), np.float32)
    onehot[:, np.arange(nodes), rng.integers(0, 20, (batch, nodes))] = 1.0
    np.savez(path,
             node_feat=onehot,
             coords=rng.standard_normal((batch, nodes, 3)).astype(np.float32),
             edge_src=rng.integers(0, nodes, (batch, edges)).astype(np.int32),
             edge_dst=rng.integers(0, nodes, (batch, edges)).astype(np.int32),
             edge_feat=np.ones((batch, edges, 1), np.float32),
             edge_mask=np.ones((batch, edges), bool),
             node_mask=np.ones((batch, nodes), bool),
             num_nodes=np.full((batch,), nodes, np.int32),
             seq=rng.random((batch, seq_len, 21)).astype(np.float32),
             props=rng.random((batch, 2)).astype(np.float32))
