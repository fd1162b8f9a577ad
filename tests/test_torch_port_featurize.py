"""The PyTorch port's corpus tools against the JAX package's, on the CPU:
the PDB parsers, the edge rules, ``featurize_pdb`` and
``featurize_directory`` (the numpy path and the native library built from
native/featurizer.cc), ``cli.featurize``, the legacy ``.pt`` graphs
(``convert_pt_graph``, ``cli.convert_graphs``, ``load_graph_dir``), the
duplicate scan and ``cli.validate_data``.

Everything here is numpy or file I/O on both sides, so the comparisons are
exact: the same arrays bit for bit, the same files, the same printed lines.
The one ordering difference is documented and held: the JAX package's
native CA path emits each edge's two arcs together, the port's puts every
arc in the numpy path's row-major order, so those two edge lists are held
equal as sets, and the port's native and numpy paths bit for bit. PDBs are
written as tests/test_featurize.py writes them.
"""

import contextlib
import dataclasses
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from immunostruct_tpu.cli import convert_graphs as jax_convert_cli
from immunostruct_tpu.cli import validate_data as jax_validate_cli
from immunostruct_tpu.config import Config as JaxConfig
from immunostruct_tpu.data import dedupe as jax_dedupe
from immunostruct_tpu.data.dataset import ImmunoDataset as JaxImmunoDataset
from immunostruct_tpu.data.graphs import convert_pt_graph as jax_convert_pt
from immunostruct_tpu.data.graphs import load_graph_dir as jax_load_graph_dir
from immunostruct_tpu.data.synthetic import synthetic_corpus as jax_corpus
from immunostruct_tpu.featurize import builder as jax_builder
from immunostruct_tpu.featurize import edges as jax_edges
from immunostruct_tpu.featurize import native as jax_native
from immunostruct_tpu.featurize import pdb as jax_pdb
from immunostruct_tpu_torch.cli import convert_graphs, featurize, validate_data
from immunostruct_tpu_torch.config import Config
from immunostruct_tpu_torch.data import dedupe
from immunostruct_tpu_torch.data.dataset import GraphArrays, ImmunoDataset
from immunostruct_tpu_torch.data.graphs import convert_pt_graph, load_graph_dir
from immunostruct_tpu_torch.featurize import builder, edges, native, pdb
from tests.test_featurize import RES3, helix_coords, write_pdb
from tests.torch_threads import one_torch_thread  # noqa: F401

GRAPH_KEYS = ("name", "x", "coords", "edge_index")


def _equal(got, want):
    """Two featurizer outputs: the same name and arrays, bit for bit."""
    assert got[0] == want[0]
    for k, a, b in zip(GRAPH_KEYS[1:], got[1:], want[1:]):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _arc_set(edge_index):
    return set(map(tuple, edge_index.T.tolist()))


def _write_complex(path, rng, hla_len=40, pep_len=9, extra=True):
    """Two chains as the featurizer's inputs have them: HLA residues 1..
    hla_len (A), the peptide numbered after them (C), a helix with 3.8 A CA
    spacing and noise; ``extra`` adds residues 180-272 (cut by the
    subgraph filter) by renumbering."""
    n = hla_len + pep_len
    resnums = list(range(1, hla_len + 1))
    if extra:
        resnums = list(range(1, 20)) + list(range(200, 200 + hla_len - 19))
    resnums += list(range(273, 273 + pep_len))
    names = [RES3[int(rng.integers(0, 20))] for _ in range(n)]
    coords = helix_coords(n) + 0.8 * rng.standard_normal((n, 3)).astype(
        np.float32)
    write_pdb(path, names, coords, chains=["A"] * hla_len + ["C"] * pep_len,
              resnums=resnums)


def _write_atoms(path, records):
    """records: (atom_name, resname, resnum, (x, y, z)), chain A."""
    with open(path, "w") as f:
        for i, (an, rn, num, xyz) in enumerate(records, 1):
            f.write(f"ATOM  {i:5d}  {an:<4s}{rn} A{num:4d}    "
                    f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
                    f"  1.00  0.00           {an[0]}\n")
        f.write("END\n")


def _random_atoms(path, rng, residues=14):
    pool = ["N", "CA", "C", "O", "CB", "CG", "CD1", "NE", "NH1", "NZ",
            "OD1", "OE1", "OG", "OG1", "OH", "SD", "SG", "ND2", "NE2"]
    records, num = [], 0
    for _ in range(residues):
        num += int(rng.integers(1, 3))
        res = RES3[int(rng.integers(0, 20))]
        base = rng.uniform(0, 15, 3)
        for an in ("N", "CA", "C", "O"):
            records.append((an, res, num, tuple(base + rng.uniform(-1, 1, 3))))
        for _ in range(int(rng.integers(0, 4))):
            an = pool[int(rng.integers(0, len(pool)))]
            records.append((an, res, num, tuple(base + rng.uniform(-3, 3, 3))))
    _write_atoms(path, records)


def test_parse_pdb_matches_jax(tmp_path):
    """CA records and atom records: a duplicated residue (the first wins),
    altlocs (blank and A kept, B dropped), a HETATM, a short line and a
    second chain."""
    path = str(tmp_path / "p.pdb")
    rng = np.random.default_rng(1)
    _write_complex(path, rng, hla_len=12, pep_len=8)
    with open(path) as f:
        lines = f.read().splitlines()
    ca = lines[3]
    lines.insert(4, ca)                                   # duplicate residue
    lines.insert(5, ca[:16] + "B" + ca[17:])              # altloc B
    lines.insert(6, "HETATM" + ca[6:21] + "B" + ca[22:])  # HETATM, chain B
    lines.insert(7, "ATOM      1  CA  GLY A  99")         # short record
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    got, want = pdb.parse_pdb_ca(path), jax_pdb.parse_pdb_ca(path)
    assert got.resnames == want.resnames and got.chains == want.chains
    for k in ("coords", "resnums"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    got, want = pdb.parse_pdb_atoms(path), jax_pdb.parse_pdb_atoms(path)
    assert (got.atom_names, got.resnames, got.chains) == (
        want.atom_names, want.resnames, want.chains)
    for k in ("coords", "resnums"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_edges_matches_jax(seed):
    """Random residues on a noisy compact helix (every rule fires), two
    chains, thresholds at the defaults and moved: the same arcs, in the same
    order."""
    rng = np.random.default_rng(seed)
    n = 60
    coords = (helix_coords(n, spacing=1.5)
              + rng.standard_normal((n, 3)).astype(np.float32))
    names = [RES3[int(rng.integers(0, 20))] for _ in range(n)]
    resnums = np.arange(1, n + 1, dtype=np.int32)
    chains = ["A"] * 45 + ["C"] * 15
    for kw in ({}, dict(hbond_dist=4.5, ionic_dist=7.0)):
        got = edges.build_edges(coords, names, resnums, chains,
                                edges.EdgeConfig(**kw))
        want = jax_edges.build_edges(coords, names, resnums, chains,
                                     jax_edges.EdgeConfig(**kw))
        assert got.dtype == want.dtype and got.shape[1] > 2 * (n - 2)
        np.testing.assert_array_equal(got, want)
    assert edges.build_edges(coords[:0], [], resnums[:0], []).shape == (2, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_build_edges_atomic_matches_jax(tmp_path, seed):
    path = str(tmp_path / "a.pdb")
    _random_atoms(path, np.random.default_rng(seed))
    ca = pdb.parse_pdb_ca(path)
    got = edges.build_edges_atomic(pdb.parse_pdb_atoms(path), ca.resnums,
                                   ca.chains)
    want = jax_edges.build_edges_atomic(jax_pdb.parse_pdb_atoms(path),
                                        ca.resnums, ca.chains)
    assert got.shape[1] > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("granularity", ["ca", "atomic"])
def test_featurize_pdb_matches_jax(tmp_path, granularity):
    """The subgraph filter (residues 180-272 cut), the node features and
    the name from the file name: the numpy path bit for bit JAX's; the
    native path bit for bit the numpy path, and JAX's native path's arcs as
    a set."""
    rng = np.random.default_rng(3)
    if granularity == "ca":
        path = str(tmp_path / "complexImmunoKEY_abcde.pdb")
        _write_complex(path, rng)
    else:
        path = str(tmp_path / "atomsImmunoKEY.pdb")
        _random_atoms(path, rng, residues=20)
    cfg = edges.EdgeConfig(granularity=granularity)
    jcfg = jax_edges.EdgeConfig(granularity=granularity)
    want = jax_builder.featurize_pdb(path, jcfg, use_native=False)
    got = builder.featurize_pdb(path, cfg, use_native=False)
    _equal(got, want)
    if granularity == "ca":
        assert got[1].shape[0] == 19 + 9       # 21 HLA residues filtered
    _equal(builder.featurize_pdb(path, cfg, use_native=True), got)
    if jax_native.native_available():
        jn = jax_builder.featurize_pdb(path, jcfg, use_native=True)
        _equal(jn[:3] + (got[3],), got)
        assert _arc_set(jn[3]) == _arc_set(got[3])


@pytest.mark.parametrize("use_native", [False, True])
def test_featurize_pdb_masking_matches_jax(tmp_path, use_native):
    """``mask_percentage`` zeroes the same peptide residues' one-hots from
    the same generator, and only peptide residues."""
    path = str(tmp_path / "mImmunoK.pdb")
    _write_complex(path, np.random.default_rng(4), pep_len=10)
    want = jax_builder.featurize_pdb(path, use_native=False,
                                     mask_percentage=40,
                                     mask_rng=np.random.default_rng(9))
    got = builder.featurize_pdb(path, use_native=use_native,
                                mask_percentage=40,
                                mask_rng=np.random.default_rng(9))
    _equal(got[:3] + (want[3],), want)
    assert got[1][:19, :20].sum() == 19          # no HLA residue masked
    assert got[1][-10:, :20].sum() == 6          # 4 of 10 peptide residues
    plain = builder.featurize_pdb(path, use_native=False)
    np.testing.assert_array_equal(plain[3], got[3])


def test_featurize_pdb_derived_name_matches_jax(tmp_path, capsys,
                                                monkeypatch):
    """A file name without 'Immuno' gets the key derived from the subgraph's
    sequence, with a warning printed once."""
    monkeypatch.setattr(builder, "_WARNED_MISSING_KEY", False)
    monkeypatch.setattr(jax_builder, "_WARNED_MISSING_KEY", False)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"plain{i}.pdb"))
        _write_complex(paths[-1], np.random.default_rng(10 + i), extra=False)
    for path in paths:
        want = jax_builder.featurize_pdb(path, use_native=False)
        jax_out = capsys.readouterr().out
        got = builder.featurize_pdb(path, use_native=False)
        assert capsys.readouterr().out == jax_out
        _equal(got, want)
        assert got[0].startswith(os.path.basename(path)[:-4] + "Immuno")
    # each package warned on the first file only
    assert "warning shown once" not in jax_out


# A structure whose CA records all lie outside the subgraph's positions
# (residues 200-201), and one whose residue number does not parse
FAR_PDB = ("ATOM      1  CA  GLY A 200       0.000   0.000   0.000  1.00\n"
           "ATOM      2  CA  ALA A 201       3.800   0.000   0.000  1.00\n")
BROKEN_PDB = "ATOM      1  CA  GLY A  ab     0.000   0.000   0.000  1.00\n"


def _featurize_or_error(fn, path, use_native):
    try:
        return fn(path, use_native=use_native)
    except ValueError as e:
        return f"{type(e).__name__}: {e}"


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("text", [FAR_PDB, BROKEN_PDB],
                         ids=["no_subgraph_residue", "unparsable_residue"])
def test_featurize_pdb_without_subgraph_residues_matches_jax(
        tmp_path, text, use_native):
    """No CA in positions 1-179 and 273-999: JAX's graph of no nodes on
    both paths. A residue number that does not parse: on the numpy path
    JAX's error, on the native path what JAX's native path writes (the
    parser reads it as residue 0, which the filter drops)."""
    assert jax_native.native_available()
    path = str(tmp_path / "sImmunoQ.pdb")
    with open(path, "w") as f:
        f.write(text)
    want = _featurize_or_error(jax_builder.featurize_pdb, path, use_native)
    got = _featurize_or_error(builder.featurize_pdb, path, use_native)
    if isinstance(want, str):
        assert got == want
        assert not use_native and text == BROKEN_PDB
        return
    _equal(got, want)
    assert got[1].shape == (0, 22) and got[2].shape == (0, 3)
    assert got[3].shape == (2, 0)


@pytest.mark.parametrize("use_native", [False, True])
def test_featurize_directory_matches_jax(tmp_path, use_native):
    """A folder with a structure of no subgraph residue and a broken one,
    through each package's numpy or native path: the same graph files (the
    arrays bit for bit; on the native path each edge list the same set of
    arcs, the one documented ordering difference) and the same
    error_log.txt, or none on both sides; the other structures are
    written."""
    assert jax_native.native_available()
    src = tmp_path / "pdbs"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        _write_complex(str(src / f"s{i}Immuno{i}.pdb"), rng)
    (src / "brokenImmunoZ.pdb").write_text(BROKEN_PDB)
    (src / "farImmunoY.pdb").write_text(FAR_PDB)
    out = {}
    for tag, fn in (("jax", jax_builder.featurize_directory),
                    ("port", builder.featurize_directory)):
        dst = tmp_path / tag
        written = fn(str(src), str(dst), workers=2, use_native=use_native)
        out[tag] = (dst, sorted(os.path.basename(w) for w in written))
    (jd, jw), (pd, pw) = out["jax"], out["port"]
    assert pw == jw and len(pw) == (6 if use_native else 5)
    assert "farImmunoY.npz" in pw
    assert sorted(os.listdir(pd)) == sorted(os.listdir(jd))
    if use_native:
        assert not (pd / "error_log.txt").exists()
    else:
        log = (pd / "error_log.txt").read_text()
        assert log == (jd / "error_log.txt").read_text()
        assert log.startswith("Error creating graph brokenImmunoZ.")
    for name in pw:
        with np.load(pd / name) as a, np.load(jd / name) as b:
            assert str(a["name"]) == str(b["name"])
            for k in ("x", "coords"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            if use_native:
                assert _arc_set(a["edge_index"]) == _arc_set(b["edge_index"])
            else:
                np.testing.assert_array_equal(a["edge_index"],
                                              b["edge_index"])


def test_native_library_is_built_from_the_source(tmp_path, monkeypatch):
    """The library is named by a hash of the source and the flags (an
    edited source builds anew), has no -march=native, and a source that
    does not compile raises with the compiler's output."""
    assert "-march=native" not in native.CXX_FLAGS
    lib = native.build()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == native.BUILD_DIR
    bad = tmp_path / "featurizer.cc"
    bad.write_text(native.SOURCE.read_text() + "\nint broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    assert native.library_path() != lib
    with pytest.raises(RuntimeError, match="building the native featurizer "
                                           "failed(.|\n)*broken"):
        native.build()
    assert not native.library_path().exists()


@pytest.mark.parametrize("no_native", [False, True])
def test_cli_featurize(tmp_path, capsys, no_native):
    """The entry point writes one graph a structure and prints the rate and
    the path that ran."""
    src = tmp_path / "pdbs"
    src.mkdir()
    rng = np.random.default_rng(6)
    for i in range(3):
        _write_complex(str(src / f"s{i}Immuno{i}.pdb"), rng)
    argv = ["--alphafold-folder", str(src), "--save-folder",
            str(tmp_path / "out"), "--workers", "2"]
    written = featurize.main(argv + (["--no-native"] if no_native else []))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(written) == 3
    assert line.startswith("featurized 3 structures in ")
    assert line.endswith(f"/s, native={not no_native})")


def _write_pt_corpus(src):
    """Legacy graphs as tests/test_convert_golden.py writes them (x with
    its two trailing H-bond columns, int64 edge_index), plus a duplicate
    key, a name the filter drops and a file that is not a pickle."""
    rng = np.random.default_rng(777)
    for i, name in enumerate(["chain0ImmunoKEY0", "chain1ImmunoKEY1",
                              "chain2ImmunoKEY1", "chain3ImmunoKEYX",
                              "chain4ImmunoKEY4"]):
        n = 8 + 2 * i
        onehot = np.zeros((n, 20), np.float32)
        onehot[np.arange(n), rng.integers(0, 20, n)] = 1.0
        x = torch.tensor(np.concatenate(
            [onehot, rng.random((n, 2)).astype(np.float32)], axis=1))
        coords = torch.tensor(rng.standard_normal((n, 3)).astype(np.float32))
        ei = torch.tensor(rng.integers(0, n, (2, 4 * n)))
        torch.save(SimpleNamespace(name=name, x=x, coords=coords,
                                   edge_index=ei), src / f"g{i}.pt")


def test_pt_graphs_convert_and_load_as_jax(tmp_path, capsys):
    """``convert_pt_graph`` and ``load_graph_dir`` on .pt graphs, and the
    converter CLI (a broken file reported, the rest converted): the same
    arrays and lines as the JAX package's."""
    src = tmp_path / "pt"
    src.mkdir()
    _write_pt_corpus(src)
    for f in sorted(os.listdir(src)):
        got, want = convert_pt_graph(str(src / f)), jax_convert_pt(str(src / f))
        _equal(got, want)
        assert got[1].shape[1] == 22 and got[3].dtype == np.int32
    got, want = load_graph_dir(str(src)), jax_load_graph_dir(str(src))
    assert got.keys == want.keys == ["KEY0", "KEY1", "KEY4"]
    for k in ("node_onehot", "coords", "edge_index"):
        for a, b in zip(getattr(got, k), getattr(want, k)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    (src / "g9.pt").write_bytes(b"not a pickle")
    lines = {}
    for tag, cli in (("port", convert_graphs), ("jax", jax_convert_cli)):
        cli.main(["--src", str(src), "--dst", str(tmp_path / tag)])
        lines[tag] = capsys.readouterr().out.replace(str(tmp_path / tag), "")
    assert lines["port"] == lines["jax"]
    assert "failed g9.pt" in lines["port"] and "converted 5/6" in lines["port"]
    got = load_graph_dir(str(tmp_path / "port"))
    want = jax_load_graph_dir(str(tmp_path / "jax"))
    assert got.keys == want.keys
    for a, b in zip(got.edge_index, want.edge_index):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def iedb(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("iedb"))
    return jax_corpus(root, num_samples=16, hla_len=20, seed=21)


def _inject_duplicates(ds, graphs_cls):
    """Rows 2 and 5 again on their own graphs (full duplicates), row 7's
    sequence and props on another graph (a collision only), and row 9's on
    a copy of its graph (a full duplicate through an equal graph)."""
    g = ds.graphs
    copy = {f.name: np.concatenate([getattr(g, f.name),
                                    getattr(g, f.name)[ds.graph_idx[[9]]]])
            for f in dataclasses.fields(g)}
    rows = np.asarray([2, 5, 7, 9])
    other = (ds.graph_idx[7] + 1) % len(g.num_nodes)
    gidx = np.concatenate([ds.graph_idx, ds.graph_idx[[2, 5]],
                           [other, len(g.num_nodes)]]).astype(np.int32)

    def cat(a):
        return np.concatenate([a, a[rows]])

    return dataclasses.replace(
        ds, graphs=graphs_cls(**copy), graph_idx=gidx,
        seq_full=cat(ds.seq_full), seq_pep=cat(ds.seq_pep),
        props=cat(ds.props), immuno=cat(ds.immuno),
        foreign_norm=cat(ds.foreign_norm), pep_len=cat(ds.pep_len),
        raw_chain=ds.raw_chain + [ds.raw_chain[i] for i in rows])


def test_find_duplicates_and_dedupe_match_jax(iedb):
    from immunostruct_tpu.data.dataset import GraphArrays as JaxGraphArrays

    g, p, h = iedb
    port = _inject_duplicates(ImmunoDataset.load(Config(), g, p, h),
                              GraphArrays)
    jax_ds = _inject_duplicates(JaxImmunoDataset.load(JaxConfig(), g, p, h),
                                JaxGraphArrays)
    got, want = dedupe.find_duplicates(port), jax_dedupe.find_duplicates(jax_ds)
    assert got == want == (4, [16, 17, 19])
    a, b = dedupe.dedupe(port), jax_dedupe.dedupe(jax_ds)
    assert len(a) == len(b) == 17
    assert a.class_weights == b.class_weights and a.raw_chain == b.raw_chain
    for k in ("seq_full", "props", "immuno", "graph_idx", "pep_len"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    clean = ImmunoDataset.load(Config(), g, p, h)
    assert dedupe.dedupe(clean) is clean


@pytest.mark.parametrize("case", ["joins", "no_join"])
def test_validate_data_matches_jax(iedb, tmp_path, case):
    """The same printed lines and return code; 1 where no row joins (the
    HLA table of another corpus)."""
    g, p, h = iedb
    if case == "no_join":
        h = jax_corpus(str(tmp_path / "other"), num_samples=2, hla_len=20,
                       seed=99)[2]
    argv = ["--graph-dir", g, "--property-path", p, "--hla-path", h]
    out = {}
    for tag, cli in (("port", validate_data), ("jax", jax_validate_cli)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        out[tag] = (rc, buf.getvalue())
    # the last line of a run that joins judges the device corpus: the
    # port's by its own estimate against the card's budget
    # (device_data_budget), the JAX package's against a TPU's
    port, jax_out = out["port"][1].splitlines(), out["jax"][1].splitlines()
    if case == "joins":
        assert port[-1].startswith("device-corpus estimate: ")
        assert jax_out[-1].startswith("device-corpus HBM estimate: ")
        port, jax_out = port[:-1], jax_out[:-1]
    assert port == jax_out
    assert out["port"][0] == out["jax"][0] == (0 if case == "joins" else 1)
    assert ("join coverage: 16/16" in out["port"][1]) == (case == "joins")


def test_corpus_pdbs_featurize_into_a_corpus_that_joins(tmp_path, capsys):
    """``write_corpus_pdbs`` + ``cli.featurize`` + ``cli.validate_data``:
    the synthetic corpus written back as PDBs featurizes (both paths, the
    same files) into graphs that join every row of the corpus's table;
    each keeps HLA residues 1-179 and 273-275 and its peptide (276-)."""
    from immunostruct_tpu_torch.data.synthetic import (
        synthetic_corpus, write_corpus_pdbs,
    )

    g, p, h = synthetic_corpus(str(tmp_path / "c"), num_samples=6,
                               hla_len=275, seed=2)
    paths = write_corpus_pdbs(g, str(tmp_path / "pdb"), hla_len=275)
    assert len(paths) == 6
    outs = {}
    for tag, extra in (("native", []), ("numpy", ["--no-native"])):
        outs[tag] = str(tmp_path / tag)
        featurize.main(["--alphafold-folder", str(tmp_path / "pdb"),
                        "--save-folder", outs[tag], *extra])
    for f in sorted(os.listdir(outs["native"])):
        with np.load(os.path.join(outs["native"], f)) as a, \
                np.load(os.path.join(outs["numpy"], f)) as b:
            for k in GRAPH_KEYS:
                np.testing.assert_array_equal(a[k], b[k])
            assert 182 + 8 <= a["x"].shape[0] <= 182 + 10
    corpus, source = load_graph_dir(outs["native"]), load_graph_dir(g)
    assert sorted(corpus.keys) == sorted(source.keys)
    capsys.readouterr()
    assert validate_data.main(["--graph-dir", outs["native"],
                               "--property-path", p, "--hla-path", h]) == 0
    assert "join coverage: 6/6 table rows have a graph (100.0%)" in \
        capsys.readouterr().out
