"""Property-table parsing, pep_pair construction, HLA expansion
(counterpart of ``immunostruct_tpu/data/tables.py``; reference:
data/preprocess.py:45-64, :132-145).

The JAX package reads the tables with pandas; this module reads them with
the ``csv`` module and reproduces what the JAX code leans on pandas for:

- ``read_table``'s missing-value tokens (pandas' default ``na_values``,
  ``NA_TOKENS``) make a numeric cell NaN, so ``dropna(subset=...)`` drops
  the rows whose key column is empty or one of those tokens;
- the numeric columns (``immunogenicity``, ``smoothed_foreign``,
  ``Mprop1``, ``Mprop2``, the dropna column) are parsed as float64;
- ``dict(zip(pep_pairs, values))`` keeps the LAST row of a duplicated
  ``pep_pair``, while the ``pep_pairs`` list keeps every row in order;
- the graph join key is ``chain[-99:] + '_' + sha1(chain)[:5]``.

Text columns (peptide, allele) are kept as text. The cancer dialect keys
on ``mut_pep`` + the reformatted allele after dropping rows with a missing
``foreign``; its cancer/WT pairing (``parse_property_tables_cancer_wt``)
deduplicates each table (``dedup_property_df``) and joins them as
``pd.merge`` does: an inner join on four keys in the left table's order.
A table there is a list of rows (dicts keyed by column, in the file's
column order): the numeric columns (``NUMERIC``) as floats, NaN where
pandas reads a missing value; a missing text cell as None.
"""

from __future__ import annotations

import csv
import functools
import hashlib
import math
from typing import Iterable

# pandas' default missing-value tokens (pandas.read_csv ``na_values``)
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def get_hash(x: str) -> str:
    """sha1 hex digest (data/utils.py:157-158)."""
    return hashlib.sha1(x.encode()).hexdigest()


def to_number(text: str) -> float:
    """A numeric cell as pandas reads it: NaN for a missing-value token."""
    return math.nan if text in NA_TOKENS else float(text)


def read_rows(path: str, delimiter: str = "\t") -> list[dict]:
    """Every row of a delimited table with a header line, as a dict of
    strings keyed by column name."""
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter=delimiter))


# the columns of the property tables that pandas reads as numbers
NUMERIC = frozenset({"immunogenicity", "foreign", "smoothed_foreign",
                     "Foreignness_Score", "Mprop1", "Mprop2", "Mprop1_wt",
                     "Mprop2_wt"})
# the group and join keys of the cancer/WT pairing
GROUP_KEYS = ("mut_pep", "wt_pep", "allele")
JOIN_KEYS = GROUP_KEYS + ("immunogenicity",)


def read_typed_rows(path: str) -> list[dict]:
    """A property table as pandas' ``read_table`` gives it: NUMERIC
    columns as floats (NaN for a missing-value token), a missing text cell
    as None."""
    rows = read_rows(path)
    for r in rows:
        for k, v in r.items():
            if k in NUMERIC:
                r[k] = to_number(v)
            elif v in NA_TOKENS:
                r[k] = None
    return rows


def reformat_cancer_allele(allele: str) -> str:
    """'HLA-A0201' -> 'HLA-A*02:01' (preprocess.py:51-52)."""
    parts = allele.split("-")
    if len(parts) < 2:
        raise ValueError(f"allele {allele!r} has no '-'")
    head, tail = parts[0], parts[1]
    return head + "-" + tail[:1] + "*" + tail[1:3] + ":" + tail[3:]


def parse_property_table(path: str, cancer: bool = False):
    """Returns (foreign_dict, props_dict, immuno_dict, pep_pairs): the
    IEDB dialect (dropna on ``Foreignness_Score``, key ``peptide +
    allele``) or, with ``cancer``, the cancer one (dropna on ``foreign``,
    key ``mut_pep`` + the reformatted allele).

    Mirrors preprocess_properties (preprocess.py:45-64)."""
    if cancer:
        rows = [r for r in read_rows(path)
                if not math.isnan(to_number(r["foreign"]))]
        pairs = [r["mut_pep"] + reformat_cancer_allele(r["allele"])
                 for r in rows]
    else:
        rows = [r for r in read_rows(path)
                if not math.isnan(to_number(r["Foreignness_Score"]))]
        pairs = [r["peptide"] + r["allele"] for r in rows]
    f_dict = {p: to_number(r["smoothed_foreign"]) for p, r in zip(pairs, rows)}
    fp2_dict = {p: (to_number(r["Mprop1"]), to_number(r["Mprop2"]))
                for p, r in zip(pairs, rows)}
    imm_dict = {p: to_number(r["immunogenicity"]) for p, r in zip(pairs, rows)}
    return f_dict, fp2_dict, imm_dict, pairs


def _nan_none(v):
    """A key cell with NaN as None: pandas groups and joins NaN keys as
    equal to each other."""
    return None if isinstance(v, float) and math.isnan(v) else v


def dedup_property_df(rows: list[dict]) -> list[dict]:
    """Deduplicate (mut_pep, wt_pep, allele), keeping per group the row of
    extreme foreignness: the largest for an immunogenic group, else the
    smallest, the first on a tie, a row with NaN foreignness only where the
    group has no other (preprocess.py:92-130). The kept rows stay in their
    order. Foreignness is ``smoothed_foreign`` where the table has it, else
    ``foreign``. A group with mixed immunogenicity raises, as in the
    reference."""
    if not rows:
        return []
    fkey = "smoothed_foreign" if "smoothed_foreign" in rows[0] else "foreign"
    seen_imm: dict = {}
    for r in rows:
        key = tuple(r[c] for c in GROUP_KEYS)
        v = r["immunogenicity"]
        if None in key or math.isnan(v):   # groupby drops NaN keys, nunique NaN
            continue
        seen_imm.setdefault(key, set()).add(v)
    if any(len(v) > 1 for v in seen_imm.values()):
        raise ValueError(
            "same (mut_pep, wt_pep, allele) with different immunogenicity")

    kept = []
    for immunogenic in (True, False):
        part = [(i, r) for i, r in enumerate(rows)
                if (r["immunogenicity"] == 1) == immunogenic]
        # pandas' stable sort toward the extreme (ties keep their order),
        # NaN last
        num = [(i, r) for i, r in part if not math.isnan(r[fkey])]
        num.sort(key=lambda ir: -ir[1][fkey] if immunogenic else ir[1][fkey])
        seen = set()
        for i, r in num + [(i, r) for i, r in part if math.isnan(r[fkey])]:
            key = tuple(_nan_none(r[c]) for c in GROUP_KEYS)
            if key not in seen:
                seen.add(key)
                kept.append((i, r))
    return [r for _, r in sorted(kept, key=lambda ir: ir[0])]


def parse_property_tables_cancer_wt(path_cancer: str,
                                    path_wt: str) -> list[dict]:
    """The paired cancer/WT table (preprocess.py:67-90): each table without
    its rows of missing ``foreign``, deduplicated, then joined on (mut_pep,
    wt_pep, allele, immunogenicity), inner, in the cancer table's order.
    Rows with the columns mut_pep, wt_pep, allele, immunogenicity,
    pep_pair_cancer, pep_pair_wt, smoothed_foreign, Mprop1, Mprop1_wt,
    Mprop2, Mprop2_wt."""
    def load(path, pep_col, pair_col, cols):
        out = []
        for r in read_typed_rows(path):
            if math.isnan(r["foreign"]):
                continue
            r[pair_col] = r[pep_col] + reformat_cancer_allele(r["allele"])
            out.append({c: r[c] for c in cols})
        return dedup_property_df(out)

    short_c = load(path_cancer, "mut_pep", "pep_pair_cancer",
                   JOIN_KEYS + ("pep_pair_cancer", "smoothed_foreign",
                                "Mprop1", "Mprop2"))
    short_w = load(path_wt, "wt_pep", "pep_pair_wt",
                   JOIN_KEYS + ("foreign", "pep_pair_wt", "Mprop1_wt",
                                "Mprop2_wt"))

    def join_key(r):
        return tuple(_nan_none(r[c]) for c in JOIN_KEYS)

    by_key: dict = {}
    for r in short_w:
        by_key.setdefault(join_key(r), []).append(r)
    combined = [
        {"mut_pep": c["mut_pep"], "wt_pep": c["wt_pep"],
         "allele": c["allele"], "immunogenicity": c["immunogenicity"],
         "pep_pair_cancer": c["pep_pair_cancer"],
         "pep_pair_wt": w["pep_pair_wt"],
         "smoothed_foreign": c["smoothed_foreign"], "Mprop1": c["Mprop1"],
         "Mprop1_wt": w["Mprop1_wt"], "Mprop2": c["Mprop2"],
         "Mprop2_wt": w["Mprop2_wt"]}
        for c in short_c for w in by_key.get(join_key(c), [])]
    if not (len(short_c) == len(short_w) == len(combined)):
        raise ValueError(
            f"cancer/WT tables misaligned: {len(short_c)} vs {len(short_w)} "
            f"vs merged {len(combined)}")
    return combined


def find_matching_allele(peptide: str, alleles: Iterable[str],
                         pep_pairs: set) -> object:
    """First allele whose (peptide + allele) key exists in the table
    (reference: data/utils.py:38-43; returns 0 when none match)."""
    for allele in alleles:
        combo = peptide + allele
        if combo in pep_pairs:
            return combo
    return 0


def get_z_peps(expanded_rows: list[dict], seq_rows: list[dict]) -> list:
    """Peptides with combo2 == 0 whose table rows are all non-immunogenic
    (reference: data/utils.py:45-52): the rows' ``immunogenicity`` sums to
    0, NaN counted as 0, as pandas' ``sum`` does."""
    z_peps = []
    for pep in [r["peptide"] for r in seq_rows if r["combo2"] == 0]:
        total = sum(float(r["immunogenicity"]) for r in expanded_rows
                    if r["peptide"] == pep
                    and not math.isnan(float(r["immunogenicity"])))
        if total == 0:
            z_peps.append(pep)
    return z_peps


@functools.lru_cache(maxsize=8)
def _load_hla_seqs(hla_path: str) -> dict:
    """allele -> 274-aa sequence (the HLA csv's ``allele``/``seqs``)."""
    return {r["allele"]: r["seqs"] for r in read_rows(hla_path, ",")}


def expand_hla(pep_pairs: Iterable[str], hla_path: str) -> dict:
    """pep_pair -> (full_chain, graph_key, peptide) (preprocess.py:132-145).

    full_chain = HLA sequence + peptide; graph_key = chain[-99:]_sha1[:5]."""
    hla_seqs = _load_hla_seqs(hla_path)

    name_mapper = {}
    for pair in pep_pairs:
        parts = pair.split("HLA-")
        if len(parts) != 2:
            raise ValueError(
                f"pep_pair {pair!r} has no 'HLA-' allele part — only "
                "HLA-prefixed class-I alleles are supported "
                "(preprocess.py:132-145 assumes the same)")
        pep, hla = parts
        try:
            chain = hla_seqs["HLA-" + hla] + pep
        except KeyError:
            raise ValueError(
                f"allele 'HLA-{hla}' (from pep_pair {pair!r}) is not in "
                f"{hla_path} ({len(hla_seqs)} alleles); extend the HLA "
                "sequence table to cover this corpus") from None
        hashed = get_hash(chain)[:5]
        name_mapper[pair] = (chain, chain[-99:] + "_" + hashed, pep)
    return name_mapper
