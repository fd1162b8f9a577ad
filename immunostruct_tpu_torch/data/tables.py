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

Text columns (peptide, allele) are kept as text. The cancer dialect
(``mut_pep`` + the reformatted allele, dropna on ``foreign``), the cancer/WT
pairing and its deduplication belong to the comparative entry point and
are not ported yet.
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


def parse_property_table(path: str):
    """Returns (foreign_dict, props_dict, immuno_dict, pep_pairs) of an
    IEDB-dialect table.

    Mirrors preprocess_properties (preprocess.py:45-64)."""
    rows = [r for r in read_rows(path)
            if not math.isnan(to_number(r["Foreignness_Score"]))]
    pairs = [r["peptide"] + r["allele"] for r in rows]
    f_dict = {p: to_number(r["smoothed_foreign"]) for p, r in zip(pairs, rows)}
    fp2_dict = {p: (to_number(r["Mprop1"]), to_number(r["Mprop2"]))
                for p, r in zip(pairs, rows)}
    imm_dict = {p: to_number(r["immunogenicity"]) for p, r in zip(pairs, rows)}
    return f_dict, fp2_dict, imm_dict, pairs


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
