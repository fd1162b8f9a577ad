"""Clinical survival validation (counterpart of
``immunostruct_tpu/procedures/clinical.py``; reference:
procedures/clinical_validation.py).

A numpy Kaplan-Meier estimator and two-sample log-rank test in place of
lifelines (clinical_validation.py:7-8, :77-90), over rows (dicts keyed by
column, as ``data/tables.py::read_rows`` gives them) in place of pandas
frames. The pipeline:

  per-pMHC predicted probabilities -> per-patient summed "immunogenicity
  load" (clinical_validation.py:49-52) -> median split into low/high groups
  (:69-74, both groups include the median row: <= and >=) -> log-rank
  p-values for OS and PFS (:77-90) -> optional KM plot (:103-165).

The JAX package joins the loads to the outcome rows by position, after
sorting each by patient; a patient missing on one side shifts every later
load onto the wrong patient, or fails on the lengths. Here the join is by
patient key, and two patient sets that differ raise a ValueError naming the
patients. Where the sets are equal the result is the JAX package's: the
median split and the log-rank test depend on the loads' order and the
groups' counts, and a load here (``math.fsum``) and pandas' group sum
differ at most in the last bits.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np

OUTCOME_COLUMNS = ("OS.Time", "OS.Event", "PFS.Time", "PFS.Event")


def convert_patient_code(patient_code: str) -> str:
    """Cohort prefix remap (clinical_validation.py:13-25)."""
    mapping = {"mUC": "BC", "MM": "Neye", "RH": "RH"}
    prefix, _, number = patient_code.partition("-")
    return f"{mapping[prefix]}-{number}" if prefix in mapping else patient_code


def kaplan_meier(times: np.ndarray, events: np.ndarray):
    """KM survival estimate. Returns (unique_event_times, survival_prob)."""
    order = np.argsort(times, kind="stable")
    times, events = np.asarray(times)[order], np.asarray(events)[order]
    uniq = np.unique(times[events.astype(bool)])
    surv = []
    s = 1.0
    for t in uniq:
        at_risk = np.sum(times >= t)
        died = np.sum((times == t) & events.astype(bool))
        s *= 1.0 - died / at_risk
        surv.append(s)
    return uniq, np.asarray(surv)


def _chi2_sf_1dof(x: float) -> float:
    """Survival function of chi-square with 1 dof: erfc(sqrt(x/2))."""
    return math.erfc(math.sqrt(max(x, 0.0) / 2.0))


def logrank_test(times_a, times_b, events_a, events_b) -> float:
    """Two-sample log-rank test p-value (lifelines.logrank_test equivalent)."""
    times_a = np.asarray(times_a, float)
    times_b = np.asarray(times_b, float)
    events_a = np.asarray(events_a).astype(bool)
    events_b = np.asarray(events_b).astype(bool)

    all_event_times = np.unique(np.concatenate([times_a[events_a],
                                                times_b[events_b]]))
    o_minus_e = 0.0
    var = 0.0
    for t in all_event_times:
        n_a = np.sum(times_a >= t)
        n_b = np.sum(times_b >= t)
        d_a = np.sum((times_a == t) & events_a)
        d_b = np.sum((times_b == t) & events_b)
        n = n_a + n_b
        d = d_a + d_b
        if n < 2 or d == 0:
            continue
        expected_a = d * n_a / n
        v = d * (n_a / n) * (n_b / n) * (n - d) / (n - 1)
        o_minus_e += d_a - expected_a
        var += v
    if var <= 0:
        return 1.0
    chi2 = o_minus_e ** 2 / var
    return _chi2_sf_1dof(chi2)


def _number(cell) -> float:
    """An outcome cell as a float; comma decimals read as points
    (clinical_validation.py:98-99)."""
    return float(str(cell).replace(",", "."))


def patient_loads(predicted_probs, seq_rows: list[dict]) -> dict:
    """{patient_ID: summed probability} over the rows whose probability is
    not NaN (they are dropped before the sum, clinical_validation.py:49-52);
    ``seq_rows[i]['patient']`` is row i's patient."""
    probs = np.asarray(predicted_probs, float)
    if len(probs) != len(seq_rows):
        raise ValueError(f"{len(probs)} probabilities for {len(seq_rows)} "
                         "clinical sequence rows")
    terms: dict = {}
    for row, p in zip(seq_rows, probs.tolist()):
        if not math.isnan(p):
            terms.setdefault(convert_patient_code(str(row["patient"])),
                             []).append(p)
    return {k: math.fsum(v) for k, v in terms.items()}


def join_outcomes(loads: dict, clin_rows: list[dict]) -> list[dict]:
    """The outcome rows sorted by patient, each with its ``patient_ID``,
    numeric OS/PFS columns and its ``load``. Raises ValueError naming the
    patients when the loads' and the outcomes' patient sets differ."""
    patients = [str(r["Patient"]) for r in clin_rows]
    only_loads = sorted(set(loads) - set(patients))
    only_clin = sorted(set(patients) - set(loads))
    if only_loads or only_clin or len(set(patients)) != len(patients):
        dup = sorted({p for p in patients if patients.count(p) > 1})
        raise ValueError(
            "clinical join: the scored patients and the outcome table "
            f"disagree (scored, no outcome: {only_loads}; outcome, no scored "
            f"row: {only_clin}; outcome rows repeated: {dup})")
    out = []
    for r in sorted(clin_rows, key=lambda r: str(r["Patient"])):
        row = dict(r)
        for col in OUTCOME_COLUMNS:
            row[col] = _number(r[col])
        row["patient_ID"] = str(r["Patient"])
        row["load"] = loads[row["patient_ID"]]
        out.append(row)
    return out


def _column(rows: list[dict], col: str) -> np.ndarray:
    return np.asarray([r[col] for r in rows], float)


def clinical_pvalues(predicted_probs, seq_rows: list[dict],
                     clin_rows: list[dict],
                     fig_save_path: Optional[str] = None):
    """Per-patient load aggregation + median split + OS/PFS log-rank
    p-values; returns (os_p, pfs_p).

    ``seq_rows`` holds a 'patient' per probability; ``clin_rows`` the
    columns Patient / OS.Time / OS.Event / PFS.Time / PFS.Event (numbers or
    their text, comma decimals allowed). No plot is made when both p-values
    are above 0.1 (as in the JAX package)."""
    rows = join_outcomes(patient_loads(predicted_probs, seq_rows), clin_rows)

    load = _column(rows, "load")
    median = np.percentile(load, 50)
    low = [r for r, v in zip(rows, load) if v <= median]
    high = [r for r, v in zip(rows, load) if v >= median]

    os_p = logrank_test(_column(low, "OS.Time"), _column(high, "OS.Time"),
                        _column(low, "OS.Event"), _column(high, "OS.Event"))
    pfs_p = logrank_test(_column(low, "PFS.Time"), _column(high, "PFS.Time"),
                         _column(low, "PFS.Event"),
                         _column(high, "PFS.Event"))

    if fig_save_path is not None:
        if os_p > 0.1 and pfs_p > 0.1:
            print("Not plotting clinical KM figures: both p-values > 0.1.")
        else:
            plot_clinical_validation(low, high, os_p, pfs_p, fig_save_path)
    return os_p, pfs_p


def plot_clinical_validation(low: list[dict], high: list[dict], os_p: float,
                             pfs_p: float, fig_save_path: str) -> None:
    """KM curves for OS and PFS, low vs high predicted-immunogenicity load;
    skipped, with a printed line, where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping clinical KM plot")
        return

    fig, axes = plt.subplots(1, 2, figsize=(14, 6), dpi=150)
    for ax, (tcol, ecol, p, title) in zip(axes, [
        ("OS.Time", "OS.Event", os_p, "OS Kaplan-Meier"),
        ("PFS.Time", "PFS.Event", pfs_p, "PFS Kaplan-Meier"),
    ]):
        for rows, label, color in (
                (low, "Low Predicted Immunogenicity", "mediumblue"),
                (high, "High Predicted Immunogenicity", "firebrick")):
            t, s = kaplan_meier(_column(rows, tcol), _column(rows, ecol))
            t = np.r_[0.0, t]
            s = np.r_[1.0, s]
            ax.step(t, s, where="post", label=label, color=color,
                    linewidth=2.5)
        ax.text(0.6, 0.12, f"p-value = {p:.4f}", transform=ax.transAxes)
        ax.set_title(title)
        ax.set_xlabel("Time (months)")
        ax.set_ylabel("Survival Probability")
        ax.legend()
    fig.tight_layout(pad=2)
    os.makedirs(os.path.dirname(fig_save_path) or ".", exist_ok=True)
    fig.savefig(fig_save_path)
    plt.close(fig)
