"""The comparison that decides `correct`.

Every answer the program gave (one per request or solve: three modes of
mask, d, λ and sweeps) is held against the reference's answer for the
tensor that request sent.  The numbers, each the worst over the answers
and modes compared:

  missing    requests that never came back
  sweeps     |program's sweeps − reference's| of a mode
  lam_gap    max_i |λ_i − λ_ref,i| / max_i |λ_ref,i| of a mode
  d_gap      max_i |d_i − d_ref,i| / max_i |d_ref,i| of a mode
  mask       members on which the program's cluster differs from the
             reference's extraction run on the program's own d, over the
             three modes of one answer

The cluster is a function of d alone, and on a near-noise tensor two
sound fp32 computations of d (within lam_gap's and d_gap's limits) can
order two nearly equal entries apart and so cut the cluster one member
apart.  So d is held to the reference's d, and the extraction to the
reference's extraction of that same d, exactly.  Each number has a
limit of its own in `limits/<cell>.json`, set from the readings of sound
runs and of the control (PERF.md).
"""
from __future__ import annotations

import numpy as np

from reference import msc as reference

NAMES = ("missing", "sweeps", "mask", "lam_gap", "d_gap")


def _rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return 1.0  # a wrong-sized answer is wholly wrong
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    gap = float(np.max(np.abs(got - want))) if want.size else 0.0
    return gap / scale if scale > 0 else gap


def per_answer(answers: list, refs: dict, settings: dict) -> list:
    """The compared numbers of each answer ([(pool index, [ModeAnswer] *
    3)]) against `refs` ({pool index: [ModeAnswer] * 3}); `settings` give
    the extraction's ε and cap."""
    extracted = {}  # answers of one tensor repeat their d bit for bit
    rows = []
    for idx, modes in answers:
        row = dict.fromkeys(NAMES, 0.0)
        for got, ref in zip(modes, refs[idx]):
            d = np.asarray(got.d, np.float32)
            key = d.tobytes()
            if key not in extracted:
                extracted[key] = reference.extract(
                    d, settings["epsilon"], settings["max_extraction_iters"])
            want_mask = extracted[key]
            row["mask"] += (float(np.count_nonzero(got.mask != want_mask))
                            if got.mask.shape == want_mask.shape
                            else float(max(got.mask.size, want_mask.size)))
            row["sweeps"] = max(row["sweeps"],
                                float(abs(int(got.sweeps) - int(ref.sweeps))))
            row["lam_gap"] = max(row["lam_gap"], _rel_gap(got.lam, ref.lam))
            row["d_gap"] = max(row["d_gap"], _rel_gap(got.d, ref.d))
        rows.append(row)
    return rows


def worst(rows: list, missing: int = 0) -> dict:
    """Each number's worst over the answers, and the requests missing."""
    out = {k: max([r[k] for r in rows], default=0.0) for k in NAMES}
    out["missing"] = float(missing)
    return out


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of every number in `nums`:
    correct when each is at most its limit (a number without a limit
    fails)."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in nums.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
