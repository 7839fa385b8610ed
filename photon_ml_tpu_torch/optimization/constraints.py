"""Per-feature box constraints ("constraint maps").

Host copy of photon_ml_tpu/optimization/constraints.py (numpy only).
Semantic parity with the reference's constrained training: GLMSuite.
createConstraintFeatureMap (photon-client io/deprecated/GLMSuite.scala:190-260)
parses a JSON array of ``{"name", "term", "lowerBound", "upperBound"}`` maps
(wildcard "*" in term = every term of that name; wildcard name+term = every
feature except the intercept; overlapping constraints rejected), and
OptimizationUtils.projectCoefficientsToSubspace clamps per feature index.

Instead of an index->(lo, hi) hash consulted per coefficient, the map
compiles ONCE into dense ``(lower[D], upper[D])`` vectors (+-inf where
unconstrained) that ride the optimizers' native box-bound support (LBFGS
post-step projection, LBFGSB, TRON and NEWTON projection) as plain tensor
clamps inside the solve.
"""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.types import DELIMITER, intercept_key

WILDCARD = "*"

NAME_KEY = "name"
TERM_KEY = "term"
LOWER_KEY = "lowerBound"
UPPER_KEY = "upperBound"


def parse_constraint_entries(text: str) -> list[dict]:
    """Parse + validate the JSON constraint array (entry-level checks only)."""
    try:
        entries = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"Could not parse the constraint string {text!r}") from e
    if not isinstance(entries, list):
        raise ValueError("Constraint string must be a JSON array of maps")
    out = []
    for entry in entries:
        if not isinstance(entry, dict) or NAME_KEY not in entry or TERM_KEY not in entry:
            raise ValueError(
                f"Each constraint map must specify {NAME_KEY!r} and {TERM_KEY!r}; "
                f"got {entry!r}"
            )
        lower = float(entry.get(LOWER_KEY, -math.inf))
        upper = float(entry.get(UPPER_KEY, math.inf))
        if math.isinf(lower) and lower < 0 and math.isinf(upper) and upper > 0:
            raise ValueError(
                f"Both bounds infinite for feature name={entry[NAME_KEY]!r} "
                f"term={entry[TERM_KEY]!r}: not a constraint"
            )
        if lower >= upper:
            # strict, matching the reference (GLMSuite.scala:229 requires
            # lowerBound < upperBound — equality-pinning is rejected there too)
            raise ValueError(
                f"Lower bound {lower} must be below upper bound {upper} for "
                f"name={entry[NAME_KEY]!r} term={entry[TERM_KEY]!r}"
            )
        name, term = str(entry[NAME_KEY]), str(entry[TERM_KEY])
        if name == WILDCARD and term != WILDCARD:
            raise ValueError(
                "Wildcard in feature name alone is unsupported; a wildcard name "
                "requires a wildcard term"
            )
        out.append({"name": name, "term": term, "lower": lower, "upper": upper})
    return out


def build_bound_vectors(
    text: Optional[str], index_map: IndexMap
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Constraint string + feature index map -> dense (lower[D], upper[D]).

    Returns None when no constraint applies. Overlap and wildcard rules follow
    GLMSuite.createConstraintFeatureMap; the intercept is never constrained by
    the all-feature wildcard.
    """
    if not text:
        return None
    entries = parse_constraint_entries(text)
    if not entries:
        return None
    d = index_map.size
    lower = np.full(d, -np.inf)
    upper = np.full(d, np.inf)
    seen = np.zeros(d, dtype=bool)
    icpt = intercept_key()

    def apply(idx: int, lo: float, hi: float, what: str):
        if seen[idx]:
            raise ValueError(
                f"Conflicting constraints: feature index {idx} ({what}) is "
                "constrained more than once"
            )
        seen[idx] = True
        lower[idx] = lo
        upper[idx] = hi

    for entry in entries:
        name, term, lo, hi = entry["name"], entry["term"], entry["lower"], entry["upper"]
        if name == WILDCARD:  # term is WILDCARD too (validated above)
            if len(entries) > 1:
                raise ValueError(
                    "An all-feature wildcard constraint must be the only entry"
                )
            for key in index_map.keys():
                if key == icpt:
                    continue
                apply(index_map.get_index(key), lo, hi, "wildcard")
        elif term == WILDCARD:
            prefix = name + DELIMITER
            for key in index_map.keys():
                if key.startswith(prefix) and key != icpt:
                    apply(index_map.get_index(key), lo, hi, f"name={name!r} term=*")
        else:
            idx = index_map.get_index(feature_key(name, term))
            if idx < 0:
                continue
            apply(idx, lo, hi, f"name={name!r} term={term!r}")

    if not seen.any():
        return None
    return lower, upper


def project_coefficients(coef: np.ndarray, bounds) -> np.ndarray:
    """Clamp coefficients into the box (OptimizationUtils.
    projectCoefficientsToSubspace:56-70); identity when bounds is None."""
    if bounds is None:
        return coef
    lower, upper = bounds
    return np.clip(coef, lower, upper)
