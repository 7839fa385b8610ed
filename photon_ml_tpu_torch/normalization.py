"""Feature normalization as affine algebra: x' = (x - shift) * factor.

Port of photon_ml_tpu/normalization.py (NormalizationContext.scala:37-215,
stat/FeatureDataStatistics.scala). The per-feature statistics and the
factory are host numpy, copied. Objectives never materialize
normalized data: they fold shift and factor into an effective coefficient
vector and a margin shift, and apply the same algebra to the gradient.
Models live in the original space and solves in the transformed one; the
two ``*_space_device`` methods carry coefficients between them.

``factors`` and ``shifts`` may be numpy arrays or tensors; they are moved to
the coefficients' dtype and device where they are used.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.types import NormalizationType

Tensor = torch.Tensor


def _like(v, ref: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


@dataclasses.dataclass(frozen=True)
class FeatureDataStatistics:
    """Per-feature one-pass summary (photon-lib stat/FeatureDataStatistics.scala:1-139).

    All fields are length-D numpy arrays; computed host-side at ingest in a single pass
    (see compute()).
    """

    count: int
    mean: np.ndarray
    variance: np.ndarray
    min: np.ndarray
    max: np.ndarray
    num_nonzeros: np.ndarray
    mean_abs: np.ndarray
    intercept_index: Optional[int] = None

    @staticmethod
    def compute(X, intercept_index: Optional[int] = None) -> "FeatureDataStatistics":
        """Compute from a [N, D] host matrix (dense ndarray or scipy sparse; the
        sparse path never densifies — zeros contribute implicitly, matching the
        reference's MultivariateOnlineSummarizer semantics)."""
        import scipy.sparse as _sp

        if _sp.issparse(X):
            return FeatureDataStatistics._compute_sparse(X.tocsc(), intercept_index)
        X = np.asarray(X)
        n = X.shape[0]
        if n == 0:
            raise ValueError("Cannot compute feature statistics over zero samples")
        return FeatureDataStatistics(
            count=n,
            mean=X.mean(axis=0),
            # Reference uses MultivariateOnlineSummarizer = sample variance (n-1).
            variance=X.var(axis=0, ddof=1) if n > 1 else np.zeros(X.shape[1]),
            min=X.min(axis=0) if n else np.zeros(X.shape[1]),
            max=X.max(axis=0) if n else np.zeros(X.shape[1]),
            num_nonzeros=(X != 0).sum(axis=0).astype(np.float64),
            mean_abs=np.abs(X).mean(axis=0),
            intercept_index=intercept_index,
        )

    @staticmethod
    def _compute_sparse(X, intercept_index: Optional[int]) -> "FeatureDataStatistics":
        n, d = X.shape
        if n == 0:
            raise ValueError("Cannot compute feature statistics over zero samples")
        nnz = np.diff(X.indptr).astype(np.float64)  # per column (csc)
        s1 = np.asarray(X.sum(axis=0)).ravel()
        s2 = np.asarray(X.multiply(X).sum(axis=0)).ravel()
        mean = s1 / n
        var = (
            (s2 - n * mean**2) / (n - 1) if n > 1 else np.zeros(d)
        )
        var = np.maximum(var, 0.0)  # guard tiny negative round-off
        # vectorized per-column min/max over stored values (reduceat needs a
        # guard for empty columns: their indptr slot would reduce the NEXT
        # column's first element, so mask them out afterwards)
        mins = np.zeros(d)
        maxs = np.zeros(d)
        nonempty = nnz > 0
        if X.nnz:
            starts = X.indptr[:-1]
            safe_starts = np.minimum(starts, X.nnz - 1)
            col_min = np.minimum.reduceat(X.data, safe_starts)
            col_max = np.maximum.reduceat(X.data, safe_starts)
            mins[nonempty] = col_min[nonempty]
            maxs[nonempty] = col_max[nonempty]
        # columns with implicit zeros include 0 in their range
        has_implicit_zero = nnz < n
        mins = np.where(has_implicit_zero, np.minimum(mins, 0.0), mins)
        maxs = np.where(has_implicit_zero, np.maximum(maxs, 0.0), maxs)
        mean_abs = np.asarray(np.abs(X).sum(axis=0)).ravel() / n
        return FeatureDataStatistics(
            count=n,
            mean=mean,
            variance=var,
            min=mins,
            max=maxs,
            num_nonzeros=nnz,
            mean_abs=mean_abs,
            intercept_index=intercept_index,
        )


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """Affine transform x' = (x - shift) * factor; None means identity on that part.

    If shifts are present an intercept index is required, with shift 0 and
    factor 1 there. Coefficient tensors may carry leading batch axes.
    """

    factors: Optional[object] = None  # [D] numpy array or tensor
    shifts: Optional[object] = None  # [D] numpy array or tensor
    intercept_index: Optional[int] = None

    def __post_init__(self):
        if self.shifts is not None and self.intercept_index is None:
            raise ValueError("Shift normalization requires an intercept index")
        if self.factors is not None and self.shifts is not None:
            if len(self.factors) != len(self.shifts):
                raise ValueError("Factors and shifts must have the same size")

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    @property
    def size(self) -> int:
        if self.factors is not None:
            return len(self.factors)
        if self.shifts is not None:
            return len(self.shifts)
        return 0

    def padded_to(self, dim: int) -> "NormalizationContext":
        """Extend to ``dim`` features with identity entries (factor 1, shift 0)."""
        if self.is_identity or self.size >= dim:
            return self
        extra = dim - self.size
        factors = (
            None
            if self.factors is None
            else np.concatenate([np.asarray(self.factors), np.ones(extra)])
        )
        shifts = (
            None
            if self.shifts is None
            else np.concatenate([np.asarray(self.shifts), np.zeros(extra)])
        )
        return NormalizationContext(
            factors=factors, shifts=shifts, intercept_index=self.intercept_index
        )

    # -- coefficient-space conversions (host-side; numpy) ---------------------

    def model_to_original_space(self, coef: np.ndarray) -> np.ndarray:
        if self.is_identity:
            return coef
        out = np.array(coef, dtype=np.float64, copy=True)
        if self.factors is not None:
            out = out * np.asarray(self.factors)
        if self.shifts is not None:
            out[self.intercept_index] -= out.dot(np.asarray(self.shifts))
        return out

    def model_to_transformed_space(self, coef: np.ndarray) -> np.ndarray:
        if self.is_identity:
            return coef
        out = np.array(coef, dtype=np.float64, copy=True)
        if self.shifts is not None:
            out[self.intercept_index] += out.dot(np.asarray(self.shifts))
        if self.factors is not None:
            out = out / np.asarray(self.factors)
        return out

    def to_original_space_device(self, w: Tensor) -> Tensor:
        """Coefficients of the transformed space in the original one, batched
        over leading axes ([D] or [B, D]); tensor ops only, no host sync."""
        if self.is_identity:
            return w
        if self.factors is not None:
            w = w * _like(self.factors, w)
        if self.shifts is not None:
            w = w.clone()
            w[..., self.intercept_index] -= w @ _like(self.shifts, w)
        return w

    def to_transformed_space_device(self, w: Tensor) -> Tensor:
        """Inverse of :meth:`to_original_space_device` (warm starts enter the
        solver's transformed space)."""
        if self.is_identity:
            return w
        if self.shifts is not None:
            w = w.clone()
            w[..., self.intercept_index] += w @ _like(self.shifts, w)
        if self.factors is not None:
            w = w / _like(self.factors, w)
        return w

    def effective_coefficients(self, coef: Tensor) -> tuple[Tensor, Tensor]:
        """(effective_coef, margin_shift) with x'.w == x.eff + margin_shift:
          eff = factor * w,  margin_shift = -eff . shift
        (ValueAndGradientAggregator.init, reference :90-120)."""
        eff = coef if self.factors is None else coef * _like(self.factors, coef)
        if self.shifts is None:
            shift = torch.zeros(coef.shape[:-1], dtype=coef.dtype, device=coef.device)
        else:
            shift = -torch.sum(eff * _like(self.shifts, coef), dim=-1)
        return eff, shift

    def apply_to_gradient(self, vector_sum: Tensor, prefactor_sum: Tensor) -> Tensor:
        """grad_j = factor_j * (vector_sum_j - shift_j * prefactor_sum)
        (reference :55-75); ``prefactor_sum`` has the batch shape."""
        g = vector_sum
        if self.shifts is not None:
            g = g - _like(self.shifts, g) * prefactor_sum.unsqueeze(-1)
        if self.factors is not None:
            g = g * _like(self.factors, g)
        return g

    # -- factory (NormalizationContext.apply, reference :126-190) -------------------

    @staticmethod
    def build(
        normalization_type: NormalizationType,
        summary: Optional[FeatureDataStatistics] = None,
    ) -> "NormalizationContext":
        normalization_type = NormalizationType(normalization_type)
        if normalization_type == NormalizationType.NONE:
            return NormalizationContext()
        if summary is None:
            raise ValueError(f"{normalization_type} requires feature statistics")

        if normalization_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
            magnitude = np.maximum(np.abs(summary.max), np.abs(summary.min))
            factors = 1.0 / np.where(magnitude == 0.0, 1.0, magnitude)
            return NormalizationContext(factors=factors)

        std = np.sqrt(summary.variance)
        factors = 1.0 / np.where(std == 0.0, 1.0, std)

        if normalization_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
            return NormalizationContext(factors=factors)

        if normalization_type == NormalizationType.STANDARDIZATION:
            if summary.intercept_index is None:
                raise ValueError("STANDARDIZATION requires an intercept")
            shifts = np.array(summary.mean, copy=True)
            shifts[summary.intercept_index] = 0.0
            factors = np.array(factors, copy=True)
            factors[summary.intercept_index] = 1.0
            return NormalizationContext(
                factors=factors, shifts=shifts, intercept_index=summary.intercept_index
            )

        raise ValueError(f"NormalizationType {normalization_type} not recognized")



NO_NORMALIZATION = NormalizationContext()
