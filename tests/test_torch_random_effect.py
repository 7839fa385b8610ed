"""The port's random-effect dataset build against the JAX package's.

Same CSR matrix, entity ids, labels and weights into both build functions: bucket
shapes, entity rows, sample ids, the scoring view and every value array are
equal exactly (the build is the same host numpy code path in both). The
merge fraction is pinned per case, since its default depends on the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from photon_ml_tpu.data.random_effect import build_random_effect_dataset as jbuild
from photon_ml_tpu_torch.data import random_effect as tre


def _inputs(rng, n=900, d=12, n_ent=60):
    dense = rng.normal(size=(n, d)) * (rng.uniform(size=(n, d)) < 0.3)
    dense[:, 0] = 1.0
    X = sp.csr_matrix(dense)
    # skewed entity sizes so several pow2 sample classes appear
    ent = rng.zipf(1.6, size=n) % n_ent
    labels = (rng.uniform(size=n) > 0.5).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=n)
    return X, ent, labels, weights


@pytest.mark.parametrize("merge", [0.0, 0.05])
def test_build_matches_jax_exactly(merge, rng):
    X, ent, labels, weights = _inputs(rng)
    j = jbuild(X, ent, "userId", labels=labels, weights=weights, intercept_index=0,
               dtype=jnp.float64, bucket_merge_fraction=merge)
    t = tre.build_random_effect_dataset(X, ent, "userId", labels=labels, weights=weights,
                                        intercept_index=0, dtype=torch.float64,
                                        bucket_merge_fraction=merge, device="cpu")
    assert t.entity_ids == j.entity_ids
    assert t.n_entities == j.n_entities and t.max_k == j.max_k
    assert t.n_samples == j.n_samples and t.n_active_samples == j.n_active_samples
    assert len(t.buckets) == len(j.buckets) > 1
    for tb, jb in zip(t.buckets, j.buckets):
        assert tb.shape == jb.shape
        for name in ("entity_rows", "X", "labels", "weights", "sample_ids"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)))
    for name in ("proj_indices", "sample_entity_rows", "sample_local_cols", "sample_vals"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))


def test_scoring_only_view_matches_jax_exactly(rng):
    """The validation view: no buckets, no labels needed, the projection
    table as wide as the widest unmerged padded bucket, every array equal."""
    X, ent, _, weights = _inputs(rng)
    j = jbuild(X, ent, "userId", weights=weights, dtype=jnp.float64, scoring_only=True)
    t = tre.build_random_effect_dataset(X, ent, "userId", weights=weights, dtype=torch.float64,
                                        scoring_only=True, bucket_merge_fraction=0.05,
                                        device="cpu")
    assert t.entity_ids == j.entity_ids and t.max_k == j.max_k
    assert t.buckets == [] and j.buckets == []
    for name in ("proj_indices", "sample_entity_rows", "sample_local_cols", "sample_vals"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    with pytest.raises(ValueError, match="scoring_only"):
        tre.build_random_effect_dataset(X, ent, "userId", device="cpu")


def test_merge_fraction_follows_the_port_device(monkeypatch):
    monkeypatch.delenv("PHOTON_BUCKET_MERGE", raising=False)
    assert tre._resolve_merge_fraction(None, torch.device("cpu")) == 0.0
    assert tre._resolve_merge_fraction(None, torch.device("cuda")) == 0.05
    assert tre._resolve_merge_fraction(0.3, torch.device("cpu")) == 0.3
    monkeypatch.setenv("PHOTON_BUCKET_MERGE", "1.0")
    assert tre._resolve_merge_fraction(None, torch.device("cpu")) == 1.0
    monkeypatch.setenv("PHOTON_BUCKET_MERGE", "x")
    with pytest.raises(ValueError):
        tre._resolve_merge_fraction(None, torch.device("cpu"))


def test_unported_options_raise(rng):
    X, ent, labels, _ = _inputs(rng, n=50)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tre.build_random_effect_dataset(X, ent, "u", labels=labels, active_data_upper_bound=4,
                                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tre.build_random_effect_dataset(X, ent, "u", labels=labels, features_max=2,
                                        device="cpu")


def _standardization(X, pkg):
    from photon_ml_tpu.normalization import FeatureDataStatistics as JStats
    from photon_ml_tpu.normalization import NormalizationContext as JNorm
    from photon_ml_tpu_torch.normalization import FeatureDataStatistics, NormalizationContext

    if pkg == "jax":
        return JNorm.build("STANDARDIZATION", JStats.compute(X, intercept_index=0))
    return NormalizationContext.build("STANDARDIZATION",
                                      FeatureDataStatistics.compute(X, intercept_index=0))


def test_normalized_build_matches_jax_exactly(rng):
    """Standardized training blocks, x' = (x - shift) * factor over every
    valid (sample, observed column) cell: equal to JAX's exactly; the
    scoring view keeps raw values."""
    X, ent, labels, weights = _inputs(rng)
    j = jbuild(X, ent, "userId", labels=labels, weights=weights, intercept_index=0,
               normalization=_standardization(X, "jax"), dtype=jnp.float64,
               bucket_merge_fraction=0.0)
    t = tre.build_random_effect_dataset(X, ent, "userId", labels=labels, weights=weights,
                                        intercept_index=0,
                                        normalization=_standardization(X, "port"),
                                        dtype=torch.float64, bucket_merge_fraction=0.0,
                                        device="cpu")
    for tb, jb in zip(t.buckets, j.buckets, strict=True):
        np.testing.assert_array_equal(tb.X.numpy(), np.asarray(jb.X))
    np.testing.assert_array_equal(t.sample_vals.numpy(), np.asarray(j.sample_vals))
    assert not np.array_equal(t.buckets[0].X.numpy(), tre.build_random_effect_dataset(
        X, ent, "userId", labels=labels, weights=weights, dtype=torch.float64,
        bucket_merge_fraction=0.0, device="cpu").buckets[0].X.numpy())


@pytest.mark.parametrize("opt", ["LBFGS", "OWLQN"])
def test_normalized_random_effect_matches_jax(opt, rng):
    """Per-entity normalization gathered through the projection table: the
    per-bucket path against JAX's (warm start in the original space,
    solution converted back), and the update program equal to the
    per-bucket path bitwise."""
    from photon_ml_tpu.algorithm.random_effect import train_random_effect as jtrain
    from photon_ml_tpu.optimization.common import OptimizerConfig as JOpt
    from photon_ml_tpu.optimization.config import GLMOptimizationConfiguration as JCfg
    from photon_ml_tpu.optimization.config import RegularizationContext as JReg
    from photon_ml_tpu.types import TaskType as JTask
    from photon_ml_tpu_torch.algorithm.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.algorithm.random_effect import train_random_effect
    from photon_ml_tpu_torch.optimization.common import OptimizerConfig
    from photon_ml_tpu_torch.optimization.config import (
        GLMOptimizationConfiguration,
        RegularizationContext,
    )

    X, ent, labels, weights = _inputs(rng)
    n = X.shape[0]
    reg = "ELASTIC_NET" if opt == "OWLQN" else "L2"
    alpha = 0.5 if opt == "OWLQN" else None
    tnorm, jnorm = _standardization(X, "port"), _standardization(X, "jax")
    jds = jbuild(X, ent, "userId", labels=labels, weights=weights, intercept_index=0,
                 normalization=jnorm, dtype=jnp.float64)
    tds = tre.build_random_effect_dataset(X, ent, "userId", labels=labels, weights=weights,
                                          intercept_index=0, normalization=tnorm,
                                          dtype=torch.float64, device="cpu")
    off = 0.1 * rng.normal(size=n)
    jm, jt = jtrain(jds, JTask.LOGISTIC_REGRESSION,
                    JCfg(JOpt(optimizer_type=opt), JReg(reg, alpha), 2.0), jnp.asarray(off),
                    normalization=jnorm)
    cfg = GLMOptimizationConfiguration(OptimizerConfig(optimizer_type=opt),
                                       RegularizationContext(reg, alpha), 2.0)
    tm, tt = train_random_effect(tds, "LOGISTIC_REGRESSION", cfg, torch.as_tensor(off),
                                 normalization=tnorm)
    np.testing.assert_allclose(tm.coeffs.numpy(), np.asarray(jm.coeffs), rtol=1e-6, atol=1e-9)
    assert tt.convergence_reason_counts == jt.convergence_reason_counts
    assert (tt.iterations_mean, tt.iterations_max) == (jt.iterations_mean, jt.iterations_max)
    coord = RandomEffectCoordinate(coordinate_id="u", dataset=tds, task="LOGISTIC_REGRESSION",
                                   configuration=cfg, base_offsets=torch.as_tensor(off),
                                   normalization=tnorm)
    zeros = torch.zeros(n, dtype=torch.float64)
    model, score, _ = coord.update_and_score(None, zeros, zeros)
    assert torch.equal(model.coeffs, tm.coeffs)
    assert torch.equal(score, coord.score(tm))
