"""A run with the timed path broken underneath comes out not correct, one
fault at a time; the control (the reference in TF32 in the program's place)
fails the limits that the program's own answers meet. On the CPU, at a size
a test run holds."""

import dataclasses

import pytest
import torch

from portbench import control
from portbench.harness import Bench, run_cell

GLMIX, GLM = ("glmix-ml20m.lbfgs", 0.002), ("glm-epsilon.tron", 0.005)


def _run(cell):
    name, scale = cell
    result, _ = run_cell(Bench(), name, 2**31 + 41, 0.0, False, device="cpu", scale=scale,
                         log=lambda m: None)
    return result


def _half(weights):
    g = torch.Generator().manual_seed(5)
    return weights * (torch.rand(weights.shape, generator=g) < 0.5).to(weights.dtype) * 2.0


def _glmix_fault(monkeypatch, kind):
    from photon_ml_tpu_torch.parallel import game

    real = game.game_train_step

    def broken(data, params, *args, **kwargs):
        if kind == "half_batch":
            w = _half(data.weights)
            re = tuple(dataclasses.replace(rc, buckets=tuple(
                dataclasses.replace(b, weights=b.weights * w[b.sample_ids.clamp(min=0).long()])
                for b in rc.buckets)) for rc in data.re)
            data = dataclasses.replace(data, weights=w, re=re)
        new, diag = real(data, params, *args, **kwargs)
        if kind == "unchanged":
            return params, diag
        if kind == "altered":
            fixed = new["fixed"].clone()
            fixed[0] += 0.1
            new = {**new, "fixed": fixed}
        return new, diag

    monkeypatch.setattr(game, "game_train_step", broken)


def _glm_fault(monkeypatch, kind):
    from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
    from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem

    real = GLMOptimizationProblem.run

    def broken(self, data, *args, **kwargs):
        if kind == "half_batch":
            data = dataclasses.replace(data, weights=_half(data.weights))
        model, res = real(self, data, *args, **kwargs)
        coef = model.coefficients.means
        if kind == "unchanged":
            coef = torch.zeros_like(coef)
        elif kind == "altered":
            coef = coef.clone()
            coef[0] += 0.1
        return GeneralizedLinearModel(Coefficients(coef, None), model.task), res

    monkeypatch.setattr(GLMOptimizationProblem, "run", broken)


@pytest.mark.parametrize("cell,plant", [(GLMIX, _glmix_fault), (GLM, _glm_fault)],
                         ids=["glmix", "glm"])
def test_a_sound_run_is_correct(cell, plant):
    result = _run(cell)
    assert result["correct"] and result["failed"] == 0, result["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell,plant", [(GLMIX, _glmix_fault), (GLM, _glm_fault)],
                         ids=["glmix", "glm"])
def test_a_broken_run_is_not_correct(monkeypatch, cell, plant, kind):
    plant(monkeypatch, kind)
    result = _run(cell)
    assert not result["correct"] and result["failed"] == result["attempted"], result["checks"]


@pytest.mark.parametrize("cell", [GLMIX, GLM], ids=["glmix", "glm"])
def test_the_control_fails_where_the_program_passes(cell):
    name, scale = cell
    bench = Bench()
    limits = bench.load("checks", name)
    r = control.readings(bench, name, 2**31 + 43, device="cpu", scale=scale,
                         kinds=("program", "control"))
    assert all(r["program"][k] <= lim for k, lim in limits.items()), r["program"]
    assert any(r["control"][k] > lim for k, lim in limits.items()), r["control"]
