"""Single GLM fits: cold ``optimization.problem.GLMOptimizationProblem.run``
solves, back to back, on one placed ``LabeledData``.

Set-up makes the table on the device from the seed and places it with
``LabeledData.build``. Each solve's answer is its coefficients and the
objective value and gradient it reports; the reference (reference/glm.py)
judges them once the window has closed.
"""

from __future__ import annotations

import importlib
import time

import torch

from portbench import costs, program
from portbench.reference import glm as reference

KERNELS = {"TRON": ("fused_glm",), "LBFGS": ("fused_glm",), "NEWTON": ("fused_glm", "fused_hess")}


class Job:
    metric = "glm_solve_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, scale: float = 1.0):
        from photon_ml_tpu_torch.data.dataset import LabeledData
        from photon_ml_tpu_torch.optimization.problem import GLMOptimizationProblem
        from photon_ml_tpu_torch.types import TaskType

        self.dev = torch.device(device)
        gen = importlib.import_module(f"portbench.gen.{cfg['generator']}")
        self.cfg = cfg if scale == 1.0 else gen.scaled(cfg, scale)
        self.traffic = traffic
        self.stages = {}

        t = time.perf_counter()
        self.inputs = gen.make_table(self.cfg, seed, self.dev)
        self._sync()
        self.stages["data"] = time.perf_counter() - t

        t = time.perf_counter()
        self.data = LabeledData.build(self.inputs["X"], self.inputs["labels"], dtype=torch.float32,
                                      device=self.dev)
        self._sync()
        self.stages["placement"] = time.perf_counter() - t
        opt = traffic["optimizer"]
        self.stages["kernel_load"] = (program.load_kernels(KERNELS[opt])
                                      if self.dev.type == "cuda" else 0.0)
        self.problem = GLMOptimizationProblem(
            task=TaskType(self.cfg["task"]),
            configuration=program.coordinate_config(opt, traffic["max_iterations"],
                                                    traffic["tolerance"], self.cfg["l2_weight"]))
        self.n, self.d = self.inputs["X"].shape

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def unit(self) -> dict:
        """One cold solve. Returns its answer."""
        model, res = self.problem.run(self.data)
        self._sync()
        return {"coef": model.coefficients.means, "value": res.value, "gradient": res.gradient,
                "iterations": res.iterations}

    def end_to_end(self, units: int, wall_s: float) -> dict:
        return {self.metric: wall_s / units}

    def layer_context(self, outputs: list, counts: dict, wall_s: float) -> dict:
        iters = sum(int(o["iterations"]) for o in outputs)
        evaluations = max(counts["b1_launches"], iters)
        flops = costs.tron_solve_flops(self.n, self.d, evaluations, counts["b2_launches"])
        return {"config": "glm", "solves": len(outputs), "wall_s": wall_s, "counts": counts,
                "flops": flops, "b1_cost": costs.b1_cost(self.n, self.d),
                "b2_cost": costs.b2_cost(self.n, self.d)}

    def free_program(self):
        del self.problem, self.data

    def answers(self, outputs: list) -> list:
        return [{"coef": o["coef"], "value": float(o["value"]), "gradient": o["gradient"]}
                for o in outputs]

    def reference(self, prec: str = "f64", weights=None) -> dict:
        """The plain reference's solve on this job's table, in ``prec``;
        ``weights`` replaces the rows' unit weights. It carries the norm of
        the float64 gradient at zero, which ``gradient_gap`` is taken
        against."""
        ref = reference.run(self.inputs, self.cfg, self.traffic, prec, weights=weights)
        zero = torch.zeros(self.d, device=self.dev)
        ref["g0_norm"] = float(torch.linalg.vector_norm(
            reference.objective(self.inputs, self.cfg, zero)[1]))
        return ref

    @staticmethod
    def answer_of(ref_out: dict) -> dict:
        """A reference's output as an answer of the program (the control)."""
        return {"coef": ref_out["coef"], "value": float(ref_out["value"]),
                "gradient": ref_out["gradient"]}

    def judge(self, answer: dict, ref: dict) -> dict:
        """The numbers compared for one answer against the reference."""
        return gaps(answer, ref, self.inputs, self.cfg)

    def readings(self, outputs: list) -> list:
        ref = self.reference()
        out, last = [], None
        for a in self.answers(outputs):  # solves repeat bitwise: judge each distinct answer once
            same = last is not None and a["value"] == last[0]["value"] and all(
                torch.equal(a[k], last[0][k]) for k in ("coef", "gradient"))
            if not same:
                last = (a, self.judge(a, ref))
            out.append(last[1])
        return out


def gaps(answer: dict, ref: dict, inputs: dict, cfg: dict) -> dict:
    """The numbers an answer is judged by:

    - ``coef_gap``: the widest gap of its coefficients from the reference's
      optimum, against the reference's largest coefficient;
    - ``value_gap``: the gap of the objective value it reports from the
      value at its coefficients computed in float64, against that value;
    - ``gradient_gap``: the norm of the gap between the gradient it reports
      and the float64 gradient at its coefficients, against the gradient's
      norm at zero, ``ref["g0_norm"]`` (a check of the precision of the sums
      the kernels make).
    """
    value, grad = reference.objective(inputs, cfg, answer["coef"], "f64")
    coef, want = answer["coef"].double(), ref["coef"].double()
    return {"coef_gap": float((coef - want).abs().max() / want.abs().max()),
            "value_gap": abs(answer["value"] - value) / abs(value),
            "gradient_gap": float(torch.linalg.vector_norm(answer["gradient"].double() - grad))
            / ref["g0_norm"]}
