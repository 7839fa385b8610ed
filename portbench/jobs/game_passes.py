"""GLMix training jobs: from cold parameters, ``passes`` coordinate-descent
passes of the program's ``parallel.game.make_game_step`` over a fixed
effect and per-user and per-item random effects.

Set-up makes the ratings on the device from the seed, copies to the host
what the program's own dataset build takes (entity ids, labels, the
random-effect features as CSR), builds both random-effect datasets with
``data.random_effect.build_random_effect_dataset`` (two threads, one per
coordinate) and places everything with ``build_sharded_game_data``: the
bucket layout the passes run on is the program's.

Every job does the same work, so a window of whole jobs measures a rate.
Each job's answer is its coefficients and its last pass's total scores; the
reference (reference/glmix.py) judges them once the window has closed.
"""

from __future__ import annotations

import importlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from portbench import costs, program
from portbench.reference import glmix as reference

RE_TYPES = ("userId", "itemId")
KERNELS = {"LBFGS": ("fused_glm",), "NEWTON": ("fused_glm", "fused_hess")}


class Job:
    metric = "glmix_samples_per_s"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, scale: float = 1.0):
        from photon_ml_tpu_torch.data.random_effect import build_random_effect_dataset
        from photon_ml_tpu_torch.parallel.game import build_sharded_game_data, make_game_step
        from photon_ml_tpu_torch.types import TaskType

        self.dev = torch.device(device)
        gen = importlib.import_module(f"portbench.gen.{cfg['generator']}")
        self.cfg = cfg if scale == 1.0 else gen.scaled(cfg, scale)
        self.traffic = traffic
        self.passes = int(traffic["passes"])
        self.stages = {}

        t = time.perf_counter()
        self.inputs = gen.make_ratings(self.cfg, seed, self.dev)
        self._sync()
        self.stages["data"] = time.perf_counter() - t

        t = time.perf_counter()
        n, k = self.inputs["re_X"].shape
        vals = self.inputs["re_X"].cpu().numpy().reshape(-1)
        csr = sp.csr_matrix((vals, np.tile(np.arange(k, dtype=np.int32), n),
                             np.arange(0, n * k + 1, k, dtype=np.int64)), shape=(n, k))
        ids = [self.inputs["users"].cpu().numpy(), self.inputs["items"].cpu().numpy()]
        labels = self.inputs["labels"].cpu().numpy().astype(np.float64)
        self.stages["host_copy"] = time.perf_counter() - t

        t = time.perf_counter()

        def build(i):
            return build_random_effect_dataset(csr, ids[i], RE_TYPES[i], labels=labels,
                                               intercept_index=0, dtype=torch.float32,
                                               device=self.dev)

        with ThreadPoolExecutor(len(RE_TYPES)) as pool:
            datasets = list(pool.map(build, range(len(RE_TYPES))))
        self._sync()
        self.stages["dataset_build"] = time.perf_counter() - t

        t = time.perf_counter()
        self.data = build_sharded_game_data(self.inputs["fe_X"], self.inputs["labels"], datasets,
                                            dtype=torch.float32, device=self.dev)
        # how the program's tables map onto entity ids and feature columns
        self.layout = [(torch.as_tensor(np.asarray(ds.entity_ids, dtype=np.int64), device=self.dev),
                        ds.proj_indices.to(self.dev).long()) for ds in datasets]
        # each bucket's real rows and features per entity, for the operation count
        self.re_nnz, self.re_sums = [], []
        for rc, (_, proj) in zip(self.data.re, self.layout):
            self.re_nnz.append(int((rc.sample_local_cols >= 0).sum()))
            k_of = torch.cat([(proj >= 0).sum(1), proj.new_zeros(1)])  # the junk row: none
            self.re_sums.append([costs.entity_sums((b.sample_ids >= 0).sum(1).tolist(),
                                                   k_of[b.entity_rows.long()].tolist())
                                 for b in rc.buckets])
        del datasets, csr, ids, labels
        self._sync()
        self.stages["placement"] = time.perf_counter() - t

        opt = traffic["fe_optimizer"]
        self.stages["kernel_load"] = (program.load_kernels(KERNELS[opt])
                                      if self.dev.type == "cuda" else 0.0)
        l2 = self.cfg["l2_weight"]
        fe_cfg = program.coordinate_config(opt, traffic["fe_max_iterations"], traffic["tolerance"], l2)
        re_cfg = program.coordinate_config(traffic["re_optimizer"], traffic["re_max_iterations"],
                                           traffic["tolerance"], l2)
        self.step = make_game_step(self.data, TaskType(self.cfg["task"]), fe_cfg,
                                   [re_cfg] * len(RE_TYPES), fuse_fe=True, device=self.dev)
        self.n, self.d = self.data.fe_X.n_rows, self.data.fe_X.n_cols

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def unit(self) -> dict:
        """One job: cold parameters, then the passes. Returns its answer."""
        from photon_ml_tpu_torch.parallel.game import init_game_params

        params = init_game_params(self.data, device=self.dev)
        diags = []
        for _ in range(self.passes):
            params, diag = self.step(params)
            diags.append((diag["fe_iterations"], diag["re_iterations_max"]))
        self._sync()
        return {"fixed": params["fixed"], "re": params["re"], "total_scores": diag["total_scores"],
                "diags": diags}

    def end_to_end(self, units: int, wall_s: float) -> dict:
        return {self.metric: units * self.n * self.passes / wall_s}

    def layer_context(self, outputs: list, counts: dict, wall_s: float) -> dict:
        """What the per-layer readers of a window read: counts per pass and
        the operations of the window."""
        passes = len(outputs) * self.passes
        fe_iters, re_iters, flops = 0, 0, 0.0
        newton = self.traffic["re_optimizer"] == "NEWTON"
        for out in outputs:
            for fe_it, re_max in out["diags"]:
                it = [[int(x) for x in coord] for coord in re_max]
                fe_iters += int(fe_it)
                re_iters += sum(sum(c) for c in it)
                flops += costs.glmix_pass_flops(self.n, self.d, self.re_nnz, self.re_sums, it,
                                                newton)
        evaluations = max(counts["b1_launches"], fe_iters)
        flops += evaluations * costs.glm_evaluation_flops(self.n, self.d)
        flops += counts["b3_launches"] * costs.hessian_flops(self.n, self.d)
        return {"config": "glmix", "passes": passes, "wall_s": wall_s, "counts": counts,
                "fe_iterations": fe_iters, "re_iterations": re_iters, "flops": flops,
                "b1_cost": costs.b1_cost(self.n, self.d), "b3_cost": costs.b3_cost(self.n, self.d)}

    def free_program(self):
        """Drop the program's state before the reference runs."""
        del self.step, self.data

    def answers(self, outputs: list) -> list:
        """Each answer as the reference reads it: tables indexed by entity id
        and feature column, with the junk row's largest magnitude."""
        n_ent = (int(self.cfg["num_users"]), int(self.cfg["num_items"]))
        k = self.inputs["re_X"].shape[1]
        out = []
        for o in outputs:
            tables, junk = [], 0.0
            for table, (ids, proj), e in zip(o["re"], self.layout, n_ent):
                t, j = entity_layout(table, ids, proj, e, k)
                tables.append(t)
                junk = max(junk, j)
            out.append({"fixed": o["fixed"], "re": tuple(tables), "junk": junk,
                        "total_scores": o["total_scores"]})
        return out

    def reference(self, prec: str = "f64", weights=None) -> dict:
        """The plain reference's job on this job's inputs, in ``prec``;
        ``weights`` replaces the rows' unit weights."""
        return reference.run(self.inputs, self.cfg, self.traffic, prec, weights=weights)

    @staticmethod
    def answer_of(ref_out: dict) -> dict:
        """A reference's output as an answer of the program (the control)."""
        return {"fixed": ref_out["fixed"], "re": ref_out["re"],
                "total_scores": ref_out["total_scores"]}

    def judge(self, answer: dict, ref: dict) -> dict:
        """The numbers compared for one answer against the reference."""
        return gaps(answer, ref, self.inputs)

    def readings(self, outputs: list) -> list:
        """The numbers compared, for each answer, against the reference."""
        ref = self.reference()
        return [self.judge(a, ref) for a in self.answers(outputs)]


def entity_layout(table, ids, proj, n_ent: int, k: int):
    """([n_ent, k] float64 coefficients by entity id and global column, the
    largest magnitude past the table's entity rows) of a program table
    [E + 1, K_pad] whose row r is entity ``ids[r]`` and whose column j is
    global column ``proj[r, j]`` (-1: none)."""
    e = ids.shape[0]
    out = torch.zeros((n_ent, k), dtype=torch.float64, device=table.device)
    valid = proj >= 0
    rows = ids.unsqueeze(1).expand_as(proj)
    out[rows[valid], proj[valid]] = table[:e][valid].double()
    junk = float(table[e:].abs().max()) if table.shape[0] > e else 0.0
    return out, junk


def gaps(answer: dict, ref: dict, inputs: dict) -> dict:
    """The widest gap of each part of an answer from the reference, against
    the reference's largest magnitude of that part:

    - ``fe_coef_gap``: the fixed-effect coefficients;
    - ``user_table_gap``, ``item_table_gap``: every entity's coefficients
      (a nonzero junk row counts as a gap);
    - ``score_gap``: the total scores the answer reports, against the scores
      that its own coefficients give, computed by the reference in float64.
    """
    def rel(got, want):
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    s = reference.scores_of(inputs, answer["fixed"], answer["re"], "f64")
    scale = [float(t.double().abs().max()) for t in ref["re"]]
    tables = [rel(t, r) + answer.get("junk", 0.0) / sc
              for t, r, sc in zip(answer["re"], ref["re"], scale)]
    return {"fe_coef_gap": rel(answer["fixed"], ref["fixed"]), "user_table_gap": tables[0],
            "item_table_gap": tables[1], "score_gap": rel(answer["total_scores"], s)}
