"""Generational, integrity-checked checkpoint/resume for coordinate descent.

Port of photon_ml_tpu/io/checkpoint.py; the files are the same, so each
package reads the other's generations.

- After every completed coordinate-descent iteration the full GAME model state
  (current models, best-model snapshot, best metric, incident history) is
  written as a NEW generation ``<dir>/gen-<n>/``: one ``.npz`` per coordinate
  (raw arrays, no pickling) plus a ``state.json`` manifest carrying a SHA-256
  checksum of every artifact, with the manifest's own checksum in a sidecar.
  Writes land in a ``gen-<n>.tmp`` staging dir renamed into place, so a crash
  at any instruction never damages an existing generation.
- ``load_checkpoint`` verifies every checksum and ROLLS BACK: a torn or
  bit-rotted generation is quarantined (renamed ``gen-<n>.corrupt``) with a
  logged incident, and restore proceeds from the newest generation that
  verifies. The last ``keep_generations`` generations are retained for this.
- Transient I/O errors (OSError) retry with exponential backoff + jitter
  (resilience/retry.py); the write path carries the fault points
  ``checkpoint.write.arrays`` / ``.manifest`` / ``.commit`` and
  ``checkpoint.restore`` under the JAX package's names.

Training scores are pure functions of the models, so nothing else is saved:
resume rebuilds them from the checkpointed models, and a resumed run is
bit-identical to an uninterrupted one. Restored tables are placed on
``device`` (CUDA by default).

bfloat16 tables are stored as their uint16 bit patterns next to a
``__dtype__<name>`` marker (the JAX package's encoding); the port decodes them
with ``torch`` alone.

Legacy layout (``state.json`` directly in the checkpoint directory, a
``.old`` sibling from the old overwrite dance) is still read, with the same
never-raise contract.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.models.game import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.models.glm import Coefficients, model_class_for_task
from photon_ml_tpu_torch.resilience import (
    Incident,
    Retry,
    corrupt_file,
    faultpoint,
    register_fault_point,
)
from photon_ml_tpu_torch.types import TaskType

logger = logging.getLogger(__name__)

STATE_FILE = "state.json"
STATE_SHA_FILE = "state.json.sha256"
BEST_DIR = "best"
AUX_DIR = "aux"
GEN_PREFIX = "gen-"
QUARANTINE_SUFFIX = ".corrupt"
DEFAULT_KEEP_GENERATIONS = 3
_TMP_SUFFIX = ".tmp"
_GEN_RE = re.compile(r"^gen-(\d{8})$")
_FORMAT = 2

FP_WRITE_ARRAYS = register_fault_point("checkpoint.write.arrays")
FP_WRITE_MANIFEST = register_fault_point("checkpoint.write.manifest")
FP_WRITE_COMMIT = register_fault_point("checkpoint.write.commit")
FP_RESTORE = register_fault_point("checkpoint.restore")

# transient OSErrors get a bounded, jittered retry instead of killing the run
_DEFAULT_RETRY = Retry(max_attempts=3, base_delay=0.05, max_delay=1.0)


class CheckpointCorruption(Exception):
    """A generation failed integrity verification (load_checkpoint turns it
    into quarantine + rollback and never raises it)."""


# ---------------------------------------------------- reduced-dtype encoding
# numpy has no bfloat16: such tensors are written as their uint16 bit
# patterns next to a self-describing "__dtype__<name>" marker, the JAX
# package's on-disk encoding, and read back with torch's bit view.

_DTYPE_MARKER = "__dtype__"
_BITS_ENCODED_DTYPES = ("bfloat16",)


def _to_numpy(x) -> tuple[np.ndarray, Optional[str]]:
    """(host array, encoded dtype name or None) for a tensor or an array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.asarray(x), None


def _encode_arrays(arrays: dict) -> dict:
    out = {}
    for name, arr in arrays.items():
        host, encoded = _to_numpy(arr)
        out[name] = host
        if encoded is not None:
            out[_DTYPE_MARKER + name] = np.asarray(encoded)
    return out


def _decode_arrays(arrays: dict) -> dict:
    """Native arrays stay numpy; bit-encoded bfloat16 arrays come back as
    CPU bfloat16 tensors."""
    out = {k: v for k, v in arrays.items() if not k.startswith(_DTYPE_MARKER)}
    for key, marker in arrays.items():
        if not key.startswith(_DTYPE_MARKER):
            continue
        name, dt = key[len(_DTYPE_MARKER):], str(marker)
        if dt not in _BITS_ENCODED_DTYPES:
            raise ValueError(f"unknown encoded dtype {dt!r} for artifact array {name!r}")
        bits = np.ascontiguousarray(out[name]).view(np.int16)
        out[name] = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return out


def _load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return _decode_arrays({k: z[k] for k in z.files})


# ------------------------------------------------------------- model <-> arrays


def _model_to_arrays(model) -> tuple[dict, dict]:
    """(json-metadata, arrays) for one coordinate model."""
    if isinstance(model, FixedEffectModel):
        glm = model.model
        meta = {
            "kind": "fixed",
            "feature_shard_id": model.feature_shard_id,
            "task": TaskType(glm.task).value,
        }
        arrays = {"means": glm.coefficients.means}
        if glm.coefficients.variances is not None:
            arrays["variances"] = glm.coefficients.variances
        return meta, arrays

    if isinstance(model, RandomEffectModel):
        entity_ids = list(model.entity_ids)
        ids_are_int = all(isinstance(e, (int, np.integer)) for e in entity_ids)
        meta = {
            "kind": "random",
            "re_type": model.re_type,
            "feature_shard_id": model.feature_shard_id,
            "task": TaskType(model.task).value,
            "entity_ids_int": ids_are_int,
        }
        arrays = {
            "coeffs": model.coeffs,
            "proj_indices": model.proj_indices,
            "entity_ids": (
                np.asarray(entity_ids, dtype=np.int64)
                if ids_are_int
                else np.asarray([str(e) for e in entity_ids])
            ),
        }
        if model.variances is not None:
            arrays["variances"] = model.variances
        proj = model.projector
        if proj is not None:
            from photon_ml_tpu_torch.data.projector import RandomProjector

            if not isinstance(proj, RandomProjector):
                raise TypeError(f"Cannot checkpoint projector of type {type(proj).__name__}")
            arrays["projector_matrix"] = np.asarray(proj.matrix)
            meta["projector_intercept_index"] = proj.intercept_index
            norm = proj.normalization
            if norm is not None:
                meta["projector_norm_intercept_index"] = norm.intercept_index
                if norm.factors is not None:
                    arrays["projector_norm_factors"] = _to_numpy(norm.factors)[0]
                if norm.shifts is not None:
                    arrays["projector_norm_shifts"] = _to_numpy(norm.shifts)[0]
        return meta, arrays

    raise TypeError(f"Unknown model type: {type(model).__name__}")


def _tensor(a, dtype, device) -> torch.Tensor:
    """A stored array as a tensor on ``device``, cast to ``dtype`` (None
    keeps the stored dtype)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def _model_from_arrays(meta: dict, arrays, dtype, device) -> object:
    task = TaskType(meta["task"])
    variances = arrays.get("variances")
    if meta["kind"] == "fixed":
        coeffs = Coefficients(
            means=_tensor(arrays["means"], dtype, device),
            variances=None if variances is None else _tensor(variances, dtype, device),
        )
        return FixedEffectModel(
            model=model_class_for_task(task)(coeffs),
            feature_shard_id=meta["feature_shard_id"],
        )

    entity_ids = arrays["entity_ids"]
    ids = (
        tuple(int(e) for e in entity_ids)
        if meta["entity_ids_int"]
        else tuple(str(e) for e in entity_ids)
    )
    projector = None
    if "projector_matrix" in arrays:
        from photon_ml_tpu_torch.data.projector import RandomProjector
        from photon_ml_tpu_torch.normalization import NormalizationContext

        norm = None
        if "projector_norm_factors" in arrays or "projector_norm_shifts" in arrays:
            norm = NormalizationContext(
                factors=arrays.get("projector_norm_factors"),
                shifts=arrays.get("projector_norm_shifts"),
                intercept_index=meta.get("projector_norm_intercept_index"),
            )
        projector = RandomProjector(
            matrix=arrays["projector_matrix"],
            intercept_index=meta.get("projector_intercept_index"),
            normalization=norm,
        )
    return RandomEffectModel(
        re_type=meta["re_type"],
        feature_shard_id=meta["feature_shard_id"],
        task=task,
        entity_ids=ids,
        coeffs=_tensor(arrays["coeffs"], dtype, device),
        proj_indices=_tensor(arrays["proj_indices"], torch.int32, device),
        variances=None if variances is None else _tensor(variances, dtype, device),
        projector=projector,
    )


# ---------------------------------------------------------------- plumbing


def sha256_file(path: str) -> str:
    """Streaming SHA-256 of a file's bytes."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_array_file(directory: str, rel: str, arrays: dict, checksums: dict) -> None:
    """One .npz artifact; its SHA-256 goes into ``checksums`` before an armed
    corrupt action damages it (the bit-rot restore must catch)."""
    path = os.path.join(directory, rel)
    action = faultpoint(FP_WRITE_ARRAYS)
    np.savez(path, **_encode_arrays(arrays))
    checksums[rel] = sha256_file(path)
    if action == "corrupt":
        corrupt_file(path)


def _write_models(directory: str, subdir: str, models: dict, manifest: dict,
                  checksums: dict) -> None:
    """One .npz per coordinate into <directory>/<subdir>; fills per-model meta
    into ``manifest`` and each file's SHA-256 into ``checksums`` (keyed by
    generation-relative path)."""
    for cid, model in models.items():
        meta, arrays = _model_to_arrays(model)
        manifest[cid] = meta
        rel = os.path.join(subdir, f"{cid}.npz") if subdir else f"{cid}.npz"
        _write_array_file(directory, rel, arrays, checksums)


def _read_models(directory: str, manifest: dict, dtype, device) -> dict:
    return {
        cid: _model_from_arrays(meta, _load_npz(os.path.join(directory, f"{cid}.npz")),
                                dtype, device)
        for cid, meta in manifest.items()
    }


def _generations(root: str) -> list[tuple[int, str]]:
    """[(generation number, absolute path)] ascending; ignores staging,
    quarantined and legacy entries."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _GEN_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def _clean_stale_tmp(root: str) -> None:
    """Remove staging leftovers a crash mid-write leaked: ``gen-*.tmp`` dirs
    under the root and the legacy ``<root>.tmp`` sibling."""
    candidates = []
    if os.path.isdir(root):
        candidates += [os.path.join(root, n) for n in os.listdir(root) if n.endswith(_TMP_SUFFIX)]
    legacy = root.rstrip(os.sep) + _TMP_SUFFIX
    if os.path.exists(legacy):
        candidates.append(legacy)
    for path in candidates:
        logger.info("removing stale checkpoint staging dir %s", path)
        shutil.rmtree(path, ignore_errors=True)


def _quarantine(path: str) -> None:
    """Move a failed-verification generation aside (never silently reuse it,
    never destroy the evidence)."""
    target = path + QUARANTINE_SUFFIX
    try:
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(path, target)
        logger.warning("quarantined corrupt checkpoint generation: %s", target)
    except OSError:  # a failed quarantine must not block the rollback
        logger.warning("could not quarantine %s; ignoring it", path, exc_info=True)


# -------------------------------------------------- read-side generation API


def list_generations(directory: str) -> list[tuple[int, str]]:
    """Committed generations under a checkpoint root as ``[(number, path)]``
    ascending. Staging (``*.tmp``), quarantined (``*.corrupt``) and legacy
    entries are ignored; a missing root is an empty list."""
    return _generations(os.path.abspath(directory))


def load_generation(gen_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """Verify and load ONE generation directory without touching the disk:
    {completed_iterations, models, best_models, best_metric, best_metrics,
    incidents, generation, fingerprint, extra, aux}. ``dtype=None`` keeps every
    stored dtype (a bf16 table loads back as bf16, bit-exact). Raises
    :class:`CheckpointCorruption` on any defect."""
    return _verify_and_load_generation(os.path.abspath(gen_dir), dtype, resolve_device(device))


# ------------------------------------------------------------------ save / load


def save_checkpoint(
    directory: str,
    models: dict,
    completed_iterations: int,
    best_models: Optional[dict] = None,
    best_metric: Optional[float] = None,
    best_metrics: Optional[dict] = None,
    fingerprint: Optional[str] = None,
    incidents: Optional[list] = None,
    keep_generations: int = DEFAULT_KEEP_GENERATIONS,
    retry: Optional[Retry] = None,
    extra_state: Optional[dict] = None,
    aux_arrays: Optional[dict] = None,
) -> str:
    """Write a NEW checkpoint generation (staging dir + rename); returns its
    path. Keeps the newest ``keep_generations`` generations, pruning older
    ones (quarantined generations are left for inspection).

    ``fingerprint`` identifies the run configuration: ``load_checkpoint`` with
    a different fingerprint refuses the checkpoint. ``incidents`` (Incident
    or dicts) persist in the manifest. ``extra_state`` (a JSON-serializable
    dict) rides inside the manifest; ``aux_arrays`` ({name: {array: array or
    tensor}}) are written as ``aux/<name>.npz`` under the same checksums.
    Transient OSErrors retry with backoff; each attempt restages from
    scratch."""
    if keep_generations < 1:
        raise ValueError(f"keep_generations must be >= 1, got {keep_generations}")
    root = os.path.abspath(directory)
    incident_dicts = [
        i.to_dict() if isinstance(i, Incident) else dict(i) for i in (incidents or [])
    ]

    def _attempt() -> str:
        os.makedirs(root, exist_ok=True)
        _clean_stale_tmp(root)
        gens = _generations(root)
        gen_num = (gens[-1][0] + 1) if gens else 1
        final = os.path.join(root, f"{GEN_PREFIX}{gen_num:08d}")
        tmp = final + _TMP_SUFFIX
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        state = {
            "format": _FORMAT,
            "generation": gen_num,
            "completed_iterations": int(completed_iterations),
            "fingerprint": fingerprint,
            "best_metric": None if best_metric is None else float(best_metric),
            "best_metrics": (
                None if best_metrics is None else {k: float(v) for k, v in best_metrics.items()}
            ),
            "models": {},
            "best_models": None,
            "incidents": incident_dicts,
            "checksums": {},
            "extra": extra_state,
            "aux": sorted(aux_arrays) if aux_arrays else [],
        }
        _write_models(tmp, "", models, state["models"], state["checksums"])
        if best_models is not None:
            os.makedirs(os.path.join(tmp, BEST_DIR))
            state["best_models"] = {}
            _write_models(tmp, BEST_DIR, best_models, state["best_models"], state["checksums"])
        if aux_arrays:
            os.makedirs(os.path.join(tmp, AUX_DIR))
            for name in sorted(aux_arrays):
                if "/" in name or os.sep in name or name.startswith("."):
                    raise ValueError(f"aux artifact name {name!r} must be a flat name")
                _write_array_file(tmp, os.path.join(AUX_DIR, f"{name}.npz"),
                                  aux_arrays[name], state["checksums"])

        action = faultpoint(FP_WRITE_MANIFEST)
        state_path = os.path.join(tmp, STATE_FILE)
        with open(state_path, "w") as f:
            json.dump(state, f)
        # the manifest's own integrity record: bit-rot inside syntactically
        # valid JSON is still detected at restore
        with open(os.path.join(tmp, STATE_SHA_FILE), "w") as f:
            f.write(sha256_file(state_path) + "\n")
        if action == "corrupt":
            corrupt_file(state_path)

        faultpoint(FP_WRITE_COMMIT)
        os.rename(tmp, final)
        for _, old_path in _generations(root)[:-keep_generations]:
            shutil.rmtree(old_path, ignore_errors=True)
        return final

    return (retry or _DEFAULT_RETRY).call(_attempt, description="checkpoint save")


def _verify_and_load_generation(gen_dir: str, dtype, device) -> dict:
    """Full integrity pass over one generation; raises CheckpointCorruption on
    ANY defect (missing file, checksum mismatch, unreadable manifest/arrays)."""
    state_path = os.path.join(gen_dir, STATE_FILE)
    try:
        with open(os.path.join(gen_dir, STATE_SHA_FILE)) as f:
            expected = f.read().strip()
    except OSError as e:
        raise CheckpointCorruption(f"missing manifest checksum: {e}") from e
    try:
        actual = sha256_file(state_path)
    except OSError as e:
        raise CheckpointCorruption(f"unreadable manifest: {e}") from e
    if actual != expected:
        raise CheckpointCorruption(
            f"manifest checksum mismatch in {gen_dir} "
            f"(expected {expected[:12]}…, got {actual[:12]}…)"
        )
    try:
        with open(state_path) as f:
            state = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruption(f"unparseable manifest: {e}") from e

    for rel, expected in state.get("checksums", {}).items():
        try:
            actual = sha256_file(os.path.join(gen_dir, rel))
        except OSError as e:
            raise CheckpointCorruption(f"missing artifact {rel}: {e}") from e
        if actual != expected:
            raise CheckpointCorruption(f"artifact checksum mismatch: {rel} in {gen_dir}")

    try:
        models = _read_models(gen_dir, state["models"], dtype, device)
        best_models = None
        if state.get("best_models") is not None:
            best_models = _read_models(
                os.path.join(gen_dir, BEST_DIR), state["best_models"], dtype, device
            )
        aux = {
            name: _load_npz(os.path.join(gen_dir, AUX_DIR, f"{name}.npz"))
            for name in state.get("aux") or []
        }
    except Exception as e:  # torn .npz, bad metadata, dtype surprises ...
        raise CheckpointCorruption(f"unreadable model arrays: {e}") from e

    return {
        "completed_iterations": state["completed_iterations"],
        "best_metric": state["best_metric"],
        "best_metrics": state.get("best_metrics"),
        "models": models,
        "best_models": best_models,
        "incidents": list(state.get("incidents") or []),
        "generation": state.get("generation"),
        "fingerprint": state.get("fingerprint"),
        "extra": state.get("extra"),
        "aux": aux,
    }


def _load_legacy(directory: str, dtype, device) -> Optional[dict]:
    """Pre-generational layout: state.json directly in ``directory``. No
    checksums existed; a read failure quarantines the manifest so the next
    restore doesn't retry it (fresh-start fallback, never a raise)."""
    state_path = os.path.join(directory, STATE_FILE)
    if not os.path.exists(state_path):
        return None
    try:
        with open(state_path) as f:
            state = json.load(f)
        models = _read_models(directory, state["models"], dtype, device)
        best_models = None
        if state.get("best_models") is not None:
            best_models = _read_models(
                os.path.join(directory, BEST_DIR), state["best_models"], dtype, device
            )
    except Exception as e:
        logger.warning("legacy checkpoint %s is unreadable (%s); quarantining it", directory, e)
        try:
            os.rename(state_path, state_path + QUARANTINE_SUFFIX)
        except OSError:
            pass
        return None
    return {
        "completed_iterations": state["completed_iterations"],
        "best_metric": state["best_metric"],
        "best_metrics": state.get("best_metrics"),
        "models": models,
        "best_models": best_models,
        "incidents": list(state.get("incidents") or []),
        "generation": None,
        "fingerprint": state.get("fingerprint"),
    }


def _load_from_root(directory: str, dtype, device, sink: list) -> Optional[dict]:
    """Newest-valid-generation scan over one checkpoint root: verify newest
    first; quarantine + roll back on corruption; legacy layout last. Each
    rollback is recorded as a checkpoint-corruption incident in ``sink``, and
    the whole sink merges into the returned state's history."""
    for gen_num, gen_dir in reversed(_generations(directory)):
        try:
            restored = _verify_and_load_generation(gen_dir, dtype, device)
        except CheckpointCorruption as e:
            logger.warning(
                "checkpoint generation %d failed verification (%s); "
                "rolling back to the previous generation", gen_num, e,
            )
            _quarantine(gen_dir)
            sink.append(
                Incident(
                    kind="checkpoint-corruption",
                    cause=str(e),
                    action=f"quarantined generation {gen_num}; rolled back",
                ).to_dict()
            )
            continue
        restored["incidents"] = restored["incidents"] + list(sink)
        return restored
    legacy = _load_legacy(directory, dtype, device)
    if legacy is not None:
        legacy["incidents"] = legacy["incidents"] + list(sink)
    return legacy


def load_checkpoint(
    directory: str,
    dtype=torch.float32,
    fingerprint: Optional[str] = None,
    incident_sink: Optional[list] = None,
    device="cuda",
) -> Optional[dict]:
    """Restore {completed_iterations, models, best_models, best_metric,
    best_metrics, incidents, generation, ...} from the newest generation that
    passes integrity verification, with every table on ``device``, or None
    when no valid checkpoint exists.

    Never raises on damage: a torn or bit-rotted generation is quarantined
    and restore rolls back (the rollback appears in ``incidents``). Stale
    staging dirs are removed; a ``.old`` sibling is scanned as a fallback
    root. A saved ``fingerprint`` differing from the requested one rejects
    the checkpoint (a different RUN, not corruption: no rollback past it).
    ``incident_sink`` collects rollback incidents even when the restore ends
    in a fresh start."""
    dev = resolve_device(device)
    faultpoint(FP_RESTORE)
    directory = os.path.abspath(directory)
    _clean_stale_tmp(directory)
    sink = incident_sink if incident_sink is not None else []
    restored = _load_from_root(directory, dtype, dev, sink)
    if restored is None:
        old = directory + ".old"
        if os.path.isdir(old):
            restored = _load_from_root(old, dtype, dev, sink)
    if restored is None:
        return None
    if fingerprint is not None and restored.get("fingerprint") not in (None, fingerprint):
        return None
    restored.pop("fingerprint", None)
    return restored


class CoordinateDescentCheckpointer:
    """Save/restore hook handed to ``run_coordinate_descent``.

    ``interval`` saves every k-th completed iteration; the descent loop passes
    ``force=True`` on the final iteration. ``fingerprint`` ties the checkpoint
    to a run configuration: restore returns None when it differs.
    ``keep_generations`` bounds the rollback window. ``dtype`` and ``device``
    are where restored tables go (CUDA unless the caller names the CPU).

    ``restore()`` never raises: any unexpected failure logs and falls back to
    a fresh start.

    ``save_seconds`` and ``restore_seconds`` list the wall time of each save
    and restore.

    ``extra_state_provider`` (optional zero-argument callable returning a
    JSON-serializable dict or None) is polled at every save and rides the
    manifest's ``extra`` key: run state next to the fingerprint that a
    resume needs to replay bitwise, such as the measured
    ``re_solver="auto"`` decisions.
    """

    def __init__(
        self,
        directory: str,
        interval: int = 1,
        dtype=torch.float32,
        fingerprint: Optional[str] = None,
        keep_generations: int = DEFAULT_KEEP_GENERATIONS,
        device="cuda",
        extra_state_provider=None,
    ):
        if interval < 1:
            raise ValueError(f"checkpoint interval must be >= 1, got {interval}")
        self.directory = directory
        self.interval = int(interval)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.fingerprint = fingerprint
        self.keep_generations = int(keep_generations)
        self.extra_state_provider = extra_state_provider
        self.restore_incidents: list = []
        self.save_seconds: list = []
        self.restore_seconds: list = []

    def maybe_save(
        self,
        completed_iterations: int,
        models: dict,
        best_models: Optional[dict],
        best_metric: Optional[float],
        best_metrics: Optional[dict] = None,
        force: bool = False,
        incidents: Optional[list] = None,
    ) -> bool:
        if not force and completed_iterations % self.interval != 0:
            return False
        t0 = time.perf_counter()
        save_checkpoint(
            self.directory,
            models,
            completed_iterations,
            best_models,
            best_metric,
            best_metrics,
            fingerprint=self.fingerprint,
            incidents=incidents,
            keep_generations=self.keep_generations,
            extra_state=None if self.extra_state_provider is None else self.extra_state_provider(),
        )
        self.save_seconds.append(time.perf_counter() - t0)
        return True

    def restore(self) -> Optional[dict]:
        """``self.restore_incidents`` afterwards holds any rollback incidents
        this restore produced, even when the result is None (all generations
        corrupt -> fresh start)."""
        self.restore_incidents = []
        t0 = time.perf_counter()
        try:
            return load_checkpoint(
                self.directory,
                dtype=self.dtype,
                fingerprint=self.fingerprint,
                incident_sink=self.restore_incidents,
                device=self.device,
            )
        except Exception:
            # the never-raise contract: unexpected damage degrades to a fresh
            # start. InjectedCrash (BaseException) still propagates.
            logger.exception("checkpoint restore from %s failed; starting fresh", self.directory)
            return None
        finally:
            self.restore_seconds.append(time.perf_counter() - t0)

    def clear(self) -> None:
        # also drop the .old/.tmp siblings: load_checkpoint falls back to .old,
        # so leaving it would resurrect the state the caller tried to discard
        for path in (self.directory, self.directory + ".old", self.directory + _TMP_SUFFIX):
            if os.path.exists(path):
                shutil.rmtree(path)
