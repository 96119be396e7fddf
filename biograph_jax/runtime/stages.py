"""Resumable stage runner — the control plane of the pipeline.

Replaces the reference's task framework + taskdb + worker fleet
(modules/mapred/task.h:45 resumable JSON task state, taskdb.h:18 HTTP task
database, main/manager.cpp worker supervision, main/resurrect.cpp job
resurrection) with the design this build actually needs:

  * each stage is a pure function from input artifacts to one immutable
    output artifact (the spiral_file property kept from the reference);
  * a JSON run manifest records per-stage status / timings / attempts —
    the analog of taskdb's persisted task map (taskdb.h:95);
  * `resume` skips completed stages (bgbinary resurrect / full_pipeline
    --resume); failed stages are retried up to `max_attempts`
    (worker.cpp:67 max_errors);
  * device-level parallelism comes from jax meshes inside the stage
    functions, not from forked worker processes.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from biograph_jax.runtime import storage


@dataclass
class Stage:
    name: str
    fn: Callable[["StageRunner"], None]
    outputs: List[str] = field(default_factory=list)  # artifact paths
    max_attempts: int = 2
    # resource class (task_requirements profile analog, mapred/task.h:14):
    # "device" stages own the accelerator, "host" stages are CPU/IO bound
    # ("himem" in the reference's scheduler).  The runner serializes device
    # stages and records the class in the manifest for schedulers above.
    profile: str = "device"


class StageError(RuntimeError):
    pass


@dataclass
class ArtifactInfo:
    """One dataset entry in the run manifest (mapred/manifest.h:20 analog:
    path + size + record count + content identity)."""

    path: str
    bytes: int = 0
    records: int = 0
    uuid: str = ""

    @staticmethod
    def describe(path: str, records: int = 0, uuid: str = "") -> "ArtifactInfo":
        total = 0
        if os.path.isdir(path):
            for root, _, files in os.walk(path):
                for fn in files:
                    total += os.path.getsize(os.path.join(root, fn))
            if not uuid:
                meta = os.path.join(path, "artifact.json")
                if os.path.isfile(meta):
                    try:
                        uuid = json.load(open(meta)).get("uuid", "")
                    except Exception:
                        pass
        elif os.path.isfile(path):
            total = os.path.getsize(path)
        return ArtifactInfo(path=path, bytes=total, records=records, uuid=uuid)


class StageRunner:
    def __init__(self, run_dir: str, resume: bool = True):
        # run_dir may carry a storage scheme (file:// local, s3://, or any
        # registered backend) — the manifest and done-checks resolve through
        # runtime/storage, the reference's path-wrapper convention
        # (modules/io/path.h; manifest.h:79 names artifacts by URL)
        self.run_dir = run_dir
        self.storage = storage.for_path(run_dir)
        self.storage.makedirs(run_dir)
        self.manifest_path = storage.join(run_dir, "run_manifest.json")
        self.resume = resume
        self.manifest: Dict = {"stages": {}, "created": _now()}
        if resume and self.storage.exists(self.manifest_path):
            self.manifest = storage.read_json(self.manifest_path)
        self.context: Dict = {}

    def _save(self):
        storage.write_json_atomic(self.manifest_path, self.manifest)

    def _outputs_exist(self, stage: Stage) -> bool:
        return bool(stage.outputs) and all(
            storage.for_path(p).exists(p) for p in stage.outputs
        )

    def _stage_done(self, stage: Stage) -> bool:
        rec = self.manifest["stages"].get(stage.name)
        if not rec or rec.get("status") != "done":
            return False
        return all(storage.for_path(p).exists(p) for p in stage.outputs)

    def run(
        self,
        stages: List[Stage],
        stop_after: str | None = None,
        rerun: str | None = None,
        verbose: bool = False,
    ):
        """Run stages in order with resume + bounded retries.

        rerun: force exactly this stage to re-execute while every OTHER
        stage with existing outputs is skipped (bgbinary rerun semantics).
        Returns the stop_after stage name if it was reached and executed,
        else None."""
        for stage in stages:
            if rerun and stage.name != rerun and self._outputs_exist(stage):
                if verbose:
                    print(f"[{stage.name}] exists, skipping (--rerun {rerun})")
                continue
            if (
                not rerun
                and self.resume
                and self._stage_done(stage)
            ):
                if verbose:
                    first = stage.outputs[0] if stage.outputs else ""
                    print(f"[{stage.name}] exists, skipping ({first})")
                continue
            if rerun == stage.name:
                self.manifest["stages"].pop(stage.name, None)  # fresh attempts
            rec = self.manifest["stages"].setdefault(
                stage.name, {"attempts": 0}
            )
            ok = False
            while rec["attempts"] < stage.max_attempts and not ok:
                rec["attempts"] += 1
                rec["status"] = "running"
                rec["started"] = _now()
                self._save()
                t0 = time.time()
                try:
                    stage.fn(self)
                    ok = True
                except Exception:
                    rec["status"] = "failed"
                    rec["error"] = traceback.format_exc().splitlines()[-1]
                    self._save()
            if not ok:
                raise StageError(
                    f"stage {stage.name!r} failed after "
                    f"{rec['attempts']} attempts: {rec.get('error')}"
                )
            rec["status"] = "done"
            rec["profile"] = stage.profile
            rec["wall_s"] = round(time.time() - t0, 3)
            rec["finished"] = _now()
            # dataset manifest: record what the stage produced
            rec["outputs"] = [
                vars(ArtifactInfo.describe(p)) for p in stage.outputs
            ]
            self._save()
            if stop_after == stage.name:
                return stage.name
        return None

    def register_artifact(self, name: str, path: str, records: int = 0, uuid: str = ""):
        """Add a named dataset to the run manifest (manifest.h analog)."""
        ds = self.manifest.setdefault("datasets", {})
        ds[name] = vars(ArtifactInfo.describe(path, records=records, uuid=uuid))
        self._save()


def _now():
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
