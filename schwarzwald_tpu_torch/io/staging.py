"""Atomic per-batch staging for file-backed persistence sinks.

Nodes are persisted incrementally INSIDE a batch; the checkpoint
(tiler_state.json) marks batch boundaries. Without staging, a mid-batch
crash leaves some nodes already containing the in-flight batch's points,
and a resume re-tiles that batch, duplicating them. With staging:

  * begin(): node writes go to <work_dir>/.staging/ instead of their
    committed paths;
  * commit(extra_renames): a manifest (the staged -> committed rename
    list, INCLUDING the checkpoint file's own tmp -> tiler_state.json
    rename passed in by the Tiler) is written atomically FIRST, then
    every file is os.replace()d into place, then the manifest is removed;
  * recover() (at sink construction): a surviving manifest means a crash
    during commit — replay the renames (os.replace is idempotent here
    because staged sources are only removed by the rename itself); staged
    files without a manifest are an abandoned in-flight batch — discard.

Because the checkpoint rename rides in the same manifest as the node
renames, the committed node files and the checkpoint advance atomically:
after any crash, either both reflect the batch or neither does — resume
can never re-tile an already-committed batch.

Staged names are derived from a hash of the FULL target path (not the
basename), so two targets sharing a basename — or nested layouts — can
never collide in the flat staging directory; re-persisting the same
target within one batch deduplicates to the same staged path (last write
wins, one manifest entry).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil


class FileStaging:
    MANIFEST = "MANIFEST.json"

    def __init__(self, work_dir: str):
        self.dir = os.path.join(work_dir, ".staging")
        self.manifest_path = os.path.join(self.dir, self.MANIFEST)
        self._active: dict | None = None
        self._recover()

    def _recover(self) -> None:
        if os.path.exists(self.manifest_path):
            # crash mid-commit: finish the replay
            for staged, target in json.load(open(self.manifest_path)):
                if os.path.exists(staged):
                    os.replace(staged, target)
            os.remove(self.manifest_path)
        if os.path.isdir(self.dir):
            # leftovers without a manifest: abandoned in-flight batch
            shutil.rmtree(self.dir, ignore_errors=True)

    def begin(self) -> None:
        # metadata ops cost ~1 ms each on slow network filesystems; create
        # the staging dir once per run, not once per batch
        if not getattr(self, "_dir_made", False):
            os.makedirs(self.dir, exist_ok=True)
            self._dir_made = True
        self._active = {}

    @property
    def active(self) -> bool:
        return self._active is not None

    def path_for(self, target_path: str) -> str:
        """The path a node write should go to right now."""
        if self._active is None:
            return target_path
        digest = hashlib.sha1(target_path.encode()).hexdigest()[:16]
        staged = os.path.join(
            self.dir, f"{digest}-{os.path.basename(target_path)}")
        self._active[target_path] = staged
        return staged

    def commit(self, extra_renames=None) -> None:
        """Atomically move this batch's staged files into place.

        extra_renames: additional (already-written-src, target) pairs to
        include in the same manifest — used for the tiler checkpoint so
        node state and resume state advance as one atomic unit.
        """
        if self._active is None:
            return
        active, self._active = self._active, None
        entries = [(staged, target) for target, staged in active.items()]
        entries.extend(extra_renames or ())
        if entries:
            tmp = self.manifest_path + ".tmp"
            os.makedirs(self.dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(entries, f)
            os.replace(tmp, self.manifest_path)
            for staged, target in entries:
                os.replace(staged, target)
            os.remove(self.manifest_path)
