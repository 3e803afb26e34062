"""Typed journaling framework.

Parity: the policy-based Journal system (schwarzwald/util/logging/
Journal.h:21-330): journals are built with a fluent builder —
`new_journal(name).with_record_type(fields).as_csv(dir).into_single_file()
.build()` — choosing a record type, an output format (CSV / JSON / text /
binary) and a file-partitioning policy (single file / chunked by record
count / unique file per record), registered in a global JournalStore.
CSV headers come from the declared field names (the reference derives them
via static reflection, util/reflection/StaticReflection.h:22-70).
"""
from __future__ import annotations

import json
import os
import struct
import threading


class JournalWriter:
    def __init__(self, name: str, fields, fmt: str, directory: str,
                 partitioning: str, records_per_chunk: int = 100_000):
        self.name = name
        self.fields = list(fields) if fields else None
        self.format = fmt            # csv | json | text | binary
        self.directory = directory
        self.partitioning = partitioning  # single | chunked | unique
        self.records_per_chunk = records_per_chunk
        self._records: list = []
        self._lock = threading.Lock()
        self._chunk_index = 0
        self._unique_index = 0
        os.makedirs(directory, exist_ok=True)

    # -- record API ---------------------------------------------------------

    def add_record(self, record) -> None:
        with self._lock:
            if self.partitioning == "unique":
                self._write_file(self._unique_path(), [record])
                self._unique_index += 1
                return
            self._records.append(record)
            if (self.partitioning == "chunked"
                    and len(self._records) >= self.records_per_chunk):
                self._flush_chunk()

    add_record_untyped = add_record

    # -- output -------------------------------------------------------------

    def _extension(self) -> str:
        return {"csv": ".csv", "json": ".json", "text": ".txt",
                "binary": ".bin"}[self.format]

    def _unique_path(self) -> str:
        return os.path.join(self.directory,
                            f"{self.name}_{self._unique_index}"
                            + self._extension())

    def _write_file(self, path: str, records) -> None:
        if self.format == "csv":
            with open(path, "w") as f:
                if self.fields:
                    f.write(";".join(self.fields) + "\n")
                for r in records:
                    row = (r if isinstance(r, (list, tuple))
                           else [r.get(k) for k in self.fields]
                           if isinstance(r, dict) else [r])
                    f.write(";".join(str(v) for v in row) + "\n")
        elif self.format == "json":
            with open(path, "w") as f:
                json.dump(list(records), f, default=str)
        elif self.format == "text":
            with open(path, "w") as f:
                for r in records:
                    f.write(str(r) + "\n")
        else:  # binary: length-prefixed utf-8/bytes blobs
            with open(path, "wb") as f:
                for r in records:
                    blob = r if isinstance(r, bytes) else str(r).encode()
                    f.write(struct.pack("<Q", len(blob)))
                    f.write(blob)

    def _flush_chunk(self) -> None:
        path = os.path.join(self.directory,
                            f"{self.name}_{self._chunk_index}"
                            + self._extension())
        self._write_file(path, self._records)
        self._records = []
        self._chunk_index += 1

    def flush(self) -> None:
        with self._lock:
            if self.partitioning == "single":
                self._write_file(os.path.join(self.directory,
                                              self.name + self._extension()),
                                 self._records)
            elif self.partitioning == "chunked" and self._records:
                self._flush_chunk()


class JournalBuilder:
    def __init__(self, store: "JournalStore", name: str):
        self._store = store
        self._name = name
        self._fields = None
        self._format = "text"
        self._directory = "."
        self._partitioning = "single"
        self._records_per_chunk = 100_000

    def with_record_type(self, fields) -> "JournalBuilder":
        self._fields = fields
        return self

    # with_flat_type equivalent: single unnamed value per record
    def with_flat_type(self) -> "JournalBuilder":
        self._fields = None
        return self

    def as_csv(self, directory: str) -> "JournalBuilder":
        self._format, self._directory = "csv", directory
        return self

    def as_json(self, directory: str) -> "JournalBuilder":
        self._format, self._directory = "json", directory
        return self

    def as_text(self, directory: str) -> "JournalBuilder":
        self._format, self._directory = "text", directory
        return self

    def as_binary(self, directory: str) -> "JournalBuilder":
        self._format, self._directory = "binary", directory
        return self

    def into_single_file(self) -> "JournalBuilder":
        self._partitioning = "single"
        return self

    def into_chunked_files(self, records_per_chunk: int) -> "JournalBuilder":
        self._partitioning = "chunked"
        self._records_per_chunk = records_per_chunk
        return self

    def into_unique_files(self) -> "JournalBuilder":
        self._partitioning = "unique"
        return self

    def build(self) -> JournalWriter:
        journal = JournalWriter(self._name, self._fields, self._format,
                                self._directory, self._partitioning,
                                self._records_per_chunk)
        self._store._register(self._name, journal)
        return journal


class JournalStore:
    """Global registry (logging::JournalStore, Journal.h:78-97)."""

    _global: "JournalStore | None" = None

    def __init__(self):
        self._journals: dict[str, JournalWriter] = {}
        self._lock = threading.Lock()

    @classmethod
    def global_store(cls) -> "JournalStore":
        if cls._global is None:
            cls._global = JournalStore()
        return cls._global

    def new_journal(self, name: str) -> JournalBuilder:
        return JournalBuilder(self, name)

    def get_journal(self, name: str) -> JournalWriter | None:
        with self._lock:
            return self._journals.get(name)

    def _register(self, name: str, journal: JournalWriter) -> None:
        with self._lock:
            self._journals[name] = journal

    def flush_all(self) -> None:
        with self._lock:
            journals = list(self._journals.values())
        for j in journals:
            j.flush()
