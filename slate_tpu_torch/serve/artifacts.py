"""Durable executable artifacts: the on-disk store that lets a fresh
serving process bring a warmed bucket set live without rebuilding the
kernel library (the JAX package's ``serve/artifacts.py``).

The port compiles nothing per bucket: a bucket's core is a closure over
the drivers, and the only compiled code is the Hopper kernel library
(``ops/hopper/panel_kernels.py``, one ``nvcc`` a source).  So an
artifact is the JAX package's ``cache_seed`` rung made real: one
``.slate_exe`` file per ``(key, batch)`` whose verified header says the
entry was built by this runtime, plus one copy of the built library set
in the store, keyed by its digest::

    /dir/  (SLATE_TPU_ARTIFACTS=/dir or ArtifactStore(root))
      <label>.b<batch>.<content12>.slate_exe
      kernels/<digest>/lib<source>_<tag>.so    # the built library set
      kernels/<digest>/library.json            # each file's sha256
      .lock                                    # cross-process write lock

Each ``.slate_exe`` is one JSON header line + ``\\n`` + a small JSON
payload (the library files the entry's kernels come from; none on the
CPU).  The header carries the fingerprint: the content half
(``buckets.content_fields``: every BucketKey field, mesh included, and
the batch point) and the runtime half (:func:`runtime_fields`: torch and
CUDA versions, device name and compute capability, the library digest),
the payload's sha256 and the header's own (so a flipped byte anywhere
in the file reads as corrupt).  The library copy has its own record
(``panel_kernels.library_record``): each file's sha256, checked before
the copy is opened, so a flipped byte in a library reads as corrupt
too and is never handed to the dynamic loader.

A fresh process with a store opens the library from the store and runs
no ``nvcc``: that is the port's "restored".  Rebuilding from the sources
is its "compiled" (in the JAX package a ``cache_seed`` entry counts as
compiled).  The load ladder, each rung counted globally
(``serve.artifact_<outcome>``) and per bucket
(``serve.artifact.<label>.b<n>.<outcome>``), none fatal: ``miss`` (no
file), ``corrupt`` (unparsable header, checksum or length mismatch, or
a library copy whose record or bytes fail their sha256), ``stale`` (any
fingerprint drift, or a process that already holds a library of another
digest), ``load_fail`` (a library copy that is missing or does not
open), ``hit``.  Every rung but ``hit`` degrades to a cold build from
the sources (never the store's copy) whose :meth:`ArtifactStore.save`
overwrites the bad file and, after a bad library copy, the copy
(self-heal).  Writes are fsync + rename under a stale-breaking
cross-process lock.  The ``artifact_corrupt`` / ``artifact_stale`` /
``artifact_load_fail`` fault sites inject each rung.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional, Tuple

import torch

from ..aux import faults, metrics, sync
from .buckets import BucketKey, content_fields, fingerprint

ARTIFACTS_ENV = "SLATE_TPU_ARTIFACTS"

MAGIC = "slate-artifact"
SCHEMA = 1
SUFFIX = ".slate_exe"
KERNELS_DIR = "kernels"

#: a .lock older than this belongs to a crashed writer and is broken
LOCK_STALE_S = 30.0
LOCK_RETRY_S = 0.02
LOCK_TIMEOUT_S = 10.0


def _device(device) -> torch.device:
    """The device an entry is fingerprinted for: ``None`` is the default
    grid's (``cuda:0``; raises DistributedException without CUDA, never
    a quiet move to the CPU)."""
    if device is None:
        from ..parallel.grid import default_grid

        return default_grid().device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def runtime_fields(device=None) -> dict:
    """The runtime half of the fingerprint: an entry is valid only for
    the torch / CUDA pair, device kind and kernel library it was built
    under; any drift reads as stale, never loads."""
    from ..ops.hopper import panel_kernels as pk

    dev = _device(device)
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        capability = ".".join(map(str, torch.cuda.get_device_capability(dev)))
    else:
        kind, capability = dev.type, None
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "device_kind": kind,
            "capability": capability, "kernels": pk.library_digest()}


class _FileLock:
    """Cross-process advisory lock via O_CREAT|O_EXCL, with stale-break:
    a lock file older than LOCK_STALE_S belongs to a crashed writer and
    is removed.  Atomicity never depends on the lock (every write is a
    rename); it bounds concurrent write amplification."""

    def __init__(self, path: str, timeout_s: float = LOCK_TIMEOUT_S,
                 stale_s: float = LOCK_STALE_S):
        self.path = path
        self.timeout_s = timeout_s
        self.stale_s = stale_s
        self._held = False

    def __enter__(self) -> "_FileLock":
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, f"{os.getpid()}\n".encode())
                finally:
                    os.close(fd)
                self._held = True
                return self
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(self.path) > self.stale_s:
                        os.unlink(self.path)  # crashed writer; break it
                        continue
                except OSError:
                    continue  # released between stat and unlink
                if time.monotonic() > deadline:
                    # proceed without the lock rather than wedge the
                    # process: rename keeps every write atomic anyway
                    metrics.inc("serve.artifact_lock_timeout")
                    return self
                time.sleep(LOCK_RETRY_S)

    def __exit__(self, *exc) -> bool:
        if self._held:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self._held = False
        return False


def _header_sha(header: dict) -> str:
    """sha256 of a header's canonical JSON without its own checksum."""
    body = {k: v for k, v in header.items() if k != "header_sha256"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def _write_atomic(path: str, blob: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # readers see whole files only
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


class ArtifactStore:
    """On-disk store of bucket artifacts and the kernel library they
    run.  Thread-safe; every public method degrades to "no artifact" on
    filesystem trouble: the store never takes serving down with it."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = sync.Lock(name="artifacts.ArtifactStore._lock")
        self._runtime: dict = {}  # device -> runtime fields  # guarded by: _lock
        # set when the store's library copy failed its checks or to open: the next
        # save overwrites it from the process's own build
        self._library_bad = False  # guarded by: _lock
        self._library_saved = False  # guarded by: _lock

    # -- identity ----------------------------------------------------------

    def _runtime_fields(self, device=None) -> dict:
        dev = str(_device(device))
        with self._lock:
            if dev not in self._runtime:
                self._runtime[dev] = runtime_fields(dev)
            return dict(self._runtime[dev])

    def fingerprint(self, key: BucketKey, batch: int, device=None) -> Tuple[str, dict]:
        """(hex digest, field dict) of one entry's full identity."""
        fields = {**content_fields(key, batch), **self._runtime_fields(device)}
        return fingerprint(fields), fields

    def path_for(self, key: BucketKey, batch: int) -> str:
        """The entry's file: the bucket label plus a short content-only
        hash.  The runtime half lives in the header, not the name, so an
        entry of another runtime is found and counted stale."""
        chash = fingerprint(content_fields(key, batch))[:12]
        return os.path.join(self.root, f"{key.label}.b{int(batch)}.{chash}{SUFFIX}")

    def kernels_dir(self, digest: Optional[str] = None) -> str:
        """Where the store keeps the library set of ``digest`` (default:
        the current sources')."""
        if digest is None:
            from ..ops.hopper import panel_kernels as pk

            digest = pk.library_digest()
        return os.path.join(self.root, KERNELS_DIR, digest)

    # -- the kernel library --------------------------------------------------

    def save_library(self) -> bool:
        """Copy the process's loaded library set (built first if need
        be) into ``kernels/<digest>/`` with its record of sha256s,
        written last, once a process, or again after the copy failed its
        checks or to open.  Never raises."""
        from ..ops.hopper import panel_kernels as pk

        with self._lock:
            if self._library_saved and not self._library_bad:
                return True
        try:
            files = pk.library_files()
            dest = self.kernels_dir(pk._libs_digest)
            os.makedirs(dest, exist_ok=True)
            shas = {}
            with _FileLock(os.path.join(self.root, ".lock")):
                for src in files:
                    out = os.path.join(dest, src.name)
                    with open(src, "rb") as f:
                        blob = f.read()
                    shas[src.name] = hashlib.sha256(blob).hexdigest()
                    if os.path.abspath(str(src)) != os.path.abspath(out):
                        _write_atomic(out, blob)  # else opened from this store
                _write_atomic(os.path.join(dest, pk.LIBRARY_RECORD),
                              pk.library_record(pk._libs_digest, shas))
            with self._lock:
                self._library_saved, self._library_bad = True, False
            metrics.inc("serve.artifact_library_saved")
            return True
        except Exception:  # noqa: BLE001 — persistence never crashes serving
            metrics.inc("serve.artifact_save_error")
            return False

    def open_library(self) -> str:
        """Open the store's library copy of the current digest through
        ``panel_kernels.open_from``, which checks its bytes first:
        ``"opened"``, ``"loaded"`` (already held), ``"stale"`` (the
        process holds another digest), ``"corrupt"`` (the record or a
        file fails its sha256) or ``"failed"`` (missing, or does not
        open)."""
        from ..ops.hopper import panel_kernels as pk

        digest = pk.library_digest()
        try:
            return pk.open_from(self.kernels_dir(digest), digest)
        except Exception as e:  # noqa: BLE001 — a bad copy degrades to a rebuild
            with self._lock:
                self._library_bad = True
            return "corrupt" if isinstance(e, pk.LibraryCorrupt) else "failed"

    # -- save ----------------------------------------------------------------

    def save(self, key: BucketKey, batch: int, device=None) -> bool:
        """Persist one built entry (and, on a CUDA device, the library
        its kernels come from).  Returns whether it was written; a
        persistence failure never raises (a device that does not resolve
        does: ``None`` without CUDA)."""
        dev = _device(device)
        try:
            names = []
            if dev.type == "cuda":
                from ..ops.hopper import panel_kernels as pk

                if not self.save_library():
                    return False
                names = pk.library_names()
            fp, fields = self.fingerprint(key, batch, dev)
            payload = json.dumps({"kernels": names}, sort_keys=True).encode()
            header = {"magic": MAGIC, "schema": SCHEMA, "fingerprint": fp, "fields": fields,
                      "sha256": hashlib.sha256(payload).hexdigest(),
                      "payload_bytes": len(payload), "created_unix": time.time()}
            header["header_sha256"] = _header_sha(header)
            blob = (json.dumps(header, sort_keys=True) + "\n").encode() + payload
            with _FileLock(os.path.join(self.root, ".lock")):
                _write_atomic(self.path_for(key, batch), blob)
            metrics.inc("serve.artifact_saved")
            return True
        except Exception:  # noqa: BLE001 — persistence never crashes serving
            metrics.inc("serve.artifact_save_error")
            return False

    # -- load ----------------------------------------------------------------

    def _count(self, key: BucketKey, batch: int, outcome: str) -> None:
        metrics.inc(f"serve.artifact_{outcome}")
        metrics.inc(f"serve.artifact.{key.label}.b{int(batch)}.{outcome}")

    def load(self, key: BucketKey, batch: int, device=None) -> bool:
        """Verify one entry; True when the caller may bring it live as
        restored (on a CUDA device the library is then open, from the
        store unless the process already held it), False when it must
        rebuild.  Each rung is counted; none raises (a device that does
        not resolve does)."""
        dev = _device(device)
        path = self.path_for(key, batch)
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            self._count(key, batch, "miss")
            return False
        try:
            if faults.fire("artifact_corrupt") is not None:
                blob = self._flip_byte(blob)
            nl = blob.find(b"\n")
            if nl < 0:
                raise ValueError("no header line")
            header = json.loads(blob[:nl].decode())
            payload = blob[nl + 1:]
            if header.get("magic") != MAGIC or header.get("schema") != SCHEMA:
                raise ValueError("bad magic/schema")
            if header.get("header_sha256") != _header_sha(header):
                raise ValueError("header checksum mismatch")
            if hashlib.sha256(payload).hexdigest() != header.get("sha256"):
                raise ValueError("payload checksum mismatch")
            if len(payload) != int(header.get("payload_bytes", -1)):
                raise ValueError("payload truncated")
            json.loads(payload.decode())
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            # torn / truncated / bit-rotted bytes: the rebuild's save()
            # overwrites the file
            self._count(key, batch, "corrupt")
            return False
        fp, _fields = self.fingerprint(key, batch, dev)
        if faults.fire("artifact_stale") is not None:
            fp += "!stale"  # as if another runtime had written it
        if header.get("fingerprint") != fp:
            self._count(key, batch, "stale")
            return False
        try:
            faults.check("artifact_load_fail")
            if dev.type == "cuda":
                got = self.open_library()
                if got in ("stale", "corrupt"):
                    self._count(key, batch, got)
                    return False
                if got == "failed":
                    raise RuntimeError("the store's kernel library does not open")
        except Exception:  # noqa: BLE001 — verified bytes can still fail to load
            self._count(key, batch, "load_fail")
            return False
        self._count(key, batch, "hit")
        return True

    @staticmethod
    def _flip_byte(blob: bytes) -> bytes:
        """One flipped byte just past the header (the artifact_corrupt
        injection: the checksum, not the JSON parse, must catch it)."""
        if not blob:
            return blob
        nl = blob.find(b"\n")
        i = min(nl + 1, len(blob) - 1) if nl >= 0 else len(blob) - 1
        out = bytearray(blob)
        out[i] ^= 0x01
        return bytes(out)

    # -- introspection -------------------------------------------------------

    def entries(self) -> list:
        """Header dicts of every artifact in the store (an unreadable
        header as ``{"path": ..., "error": ...}``), for tools."""
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not name.endswith(SUFFIX):
                continue
            path = os.path.join(self.root, name)
            try:
                with open(path, "rb") as f:
                    h = json.loads(f.readline().decode())
                h["path"] = path
                out.append(h)
            except (OSError, ValueError, UnicodeDecodeError) as e:
                out.append({"path": path, "error": str(e)})
        return out


def store_from_env(artifact_dir: Optional[str] = None) -> Optional[ArtifactStore]:
    """The store of an explicit directory or ``SLATE_TPU_ARTIFACTS``;
    None when neither names one.  A store that cannot be created
    degrades to None (counted): serving without durability beats not
    serving."""
    root = artifact_dir if artifact_dir is not None else os.environ.get(ARTIFACTS_ENV) or None
    if not root:
        return None
    try:
        return ArtifactStore(root)
    except OSError:
        metrics.inc("serve.artifact_store_error")
        return None

