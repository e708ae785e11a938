"""Durable multi-generation checkpoints — the port of
``tpu_p2p/utils/checkpoint.py``, writing the reference's format byte for
byte.

- :func:`save_generation` writes a complete ``gen-<step>/`` (params, the
  optional optimizer state and schedule metadata, and a
  ``MANIFEST.json`` with per-file and per-array sha256 checksums and
  byte sizes) into a temp dir, fsyncs every file and the directory,
  publishes it with one ``os.rename``, then updates the ``LATEST``
  pointer (write-temp + rename) and prunes to the newest ``keep``
  generations. A crash at any byte leaves no new generation or a whole
  one.
- :func:`load_latest` is the verifying loader: it walks the generations
  newest first, re-checks sizes and checksums (:func:`verify_generation`
  names the damage in the reference's words), and falls back to the
  newest intact one, reporting what it skipped and why; with no
  generation it reads the legacy flat layout (:func:`save_params`).
- Every generation file goes through :func:`_write_file`, which retries
  transient ``OSError`` (:func:`tpu_p2p_torch.utils.retry.retry_io`) and
  is the only place the storage faults of
  :mod:`tpu_p2p_torch.obs.faults` apply.

These are host functions of global arrays: params and optimizer leaves
are dicts and trees of tensors (or numpy arrays), written as numpy
``.npz``. A bfloat16 leaf is written through its 16-bit pattern with
the header ``ml_dtypes`` gives it (descr ``'<V2'``) and recorded as
``"bfloat16"``; on load such a leaf is viewed back through its bits by
the recorded dtype. Loaded leaves are CPU tensors. Placing them on a
mesh is the caller's (``place_flagship_params``).

The reference's orbax pair (``save_params_orbax`` /
``load_params_orbax``) has no counterpart here.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import io
import json
import os
import re
import shutil
import uuid
import zipfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

CKPT_KEEP = 3                      # reference: tpu_p2p/config.py
_META = "tpu_p2p_checkpoint.json"
_OPT_META = "tpu_p2p_opt_state.json"
_SCHED_META = "train_schedule.json"
MANIFEST = "MANIFEST.json"
LATEST = "LATEST"
_GEN_FORMAT = "tpu-p2p-gen-1"
_GEN_RE = re.compile(r"^gen-(\d{6,})$")

# dtypes numpy has no type for, stored as raw bits of this width with
# ml_dtypes' npy descr
_BITS = {"bfloat16": (torch.int16, np.int16, "<V2")}


def _gen_name(step: int) -> str:
    return f"gen-{int(step):06d}"


def _digest(data) -> str:
    return hashlib.sha256(data).hexdigest()


def _raw_bytes(a: np.ndarray) -> memoryview:
    """An array's bytes in C order, without a copy where it is
    contiguous."""
    return memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _array_digest(a: np.ndarray) -> str:
    return _digest(_raw_bytes(a))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    """A thread pool for hashing: sha256 and file IO release the GIL, so
    a checkpoint's arrays hash on every core."""
    return concurrent.futures.ThreadPoolExecutor(
        min(os.cpu_count() or 1, 16))


def _start(pool, fn, items: dict):
    """Start ``fn`` on each item in ``pool`` → a function that waits for
    them all and returns ``{k: fn(v)}``."""
    futures = {k: pool.submit(fn, v) for k, v in items.items()}
    return lambda: {k: f.result() for k, f in futures.items()}


def _parallel(fn, items: dict) -> dict:
    """``{k: fn(v)}`` on a thread pool."""
    if len(items) < 2:
        return {k: fn(v) for k, v in items.items()}
    with _pool() as pool:
        return _start(pool, fn, items)()


# ------------------------------------------------------ host arrays


class _Host:
    """One leaf on the host: its raw array, dtype name and npy descr."""

    __slots__ = ("raw", "dtype", "descr")

    def __init__(self, leaf) -> None:
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            name = str(t.dtype).replace("torch.", "")
            if name in _BITS:
                raw = t.view(_BITS[name][0]).numpy()
            else:
                raw = t.numpy()
        else:
            a = np.ascontiguousarray(leaf).reshape(np.shape(leaf))
            name = a.dtype.name
            raw = a.view(_BITS[name][1]) if name in _BITS else a
        self.raw, self.dtype = raw, name
        self.descr = (_BITS[name][2] if name in _BITS
                      else np.lib.format.dtype_to_descr(raw.dtype))


def _npz_bytes(arrays: Dict[str, _Host]) -> memoryview:
    """What ``np.savez(buf, **arrays)`` writes, with each leaf's descr
    (a bfloat16 leaf's is ``'<V2'``, as with ``ml_dtypes``), as a view
    of the buffer (no final copy)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, h in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": h.descr, "fortran_order": False,
                          "shape": h.raw.shape})
                fid.write(_raw_bytes(h.raw))
    return buf.getbuffer()


def _to_tensor(a: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """A loaded array as a CPU tensor of the recorded ``dtype``: a raw
    ``V2`` array is viewed through its bits."""
    if dtype in _BITS:
        bits = _BITS[dtype]
        return torch.from_numpy(a.view(bits[1])).view(getattr(torch, dtype))
    return torch.from_numpy(a)


def _read_npz(fp: str) -> Dict[str, np.ndarray]:
    """Every array of the npz at ``fp`` (``np.load``, which checks each
    member's CRC-32 as it reads it)."""
    with np.load(fp) as z:
        return {k: z[k] for k in z.files}


# ----------------------------------------------- interposed IO writer
# Every generation file lands through _write_file: one choke point for
# fsync discipline, bounded retry, and the storage faults.


def _io_session(step: int) -> dict:
    from tpu_p2p_torch.obs import faults

    plan = faults.active_plan()
    return {
        "plan": plan,
        "step": int(step),
        "crash_budget": faults.ckpt_crash_budget(plan, step),
        "retries": 0,
        "bytes": 0,
    }


def _write_file(session: dict, path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` (flush + fsync), under the active
    fault plan's storage faults, retrying transient OSError with
    bounded exponential backoff."""
    from tpu_p2p_torch.obs import faults
    from tpu_p2p_torch.utils.retry import retry_io

    plan = session["plan"]

    def attempt():
        if faults.take_ckpt_io_error(plan):
            raise OSError(
                f"injected transient IO error writing {path} "
                "(FaultPlan.ckpt_io_errors)")
        budget = session["crash_budget"]
        with open(path, "wb") as fh:
            if budget is not None and len(data) > budget:
                fh.write(data[:budget])
                fh.flush()
                os.fsync(fh.fileno())
                faults.mark_ckpt_crash_fired(plan)
                raise faults.SimulatedCrash(path, budget,
                                            step=session["step"])
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        if budget is not None:
            session["crash_budget"] = budget - len(data)
        session["bytes"] += len(data)

    def count(_attempt, _exc):
        session["retries"] += 1

    retry_io(attempt, on_retry=count)


def _maybe_corrupt_published(session: dict, gen_dir: str) -> bool:
    """Apply the seeded published-generation bit flip
    (``FaultPlan.ckpt_corrupt_seed``) after the publish, so the loader's
    checksum fallback is what it tests: the same byte and bit as the
    reference's for the same seed."""
    from tpu_p2p_torch.obs import faults

    plan = session["plan"]
    if not faults.ckpt_corrupt_due(plan, session["step"]):
        return False
    fp = os.path.join(gen_dir, "params.npz")
    with open(fp, "rb") as fh:
        data = bytearray(fh.read())
    rng = np.random.default_rng(plan.ckpt_corrupt_seed)
    off = int(rng.integers(0, len(data)))
    data[off] ^= 1 << int(rng.integers(0, 8))
    with open(fp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    return True


# ------------------------------------------------- payload assembly


def _params_payload(params, step: int, pool=None):
    """→ (npz_bytes, meta_dict, array_records) for a params dict (in its
    order: the zip members and the JSON keys follow it). With ``pool``
    the arrays hash while the npz is built."""
    arrays = {k: _Host(v) for k, v in params.items()}
    npz, digests = _npz_and_digests(arrays, pool)
    meta = {
        "step": int(step), "keys": sorted(arrays),
        "dtypes": {k: h.dtype for k, h in arrays.items()},
        "sha256": digests,
    }
    return npz, meta, _records(arrays, digests)


def _opt_payload(opt_state, step: int, pool=None):
    """An optimizer state flattened into the positional ``l0..lN`` npz
    and its pairing-fingerprint meta (the leaf paths)."""
    from tpu_p2p_torch.utils.optim import tree_flatten_with_path

    flat = tree_flatten_with_path(opt_state)
    arrays = {f"l{i}": _Host(v) for i, (_, v) in enumerate(flat)}
    npz, digests = _npz_and_digests(arrays, pool)
    meta = {
        "step": int(step), "count": len(flat),
        "leaf_paths": [p for p, _ in flat],
        "dtypes": {k: h.dtype for k, h in arrays.items()},
        "shapes": {k: list(h.raw.shape) for k, h in arrays.items()},
    }
    return npz, meta, _records(arrays, digests)


def _npz_and_digests(arrays: Dict[str, _Host], pool):
    raws = {k: h.raw for k, h in arrays.items()}
    if pool is None:
        return _npz_bytes(arrays), {k: _array_digest(a)
                                    for k, a in raws.items()}
    digests = _start(pool, _array_digest, raws)
    return _npz_bytes(arrays), digests()


def _records(arrays: Dict[str, _Host], digests: dict) -> dict:
    return {k: {"sha256": digests[k], "bytes": int(h.raw.nbytes),
                "dtype": h.dtype, "shape": list(h.raw.shape)}
            for k, h in arrays.items()}


# -------------------------------------------------- flat (legacy) API


def save_params(path: str, params, step: int = 0) -> str:
    """Write ``params`` (+ step metadata with per-array checksums) flat
    under directory ``path`` — the legacy single-checkpoint layout."""
    os.makedirs(path, exist_ok=True)
    npz, meta, _records = _params_payload(params, step)
    with open(os.path.join(path, "params.npz"), "wb") as fh:
        fh.write(npz)
    with open(os.path.join(path, _META), "w") as fh:
        json.dump(meta, fh)
    return path


def _load_flat_params(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """The verifying flat-layout reader shared by :func:`load_params`
    and the generation loader."""
    with open(os.path.join(path, _META)) as fh:
        meta = json.load(fh)
    arrays = _read_npz(os.path.join(path, "params.npz"))
    if set(arrays) != set(meta["keys"]):
        raise ValueError(
            f"checkpoint at {path} is torn: meta lists {meta['keys']}, "
            f"npz holds {sorted(arrays)}"
        )
    # Checksums verify the raw stored bytes, before the dtype view.
    wants = meta.get("sha256", {})
    got_all = _parallel(_array_digest,
                        {k: arrays[k] for k in wants if k in arrays})
    for k, want in wants.items():
        if k not in arrays:
            continue  # key-set tears are already caught above
        got = got_all[k]
        if got != want:
            raise ValueError(
                f"checkpoint at {path} is torn: array {k!r} checksum "
                f"mismatch (npz and meta were written by different "
                "saves, or the file rotted at rest)"
            )
    dtypes = meta.get("dtypes", {})
    return ({k: _to_tensor(a, dtypes.get(k)) for k, a in arrays.items()},
            meta.get("step", 0))


def load_params(path: str, mesh=None, specs: Optional[dict] = None):
    """Restore ``(params, step)``: CPU tensors, or with ``mesh`` and
    ``specs`` (``flagship_param_specs``) this rank's shard of each on
    ``mesh.device`` — a checkpoint saved under one mesh restores under
    another. Generations route through the verifying ladder
    (:func:`load_latest`); a flat legacy layout reads directly."""
    if list_generations(path):
        lc = load_latest(path)
        arrays, step = lc.params, lc.step
    else:
        arrays, step = _load_flat_params(path)
    if mesh is not None and specs is not None:
        from tpu_p2p_torch.parallel.runtime import local_shard

        arrays = {k: local_shard(v, mesh, specs[k]).contiguous().to(
            mesh.device) for k, v in arrays.items()}
    return arrays, step


def save_opt_state(path: str, opt_state, step: int = 0) -> str:
    """Write an optimizer-state tree under ``path`` — the legacy flat
    layout (:func:`save_generation` folds the same files into the
    atomic publish). Leaves are stored positionally (flatten order)."""
    os.makedirs(path, exist_ok=True)
    npz, meta, _records = _opt_payload(opt_state, step)
    with open(os.path.join(path, "opt_state.npz"), "wb") as fh:
        fh.write(npz)
    with open(os.path.join(path, _OPT_META), "w") as fh:
        json.dump(meta, fh)
    return path


def clear_opt_state(path: str) -> None:
    """Remove any optimizer-state files under ``path`` (a flat dir
    reused by a plain-SGD run must not keep a stale pairing)."""
    for name in ("opt_state.npz", _OPT_META):
        fp = os.path.join(path, name)
        if os.path.exists(fp):
            os.remove(fp)


def load_opt_state(path: str, template, expect_step: Optional[int] = None):
    """Restore an optimizer state saved by :func:`save_opt_state` (or
    inside a generation) into ``template``'s structure: each leaf a
    tensor on its template leaf's device (the CPU for a ``meta`` or
    numpy template leaf). The template's leaves give the expected global
    shapes; ``expect_step`` the params checkpoint's step."""
    from tpu_p2p_torch.utils.optim import (tree_flatten_with_path,
                                           tree_unflatten)

    with open(os.path.join(path, _OPT_META)) as fh:
        meta = json.load(fh)
    if expect_step is not None and meta.get("step") != expect_step:
        raise ValueError(
            f"optimizer state at {path} was saved at step "
            f"{meta.get('step')}, but the params checkpoint is at step "
            f"{expect_step} — stale/torn optimizer state"
        )
    arrays = _read_npz(os.path.join(path, "opt_state.npz"))
    t_flat = tree_flatten_with_path(template)
    t_leaves = [v for _, v in t_flat]
    if len(t_leaves) != meta["count"] or len(arrays) != meta["count"]:
        raise ValueError(
            f"optimizer state at {path} has {meta['count']} leaves; "
            f"this optimizer/config expects {len(t_leaves)} — "
            "optimizer/checkpoint mismatch"
        )
    saved_paths = meta.get("leaf_paths")  # absent in older checkpoints
    if saved_paths is not None:
        want_paths = [p for p, _ in t_flat]
        if saved_paths != want_paths:
            moved = [f"slot {i}: saved {s!r} vs expected {w!r}"
                     for i, (s, w) in enumerate(zip(saved_paths, want_paths))
                     if s != w][:4]
            raise ValueError(
                f"optimizer state at {path} pairs its leaves differently "
                f"than this optimizer/config ({'; '.join(moved)}) — "
                "positional restore would silently mis-pair same-shaped "
                "leaves (e.g. mu vs nu); refusing"
            )
    dtypes = meta.get("dtypes", {})
    out = []
    for i, t in enumerate(t_leaves):
        a = arrays[f"l{i}"]
        if tuple(a.shape) != tuple(np.shape(t)):
            raise ValueError(
                f"optimizer leaf {i}: saved shape {a.shape} vs expected "
                f"{tuple(np.shape(t))} — optimizer/checkpoint mismatch"
            )
        v = _to_tensor(a, dtypes.get(f"l{i}"))
        if isinstance(t, torch.Tensor) and t.device.type != "meta":
            v = v.to(t.device)
        out.append(v)
    return tree_unflatten(template, out)


# ------------------------------------------- durable generation layout


def list_generations(path: str) -> List[Tuple[int, str]]:
    """Published generations under ``path``, NEWEST FIRST, as ``(step,
    name)`` pairs; temp dirs of a crashed save never appear."""
    out: List[Tuple[int, str]] = []
    if not os.path.isdir(path):
        return out
    for name in os.listdir(path):
        m = _GEN_RE.match(name)
        if m and os.path.isdir(os.path.join(path, name)):
            out.append((int(m.group(1)), name))
    out.sort(reverse=True)
    return out


def has_opt_state(gen_dir: str) -> bool:
    """Does the generation (or flat dir) ``gen_dir`` carry an optimizer
    state? (A plain-SGD save writes none; an optax one always does, even
    with no leaves.)"""
    return os.path.exists(os.path.join(gen_dir, "opt_state.npz"))


def read_sched_meta(gen_dir: str) -> Optional[dict]:
    """The schedule metadata saved beside an optimizer state in
    ``gen_dir``, or None (absent in older checkpoints)."""
    fp = os.path.join(gen_dir, _SCHED_META)
    if not os.path.exists(fp):
        return None
    with open(fp) as fh:
        return json.load(fh)


def has_checkpoint(path: Optional[str]) -> bool:
    """Is there anything restorable under ``path`` — a published
    generation or a legacy flat ``params.npz``? (Existence, not
    integrity.)"""
    if not path:
        return False
    if list_generations(path):
        return True
    return os.path.exists(os.path.join(path, "params.npz"))


def read_latest_pointer(path: str) -> Optional[str]:
    """The ``LATEST`` pointer's generation name, or None (a hint: the
    loader walks the whole ladder regardless)."""
    fp = os.path.join(path, LATEST)
    try:
        with open(fp) as fh:
            name = fh.read().strip()
    except OSError:
        return None
    return name or None


def verify_generation(gen_dir: str) -> Optional[str]:
    """Integrity-check one published generation; → None when intact,
    else the reason naming the damage (empty dir, missing/torn manifest,
    missing file, truncation, file/array checksum mismatch, missing or
    unexpected array)."""
    if not os.path.isdir(gen_dir):
        return "missing generation dir"
    if not os.listdir(gen_dir):
        return "empty generation dir"
    mf = os.path.join(gen_dir, MANIFEST)
    if not os.path.exists(mf):
        return "missing manifest"
    try:
        with open(mf) as fh:
            manifest = json.load(fh)
    except (json.JSONDecodeError, OSError) as e:
        return f"torn manifest ({type(e).__name__})"
    if (manifest.get("format") != _GEN_FORMAT
            or not isinstance(manifest.get("files"), dict)
            or "step" not in manifest):
        return "torn manifest (wrong format/keys)"
    files = sorted(manifest["files"].items())
    whole = {}  # the files whose size is right, hashed in parallel
    for fname, rec in files:
        fp = os.path.join(gen_dir, fname)
        if os.path.exists(fp) and os.path.getsize(fp) == rec.get("bytes"):
            whole[fname] = fp
    digests = _parallel(_file_digest, whole)
    for fname, rec in files:  # the first damage in name order, as the
        # reference's one-file-at-a-time walk reports it
        fp = os.path.join(gen_dir, fname)
        if not os.path.exists(fp):
            return f"missing file {fname}"
        size = os.path.getsize(fp)
        if size != rec.get("bytes"):
            return (f"truncated {fname}: {size} of "
                    f"{rec.get('bytes')} bytes")
        if digests[fname] != rec.get("sha256"):
            return f"checksum mismatch in {fname}"
    for fname, want in sorted(manifest.get("arrays", {}).items()):
        fp = os.path.join(gen_dir, fname)
        try:
            arrays = _read_npz(fp)
        except Exception as e:  # noqa: BLE001 — any unreadable npz is
            # the same verdict: this generation cannot be trusted.
            return f"unreadable {fname} ({type(e).__name__})"
        missing = set(want) - set(arrays)
        if missing:
            return f"missing array {sorted(missing)[0]!r} in {fname}"
        extra = set(arrays) - set(want)
        if extra:
            return f"unexpected array {sorted(extra)[0]!r} in {fname}"
        got = _parallel(_array_digest, arrays)
        for k, rec in sorted(want.items()):
            if got[k] != rec.get("sha256"):
                return f"array checksum mismatch: {k!r} in {fname}"
    return None


def _file_digest(fp: str) -> str:
    h = hashlib.sha256()
    with open(fp, "rb") as fh:
        for chunk in iter(lambda: fh.read(64 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@dataclass
class LoadedCheckpoint:
    """What the verifying loader found: the generation (or legacy flat
    dir) it settled on, the params as CPU tensors, and the generations
    it skipped with the reason each was rejected."""

    path: str                 # the dir the params came from
    name: Optional[str]       # gen-XXXXXX, or None for legacy flat
    step: int
    params: Dict[str, torch.Tensor]
    skipped: List[dict] = field(default_factory=list)


def load_latest(path: str) -> LoadedCheckpoint:
    """The verifying loader: the newest INTACT generation, else the
    legacy flat layout; raises ``ValueError`` listing every skipped
    generation and why when nothing restorable survives."""
    skipped: List[dict] = []
    for _step, name in list_generations(path):
        gd = os.path.join(path, name)
        reason = verify_generation(gd)
        if reason is not None:
            skipped.append({"generation": name, "reason": reason})
            continue
        arrays, step = _load_flat_params(gd)
        return LoadedCheckpoint(path=gd, name=name, step=step,
                                params=arrays, skipped=skipped)
    if os.path.exists(os.path.join(path, "params.npz")):
        arrays, step = _load_flat_params(path)
        return LoadedCheckpoint(path=path, name=None, step=step,
                                params=arrays, skipped=skipped)
    detail = "; ".join(f"{s['generation']}: {s['reason']}"
                       for s in skipped) or "no generations, no flat layout"
    raise ValueError(
        f"no intact checkpoint under {path} ({detail})"
    )


def latest_intact_step(path: str) -> Optional[int]:
    """Step of the newest generation that verifies (the legacy flat
    step when no generation exists), or None — where a resume would
    land, without loading the params."""
    for step, name in list_generations(path):
        if verify_generation(os.path.join(path, name)) is None:
            return step
    meta = os.path.join(path, _META)
    if os.path.exists(meta) and os.path.exists(
            os.path.join(path, "params.npz")):
        try:
            with open(meta) as fh:
                return int(json.load(fh).get("step", 0))
        except (json.JSONDecodeError, OSError, ValueError):
            return None
    return None


def save_generation(path: str, params, step: int, *, opt_state=None,
                    sched_meta: Optional[dict] = None,
                    keep: Optional[int] = None) -> dict:
    """Atomically publish ``gen-<step>/`` under ``path`` (the reference's
    protocol: every file through the interposed fault/retry writer into
    a temp dir with flush + fsync, the dir fsynced, ONE rename, the
    parent fsynced, then ``LATEST`` and retention to the newest ``keep``
    generations, default :data:`CKPT_KEEP`). Params and optimizer state
    publish in the same generation.

    → ``path``/``name``/``step``, ``bytes`` written, ``write_retries``
    absorbed, ``corrupted`` (the injected rot, when it fired) and the
    ``pruned`` generation names.
    """
    if keep is None:
        keep = CKPT_KEEP
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(path, exist_ok=True)
    # Sweep leftovers from crashed saves (one writer owns a dir).
    for name in os.listdir(path):
        if name.startswith((".tmp-gen-", ".stale-gen-")):
            shutil.rmtree(os.path.join(path, name), ignore_errors=True)

    session = _io_session(step)
    name = _gen_name(step)
    tmp = os.path.join(path, f".tmp-gen-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)

    files: Dict[str, bytes] = {}
    arrays_manifest: Dict[str, dict] = {}
    with _pool() as pool:
        npz, meta, records = _params_payload(params, step, pool)
        files["params.npz"] = npz
        files[_META] = json.dumps(meta).encode()
        arrays_manifest["params.npz"] = records
        if opt_state is not None:
            onpz, ometa, orecords = _opt_payload(opt_state, step, pool)
            files["opt_state.npz"] = onpz
            files[_OPT_META] = json.dumps(ometa).encode()
            arrays_manifest["opt_state.npz"] = orecords
        if sched_meta is not None:
            files[_SCHED_META] = json.dumps(sched_meta).encode()
        # The files hash while they are written; the manifest (which
        # covers every sibling file, and goes last) waits for them.
        digests = _start(pool, _digest, files)
        for fname in ("params.npz", _META, "opt_state.npz", _OPT_META,
                      _SCHED_META):
            if fname in files:
                _write_file(session, os.path.join(tmp, fname),
                            files[fname])
        manifest = {
            "format": _GEN_FORMAT,
            "step": int(step),
            "files": {fname: {"sha256": digest, "bytes": len(files[fname])}
                      for fname, digest in digests().items()},
            "arrays": arrays_manifest,
        }
    _write_file(session, os.path.join(tmp, MANIFEST),
                json.dumps(manifest, indent=1).encode())
    _fsync_dir(tmp)

    final = os.path.join(path, name)
    if os.path.exists(final):
        # Republishing a step (a resumed run re-reaching a save point):
        # the stale dir moves aside so the rename stays atomic.
        aside = os.path.join(path,
                             f".stale-gen-{uuid.uuid4().hex[:8]}")
        os.rename(final, aside)
        os.rename(tmp, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _fsync_dir(path)

    # LATEST moves only after the publish, through the same writer.
    latest_tmp = os.path.join(path, LATEST + ".tmp")
    _write_file(session, latest_tmp, (name + "\n").encode())
    os.replace(latest_tmp, os.path.join(path, LATEST))
    _fsync_dir(path)

    corrupted = _maybe_corrupt_published(session, final)

    pruned: List[str] = []
    for _s, old in list_generations(path)[keep:]:
        shutil.rmtree(os.path.join(path, old), ignore_errors=True)
        pruned.append(old)

    return {"path": final, "name": name, "step": int(step),
            "bytes": session["bytes"],
            "write_retries": session["retries"],
            "corrupted": corrupted, "pruned": pruned}
