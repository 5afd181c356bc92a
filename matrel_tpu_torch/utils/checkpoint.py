"""Checkpoint / resume — the counterpart of
``matrel_tpu/utils/checkpoint.py`` (the RDD ``checkpoint()`` /
``persist()`` analogue).

Driver-level checkpoint-and-restart: named matrices, tensors and
block-sparse matrices persist per step with an atomic rename, and restore
into the same spec. The on-disk format is the JAX package's, so a step
written by either package restores in this one::

    <dir>/step_000000042.tmp/...  → atomic rename → <dir>/step_000000042/
        meta.json              (shapes, specs, dtypes, user state, sha1s)
        <name>.npy             (one file per matrix / tensor, whole)
        <name>.npz             (block-sparse: blocks, block_rows, block_cols)

bfloat16 has no numpy dtype without ``ml_dtypes``. The JAX package writes
an ``ml_dtypes`` bfloat16 array, which numpy stores as the raw 2-byte
void type ``|V2``; this package writes its bf16 tensors' 16-bit patterns
as the same ``|V2`` payload and reads any ``|V2`` payload back as
bfloat16, bit for bit. Each matrix's meta also records its ``dtype``
(an additive key the JAX reader ignores).

On one card a matrix's spec is the 1×1 (or virtual-grid) spec it
carries. On a rank mesh every rank calls :meth:`CheckpointManager.save`
(the whole matrix is gathered), rank 0 writes, and every rank's
:meth:`~CheckpointManager.restore` keeps its own block under the saved
spec.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh, P
from matrel_tpu_torch.resilience import faults as faults_lib
from matrel_tpu_torch.resilience.errors import CheckpointCorruption

#: numpy's spelling of a 2-byte payload with no numpy dtype: how numpy
#: stores an ``ml_dtypes`` bfloat16 array, and how this package stores
#: a bfloat16 tensor.
BF16_PAYLOAD = np.dtype("V2")


def tensor_to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the host array a checkpoint or disk-tier artifact
    stores: its numpy twin, or for bfloat16 the raw 16-bit patterns as
    ``|V2`` (bit-exact; no ``ml_dtypes`` needed)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return (t.contiguous().view(torch.int16).cpu().numpy()
                .view(BF16_PAYLOAD))
    return t.cpu().numpy()


def host_to_tensor(arr: np.ndarray,
                   device: Optional[torch.device] = None) -> torch.Tensor:
    """The inverse of :func:`tensor_to_host`. A ``|V2`` payload can only
    come from a bfloat16 array (this package's or ``ml_dtypes``'), so
    it is read as bfloat16 from its 16-bit pattern; an ``ml_dtypes``
    bfloat16 array in memory is taken the same way."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == BF16_PAYLOAD or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t if device is None else t.to(device)


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype as numpy spells it ("float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _file_sha1(path: str) -> str:
    """Streamed sha1 of one artifact file — the stored checksum the
    restore path verifies (a torn write, a flipped bit or a truncated
    copy fails typed, never hands back silently-corrupt values)."""
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify_file(d: str, fname: str, meta: Dict[str, Any]) -> str:
    """Path of one checkpoint artifact, checksum-verified when the
    metadata carries one (checkpoints without checksums load
    unverified)."""
    path = os.path.join(d, fname)
    want = (meta.get("checksums") or {}).get(fname)
    if want is not None:
        if not os.path.exists(path):
            raise CheckpointCorruption(
                f"checkpoint artifact {fname} missing from {d}")
        got = _file_sha1(path)
        if got != want:
            raise CheckpointCorruption(
                f"checkpoint artifact {fname} failed its checksum "
                f"(stored {want[:12]}…, computed {got[:12]}…) — "
                f"refusing to restore corrupt data from {d}")
    return path


def _check_name(name: str) -> None:
    """Entry names become file names inside the step directory: a
    separator (or '..') would crash the save or escape the directory."""
    if (not name or name in (".", "..") or "/" in name or "\\" in name
            or "\x00" in name or os.sep in name):
        raise ValueError(
            f"checkpoint entry name {name!r} is not a valid filename "
            f"component (no separators, '..', or NUL)")


def _spec_to_json(spec) -> list:
    out = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, (tuple, list)):
            out.append(list(part))
        else:
            out.append(part)
    return out


def _spec_from_json(parts: list) -> P:
    return P(*[tuple(p) if isinstance(p, list) else p for p in parts])


def split_catalog(catalog: Mapping[str, Any]
                  ) -> Tuple[Dict[str, BlockMatrix], Dict[str, Any], list]:
    """(dense, block_sparse, other names) of a session catalog: dense
    tables save as the format's matrices, block-sparse ones as its
    ``sparse`` entries; a COO table has no entry in the format."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    dense: Dict[str, BlockMatrix] = {}
    sparse: Dict[str, Any] = {}
    other = []
    for name, m in catalog.items():
        if isinstance(m, BlockMatrix):
            dense[name] = m
        elif isinstance(m, BlockSparseMatrix):
            sparse[name] = m
        else:
            other.append(name)
    return dense, sparse, sorted(other)


def _whole(bm: BlockMatrix) -> torch.Tensor:
    """The whole padded value of a matrix (gathered on a rank mesh —
    a collective every rank joins)."""
    if not bm.mesh.ranked:
        return bm.data
    from matrel_tpu_torch.parallel import collectives as coll
    return coll.gather_full(bm.as_shard(), bm.mesh)


def _writes(mesh: Optional[Mesh]) -> bool:
    """Does this process write the files (rank 0 of a rank mesh, or the
    one process of a card)?"""
    return mesh is None or not mesh.ranked or mesh.ranks.rank == 0


class CheckpointManager:
    """Writes / reads checkpoints of BlockMatrices, tensors, block-sparse
    matrices and a JSON state dict."""

    def next_step(self) -> int:
        """The step after the latest saved one (0 for an empty
        directory) — monotonic saves never collide with keep-k GC."""
        latest = self.latest_step()
        return 0 if latest is None else latest + 1

    def __init__(self, directory: str, keep: int = 2, config=None):
        self.directory = directory
        self.keep = keep
        # consulted only for the "checkpoint" fault site
        # (resilience/faults.py); None defers to default_config() at
        # check time, so an env-configured schedule reaches direct users
        self.config = config
        os.makedirs(directory, exist_ok=True)

    def _fault_check(self) -> None:
        cfg = self.config
        if cfg is None:
            from matrel_tpu_torch.config import default_config
            cfg = default_config()
        faults_lib.check("checkpoint", cfg)

    # -- save ---------------------------------------------------------------

    def save(self, step: int,
             matrices: Optional[Mapping[str, BlockMatrix]] = None,
             arrays: Optional[Mapping[str, Any]] = None,
             sparse: Optional[Mapping[str, Any]] = None,
             state: Optional[Dict[str, Any]] = None,
             mesh: Optional[Mesh] = None) -> str:
        """Write step ``step``. On a rank mesh (``mesh``, else the dense
        matrices' mesh) every rank calls it and rank 0 writes."""
        self._fault_check()
        matrices = dict(matrices or {})
        arrays = dict(arrays or {})
        sparse = dict(sparse or {})
        for name in (*matrices, *arrays, *sparse):
            _check_name(name)
        final = os.path.join(self.directory, f"step_{step:09d}")
        # every rank gathers (a collective); only the writer touches disk
        hosts = {name: tensor_to_host(_whole(bm))
                 for name, bm in matrices.items()}
        if mesh is None:
            mesh = next((bm.mesh for bm in matrices.values()), None)
        if not _writes(mesh):
            return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta: Dict[str, Any] = {"step": step, "state": state or {},
                                "matrices": {}, "arrays": [],
                                "sparse": {}, "checksums": {}}
        for name, bm in matrices.items():
            np.save(os.path.join(tmp, f"{name}.npy"), hosts[name])
            meta["matrices"][name] = {
                "shape": list(bm.shape), "spec": _spec_to_json(bm.spec),
                "nnz": bm.nnz, "block_size": bm.block_size,
                "dtype": dtype_name(bm.dtype),
            }
        for name, arr in arrays.items():
            host = (tensor_to_host(arr) if isinstance(arr, torch.Tensor)
                    else np.asarray(arr))
            np.save(os.path.join(tmp, f"{name}.npy"), host)
            meta["arrays"].append(name)
        for name, sm in sparse.items():
            np.savez(os.path.join(tmp, f"{name}.npz"),
                     blocks=tensor_to_host(sm.blocks),
                     block_rows=tensor_to_host(sm.block_rows),
                     block_cols=tensor_to_host(sm.block_cols))
            meta["sparse"][name] = {"shape": list(sm.shape),
                                    "block_size": sm.block_size,
                                    "dtype": dtype_name(sm.blocks.dtype)}
        # per-artifact checksums, computed after every write: restore
        # verifies each file it reads (CheckpointCorruption on mismatch)
        for fname in sorted(os.listdir(tmp)):
            meta["checksums"][fname] = _file_sha1(os.path.join(tmp, fname))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()
        return final

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, mesh: Mesh, step: Optional[int] = None
                ) -> Optional[Tuple[int, Dict[str, BlockMatrix],
                                    Dict[str, torch.Tensor],
                                    Dict[str, Any]]]:
        """(step, matrices, arrays, state), or None when the directory
        holds no step. Every artifact is checksum-verified against the
        metadata written at save time; a mismatch (or unparseable
        metadata) raises the typed ``CheckpointCorruption``."""
        got = self.restore_all(mesh, step)
        if got is None:
            return None
        step, matrices, _sparse, arrays, state = got
        return step, matrices, arrays, state

    def restore_all(self, mesh: Mesh, step: Optional[int] = None):
        """(step, matrices, block-sparse matrices, arrays, state) of one
        step under a single fault-site check, or None — what a session
        catalog restore reads (its tables may be dense or
        block-sparse)."""
        self._fault_check()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.directory, f"step_{step:09d}")
        meta = self._load_meta(d)
        matrices: Dict[str, BlockMatrix] = {}
        for name, m in meta["matrices"].items():
            host = np.load(_verify_file(d, f"{name}.npy", meta))
            spec = _spec_from_json(m["spec"])
            full = host_to_tensor(host, mesh.device)
            matrices[name] = BlockMatrix(
                data=BlockMatrix._place(full, mesh, spec),
                shape=tuple(m["shape"]), mesh=mesh, spec=spec,
                nnz=m["nnz"], block_size=m["block_size"])
        arrays = {name: host_to_tensor(
                      np.load(_verify_file(d, f"{name}.npy", meta)),
                      mesh.device)
                  for name in meta["arrays"]}
        return (meta["step"], matrices, self._sparse_of(d, meta, mesh),
                arrays, meta["state"])

    @staticmethod
    def _load_meta(d: str) -> Dict[str, Any]:
        """Parse one step's meta.json; corruption raises typed (the
        restore caller decides whether an older step will do)."""
        try:
            with open(os.path.join(d, "meta.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruption(
                f"checkpoint metadata unreadable in {d}: {e}") from e

    def restore_sparse(self, mesh: Mesh,
                       step: Optional[int] = None) -> Dict[str, Any]:
        """Restore the BlockSparseMatrix entries saved with
        ``save(sparse=...)``."""
        self._fault_check()
        if step is None:
            step = self.latest_step()
        if step is None:
            return {}
        d = os.path.join(self.directory, f"step_{step:09d}")
        return self._sparse_of(d, self._load_meta(d), mesh)

    @staticmethod
    def _sparse_of(d: str, meta: Dict[str, Any],
                   mesh: Mesh) -> Dict[str, Any]:
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        out = {}
        for name, m in meta.get("sparse", {}).items():
            z = np.load(_verify_file(d, f"{name}.npz", meta))
            out[name] = BlockSparseMatrix(
                blocks=host_to_tensor(z["blocks"], mesh.device),
                block_rows=host_to_tensor(z["block_rows"], mesh.device),
                block_cols=host_to_tensor(z["block_cols"], mesh.device),
                shape=tuple(m["shape"]), block_size=m["block_size"],
                mesh=mesh)
        return out

    # -- housekeeping -------------------------------------------------------

    def _steps(self):
        pat = re.compile(r"^step_(\d{9})$")
        out = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc(self):
        steps = self._steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)
