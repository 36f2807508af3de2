"""Manifest-sharded checkpoints on the LST object store.

The port of ``src/repro/train/checkpoints.py``. Every leaf of a tree of
dicts, lists and tuples (tensors, numpy arrays or Python scalars) is
written as its own object under ``ckpt/step-N/`` and a manifest records
each leaf's path, shape, dtype and key, and the tree's structure. The
objects and the manifest are byte-equal to the JAX package's for the same
tree, so a checkpoint written by either package restores in the other:

  * leaves go in the order JAX flattens them (dict keys sorted);
  * each ``key`` is ``jax.tree_util.keystr``'s text
    (``"[0]['layers']['attn']['wq']"``) and ``treedef`` is JAX's
    ``PyTreeDef`` text, rendered here for dict, list and tuple trees;
  * a bf16 leaf is written as its raw 16 bits under the name
    ``"bfloat16"`` and read back the same way, without ``ml_dtypes``; a
    Python int is ``np.asarray(int)``, ``"int64"``.

Saves may run on a host thread; the device-to-host copies are taken
before the thread starts, so a step that runs meanwhile cannot change
what is written. The manifest is written last (atomic publish), and
superseded checkpoints are deleted (``keep_last``).

Across ranks (an initialised process group of more than one rank) every
rank calls ``save`` and ``restore`` together. ``save`` gathers each
DTensor leaf's full tensor on every rank and writes once, from rank 0, the
bytes a one-device save of the same values writes. ``restore`` reads on
rank 0 and lays each leaf out from there: with ``shardings=`` (a tree of
``(mesh, placements)``, ``sharding.tree_shardings``'s) each leaf is
scattered onto that mesh, which need not be the saving job's (the
reference's elastic restore); a DTensor leaf of ``tree_like`` is laid out
as it is; any other leaf is broadcast.
"""

from __future__ import annotations

import io
import json
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.dist.sharding import is_dtensor
from repro_torch.lst.files import DataFile
from repro_torch.lst.storage import ObjectStore
from repro_torch.lst.table import LogStructuredTable
from repro_torch.models.common import tree_leaves, tree_unflatten


def _flatten_with_path(tree: Any, prefix: str = "") -> Tuple[list, str]:
    """``[(keystr, leaf), ...]`` in JAX's leaf order, and the text of the
    tree's ``PyTreeDef`` body."""
    if isinstance(tree, dict):
        out, parts = [], []
        for k in sorted(tree):
            sub, text = _flatten_with_path(tree[k], f"{prefix}[{k!r}]")
            out += sub
            parts.append(f"{k!r}: {text}")
        return out, "{" + ", ".join(parts) + "}"
    if isinstance(tree, (list, tuple)):
        out, parts = [], []
        for i, t in enumerate(tree):
            sub, text = _flatten_with_path(t, f"{prefix}[{i}]")
            out += sub
            parts.append(text)
        if isinstance(tree, list):
            return out, "[" + ", ".join(parts) + "]"
        return out, "(" + ", ".join(parts) + (",)" if len(parts) == 1
                                              else ")")
    return [(prefix, tree)], "*"


def _to_host(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy, even of a CPU
    tensor); a bf16 tensor as its raw bits (uint16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _leaf_from_bytes(raw: bytes, shape, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def _is_sharding(x) -> bool:
    return x is None or (isinstance(x, tuple) and len(x) == 2
                         and hasattr(x[0], "mesh_dim_names"))


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class CheckpointManager:
    def __init__(self, store: ObjectStore, prefix: str = "ckpt",
                 keep_last: int = 3,
                 table: Optional[LogStructuredTable] = None) -> None:
        self.store = store
        self.prefix = prefix
        self.keep_last = keep_last
        self.table = table           # optional LST registration for AutoComp
        self._async_thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        self.wait()                   # one in-flight async save at a time
        with_path, treedef = _flatten_with_path(tree)
        keys = [k for k, _ in with_path]
        # every rank gathers its DTensor leaves (a collective); rank 0 writes
        full = [leaf.full_tensor() if is_dtensor(leaf) else leaf
                for _, leaf in with_path]
        if collectives.ranked() and dist.get_rank() != 0:
            return
        # device->host now, before any thread: a later step cannot change it
        leaves = []
        for leaf in full:
            arr = _to_host(leaf)
            leaves.append((arr, _dtype_name(leaf, arr)))

        def do_save():
            base = f"{self.prefix}/step-{step:08d}"
            entries = []
            datafiles = []
            for i, (key, (arr, dtype)) in enumerate(zip(keys, leaves)):
                path = f"{base}/leaf-{i:05d}.npy"
                raw = np.ascontiguousarray(arr).tobytes()
                self.store.put(path, raw)
                entries.append({"path": path, "shape": list(arr.shape),
                                "dtype": dtype, "key": key})
                datafiles.append(DataFile(path=path, size_bytes=len(raw),
                                          num_rows=int(arr.size),
                                          partition=f"step-{step:08d}"))
            manifest = {"step": step, "leaves": entries,
                        "treedef": f"PyTreeDef({treedef})"}
            # manifest LAST -> atomic publish
            self.store.put(f"{base}/MANIFEST.json",
                           json.dumps(manifest).encode())
            if self.table is not None:
                self.table.append(datafiles)
            self.save_count += 1
            self._gc()

        if blocking:
            do_save()
        else:
            self._async_thread = threading.Thread(target=do_save, daemon=True)
            self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # --------------------------------------------------------------- restore
    def available_steps(self) -> List[int]:
        steps = []
        for p in self.store.list(self.prefix + "/"):
            if p.endswith("MANIFEST.json"):
                steps.append(int(p.split("step-")[1].split("/")[0]))
        return sorted(steps)

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None,
                partial_ok: bool = False) -> Tuple[Any, int]:
        """Restore into the structure of ``tree_like``; each leaf takes the
        dtype and device of ``tree_like``'s leaf (a tensor), or comes back
        as a CPU tensor where that leaf is a Python scalar or numpy array.

        Leaves are matched by key, so ``tree_like`` may order them
        differently. With ``partial_ok=True`` leaves of ``tree_like`` that
        are absent from the checkpoint keep their value (a run that
        switched to ``grad_transport="int8_ef"`` keeps its fresh zero
        residual), and checkpoint leaves absent from ``tree_like`` are
        dropped. Manifests without keys fall back to positional matching.

        ``shardings`` (a tree like ``tree_like`` of ``(mesh, placements)``
        or ``None`` leaves) lays each leaf out on a mesh, scattered from
        rank 0; a DTensor leaf of ``tree_like`` without one keeps its own
        layout. Across ranks every rank calls ``restore`` and rank 0 reads;
        an error there is raised on every rank.
        """
        with_path, _ = _flatten_with_path(tree_like)
        lay = [None] * len(with_path) if shardings is None else \
            tree_leaves(shardings, _is_sharding)
        if len(lay) != len(with_path):
            raise ValueError(f"shardings has {len(lay)} leaves, the tree "
                             f"{len(with_path)}")
        ranked = collectives.ranked()
        if ranked and dist.get_rank() != 0:
            return self._restore_from_rank0(tree_like, with_path, lay)
        try:
            step, matched = self._match(with_path, step, partial_ok)
        except (FileNotFoundError, KeyError, AssertionError) as e:
            if ranked:              # the other ranks raise it too
                dist.broadcast_object_list([e], 0)
            raise
        if ranked:
            dist.broadcast_object_list(
                [(step, [ent is not None for _, _, ent in matched])], 0)
        out = []
        for (key, ref, ent), sh in zip(matched, lay):
            ref_t = ref if isinstance(ref, torch.Tensor) \
                else torch.from_numpy(np.array(ref))
            if ent is None:                    # partial_ok: keep current value
                out.append(ref_t)
                continue
            arr = _leaf_from_bytes(self.store.get(ent["path"]),
                                   ent["shape"], ent["dtype"])
            out.append(self._lay_out(arr, ref_t, sh, ranked))
        return tree_unflatten(tree_like, out), step

    def _match(self, with_path, step, partial_ok) -> Tuple[int, list]:
        """The step to restore and ``(key, ref, manifest entry or None)``
        for each leaf of the tree."""
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError("no checkpoints available")
        step = steps[-1] if step is None else step
        base = f"{self.prefix}/step-{step:08d}"
        manifest = json.loads(self.store.get(f"{base}/MANIFEST.json"))
        ents = manifest["leaves"]
        if all("key" in e for e in ents):
            by_key = {e["key"]: e for e in ents}
            matched = [(k, ref, by_key.get(k)) for k, ref in with_path]
            missing = [k for k, _, e in matched if e is None]
            tree_keys = {k for k, _, _ in matched}
            extra = [k for k in by_key if k not in tree_keys]
            if (missing or extra) and not partial_ok:
                raise KeyError(
                    f"checkpoint step-{step} / tree mismatch: tree leaves "
                    f"missing from checkpoint {missing[:5]}, checkpoint "
                    f"leaves absent from tree {extra[:5]} (pass "
                    f"partial_ok=True to restore the intersection)")
        else:
            assert len(with_path) == len(ents), \
                f"leaf count mismatch: {len(with_path)} vs {len(ents)}"
            matched = [(k, ref, ent)
                       for (k, ref), ent in zip(with_path, ents)]
        for key, ref, ent in matched:
            shape = tuple(np.shape(ref))
            assert ent is None or tuple(ent["shape"]) == shape, \
                f"shape mismatch at leaf {key}: {ent['shape']} vs {shape}"
        return step, matched

    @staticmethod
    def _lay_out(arr: Optional[torch.Tensor], ref: torch.Tensor, sh,
                 ranked: bool):
        """One restored leaf (``arr`` on rank 0, ``None`` elsewhere) at
        ``ref``'s dtype: scattered to ``sh``'s placements, or to a DTensor
        ``ref``'s own; otherwise at ``ref``'s device, broadcast from rank
        0 across ranks."""
        from torch.distributed.tensor import distribute_tensor

        if sh is None and is_dtensor(ref):
            sh = (ref.device_mesh, tuple(ref.placements))
        if sh is not None:
            mesh, placements = sh
            dev = _mesh_device(mesh)
            full = torch.empty(ref.shape, dtype=ref.dtype, device=dev) \
                if arr is None else arr.to(device=dev, dtype=ref.dtype)
            return distribute_tensor(full, mesh, list(placements),
                                     src_data_rank=0)
        if arr is None:
            arr = torch.empty(ref.shape, dtype=ref.dtype, device=ref.device)
        else:
            arr = arr.to(device=ref.device, dtype=ref.dtype)
        return collectives.broadcast(arr) if ranked else arr

    def _restore_from_rank0(self, tree_like, with_path, lay):
        """A rank other than 0: take the step and the leaves that rank 0
        read, in its order."""
        got = [None]
        dist.broadcast_object_list(got, 0)
        if isinstance(got[0], BaseException):
            raise got[0]
        step, present = got[0]
        out = []
        for (_, ref), sh, here in zip(with_path, lay, present):
            ref_t = ref if isinstance(ref, torch.Tensor) \
                else torch.from_numpy(np.array(ref))
            out.append(self._lay_out(None, ref_t, sh, True) if here
                       else ref_t)
        return tree_unflatten(tree_like, out), step

    # -------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            base = f"{self.prefix}/step-{s:08d}"
            for p in self.store.list(base + "/"):
                self.store.delete(p)


def bundle_merge_fn(table: LogStructuredTable, task, out_path: str) -> DataFile:
    """Checkpoint-bundle compaction: pack many small leaf objects into one
    indexed blob (AutoComp merge_fn for checkpoint tables)."""
    index = {}
    blob = io.BytesIO()
    for f in task.inputs:
        raw = table.store.get(f.path)
        index[f.path] = [blob.tell(), len(raw)]
        blob.write(raw)
    payload = json.dumps(index).encode()
    head = len(payload).to_bytes(8, "little")
    table.store.put(out_path, head + payload + blob.getvalue())
    return DataFile(path=out_path,
                    size_bytes=8 + len(payload) + blob.tell(),
                    num_rows=sum(f.num_rows for f in task.inputs),
                    partition=task.scope, created_at=table.now_fn())
