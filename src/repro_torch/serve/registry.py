"""Versioned model registry: the lifecycle seam between training and
serving. The counterpart of ``repro.serve.registry``, on the same on-disk
registry: the index, the checkpoints and the lease files are the
reference's, so a version either package registers loads into the other,
and a lease a live process of either package holds makes the other's
``prune`` / ``sweep`` defer the tag.

Every training run is registered as an immutable VERSION: the fp32
parameter tree persisted through ``checkpoint/manager.py`` (atomic
write, content hashes, one ``step_<version>`` directory per version in
``<root>/ckpts``) plus JSON metadata — the CRONet config, the deployed
``u_scale``, the training load distribution (``fea.dataset.LoadCase``
descriptors), and the held-out eval metrics. The serving gateway
resolves params from here at engine build and hot-swaps between versions
(``TopoGateway.swap_model``); ``prune`` reclaims old versions while
``pin`` protects the ones serving may still swap back to.

Fleet operations (the per-bucket model lifecycle) add three notions:

  * MESH-SPECIALIZED versions — ``register(..., mesh=(nelx, nely))``
    marks a checkpoint as fine-tuned for one discretization (cf.
    FE-CNN-style per-discretization specialization). ``latest()``
    deliberately skips specialized versions — a mesh-specific fine-tune
    must never hijack the fleet default — while ``latest(mesh=...)``
    returns the newest version specialized for that mesh (or ``None``).
    ``ModelResolver`` packages the bucket-level lookup the gateway
    uses: mesh-specialized version if registered, else fleet default.
  * LEASES — a serving gateway ``acquire()``s every tag it is serving
    or canarying and ``release()``s it on swap/evict/shutdown.
    ``prune`` DEFERS leased versions (never deletes a live model, even
    an unpinned one); they become reclaimable once released.
  * PROMOTION metadata — ``promote(tag)`` stamps ``promoted_at`` when a
    canary graduates to a bucket's serving model, so the index records
    which versions ever carried production traffic.

The serving-data flywheel (the reference's serve/flywheel.py, not ported
yet) adds two more:

  * LINEAGE — ``register(..., parent=tag)`` records which version a
    fine-tuned child warm-started from; the retention ``sweep`` groups
    versions by ``(mesh, lineage root)`` and keeps the newest K per
    group (pinned + leased always kept), bounding the registry as the
    flywheel churns out per-bucket children.
  * GENERATION — a monotonic index-mutation counter; ``ModelResolver``
    invalidates its per-tag param cache when it moves, so a tag that
    was pruned and re-registered never serves stale weights out of an
    LRU hit.

Layout::

    <root>/registry.json          index: versions + metadata (atomic)
    <root>/ckpts/step_<version>/  one checkpoint per version (manager.py)
    <root>/leases/<h>.<pid>.json  cross-process lease mirrors (one per
                                  (tag, process); dead-pid files are
                                  stale and reaped on the next scan)

The index is the source of truth for metadata; the checkpoint manifest
remains the source of truth for array bytes (hash-verified on load).
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import param_shapes, resolve_device, torch_dtype
from repro_torch.configs.cronet import CRONetConfig

__all__ = ["ModelRecord", "ModelRegistry", "ModelResolver", "NoModelError"]

Mesh = Tuple[int, int]


class NoModelError(LookupError):
    """The registry has no version matching the request (or none at
    all — train and ``register()`` one first)."""


def cfg_to_dict(cfg: CRONetConfig) -> Dict:
    return dataclasses.asdict(cfg)


def cfg_from_dict(d: Dict) -> CRONetConfig:
    d = dict(d)
    for k in ("b_pool", "t_pool"):           # json round-trips tuples as lists
        if k in d:
            d[k] = tuple(d[k])
    return CRONetConfig(**d)


@dataclasses.dataclass(frozen=True)
class ModelRecord:
    """One registered checkpoint version (metadata only; ``load`` on the
    registry materializes the params)."""
    tag: str
    version: int                    # checkpoint step in <root>/ckpts
    cfg: CRONetConfig
    u_scale: float
    metrics: Dict                   # held-out eval (acceptance, mse, ...)
    load_cases: List[Dict]          # training distribution descriptors
    created_at: str
    pinned: bool = False
    mesh: Optional[Mesh] = None     # (nelx, nely) this version is
    #                                 specialized for; None = fleet-wide
    promoted_at: Optional[str] = None   # set when a canary graduates
    parent: Optional[str] = None    # lineage: the tag this version was
    #                                 fine-tuned from (flywheel children)

    def describe(self) -> Dict:
        d = dataclasses.asdict(self)
        d["cfg"] = cfg_to_dict(self.cfg)
        return d


class ModelRegistry:
    """Versioned CRONet checkpoint store with ``register`` / ``get`` /
    ``latest`` / ``load`` / ``pin`` / ``prune``. Thread-safe; the index
    write is atomic (tmp + rename), so a crashed register never corrupts
    the registry."""

    INDEX = "registry.json"
    LEASE_DIR = "leases"

    def __init__(self, root: str):
        self.root = root
        self.ckpt_dir = os.path.join(root, "ckpts")
        self.lease_dir = os.path.join(root, self.LEASE_DIR)
        self._lock = threading.RLock()
        self._leases: Dict[str, int] = {}   # tag -> live refcount
        self._generation = 0                # bumped on every index write

    # ------------------------------------------------------------- index

    def _read_index(self) -> Dict:
        path = os.path.join(self.root, self.INDEX)
        if not os.path.exists(path):
            return {"versions": []}
        with open(path) as f:
            return json.load(f)

    def _write_index(self, index: Dict):
        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, self.INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(index, f, indent=1)
        os.replace(tmp, os.path.join(self.root, self.INDEX))
        with self._lock:
            # every mutation funnels through here, so the generation
            # counter is a complete change signal for param caches
            # (ModelResolver invalidates on a generation mismatch —
            # a pruned-then-re-registered tag must never serve stale
            # params out of an LRU hit)
            self._generation += 1

    @property
    def generation(self) -> int:
        """Monotonic index-mutation counter (this process). Caches keyed
        by tag (``ModelResolver``) compare it to detect that a tag may
        have been re-registered, pruned, or had metadata re-stamped
        since their entries were filled."""
        with self._lock:
            return self._generation

    @staticmethod
    def _record(entry: Dict) -> ModelRecord:
        mesh = entry.get("mesh")
        return ModelRecord(
            tag=entry["tag"], version=int(entry["version"]),
            cfg=cfg_from_dict(entry["cfg"]),
            u_scale=float(entry["u_scale"]),
            metrics=entry.get("metrics") or {},
            load_cases=entry.get("load_cases") or [],
            created_at=entry.get("created_at", ""),
            pinned=bool(entry.get("pinned", False)),
            mesh=tuple(int(v) for v in mesh) if mesh else None,
            promoted_at=entry.get("promoted_at"),
            parent=entry.get("parent"))

    # ------------------------------------------------------------ queries

    def records(self) -> List[ModelRecord]:
        """All versions, oldest first."""
        with self._lock:
            entries = self._read_index()["versions"]
        return [self._record(e) for e in entries]

    def tags(self) -> List[str]:
        return [r.tag for r in self.records()]

    def get(self, tag: str) -> ModelRecord:
        for r in self.records():
            if r.tag == tag:
                return r
        raise NoModelError(
            f"no model tagged {tag!r} in registry {self.root} "
            f"(have {self.tags() or 'none'})")

    def latest(self, mesh: Optional[Mesh] = None) -> Optional[ModelRecord]:
        """The most recently registered version, or None when empty.

        Tie-breaking against mesh-specialized tags: with ``mesh=None``
        only FLEET-WIDE versions are considered — registering a
        mesh-specialized fine-tune must never change what the rest of
        the fleet serves (falls back to the newest version overall only
        when no fleet-wide version exists at all). With ``mesh=(nelx,
        nely)`` the newest version specialized for exactly that mesh is
        returned, or ``None`` — the caller (``ModelResolver``) owns the
        fall-back to the fleet default."""
        recs = self.records()
        if mesh is not None:
            mesh = (int(mesh[0]), int(mesh[1]))
            recs = [r for r in recs if r.mesh == mesh]
            return recs[-1] if recs else None
        fleet = [r for r in recs if r.mesh is None]
        if fleet:
            return fleet[-1]
        return recs[-1] if recs else None

    def __len__(self) -> int:
        return len(self.records())

    # ----------------------------------------------------------- mutation

    def register(self, params, cfg: CRONetConfig, u_scale: float, *,
                 tag: Optional[str] = None, metrics: Optional[Dict] = None,
                 load_cases: Optional[Sequence[Dict]] = None,
                 pin: bool = False,
                 mesh: Optional[Mesh] = None,
                 parent: Optional[str] = None) -> ModelRecord:
        """Persist ``params`` as a new immutable version (checkpoint
        write first, index update second — a crash in between leaves an
        orphan checkpoint, never a dangling index entry). ``mesh``
        marks the version as specialized for one ``(nelx, nely)``
        discretization: it is resolved only for that mesh's bucket
        (``latest(mesh=...)`` / ``ModelResolver``) and never becomes
        the fleet default. ``parent`` records lineage — the tag this
        version was fine-tuned from (``train_cronet.finetune_from_tag``
        stamps it) — which the retention ``sweep`` keep-policy groups
        on."""
        with self._lock:
            index = self._read_index()
            version = 1 + max((int(e["version"])
                               for e in index["versions"]), default=0)
            tag = tag if tag is not None else f"v{version}"
            if any(e["tag"] == tag for e in index["versions"]):
                raise ValueError(f"tag {tag!r} already registered "
                                 f"(versions are immutable)")
            extras = {"tag": tag, "u_scale": float(u_scale),
                      "cfg": cfg_to_dict(cfg)}
            ckpt.save(self.ckpt_dir, version, {"params": params},
                      extras=extras)
            entry = {"tag": tag, "version": version,
                     "cfg": cfg_to_dict(cfg), "u_scale": float(u_scale),
                     "metrics": dict(metrics or {}),
                     "load_cases": list(load_cases or []),
                     "created_at": datetime.datetime.now(
                         datetime.timezone.utc).isoformat(),
                     "pinned": bool(pin),
                     "mesh": ([int(mesh[0]), int(mesh[1])]
                              if mesh is not None else None),
                     "parent": parent}
            index["versions"].append(entry)
            self._write_index(index)
            return self._record(entry)

    def promote(self, tag: str) -> ModelRecord:
        """Stamp ``promoted_at`` on a version — called when a canary of
        this version graduates to a bucket's serving model, so the
        index records which checkpoints ever carried production
        traffic. Idempotent (keeps the first promotion time)."""
        with self._lock:
            index = self._read_index()
            for e in index["versions"]:
                if e["tag"] == tag:
                    if not e.get("promoted_at"):
                        e["promoted_at"] = datetime.datetime.now(
                            datetime.timezone.utc).isoformat()
                        self._write_index(index)
                    return self._record(e)
        raise NoModelError(f"no model tagged {tag!r} in {self.root}")

    def pin(self, tag: str, pinned: bool = True) -> ModelRecord:
        """(Un)pin a version: pinned versions survive ``prune``."""
        with self._lock:
            index = self._read_index()
            for e in index["versions"]:
                if e["tag"] == tag:
                    e["pinned"] = bool(pinned)
                    self._write_index(index)
                    return self._record(e)
        raise NoModelError(f"no model tagged {tag!r} in {self.root}")

    # ------------------------------------------------------------- leases
    #
    # Leases exist on two levels. The in-memory refcount map serves the
    # single-process case (gateway threads). With engine-worker
    # PROCESSES sharing one on-disk registry, each process additionally
    # mirrors its refcounts into one lease FILE per (tag, pid) under
    # ``<root>/leases/`` — ``prune``/``sweep`` in ANY process then defer
    # tags that OTHER live processes are serving. A file whose writer
    # pid is dead is stale (the process crashed before releasing) and is
    # reaped on the next scan, so a kill -9'd worker cannot pin a
    # version forever. All file I/O is best-effort: lease bookkeeping
    # runs on shutdown/crash paths that must never raise.

    def _lease_path(self, tag: str, pid: Optional[int] = None) -> str:
        pid = os.getpid() if pid is None else pid
        h = hashlib.sha1(tag.encode()).hexdigest()[:12]
        return os.path.join(self.lease_dir, f"{h}.{pid}.json")

    def _write_lease_file(self, tag: str, count: int):
        """Mirror this process's refcount for ``tag`` to disk (atomic
        tmp + replace; count <= 0 removes the file)."""
        try:
            path = self._lease_path(tag)
            if count <= 0:
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                return
            os.makedirs(self.lease_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"tag": tag, "pid": os.getpid(),
                           "count": int(count)}, f)
            os.replace(tmp, path)
        except OSError:
            pass

    @staticmethod
    def _pid_alive(pid: int) -> bool:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except (PermissionError, OSError):
            return True   # exists but owned elsewhere: alive
        return True

    def foreign_leases(self) -> Dict[str, int]:
        """Tags leased by OTHER live processes sharing this registry
        root (scanned from the lease files), with stale dead-pid files
        reaped as a side effect. This process's own leases are reported
        by ``leased()`` — the in-memory map is authoritative for them."""
        out: Dict[str, int] = {}
        try:
            names = os.listdir(self.lease_dir)
        except OSError:
            return out
        me = os.getpid()
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.lease_dir, name)
            try:
                with open(path) as f:
                    rec = json.load(f)
                tag, pid = rec["tag"], int(rec["pid"])
                count = int(rec.get("count", 1))
            except (OSError, ValueError, KeyError, TypeError):
                continue   # torn write mid-crash: ignore, never raise
            if pid == me:
                continue
            if not self._pid_alive(pid):
                try:
                    os.unlink(path)   # crashed holder: reap the lease
                except OSError:
                    pass
                continue
            out[tag] = out.get(tag, 0) + count
        return out

    def acquire(self, tag: str) -> ModelRecord:
        """Mark a version LIVE (being served or canaried): ``prune``
        defers it until every acquirer has ``release``d. Refcounted —
        a gateway serving a tag in three buckets acquires it three
        times. Raises ``NoModelError`` for an unknown tag (a lease on
        nothing would silently protect nothing). The refcount is
        mirrored to a per-process lease file so prune/sweep in OTHER
        processes sharing this root defer the tag too."""
        rec = self.get(tag)
        with self._lock:
            self._leases[tag] = self._leases.get(tag, 0) + 1
            self._write_lease_file(tag, self._leases[tag])
        return rec

    def release(self, tag: str):
        """Drop one live reference; unknown/over-released tags are
        ignored (release runs on shutdown paths that must not raise)."""
        with self._lock:
            n = self._leases.get(tag, 0) - 1
            if n > 0:
                self._leases[tag] = n
            else:
                self._leases.pop(tag, None)
            self._write_lease_file(tag, max(n, 0))

    def leased(self) -> Dict[str, int]:
        """Live tags and their refcounts (snapshot; THIS process only —
        see ``foreign_leases()`` for other processes on the same root)."""
        with self._lock:
            return dict(self._leases)

    def prune(self, keep: int = 3) -> List[str]:
        """Drop all but the newest ``keep`` versions; pinned versions
        are always kept (and don't count against ``keep``), and LEASED
        versions — currently served or canaried by some gateway — are
        DEFERRED, never deleted out from under live traffic (they
        become reclaimable once released). Returns the pruned tags."""
        with self._lock:
            index = self._read_index()
            foreign = self.foreign_leases()
            pinned = [int(e["version"]) for e in index["versions"]
                      if e.get("pinned") or self._leases.get(e["tag"])
                      or foreign.get(e["tag"])]
            removed = set(ckpt.prune_old(self.ckpt_dir, keep=keep,
                                         pinned=pinned))
            dropped = [e["tag"] for e in index["versions"]
                       if int(e["version"]) in removed]
            index["versions"] = [e for e in index["versions"]
                                 if int(e["version"]) not in removed]
            self._write_index(index)
            return dropped

    def _lineage_root(self, entries: List[Dict], tag: str) -> str:
        """Follow the ``parent`` chain to the oldest ancestor still in
        the index (cycle-safe: stops on a repeat or a pruned parent)."""
        by_tag = {e["tag"]: e for e in entries}
        seen = set()
        while tag in by_tag and tag not in seen:
            seen.add(tag)
            parent = by_tag[tag].get("parent")
            if not parent or parent not in by_tag:
                break
            tag = parent
        return tag

    def sweep(self, keep_per_lineage: int = 2) -> List[str]:
        """Retention keep-policy sweep: within each ``(mesh, lineage
        root)`` group, drop all but the newest ``keep_per_lineage``
        versions. Pinned and LEASED (serving/canarying) versions are
        always kept, exactly as in ``prune`` — so a flywheel churning
        out fine-tuned children per bucket keeps each bucket's recent
        history without growing the registry unboundedly, while the
        fleet-wide lineage (mesh=None) is retained independently.
        Returns the dropped tags."""
        with self._lock:
            index = self._read_index()
            entries = index["versions"]
            if not entries:
                return []
            groups: Dict[Tuple, List[Dict]] = {}
            for e in entries:
                mesh = tuple(e["mesh"]) if e.get("mesh") else None
                key = (mesh, self._lineage_root(entries, e["tag"]))
                groups.setdefault(key, []).append(e)
            foreign = self.foreign_leases()
            keep_versions = set()
            for e in entries:
                if e.get("pinned") or self._leases.get(e["tag"]) \
                        or foreign.get(e["tag"]):
                    keep_versions.add(int(e["version"]))
            for members in groups.values():
                # entries are index-ordered (oldest first): the newest K
                # UNPINNED/UNLEASED members — pinned and serving copies
                # don't consume retention slots, they ride on top
                free = [e for e in members
                        if int(e["version"]) not in keep_versions]
                for e in free[-max(0, int(keep_per_lineage)):]:
                    keep_versions.add(int(e["version"]))
            # keep=0 + pinned=keep_versions: prune_old deletes exactly
            # the complement of the keep set
            removed = set(ckpt.prune_old(self.ckpt_dir, keep=0,
                                         pinned=keep_versions))
            dropped = [e["tag"] for e in entries
                       if int(e["version"]) in removed]
            index["versions"] = [e for e in entries
                                 if int(e["version"]) not in removed]
            self._write_index(index)
            return dropped

    # -------------------------------------------------------------- load

    def load(self, tag: Optional[str] = None, dtype: str = "float32",
             device="cuda") -> Tuple[Dict, ModelRecord]:
        """Materialize a version's params (hash-verified restore through
        checkpoint/manager.py) as the port's ``Params`` on ``device`` (the
        card unless the caller asks for the CPU). ``tag=None`` loads the
        latest.

        ``dtype`` is the deploy cast: "float32" restores the training
        master weights, "bfloat16" the paper's deployment precision —
        the cast happens inside ``restore`` via the like-tree dtypes.
        """
        record = self.get(tag) if tag is not None else self.latest()
        if record is None:
            raise NoModelError(
                f"registry {self.root} is empty — train a surrogate and "
                f"register() it first")
        want = torch_dtype(dtype)
        like = {"params": {
            part: {name: torch.empty(shape, dtype=want, device="meta")
                   for name, shape in leaves.items()}
            for part, leaves in param_shapes(record.cfg).items()}}
        tree, _ = ckpt.restore(self.ckpt_dir, like, step=record.version,
                               device=device)
        return tree["params"], record


# ------------------------------------------------------------- resolution


def _same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name one device."""
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def check_device(params, device) -> None:
    """Raise ``ValueError`` unless every tensor of a (nested dict)
    parameter tree lies on ``device``."""
    dev = torch.device(device)
    for name, t in (params.items() if isinstance(params, dict) else ()):
        if isinstance(t, dict):
            check_device(t, dev)
        elif isinstance(t, torch.Tensor) and not _same_device(t.device, dev):
            raise ValueError(
                f"parameter {name!r} is on {t.device}, not on {dev}: load "
                f"the model onto the serving device instead of copying it")


class ModelResolver:
    """Registry-driven per-bucket model resolution: which checkpoint
    should serve mesh ``(nelx, nely)``?

      1. the newest version SPECIALIZED for that mesh
         (``register(..., mesh=...)``), if one is registered — the
         FE-CNN-style per-discretization fine-tune wins for its mesh;
      2. otherwise the fleet default: ``default_tag`` when given
         (usually the gateway's currently-served version, so a fleet
         rollout pins new buckets to it), else ``latest()``.

    ``resolve`` returns metadata only; ``load`` materializes the params
    through a small per-tag LRU cache (``cache_size`` param trees, the
    working set of fleet default + specialized + canary versions) so a
    pool rebuilding the same bucket (eviction / canary churn) does not
    re-read the checkpoint from disk each time — while a long-lived
    gateway cycling many rollouts does not pin every version it ever
    served in memory.

    Every tree it holds lies on ONE device, ``device`` (the card unless
    the caller asks for the CPU): ``load`` restores onto it and ``prime``
    refuses a tree on any other, so a gateway never serves weights that
    were silently copied across devices. The cached tensors are shared by
    every engine of a tag; nothing on the serving path writes into them.
    """

    def __init__(self, registry: ModelRegistry,
                 default_tag: Optional[str] = None,
                 cache_size: int = 8, device="cuda"):
        self.registry = registry
        self.default_tag = default_tag
        self.device = resolve_device(device)
        self.cache_size = max(1, cache_size)
        self._cache: "collections.OrderedDict[str, Tuple[object, ModelRecord]]" \
            = collections.OrderedDict()
        self._cache_gen = registry.generation   # index state cached against
        self._lock = threading.Lock()

    def _check_generation_locked(self):
        """Generation-checked invalidation (call with ``_lock`` held):
        the per-tag cache is only valid for the registry index it was
        filled against. A tag that was pruned and re-registered reuses
        its key with DIFFERENT params — without this check the LRU hit
        would keep serving the deleted version's weights forever."""
        gen = self.registry.generation
        if gen != self._cache_gen:
            self._cache.clear()
            self._cache_gen = gen

    def resolve(self, mesh: Optional[Mesh]) -> ModelRecord:
        """Best record for the bucket (metadata only). Raises
        ``NoModelError`` when neither a specialized version nor a fleet
        default exists."""
        rec = (self.registry.latest(mesh=mesh) if mesh is not None
               else None)
        if rec is not None:
            return rec
        if self.default_tag is not None:
            return self.registry.get(self.default_tag)
        rec = self.registry.latest()
        if rec is None:
            raise NoModelError(
                f"registry {self.registry.root} is empty — train a "
                f"surrogate and register() it first")
        return rec

    def _put(self, tag: str, params, record: ModelRecord):
        self._cache[tag] = (params, record)
        self._cache.move_to_end(tag)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    def prime(self, tag: str, params, record: ModelRecord):
        """Seed the cache with already-materialized params (the gateway
        loads its serving version at construction; resolving the same
        tag for a bucket must not re-read the checkpoint). Raises
        ``ValueError`` when a tensor of ``params`` lies on another device
        than the resolver's."""
        check_device(params, self.device)
        with self._lock:
            self._check_generation_locked()
            self._put(tag, params, record)

    def holds(self, tag: Optional[str], params) -> bool:
        """True iff ``params`` IS (identity, not equality) the cached
        param tree for ``tag``. The worker-mode gateway uses this to
        decide whether an engine spec may ship a ``registry_root``
        reference instead of the pickled tree: only when the params
        provably came from this resolver's registry read is a
        worker-side re-read guaranteed to reproduce them — an
        explicit-params pin under a registered tag must still travel by
        value or the bitwise contract breaks."""
        if tag is None:
            return False
        with self._lock:
            self._check_generation_locked()
            hit = self._cache.get(tag)
        return hit is not None and hit[0] is params

    def load(self, tag: str) -> Tuple[object, ModelRecord]:
        """Materialize a tag's params (LRU-cached per tag; the cache is
        invalidated wholesale whenever the registry index mutated since
        it was filled — see ``_check_generation_locked`` — so a
        re-registered or pruned tag never serves stale weights).
        Eviction only means a future load re-reads the checkpoint from
        disk."""
        with self._lock:
            self._check_generation_locked()
            hit = self._cache.get(tag)
            if hit is not None:
                self._cache.move_to_end(tag)
                return hit
            gen = self._cache_gen
        params, rec = self.registry.load(tag, device=self.device)
        with self._lock:
            self._check_generation_locked()
            if self._cache_gen == gen:
                # only cache a read that is provably from the index
                # state the cache tracks — a concurrent register/prune
                # during our disk read must not be masked by it
                self._put(tag, params, rec)
        return params, rec
