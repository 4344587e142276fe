"""Checkpoint save and load with ``latest``-tag semantics, crash-safe.

Port of ``deepspeed_tpu/runtime/checkpointing.py``. Its semantics are
kept; its format is the port's own, since orbax cannot be read without
JAX. A tag directory holds:

- ``state/params.pt``, ``state/optimizer.pt``, ``state/engine.pt``
  (``torch.save``): the master parameters, the optimizer state, and the
  engine's own state (the applied-step counter, the loss-scale state, the
  generator's state with its device type, the curriculum's state);
- ``ds_meta.json``: the step counters, precision and ``client_state``;
- ``ds_manifest.json``: every other file's size and CRC32.

Crash consistency, as in the JAX package:

- a save stages the whole tag under ``<tag>.building`` and commits it by
  one directory rename (an existing tag is first moved aside to
  ``<tag>.old``), so a crash before the commit leaves no visible tag;
- the ``latest`` pointer is replaced atomically (tmp file, fsync,
  ``os.replace``, directory fsync): until it lands, every loader still
  resolves the previous checkpoint;
- :func:`validate_tag` checks every file against the manifest, and an
  implicit load (no ``tag``) whose ``latest`` is missing or invalid walks
  back to the newest valid tag; an explicit ``tag`` is never substituted;
  ``strict=True`` raises :class:`CheckpointError` where a non-strict load
  warns and returns ``(None, {})``;
- the ``checkpoint.pre_commit`` and ``checkpoint.commit`` fault sites
  (``utils/faults.py``) fire just before and just after the commit.

Across ranks (a mesh of more than one rank) every rank writes the pieces
it is the first dp rank to hold into ``state/pieces_rank<r>.pt``: per
leaf its path, start and stop per dim, and the slice (this rank's store
box of each parameter, its update box of each optimizer-state leaf), as
the JAX package's host optimizer exports its ``shard_export`` pieces; a
tensor-parallel qkv's pieces carry their column map, and every
consolidation puts the columns back in JAX's order.
After a barrier rank 0 writes ``state/optimizer_rest.pt`` (the optimizer
state's counters and any leaf no parameter shapes), ``engine.pt``,
``ds_meta.json`` (with the true ``dp_world_size``), the manifest, the
commit rename and ``latest``; the tag is staged under ``<tag>.building``
at every world size (the port's layer owns its barrier). A checkpoint
loads at any world size and ZeRO stage: each rank assembles its own
boxes from the pieces (or cuts them from a one-process checkpoint's
whole trees), and :func:`load_fp32_state_dict_from_zero_checkpoint`
consolidates the pieces without an engine.

The state files are read with ``torch.load(weights_only=True,
mmap=True)`` and must match the engine's trees: the same leaves, each of
the engine's global shape and dtype (whatever the world size that saved
them), or the load raises :class:`CheckpointError`. The flat 16-bit model file (:func:`write_16bit_model`) is the
JAX package's npz format exactly, so either package reads the other's.
"""

import json
import os
import shutil
import zlib
from dataclasses import asdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.parallel.tensor import cut as cut_columns
from deepspeed_tpu_torch.parallel.tensor import same_columns
from deepspeed_tpu_torch.tree import tree_paths
from deepspeed_tpu_torch.utils.faults import maybe_fire
from deepspeed_tpu_torch.utils.logging import logger

LATEST_FILE = "latest"
META_FILE = "ds_meta.json"
MANIFEST_FILE = "ds_manifest.json"
STATE_DIR = "state"
PARAMS_FILE = "params.pt"
OPTIMIZER_FILE = "optimizer.pt"
ENGINE_FILE = "engine.pt"
PIECES_FILE = "pieces_rank{}.pt"          # across ranks: one per rank
OPT_REST_FILE = "optimizer_rest.pt"      # across ranks: rank 0's
_BUILD_SUFFIX = ".building"   # staged (uncommitted) tag directory
_OLD_SUFFIX = ".old"          # a displaced previous tag during overwrite


class CheckpointError(RuntimeError):
    """No loadable checkpoint (missing or corrupt with ``strict=True``), or
    one whose trees do not match the engine's."""


def _root(save_dir: str) -> str:
    return os.path.abspath(os.path.expanduser(save_dir))


def _tag_dir(save_dir: str, tag: str) -> str:
    return os.path.join(_root(save_dir), str(tag))


def _fsync_dir(path: str) -> None:
    """Persist a directory entry (a rename) to disk."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return   # a filesystem without directory open support
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _atomic_write_text(path: str, text: str) -> None:
    """Replace ``path`` atomically and durably: tmp + fsync + rename +
    parent fsync. Readers see the old or the new content, never a torn
    one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path) or ".")


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _write_manifest(tag_path: str, tag: str) -> None:
    """Record every payload file's size and CRC32, so that a partial
    write or bit rot is found at load time."""
    files: Dict[str, Dict[str, int]] = {}
    for root, _dirs, names in os.walk(tag_path):
        for name in names:
            fp = os.path.join(root, name)
            rel = os.path.relpath(fp, tag_path)
            if rel == MANIFEST_FILE:
                continue
            files[rel] = {"bytes": os.path.getsize(fp),
                          "crc32": _file_crc32(fp)}
    _atomic_write_text(os.path.join(tag_path, MANIFEST_FILE),
                       json.dumps({"tag": tag, "files": files}, indent=1,
                                  sort_keys=True))


def validate_tag(load_dir: str, tag: str) -> bool:
    """True when the tag directory exists and every file its manifest
    lists has the recorded size and CRC32. A tag without a manifest
    validates on the presence of its state directory."""
    path = _tag_dir(load_dir, str(tag))
    if not os.path.isdir(path):
        return False
    man = os.path.join(path, MANIFEST_FILE)
    if not os.path.isfile(man):
        return os.path.isdir(os.path.join(path, STATE_DIR))
    try:
        with open(man) as f:
            entries = json.load(f)["files"]
    except (OSError, ValueError, KeyError):
        return False
    for rel, info in entries.items():
        fp = os.path.join(path, rel)
        if not os.path.isfile(fp):
            return False
        if os.path.getsize(fp) != info.get("bytes"):
            return False
        if _file_crc32(fp) != info.get("crc32"):
            return False
    return True


def list_tags(load_dir: str) -> List[str]:
    """Tag directories under ``load_dir``, newest first (directory mtime).
    Staged ``.building`` and displaced ``.old`` directories are never
    candidates."""
    root = _root(load_dir)
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        p = os.path.join(root, name)
        if not os.path.isdir(p) or name.startswith(".") \
                or name.endswith(_BUILD_SUFFIX) or name.endswith(_OLD_SUFFIX):
            continue
        out.append((os.path.getmtime(p), name))
    return [name for _mt, name in sorted(out, reverse=True)]


def get_latest_tag(load_dir: str) -> Optional[str]:
    latest_path = os.path.join(_root(load_dir), LATEST_FILE)
    if os.path.isfile(latest_path):
        with open(latest_path) as f:
            return f.read().strip()
    return None


def _save(obj, path: str) -> None:
    torch.save(obj, path)
    _fsync_file(path)


def _opt_layouts(opt_state, layouts: Dict[str, Any]):
    """(path, leaf, layout or None) of every optimizer-state leaf: a
    tensor leaf whose path ends in a parameter's path (``mu/<param>``)
    takes that parameter's layout."""
    for path, leaf in tree_paths(opt_state):
        parts = path.split("/")
        lay = next((layouts[p] for p in ("/".join(parts[i:])
                                         for i in range(1, len(parts)))
                    if p in layouts), None)
        yield path, leaf, lay if isinstance(leaf, torch.Tensor) else None


def _piece(path: str, box, t: torch.Tensor, columns=None) -> Dict:
    """One saved slice: its box in the stored order of the leaf, and the
    leaf's column map where that order is not JAX's (a tensor-parallel
    qkv: ``parallel/tensor.py``)."""
    out = {"path": path, "start": [b.start for b in box],
           "stop": [b.stop for b in box], "tensor": t.detach().cpu()}
    if columns is not None:
        out["columns"] = columns
    return out


def _ranked(engine) -> bool:
    """Whether the engine is one of several ranks."""
    return engine.mesh.size > 1


def _engine_state(engine) -> Dict:
    sched = engine.curriculum_scheduler
    return {"step_count": engine.step_count,
            "scale_state": asdict(engine.scale_state),
            "rng_state": engine.rng.get_state(),
            "rng_device": engine.rng.device.type,
            "curriculum": None if sched is None else sched.get_state()}


def _save_pieces(engine, state_dir: str) -> None:
    """This rank's pieces (the boxes it is the first dp rank to hold);
    rank 0 adds the optimizer state's other leaves."""
    zero = engine._zero
    lays = {lay.path: lay for lay in zero.flat}
    pieces = {"params": [], "optimizer": []}
    for (path, t), lay, own in zip(tree_paths(engine.params), zero.flat,
                                   zero.owners("store")):
        if own:
            pieces["params"].append(_piece(path, lay.store_box, t,
                                           lay.stored_columns))
    owners = dict(zip((lay.path for lay in zero.flat),
                      zero.owners("update")))
    rest = {}
    for path, leaf, lay in _opt_layouts(engine.opt_state, lays):
        if lay is not None:
            if owners[lay.path]:
                pieces["optimizer"].append(_piece(path, lay.update_box,
                                                  leaf, lay.stored_columns))
        else:
            rest[path] = leaf.detach().cpu() \
                if isinstance(leaf, torch.Tensor) else leaf
    _save(pieces, os.path.join(state_dir,
                               PIECES_FILE.format(engine.mesh.rank)))
    if engine.mesh.rank == 0:
        _save(rest, os.path.join(state_dir, OPT_REST_FILE))


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None,
                    save_latest: bool = True) -> bool:
    """Write the engine's state under ``save_dir/<tag>`` (default tag
    ``global_step<N>``) and point ``latest`` at it. A crash at any point
    leaves the previous checkpoint loadable. Across ranks every rank
    calls it (see the module docstring)."""
    from deepspeed_tpu_torch.utils.distributed import barrier
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    tag = str(tag)
    save_root = _root(save_dir)
    final_path = _tag_dir(save_dir, tag)
    path = final_path + _BUILD_SUFFIX
    state_dir = os.path.join(path, STATE_DIR)
    ranked = _ranked(engine)
    lead = not ranked or engine.mesh.rank == 0
    if lead:
        if os.path.exists(path):
            shutil.rmtree(path)   # left by an earlier save that crashed
        os.makedirs(state_dir)
    if ranked:
        barrier()
        _save_pieces(engine, state_dir)
    else:
        _save(engine.params, os.path.join(state_dir, PARAMS_FILE))
        _save(engine.opt_state, os.path.join(state_dir, OPTIMIZER_FILE))
    if lead:
        _save(_engine_state(engine), os.path.join(state_dir, ENGINE_FILE))
    if ranked:
        barrier()   # every rank's pieces are down
    if lead:
        meta = {
            "tag": tag,
            "global_steps": engine.global_steps,
            "global_samples": engine.global_samples,
            "micro_steps": engine.micro_steps,
            "skipped_steps": engine.skipped_steps,
            "zero_stage": engine.config.zero.stage,
            "precision": engine.config.precision_name,
            "dp_world_size": engine.dp_world_size,
            "pieces": engine.mesh.size if ranked else 0,
            "client_state": client_state or {},
        }
        _atomic_write_text(os.path.join(path, META_FILE),
                           json.dumps(meta, indent=2, default=str))
        # the manifest last: it attests every file above
        _write_manifest(path, tag)
        _commit(save_root, path, final_path, tag, save_latest)
    if ranked:
        barrier()   # the tag is committed before any rank goes on
    logger.info(f"saved checkpoint {tag} to {final_path}")
    return True


def _commit(save_root: str, path: str, final_path: str, tag: str,
            save_latest: bool) -> None:
    """The staged tag's rename into place, then ``latest``."""
    # a crash here leaves only the staged directory, which no loader sees
    maybe_fire("checkpoint.pre_commit")
    displaced = None
    if os.path.exists(final_path):
        # a rename cannot replace a non-empty directory: move the old tag
        # aside first (a crash leaves old-aside + new or old in place,
        # both valid states for validation and the walk-back)
        displaced = final_path + _OLD_SUFFIX
        if os.path.exists(displaced):
            shutil.rmtree(displaced)
        os.rename(final_path, displaced)
    os.rename(path, final_path)
    _fsync_dir(save_root)
    if displaced is not None:
        shutil.rmtree(displaced)
    # a crash here leaves the tag durable and `latest` on the previous one
    maybe_fire("checkpoint.commit")
    if save_latest:
        _atomic_write_text(os.path.join(save_root, LATEST_FILE), tag)


def _resolve_tag(load_dir: str, tag: Optional[str], strict: bool
                 ) -> Optional[str]:
    """The tag to load: ``tag`` if it validates, else (implicit load) the
    newest valid tag; None after a warning, or CheckpointError under
    ``strict``."""
    def fail(msg):
        if strict:
            raise CheckpointError(msg)
        logger.warning(msg)
        return None

    requested = tag
    if tag is None:
        tag = get_latest_tag(load_dir)
        if tag is None:
            return fail(f"Unable to find latest file at {load_dir}/"
                        f"{LATEST_FILE}, if trying to load latest checkpoint "
                        f"please pass a valid tag")
    if validate_tag(load_dir, tag):
        return tag
    if requested is not None:
        return fail(f"checkpoint {tag} at {load_dir} is missing or fails "
                    f"manifest validation")
    fallback = next((t for t in list_tags(load_dir)
                     if t != tag and validate_tag(load_dir, t)), None)
    if fallback is None:
        return fail(f"latest checkpoint {tag} at {load_dir} is invalid and "
                    f"no valid tag remains")
    logger.warning(f"latest checkpoint {tag} at {load_dir} is missing or "
                   f"corrupt; walking back to newest valid tag {fallback}")
    return fallback


def _load(path: str) -> Any:
    """A state file on the host, its tensors read as they are used."""
    return torch.load(path, weights_only=True, map_location="cpu",
                      mmap=True)


class _Leaves:
    """A checkpoint's leaves cut to any box: from its pieces (a save
    across ranks) or from its whole trees (one process)."""

    def __init__(self, state_dir: str, meta: Dict):
        self.pieces: Dict[Tuple[str, str], List[Dict]] = {}
        self.rest: Dict[str, Any] = {}    # the leaves that are no tensor
        self._natural: Dict[Tuple[str, str], torch.Tensor] = {}
        n = int(meta.get("pieces", 0))
        if n:
            for r in range(n):
                got = _load(os.path.join(state_dir, PIECES_FILE.format(r)))
                for kind, items in got.items():
                    for it in items:
                        self.pieces.setdefault((kind, it["path"]),
                                               []).append(it)
            whole = {"optimizer": _load(os.path.join(state_dir,
                                                     OPT_REST_FILE)).items()}
        else:
            whole = {kind: tree_paths(_load(fp))
                     for kind, fp in (
                         ("params", os.path.join(state_dir, PARAMS_FILE)),
                         ("optimizer", os.path.join(state_dir,
                                                    OPTIMIZER_FILE)))
                     if os.path.isfile(fp)}
        for kind, pairs in whole.items():
            for path, leaf in pairs:
                if isinstance(leaf, torch.Tensor):
                    self.pieces[(kind, path)] = [_piece(
                        path, _full_box(leaf.shape), leaf)]
                else:
                    self.rest[path] = leaf

    def shape(self, kind: str, path: str) -> Tuple[int, ...]:
        items = self.pieces[(kind, path)]
        return tuple(max(it["stop"][d] for it in items)
                     for d in range(len(items[0]["stop"])))

    def paths(self, kind: str) -> List[str]:
        return [p for k, p in self.pieces if k == kind]

    def cut(self, kind: str, path: str, box, shape, like: torch.Tensor,
            what: str, columns=None) -> torch.Tensor:
        """The checkpoint's ``box`` of leaf ``path``, whose global shape
        in the engine is ``shape``, as a tensor of ``like``'s dtype and
        device; CheckpointError where the leaf is missing, of another
        global shape or dtype, or not covered. ``box`` is in the order of
        ``columns`` (the engine's column map of the leaf; None: JAX's):
        where the checkpoint's pieces hold another order, the leaf is
        assembled whole in JAX's order once and cut from there."""
        items = self.pieces.get((kind, path))
        if items is None:
            raise CheckpointError(f"{what}: not in the checkpoint")
        held_cols = items[0].get("columns")
        if not same_columns(held_cols, columns):
            key = (kind, path)
            if key not in self._natural:
                whole = self.cut(kind, path, _full_box(shape), shape,
                                 torch.empty(0, dtype=like.dtype), what,
                                 held_cols)
                self._natural[key] = whole if held_cols is None else \
                    whole.index_select(-1, torch.argsort(held_cols))
            return cut_columns(self._natural[key], box,
                               columns).to(like.device)
        held = (self.shape(kind, path), items[0]["tensor"].dtype)
        if held != (tuple(shape), like.dtype):
            raise CheckpointError(
                f"{what}: the checkpoint holds {held}, the engine "
                f"{(tuple(shape), like.dtype)}")
        out = torch.empty([b.stop - b.start for b in box], dtype=like.dtype)
        covered = 0
        for it in items:
            lo = [max(b.start, s0) for b, s0 in zip(box, it["start"])]
            hi = [min(b.stop, s1) for b, s1 in zip(box, it["stop"])]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = tuple(slice(a - s0, b - s0)
                        for a, b, s0 in zip(lo, hi, it["start"]))
            if lo == [b.start for b in box] and hi == [b.stop for b in box]:
                # one piece holds the whole box: no staging copy
                return it["tensor"][src].to(like.device)
            dst = tuple(slice(a - b0.start, b - b0.start)
                        for a, b, b0 in zip(lo, hi, box))
            out[dst] = it["tensor"][src]
            covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
        if covered != out.numel():
            raise CheckpointError(f"{what}: the checkpoint's pieces cover "
                                  f"{covered} of {out.numel()} entries")
        return out.to(like.device)


def _full_box(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, d) for d in shape)


def _set_path(tree: Dict, path: str, value) -> None:
    *head, last = path.split("/")
    for k in head:
        tree = tree[k]
    tree[last] = value


def _no_extra(what: str, held, wanted) -> None:
    extra = sorted(set(held) - set(wanted))
    if extra:
        raise CheckpointError(f"{what}: the checkpoint holds {extra}, which "
                              f"the engine lacks")


@torch.no_grad()
def _restore_boxes(engine, leaves: _Leaves, load_optimizer_states: bool
                   ) -> None:
    """The engine's boxes (its store boxes of the parameters, its update
    boxes of the optimizer state: whole leaves but where ZeRO splits them
    across ranks) from the checkpoint, which must hold the engine's
    leaves and no other."""
    lays = {lay.path: lay for lay in engine._zero.flat}
    _no_extra("params", leaves.paths("params"), lays)
    for path, t in tree_paths(engine.params):
        lay = lays[path]
        t.copy_(leaves.cut("params", path, lay.store_box, lay.shape, t,
                           f"params/{path}", lay.stored_columns))
    if not load_optimizer_states:
        return
    opt = list(_opt_layouts(engine.opt_state, lays))
    _no_extra("optimizer state",
              leaves.paths("optimizer") + list(leaves.rest),
              [path for path, _, _ in opt])
    for path, leaf, lay in opt:
        what = f"optimizer state/{path}"
        if lay is not None:
            leaf.copy_(leaves.cut("optimizer", path, lay.update_box,
                                  lay.shape, leaf, what,
                                  lay.stored_columns))
        elif isinstance(leaf, torch.Tensor):
            leaf.copy_(leaves.cut("optimizer", path, _full_box(leaf.shape),
                                  leaf.shape, leaf, what))
        elif path in leaves.rest:
            if type(leaves.rest[path]) is not type(leaf):
                raise CheckpointError(f"{what}: the checkpoint holds "
                                      f"{leaves.rest[path]!r}, the engine "
                                      f"{leaf!r}")
            _set_path(engine.opt_state, path, leaves.rest[path])
        else:
            raise CheckpointError(f"{what}: not in the checkpoint")


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    strict: bool = False):
    """Restore the engine's state from ``load_dir`` (``tag`` or the
    ``latest`` one). Returns ``(path, client_state)``, or ``(None, {})``
    when nothing loadable was found and ``strict`` is False. A checkpoint
    of any world size and ZeRO stage loads into an engine of any other
    (each rank takes its own boxes).

    ``load_optimizer_states=False`` keeps the engine's optimizer state
    (parameters, counters and the rest are loaded). The generator's state
    is restored on the device type that saved it; on another, the
    generator is reseeded from ``(seed, global_steps)`` and a warning
    says so."""
    tag = _resolve_tag(load_dir, tag, strict)
    if tag is None:
        return None, {}
    path = _tag_dir(load_dir, tag)
    state_dir = os.path.join(path, STATE_DIR)
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    _restore_boxes(engine, _Leaves(state_dir, meta), load_optimizer_states)
    es = _load(os.path.join(state_dir, ENGINE_FILE))
    from deepspeed_tpu_torch.runtime.loss_scaler import LossScaleState
    engine.step_count = int(es["step_count"])
    engine.scale_state = LossScaleState(**es["scale_state"])
    engine.global_steps = meta.get("global_steps", 0)
    engine.global_samples = meta.get("global_samples", 0)
    engine.micro_steps = meta.get("micro_steps", 0)
    engine.skipped_steps = meta.get("skipped_steps", 0)
    if es["rng_device"] == engine.rng.device.type:
        engine.rng.set_state(es["rng_state"])
    else:
        seed = engine.reseed_rng()
        logger.warning(
            f"checkpoint {tag} holds a {es['rng_device']} generator state "
            f"and this engine's generator is on {engine.rng.device.type}: "
            f"the state cannot move across device types, so the generator "
            f"was reseeded ({seed}, from the config seed and global_steps "
            f"{engine.global_steps}); everything else was loaded")
    if engine.curriculum_scheduler is not None and es["curriculum"]:
        engine.curriculum_scheduler.set_state(es["curriculum"])
    if engine.progressive_layer_drop is not None:
        engine.progressive_layer_drop.update_state(
            engine.global_steps - engine.skipped_steps)
    logger.info(f"loaded checkpoint {tag} from {path}")
    return path, meta.get("client_state", {})


# ---------------------------------------------------------------------------
# weights without an engine (the zero_to_fp32 tool of the reference)
# ---------------------------------------------------------------------------

def load_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                              tag: Optional[str] = None
                                              ) -> Dict:
    """The parameters of a checkpoint (``tag`` or ``latest``) as float32
    tensors on the host, without an engine; a save across ranks is
    consolidated from every rank's pieces."""
    if tag is None:
        tag = get_latest_tag(ckpt_dir)
        if tag is None:
            raise CheckpointError(f"no {LATEST_FILE} tag in {ckpt_dir}")
    path = _tag_dir(ckpt_dir, tag)
    state_dir = os.path.join(path, STATE_DIR)
    meta_path = os.path.join(path, META_FILE)
    meta = {}
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if not meta.get("pieces", 0) and \
            not os.path.isfile(os.path.join(state_dir, PARAMS_FILE)):
        raise CheckpointError(f"checkpoint {tag} at {ckpt_dir} has no "
                              f"{STATE_DIR}/{PARAMS_FILE}")
    leaves = _Leaves(state_dir, meta)
    tree: Dict = {}
    for kind, p in sorted(leaves.pieces):
        if kind != "params":
            continue
        shape = leaves.shape(kind, p)
        like = leaves.pieces[(kind, p)][0]["tensor"]
        t = leaves.cut(kind, p, _full_box(shape), shape, torch.empty(
            0, dtype=like.dtype), f"params/{p}")
        node = tree
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t.float() if t.is_floating_point() else t
    return tree


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict:
    return load_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)


# ---------------------------------------------------------------------------
# the flat 16-bit model file, the JAX package's npz format
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], key + "/")
        else:
            yield key, tree[k]


def write_16bit_model(params: Dict, save_dir: str,
                      save_filename: str = "model_weights.npz") -> str:
    """Save a parameter tree as one flat npz, keys the tree's paths joined
    by ``/``. bf16 leaves (which npz cannot hold) are stored as their
    uint16 bits and listed in ``__bf16_keys__``, as the JAX package's
    ``write_16bit_model`` stores them."""
    os.makedirs(save_dir, exist_ok=True)
    out, bf16_keys = {}, []
    for key, leaf in _flat(params):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            bf16_keys.append(key)
            a = t.view(torch.int16).numpy().view(np.uint16)
        else:
            a = t.numpy()
        out[key] = a
    out["__bf16_keys__"] = np.asarray(bf16_keys, dtype="U")
    path = os.path.join(save_dir, save_filename)
    np.savez(path, **out)
    return path


def load_16bit_model(path: str) -> Dict:
    """Inverse of :func:`write_16bit_model` (and of the JAX package's):
    a nested dict of host tensors, split on ``/``, bf16 leaves restored
    from their bits."""
    with np.load(path) as z:
        bf16 = set(z["__bf16_keys__"].tolist())
        tree: Dict = {}
        for k in z.files:
            if k == "__bf16_keys__":
                continue
            a = z[k]
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
                if k in bf16 else torch.from_numpy(a)
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return tree
