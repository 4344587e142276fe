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

The state files are read with ``torch.load(weights_only=True)`` onto the
engine's device, and must match the engine's trees (keys, shapes,
dtypes). The flat 16-bit model file (:func:`write_16bit_model`) is the
JAX package's npz format exactly, so either package reads the other's.
"""

import json
import os
import shutil
import zlib
from dataclasses import asdict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.utils.faults import maybe_fire
from deepspeed_tpu_torch.utils.logging import logger

LATEST_FILE = "latest"
META_FILE = "ds_meta.json"
MANIFEST_FILE = "ds_manifest.json"
STATE_DIR = "state"
PARAMS_FILE = "params.pt"
OPTIMIZER_FILE = "optimizer.pt"
ENGINE_FILE = "engine.pt"
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


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None,
                    save_latest: bool = True) -> bool:
    """Write the engine's state under ``save_dir/<tag>`` (default tag
    ``global_step<N>``) and point ``latest`` at it. A crash at any point
    leaves the previous checkpoint loadable."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    tag = str(tag)
    save_root = _root(save_dir)
    final_path = _tag_dir(save_dir, tag)
    path = final_path + _BUILD_SUFFIX
    if os.path.exists(path):
        shutil.rmtree(path)   # left by an earlier save that crashed
    state_dir = os.path.join(path, STATE_DIR)
    os.makedirs(state_dir)

    _save(engine.params, os.path.join(state_dir, PARAMS_FILE))
    _save(engine.opt_state, os.path.join(state_dir, OPTIMIZER_FILE))
    sched = engine.curriculum_scheduler
    _save({"step_count": engine.step_count,
           "scale_state": asdict(engine.scale_state),
           "rng_state": engine.rng.get_state(),
           "rng_device": engine.rng.device.type,
           "curriculum": None if sched is None else sched.get_state()},
          os.path.join(state_dir, ENGINE_FILE))
    meta = {
        "tag": tag,
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.config.zero.stage,
        "precision": engine.config.precision_name,
        "dp_world_size": 1,
        "client_state": client_state or {},
    }
    _atomic_write_text(os.path.join(path, META_FILE),
                       json.dumps(meta, indent=2, default=str))
    # the manifest last: it attests every file above
    _write_manifest(path, tag)
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
    logger.info(f"saved checkpoint {tag} to {final_path}")
    return True


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


def _restore(dst, src, what: str):
    """``src`` (loaded) into ``dst`` (the engine's): tensors copied in
    place, other leaves taken from ``src``; raises CheckpointError where
    keys, shapes or dtypes differ."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or set(src) != set(dst):
            raise CheckpointError(
                f"{what}: the checkpoint holds "
                f"{sorted(src) if isinstance(src, dict) else type(src)}, "
                f"the engine {sorted(dst)}")
        return {k: _restore(dst[k], src[k], f"{what}/{k}") for k in dst}
    if isinstance(dst, torch.Tensor):
        if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
                or src.dtype != dst.dtype:
            got = (tuple(src.shape), src.dtype) \
                if isinstance(src, torch.Tensor) else type(src)
            raise CheckpointError(
                f"{what}: the checkpoint holds {got}, the engine "
                f"{(tuple(dst.shape), dst.dtype)}")
        dst.copy_(src)
        return dst
    if type(src) is not type(dst):
        raise CheckpointError(f"{what}: the checkpoint holds {src!r}, the "
                              f"engine {dst!r}")
    return src


def _load(path: str, device) -> Any:
    return torch.load(path, weights_only=True, map_location=device)


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None,
                    load_optimizer_states: bool = True,
                    strict: bool = False):
    """Restore the engine's state from ``load_dir`` (``tag`` or the
    ``latest`` one). Returns ``(path, client_state)``, or ``(None, {})``
    when nothing loadable was found and ``strict`` is False.

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
    device = engine.device
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)

    with torch.no_grad():
        _restore(engine.params, _load(os.path.join(state_dir, PARAMS_FILE),
                                      device), "params")
        if load_optimizer_states:
            engine.opt_state = _restore(
                engine.opt_state,
                _load(os.path.join(state_dir, OPTIMIZER_FILE), device),
                "optimizer state")
    es = _load(os.path.join(state_dir, ENGINE_FILE), "cpu")
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
    tensors on the host, without an engine."""
    if tag is None:
        tag = get_latest_tag(ckpt_dir)
        if tag is None:
            raise CheckpointError(f"no {LATEST_FILE} tag in {ckpt_dir}")
    path = os.path.join(_tag_dir(ckpt_dir, tag), STATE_DIR, PARAMS_FILE)
    if not os.path.isfile(path):
        raise CheckpointError(f"checkpoint {tag} at {ckpt_dir} has no "
                              f"{STATE_DIR}/{PARAMS_FILE}")
    params = _load(path, "cpu")

    def fp32(node):
        if isinstance(node, dict):
            return {k: fp32(v) for k, v in node.items()}
        return node.float() if node.is_floating_point() else node
    return fp32(params)


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
