"""Registry and resolver of the ``DS_*`` environment flags.

Port of ``deepspeed_tpu/utils/env.py``: the same flag table (names,
kinds, defaults, choices and aliases) and the same parser, so a setting
means the same thing to both packages. An explicit value wins, then the
environment, then the declared default; the off spellings (``""``,
``off``, ``0``, ``false``, ``no``) and on spellings (``on``, ``1``,
``true``, ``yes``) are accepted, anything else raises ``ValueError``.

What the port does with each flag:

- resolved as in JAX: ``DS_KV_QUANT`` (``ops/quantizer.py``),
  ``DS_PREFIX_CACHE`` (``inference/paged_cache.py``), ``DS_SPEC_DECODE``,
  ``DS_SPEC_K`` and ``DS_SPEC_DRAFT`` (``inference/spec_decode.py``),
  ``DS_KV_HOST_TIER`` and ``DS_KV_HOST_BUDGET_MB``
  (``inference/host_tier.py``), ``DS_DECODE_HORIZON``
  (:func:`resolve_decode_horizon`), ``DS_TELEMETRY`` (``telemetry``),
  ``DS_COST_ACCOUNTING``, ``DS_FLIGHT_RECORDER`` and ``DS_FLIGHT_DIR``
  (``inference/serving.py``), ``DS_FAULTS`` and ``DS_FAULT_SEED``
  (``utils/faults.py``), ``DS_LORA_SERVE``, ``DS_LORA_POOL_MB``,
  ``DS_LORA_MAX_RANK`` and ``DS_LORA_RANK_BLOCK``
  (``inference/adapters.py``);
- checked, with no effect on the numbers or the kernels:
  ``DS_FLASH_WINDOW_IMPL`` (``ops/attention/flash.py
  resolve_window_impl``, for ring and Ulysses attention's windows, and
  ``GPTConfig.attn_window_impl``): an unknown value raises the JAX
  package's ``ValueError``; "banded" and "masked" both run the flash
  kernels' one windowed design (the JAX package's "masked" is a TPU
  compiler workaround that gives the same numbers);
- never read: ``DS_PAGED_DECODE_IMPL`` and ``DS_INT8_FUSED`` choose an
  implementation in the JAX package, and the port has no implementation
  switch (it dispatches by device).
"""

import os
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["Flag", "FLAGS", "MAX_DECODE_HORIZON", "resolve_flag",
           "resolve_decode_horizon", "flag_names"]

# the shared bool grammar every DS_* switch accepts; "" (unset) is off
TRUE_WORDS = ("on", "1", "true", "yes")
FALSE_WORDS = ("", "off", "0", "false", "no")


@dataclass(frozen=True)
class Flag:
    """One declared environment knob. ``kind`` selects the parser:
    ``bool``, ``int``, ``float``, ``str`` (stripped, verbatim) or
    ``choice`` (``aliases`` first, then checked against ``choices``).
    ``default`` is returned when the variable is unset or empty."""
    name: str
    kind: str
    default: object
    help: str
    choices: Tuple[str, ...] = ()
    aliases: Mapping[str, str] = field(default_factory=dict)


def _mk(name, kind, default, help, **kw) -> Tuple[str, Flag]:
    return name, Flag(name=name, kind=kind, default=default, help=help, **kw)


FLAGS: Dict[str, Flag] = dict([
    _mk("DS_TELEMETRY", "bool", False,
        "metrics/tracer/breakdown plane on the serving engine"),
    _mk("DS_PREFIX_CACHE", "bool", False,
        "shared-prefix KV cache with refcounted blocks and copy-on-write"),
    _mk("DS_SPEC_DECODE", "bool", False,
        "speculative serving (draft + k+1 verify per slot)"),
    _mk("DS_SPEC_DRAFT", "str", "ngram",
        "named drafter for speculative serving; 'ngram' is the only named "
        "one, model drafters pass an object"),
    _mk("DS_SPEC_K", "int", 4, "draft chunk length per speculative step"),
    _mk("DS_KV_QUANT", "choice", "off",
        "paged KV-cache block quantization",
        choices=("off", "int8"),
        aliases={"0": "off", "false": "off", "no": "off", "none": "off",
                 "on": "int8", "1": "int8", "true": "int8", "yes": "int8"}),
    _mk("DS_KV_HOST_TIER", "bool", False,
        "host-DRAM second tier for spilled KV blocks"),
    _mk("DS_KV_HOST_BUDGET_MB", "float", 256.0,
        "host-tier byte budget in MiB"),
    _mk("DS_PAGED_DECODE_IMPL", "str", None,
        "paged-decode implementation of the JAX package; not read here"),
    _mk("DS_FLASH_WINDOW_IMPL", "str", "banded",
        "windowed flash implementation of the JAX package ('banded'/"
        "'masked'); checked here, one design runs either way"),
    _mk("DS_INT8_FUSED", "bool", False,
        "fused int8 dense entries of the JAX package; not read here"),
    _mk("DS_LORA_SERVE", "bool", False,
        "multi-tenant LoRA adapter serving"),
    _mk("DS_LORA_POOL_MB", "float", 16.0,
        "device adapter-pool byte budget in MiB"),
    _mk("DS_LORA_MAX_RANK", "int", 16,
        "largest adapter rank the pool accepts"),
    _mk("DS_LORA_RANK_BLOCK", "int", 8,
        "rank granularity of one adapter-pool block"),
    _mk("DS_DECODE_HORIZON", "int", 1,
        "decode iterations fused into one dispatch"),
    _mk("DS_FAULTS", "str", "",
        "ambient fault spec 'site:kind@step[*count][~param];...'"),
    _mk("DS_FAULT_SEED", "int", 0,
        "seed for the ambient fault injector's backoff jitter"),
    _mk("DS_COST_ACCOUNTING", "bool", False,
        "per-dispatch analytic cost accounting"),
    _mk("DS_FLIGHT_RECORDER", "bool", False,
        "bounded flight recorder writing postmortem artifacts"),
    _mk("DS_FLIGHT_DIR", "str", "",
        "directory for flight-recorder artifacts"),
])

# ceiling on the fused-decode horizon: every emitted token of a horizon is
# buffered per slot until the harvest, and the host's gain per token has
# long flattened by then
MAX_DECODE_HORIZON = 32


def resolve_decode_horizon(value=None) -> int:
    """The fused-decode horizon N: an explicit ``value`` wins, then
    ``DS_DECODE_HORIZON``, then 1 (one token per dispatch). Raises
    ``ValueError`` outside 1 <= N <= :data:`MAX_DECODE_HORIZON`."""
    n = resolve_flag("DS_DECODE_HORIZON", value)
    if not 1 <= int(n) <= MAX_DECODE_HORIZON:
        raise ValueError(
            f"DS_DECODE_HORIZON={n!r}: expected an integer in "
            f"[1, {MAX_DECODE_HORIZON}]")
    return int(n)


def flag_names() -> Tuple[str, ...]:
    """Every declared DS_* knob, sorted."""
    return tuple(sorted(FLAGS))


def _parse(flag: Flag, raw: str):
    v = raw.strip()
    if flag.kind != "str":
        v = v.lower()
    if v == "":
        return flag.default
    if flag.kind == "bool":
        if v in FALSE_WORDS:
            return False
        if v in TRUE_WORDS:
            return True
        raise ValueError(f"{flag.name}={raw!r}: expected 'on' or 'off'")
    if flag.kind == "int":
        try:
            return int(v)
        except ValueError:
            raise ValueError(f"{flag.name}={raw!r}: expected an integer")
    if flag.kind == "float":
        try:
            return float(v)
        except ValueError:
            raise ValueError(f"{flag.name}={raw!r}: expected a number")
    if flag.kind == "choice":
        v = flag.aliases.get(v, v)
        if v not in flag.choices:
            raise ValueError(f"{flag.name}={raw!r}: expected "
                             + " or ".join(f"'{c}'"
                                           for c in reversed(flag.choices)))
        return v
    return v


def resolve_flag(name: str, override=None, env: Optional[Mapping] = None):
    """Resolve the declared knob ``name``: an explicit ``override`` wins,
    else the environment (``env``, default ``os.environ``), else the
    declared default. A string override is parsed like an environment
    value; True/False map onto a choice flag's on/off spellings. An
    undeclared name raises ``KeyError``."""
    flag = FLAGS.get(name)
    if flag is None:
        raise KeyError(f"undeclared env flag {name!r}; add it to "
                       f"deepspeed_tpu_torch.utils.env.FLAGS")
    if override is not None:
        if isinstance(override, str):
            return _parse(flag, override)
        if flag.kind == "bool":
            return bool(override)
        if flag.kind == "int":
            return int(override)
        if flag.kind == "float":
            return float(override)
        if flag.kind == "choice" and isinstance(override, bool):
            return _parse(flag, "on" if override else "off")
        return override
    env = os.environ if env is None else env
    return _parse(flag, env.get(name, ""))
